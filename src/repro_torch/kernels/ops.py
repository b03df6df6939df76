"""Dispatchers between the hand-written kernels and their plain versions,
as ``repro.kernels.ops``: ``use_pallas`` (the ``use_pallas_norm`` setting
of ``ParallelConfig``) selects K2's and K1's wrappers, and
``layers.attention`` reaches K3 through ``flash_attention`` under
``attn_impl="pallas"``.  Where autograd records the call, K2 and K3 go
through their ``torch.autograd.Function`` (``kernels/autograd.py``)."""
from __future__ import annotations

from repro_torch.kernels import autograd as AG
from repro_torch.kernels.ar_rmsnorm import ar_rmsnorm as _k1
from repro_torch.kernels.ar_rmsnorm import ar_rmsnorm_plain
from repro_torch.kernels.flash_attention import flash_attention as _k3
from repro_torch.kernels.fused_rmsnorm import (fused_residual_rmsnorm as _k2,
                                               fused_residual_rmsnorm_plain)


def fused_residual_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                           use_pallas: bool = False):
    """Single-pass residual + RMSNorm.  Returns (normed, new_residual)."""
    if not use_pallas:
        return fused_residual_rmsnorm_plain(x, residual, weight, eps)
    if AG.needs_grad(x, residual, weight):
        return AG.FusedResidualRMSNorm.apply(x, residual, weight, eps)
    return _k2(x, residual, weight, eps=eps)


def ar_rmsnorm(x, residual, weight, *, eps: float = 1e-6, ctas: int = 8,
               use_pallas: bool = False):
    """AllReduce over the rank axis + residual + RMSNorm (kernel K1).
    Returns (normed on every rank, new token-sharded residual)."""
    if not use_pallas:
        return ar_rmsnorm_plain(x, residual, weight, eps)
    if AG.needs_grad(x, residual, weight):
        raise RuntimeError(
            "kernel K1 (comm mode 'ring') has no backward: train with comm "
            "mode vanilla, reordered, fused or nocomm")
    return _k1(x, residual, weight, eps=eps, ctas=ctas)


def flash_attention(q, k, v, qpos, kpos, *, causal: bool, window: int = 0,
                    sm_scale=None):
    """Attention forward through kernel K3 (shapes as
    ``kernels.flash_attention.flash_attention_plain``)."""
    if AG.needs_grad(q, k, v):
        return AG.FlashAttention.apply(q, k, v, qpos, kpos, causal, window,
                                       sm_scale)
    return _k3(q, k, v, qpos, kpos, causal=causal, window=window,
               sm_scale=sm_scale)
