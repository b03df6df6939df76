"""Dispatchers between the hand-written kernels and their plain versions,
as ``repro.kernels.ops``: ``use_pallas`` (the ``use_pallas_norm`` setting
of ``ParallelConfig``) selects the kernel's wrapper."""
from __future__ import annotations

from repro_torch.kernels.ar_rmsnorm import ar_rmsnorm as _k1
from repro_torch.kernels.ar_rmsnorm import ar_rmsnorm_plain
from repro_torch.kernels.fused_rmsnorm import (fused_residual_rmsnorm as _k2,
                                               fused_residual_rmsnorm_plain)


def fused_residual_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                           use_pallas: bool = False):
    """Single-pass residual + RMSNorm.  Returns (normed, new_residual)."""
    if use_pallas:
        return _k2(x, residual, weight, eps=eps)
    return fused_residual_rmsnorm_plain(x, residual, weight, eps)


def ar_rmsnorm(x, residual, weight, *, eps: float = 1e-6, ctas: int = 8,
               use_pallas: bool = False):
    """AllReduce over the rank axis + residual + RMSNorm (kernel K1).
    Returns (normed on every rank, new token-sharded residual)."""
    if use_pallas:
        return _k1(x, residual, weight, eps=eps, ctas=ctas)
    return ar_rmsnorm_plain(x, residual, weight, eps)
