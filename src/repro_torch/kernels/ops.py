"""Dispatcher between kernel K2 and its plain version, as
``repro.kernels.ops``: ``use_pallas`` (the ``use_pallas_norm`` setting of
``ParallelConfig``) selects the hand-written kernel's wrapper."""
from __future__ import annotations

from repro_torch.kernels.fused_rmsnorm import (fused_residual_rmsnorm as _k2,
                                               fused_residual_rmsnorm_plain)


def fused_residual_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                           use_pallas: bool = False):
    """Single-pass residual + RMSNorm.  Returns (normed, new_residual)."""
    if use_pallas:
        return _k2(x, residual, weight, eps=eps)
    return fused_residual_rmsnorm_plain(x, residual, weight, eps)
