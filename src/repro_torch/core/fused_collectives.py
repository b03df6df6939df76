"""The add+norm slot after attention and after the FFN: AllReduce +
residual-add + RMSNorm, as ``repro.core.fused_collectives`` at tp=1.

At tp=1 the reduction, the reduce-scatter and the all-gather around the
norm are identities, so the modes differ only in how the add+norm runs:

    vanilla / nocomm : unfused two-pass add+norm on all tokens
    reordered        : unfused two-pass add+norm on the token shard
    fused            : single-pass fused add+norm (kernel K2 when
                       ``ctx.use_pallas``)
    ring             : the one-kernel AllReduce-RMSNorm (K1), not ported
"""
from __future__ import annotations

import torch

from repro_torch.distributed.context import CommCtx
from repro_torch.kernels.ops import fused_residual_rmsnorm
from repro_torch.layers.norms import residual_rmsnorm_unfused, rms_norm


def comm_norm(x, residual, weight, *, ctx: CommCtx, reduce_input: bool = True,
              weight_post=None):
    """x (T, d) block output; residual (T // tp, d) or (T, d) by mode;
    weight (d,).  Returns (normed (T, d), new_residual)."""
    mode = ctx.mode
    if mode == "ring":
        raise NotImplementedError(
            "comm_mode='ring' needs kernel K1 (NVLS AllReduce-RMSNorm), "
            "queued in ROADMAP.md section B")
    if mode in ("nocomm", "vanilla"):
        if weight_post is not None:
            x = rms_norm(x, weight_post, ctx.eps)
        return residual_rmsnorm_unfused(x, residual, weight, ctx.eps)
    if mode not in ("reordered", "fused"):
        raise ValueError(f"unknown comm mode {mode!r}")
    local = x                     # psum_scatter at tp=1
    if weight_post is not None:
        local = rms_norm(local, weight_post, ctx.eps)
    if mode == "fused" and weight_post is None:
        normed, new_res = fused_residual_rmsnorm(
            local, residual, weight, eps=ctx.eps, use_pallas=ctx.use_pallas)
    else:
        normed, new_res = residual_rmsnorm_unfused(local, residual, weight,
                                                   ctx.eps)
    return normed, new_res        # all_gather at tp=1


def final_norm(residual, weight, *, ctx: CommCtx):
    """Final pre-LM-head RMSNorm on the residual stream (no add)."""
    return rms_norm(residual, weight, ctx.eps)


def fresh_residual(t_tokens: int, d: int, dtype, *, ctx: CommCtx,
                   device=None):
    """Zero residual in the layout the configured mode expects."""
    rows = t_tokens // ctx.tp_size() if ctx.sharded_residual else t_tokens
    return torch.zeros((rows, d), dtype=dtype, device=device)
