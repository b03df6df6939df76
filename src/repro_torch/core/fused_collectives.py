"""The add+norm slot after attention and after the FFN: AllReduce +
residual-add + RMSNorm, five ways, as ``repro.core.fused_collectives``.

The tp ranks sit on a leading rank axis of R = ``ctx.local_ranks``
entries (``distributed/context.py``): all tp ranks of one device under
the ``rank_axis`` backend, this process's one rank under
``process_group``.  Shapes:

    x          (R, T, d)   row-parallel product output, partial over ranks
    residual   vanilla/nocomm: (R, T, d), full on every rank
               reordered/fused/ring: (R, T // tp, d), each rank's token slice
    weight     (d,)
    returns    (normed (R, T, d), the same on every rank, new residual)

Modes:

    vanilla   : psum -> +residual -> RMSNorm on all T tokens on every rank
    reordered : psum_scatter -> unfused add+norm on 1/tp of the tokens ->
                all_gather
    fused     : psum_scatter -> single-pass fused add+norm (kernel K2 when
                ``ctx.use_pallas``, on the local rows) -> all_gather
    ring      : the whole slot in one kernel, K1 on
                ``ring_ctas(ctx.comm_budget)`` CTAs: on the rank axis its
                one-card form (``kernels/ar_rmsnorm.py``), under
                ``process_group`` its cross-rank form over the model
                group's peer buffers (``kernels/ar_rmsnorm_peer.py``,
                ``ctx.groups.peer``); falls down the reference's ladder to
                ``fused`` when there is no reduction to fold in, a sandwich
                post-norm, or no kernels asked for
    nocomm    : collectives skipped (perf counterfactual, wrong math)

The collectives are ``distributed/collectives.py``'s, each with both
backends.  On the rank axis psum sums in fp32, rank 0 first, and rounds
to x's dtype (``kernels.ar_rmsnorm.rank_sum``), psum_scatter(tiled) gives
rank r rows ``[r·C, (r+1)·C)``, and all_gather writes the full result into
every rank.  With a data axis (``ctx.dp`` = D > 1) T holds the D data
shards' tokens one shard after the other, and the scatter and the gather
work inside each shard, as the reference's collectives over ``model`` do
(``distributed.context.scatter_rows``): rank r's residual holds rows
``[r·C, (r+1)·C)`` of every shard, C = T / (D·R), and K1 runs once per
data shard over that shard's rows.  Under ``process_group`` they are
``torch.distributed`` collectives over the model group; a process holds
one data shard's rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.splitting import ring_ctas
from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import CommCtx, shard_rows
from repro_torch.kernels import ar_rmsnorm_peer as K1P
from repro_torch.kernels.ops import ar_rmsnorm, fused_residual_rmsnorm
from repro_torch.layers.norms import residual_rmsnorm_unfused, rms_norm


def _ring_supported(ctx: CommCtx, reduce_input: bool, weight_post) -> bool:
    """The reference's ladder for mode="ring": K1 needs a genuine
    reduction to fold in, no sandwich post-norm (it fuses exactly
    add+norm), and kernels enabled."""
    return reduce_input and weight_post is None and ctx.use_pallas


def _ring(x, residual, weight, ctx: CommCtx):
    """K1 over each data shard's rows: x (R, T, d), residual (R, T/R, d)
    placed by ``scatter_rows``.  On the rank axis one launch per data
    shard, on views of the contiguous x; under ``process_group`` one
    launch of the cross-rank form on this process's rank (a process
    holds one data shard's rows)."""
    x = x.contiguous()
    if ctx.process_group:
        return K1P.ar_rmsnorm_peer(x, residual, weight, ctx, eps=ctx.eps,
                                   ctas=ring_ctas(ctx.comm_budget))
    if ctx.dp == 1:
        return ar_rmsnorm(x, residual, weight, eps=ctx.eps,
                          ctas=ring_ctas(ctx.comm_budget), use_pallas=True)
    r, t, d = x.shape
    c = t // (ctx.dp * r)
    outs, ress = [], []
    for g, (lo, hi) in enumerate(shard_rows(t, ctx.dp)):
        out, res = ar_rmsnorm(x[:, lo:hi], residual[:, g * c:(g + 1) * c],
                              weight, eps=ctx.eps,
                              ctas=ring_ctas(ctx.comm_budget),
                              use_pallas=True)
        outs.append(out)
        ress.append(res)
    return torch.cat(outs, dim=1), torch.cat(ress, dim=1)


def comm_norm(x, residual, weight, *, ctx: CommCtx, reduce_input: bool = True,
              weight_post=None):
    """The AllReduce-RMSNorm slot.  ``reduce_input=False``: x is already
    complete on every rank; the reduction is skipped, the token-sharded
    structure kept.  ``weight_post``: gemma-style post-norm of the reduced
    block output before the residual add."""
    mode = ctx.mode
    if x.shape[0] != ctx.local_ranks:
        raise ValueError(f"x has {x.shape[0]} ranks, ctx holds "
                         f"{ctx.local_ranks} of tp={ctx.tp}")
    if mode in ("nocomm", "vanilla"):
        if mode == "vanilla" and reduce_input:
            x = C.psum(x, ctx)           # (T, d), the same on every rank
        if weight_post is not None:
            x = rms_norm(x, weight_post, ctx.eps)
        return residual_rmsnorm_unfused(x, residual, weight, ctx.eps)
    if mode not in ("reordered", "fused", "ring"):
        raise ValueError(f"unknown comm mode {mode!r}")

    if mode == "ring":
        if _ring_supported(ctx, reduce_input, weight_post):
            return _ring(x, residual, weight, ctx)
        mode = "fused"

    r, t, d = x.shape
    if reduce_input:
        local = C.psum_scatter(x, ctx)
    else:
        local = C.token_shard_slice(x, ctx)
    if weight_post is not None:
        local = rms_norm(local, weight_post, ctx.eps)
    rows = local.shape[0] * local.shape[1]
    if mode == "fused" and weight_post is None:
        normed, new_res = fused_residual_rmsnorm(
            local.reshape(rows, d), residual.reshape(rows, d), weight,
            eps=ctx.eps, use_pallas=ctx.use_pallas)
        new_res = new_res.reshape(residual.shape)
    else:
        normed, new_res = residual_rmsnorm_unfused(local, residual, weight,
                                                   ctx.eps)
    return C.all_gather(normed.reshape(r, rows // r, d), ctx), new_res


def final_norm(residual, weight, *, ctx: CommCtx):
    """Final pre-LM-head RMSNorm on the residual stream (no add), gathered
    to every rank: (R, T, d)."""
    normed = rms_norm(residual, weight, ctx.eps)
    if ctx.sharded_residual:
        return C.all_gather(normed, ctx)
    return normed


def fresh_residual(t_tokens: int, d: int, dtype, *, ctx: CommCtx,
                   device=None):
    """Zero residual in the layout the configured mode expects."""
    rows = t_tokens // ctx.tp if ctx.sharded_residual else t_tokens
    return torch.zeros((ctx.local_ranks, rows, d), dtype=dtype,
                       device=device)


def gather_residual(residual, *, ctx: CommCtx):
    """The full residual stream on every rank: (R, T, d)."""
    if ctx.sharded_residual:
        return C.all_gather(residual, ctx)
    return residual
