"""The collectives of the comm slots, the sampler and context-parallel
decode, each with both backends of ``CommCtx`` (``distributed/context.py``).

Every per-rank tensor carries a leading rank axis of ``ctx.local_ranks``
entries: all tp ranks on the rank axis, this process's one rank under
``process_group``.  Shapes, with R = ``ctx.local_ranks``:

    psum          (R, ...) partials -> (...), the sum, the same on every rank
    psum_scatter  (R, T, ...) partials -> (R, T // tp, ...), rank r the rows
                  [r·C, (r+1)·C) of the sum (``scatter_rows``' placement)
    all_gather    (R, T // tp, ...) -> (R, T, ...), every rank the rows in
                  ``gather_rows``' order
    pmax          (R, ...) -> (...), the max over the ranks
    gather_ranks  (R, ...) -> (tp, ...), every rank's tensor, rank-major
    psum_dp       (D_loc, ...) -> (D_loc, ...), the sum over the data shards
    pmax_dp       (D_loc, ...) -> (D_loc, ...), the max over the data shards

where D_loc is ``ctx.dp`` on the rank axis and 1 in a process.
``psum``, ``pmax`` and ``gather_ranks`` take a ``ctx`` of None as the
rank axis.

The rank axis's reductions are its operations over dim 0: the sum in
float32, rank 0 first, rounded once (``kernels.ar_rmsnorm.rank_sum``).
Under ``process_group`` they are ``all_reduce``, ``reduce_scatter_tensor``
and ``all_gather_into_tensor`` over ``ctx.groups.model`` (``.data`` for
the ``_dp`` pair): a sum runs in float32 on the wire and is rounded once to
x's dtype, or in x's dtype under ``ctx.bf16_wire``; a max and a gather move
x's dtype.  Called on a side stream, NCCL orders its work after that
stream's, and the stream waits for the result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import context as C
from repro_torch.kernels.ar_rmsnorm import rank_sum


def _grouped(ctx) -> bool:
    return ctx is not None and ctx.process_group


def _wire(x: torch.Tensor, ctx: C.CommCtx) -> torch.dtype:
    """The dtype a sum of x travels in."""
    return x.dtype if ctx.bf16_wire else torch.float32


def _one(x: torch.Tensor) -> torch.Tensor:
    """A process's only rank of x (1, ...)."""
    if x.shape[0] != 1:
        raise ValueError(f"a process holds one rank, x has {x.shape[0]}")
    return x[0]


def _all_reduce(x: torch.Tensor, op, group, dtype) -> torch.Tensor:
    buf = x.to(dtype, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.dtype)


def psum(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return rank_sum(x)
    x = _one(x)
    return _all_reduce(x, dist.ReduceOp.SUM, ctx.groups.model, _wire(x, ctx))


def psum_scatter(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return C.scatter_rows(rank_sum(x), x.shape[0], ctx.dp)
    x = _one(x)
    t = x.shape[0]
    if t % ctx.tp:
        raise ValueError(f"{t} rows do not scatter over {ctx.tp} ranks")
    wire = x.to(_wire(x, ctx)).contiguous()
    out = wire.new_empty((t // ctx.tp, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, wire, group=ctx.groups.model)
    return out.to(x.dtype)[None]


def all_gather(local: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        r = local.shape[0]
        full = C.gather_rows(local, ctx.dp)
        return (full[None] if r == 1
                else full.expand(r, *full.shape).contiguous())
    return gather_ranks(local, ctx).flatten(0, 1)[None]


def gather_ranks(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return x
    _one(x)
    out = x.new_empty((ctx.tp, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=ctx.groups.model)
    return out


def pmax(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return x.amax(dim=0)
    x = _one(x)
    return _all_reduce(x, dist.ReduceOp.MAX, ctx.groups.model, x.dtype)


def token_shard_slice(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    """This process's (or each rank's) token range of a token-replicated
    (R, T, ...): ``context.token_shard_slice``'s placement."""
    if not _grouped(ctx):
        return C.token_shard_slice(x, ctx)
    c = x.shape[1] // ctx.tp
    return x[:, ctx.rank * c:(ctx.rank + 1) * c]


def psum_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return C.psum_dp(x, ctx)
    return _all_reduce(_one(x), dist.ReduceOp.SUM, ctx.groups.data,
                       _wire(x, ctx))[None]


def pmax_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        if x.shape[0] != ctx.dp:
            raise ValueError(f"x has {x.shape[0]} data shards, "
                             f"ctx.dp={ctx.dp}")
        return x.amax(dim=0, keepdim=True).expand_as(x).contiguous()
    return _all_reduce(_one(x), dist.ReduceOp.MAX, ctx.groups.data,
                       x.dtype)[None]
