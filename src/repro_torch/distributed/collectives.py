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

While ``analysis.op_costs`` counts a call (``recording``), every
collective reports its kind (the reference's HLO names), the bytes of
its result as its tensors hold one rank's (on the rank axis a model-axis
result spans every data shard folded into the batch, and a data-axis
one carries the model ranks), its group size and its axis, and its
body's tensor ops are not counted as the model's (on the rank axis a
collective is an operation over dim 0).  ``note`` reports a collective
that a caller computes with index ops (the ``ep2d`` all-to-alls,
``layers/moe.py``), with one device's result bytes.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

from repro_torch.distributed import context as C
from repro_torch.kernels.ar_rmsnorm import rank_sum


_RECORDERS: list = []


@contextlib.contextmanager
def recording(recorder):
    """Report every collective to ``recorder`` while the block runs: an
    object with ``collective()``, a context manager around a collective's
    body, ``inside`` (whether such a body is running: a collective that
    another one calls is not reported) and ``add(kind, nbytes, group,
    axis)``, ``axis`` None where ``nbytes`` is one device's."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def note(kind: str, device_bytes: float, group: int,
         axis: str | None = None) -> None:
    """Report one collective of ``kind`` over a group of ``group`` ranks
    whose result is ``device_bytes`` on each device (as the tensors hold
    it where ``axis`` is given: ``model`` or ``data``)."""
    if _RECORDERS and group > 1:
        _RECORDERS[-1].add(kind, float(device_bytes), int(group), axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reports(kind: str, axis: str, per_rank):
    """Decorator: a recorder sees the call as one ``kind`` collective over
    ``axis``; ``per_rank(out, x, ctx)`` gives (one rank's result bytes,
    the group size)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(x, ctx):
            if not _RECORDERS or _RECORDERS[-1].inside:
                return fn(x, ctx)
            with _RECORDERS[-1].collective():
                out = fn(x, ctx)
            note(kind, *per_rank(out, x, ctx), axis)
            return out
        return inner
    return wrap


def _model_group(x, ctx) -> int:
    return ctx.tp if _grouped(ctx) else x.shape[0]


def _whole(out, x, ctx):
    """A result every rank holds whole: a sum, a max, or every rank's
    tensors gathered (``gather_ranks``)."""
    return _nbytes(out), _model_group(x, ctx)


def _per_rank(out, x, ctx):
    """A result whose leading axis is the local ranks."""
    return _nbytes(out) / out.shape[0], _model_group(x, ctx)


def _per_shard(out, x, ctx):
    """A (D_loc, ...) result over the data axis."""
    return _nbytes(out) / out.shape[0], ctx.dp


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


@_reports("all-reduce", "model", _whole)
def psum(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return rank_sum(x)
    x = _one(x)
    return _all_reduce(x, dist.ReduceOp.SUM, ctx.groups.model, _wire(x, ctx))


@_reports("reduce-scatter", "model", _per_rank)
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


@_reports("all-gather", "model", _per_rank)
def all_gather(local: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        r = local.shape[0]
        full = C.gather_rows(local, ctx.dp)
        return (full[None] if r == 1
                else full.expand(r, *full.shape).contiguous())
    return gather_ranks(local, ctx).flatten(0, 1)[None]


@_reports("all-gather", "model", _whole)
def gather_ranks(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return x
    _one(x)
    out = x.new_empty((ctx.tp, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=ctx.groups.model)
    return out


@_reports("all-reduce", "model", _whole)
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


@_reports("all-reduce", "data", _per_shard)
def psum_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return C.psum_dp(x, ctx)
    return _all_reduce(_one(x), dist.ReduceOp.SUM, ctx.groups.data,
                       _wire(x, ctx))[None]


@_reports("all-reduce", "data", _per_shard)
def pmax_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        if x.shape[0] != ctx.dp:
            raise ValueError(f"x has {x.shape[0]} data shards, "
                             f"ctx.dp={ctx.dp}")
        return x.amax(dim=0, keepdim=True).expand_as(x).contiguous()
    return _all_reduce(_one(x), dist.ReduceOp.MAX, ctx.groups.data,
                       x.dtype)[None]
