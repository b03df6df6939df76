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
    all_to_all    (R_x, D_loc, N, ...) -> (R_x, D_loc, N, ...), each data
                  shard's N rows cut into D tiles, tile j to shard j

where D_loc is ``ctx.dp`` on the rank axis and 1 in a process, and R_x is
R or 1 (a tensor the same on every model rank, as ``ep2d``'s routed
rows).
``psum``, ``pmax`` and ``gather_ranks`` take a ``ctx`` of None as the
rank axis.

The rank axis's reductions are its operations over dim 0: the sum in
float32, rank 0 first, rounded once (``kernels.ar_rmsnorm.rank_sum``).
Under ``process_group`` they are ``all_reduce``, ``reduce_scatter_tensor``
and ``all_gather_into_tensor`` over ``ctx.groups.model`` (``.dp``, the
data-parallel group, for the ``_dp`` pair), and ``all_to_all`` (on the rank axis the index op of
``lax.all_to_all(tiled=True)``) is ``all_to_all_single`` over
``ctx.groups.data``: a sum runs in float32 on the wire and is rounded
once to x's dtype, or in x's dtype under ``ctx.bf16_wire``; a max, a
gather and an all-to-all move x's dtype.  Called on a side stream, NCCL
orders its work after that stream's, and the stream waits for the
result.  Where autograd records a call under ``process_group``,
``psum``, ``psum_scatter``, ``all_gather``, ``gather_ranks``,
``psum_dp`` and ``all_to_all`` carry a backward (the Functions below),
``token_shard_slice`` is a slice and ``pmax`` carries no gradient;
``pmax_dp`` serves only.

While ``analysis.op_costs`` counts a call (``recording``), every
collective reports its kind (the reference's HLO names), the bytes of
its result as its tensors hold one rank's (on the rank axis a model-axis
result spans every data shard folded into the batch, and a data-axis
one carries the model ranks), its group size and its axis, and its
body's tensor ops are not counted as the model's (on the rank axis a
collective is an operation over dim 0).  ``note`` reports a collective
with one device's result bytes.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

from repro_torch.distributed import context as C
from repro_torch.kernels import autograd as AG
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
        def inner(x, ctx, **kw):
            if not _RECORDERS or _RECORDERS[-1].inside:
                return fn(x, ctx, **kw)
            with _RECORDERS[-1].collective():
                out = fn(x, ctx, **kw)
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


def _reduce_scatter(x: torch.Tensor, group, size: int, dtype):
    """(T, ...) partials -> (T // size, ...), this rank's rows of the sum,
    summed in ``dtype`` and rounded once to x's dtype."""
    t = x.shape[0]
    if t % size:
        raise ValueError(f"{t} rows do not scatter over {size} ranks")
    wire = x.to(dtype).contiguous()
    out = wire.new_empty((t // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, wire, group=group)
    return out.to(x.dtype)


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """(C, ...) -> (size · C, ...), every rank's rows, rank-major."""
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


# Under process_group a collective that autograd records is one of four
# Functions.  Each backward is derived from the rank axis's form: a
# process's input gradient is its rank's slice of what autograd gives
# through the operation over dim 0, where a value the same on every rank
# (a sum, a gathered tensor) carries, in each process, that process's
# share of its cotangent, the shares summing to it over the group (the
# loss is computed on every model rank and seeded so that the seeds sum
# to one, ``training/train_step.py``).  So the sum's backward sums the
# shares (all-reduce), the reduce-scatter's gathers each rank's rows of
# the cotangent (all-gather), and the all-gather's, whose copies on every
# rank the rank axis reads as one tensor expanded R times, sums the
# copies' cotangents and keeps the rank's rows (reduce-scatter).  Sums in
# the backward travel as the forward's do (float32 unless ``bf16_wire``)
# and are rounded once.  A backward runs on the stream autograd runs the
# node on, the forward's: NCCL orders its work after that stream's, and
# the stream waits for the result, as in the forward.

class _AllReduceSum(torch.autograd.Function):
    """``psum`` and ``psum_dp``: the sum over ``group``; its backward the
    all-reduce of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, bf16_wire: bool):
        ctx.group, ctx.bf16_wire = group, bf16_wire
        return _all_reduce(x, dist.ReduceOp.SUM, group,
                           x.dtype if bf16_wire else torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group,
                           g.dtype if ctx.bf16_wire
                           else torch.float32), None, None


class _ReduceScatter(torch.autograd.Function):
    """``psum_scatter``: this rank's rows of the sum; its backward the
    all-gather of the rows' cotangents."""

    @staticmethod
    def forward(ctx, x, group, size: int, bf16_wire: bool):
        ctx.group, ctx.size = group, size
        return _reduce_scatter(x, group, size,
                               x.dtype if bf16_wire else torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.size), None, None, None


class _AllGather(torch.autograd.Function):
    """``all_gather`` and ``gather_ranks``: every rank's rows; its
    backward the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, size: int, bf16_wire: bool):
        ctx.group, ctx.size, ctx.bf16_wire = group, size, bf16_wire
        return _all_gather(x, group, size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.size,
                               g.dtype if ctx.bf16_wire
                               else torch.float32), None, None, None


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of a process's (1, 1, N, ...) rows over
    ``group``: tile j of its N rows to rank j, tile s of the result from
    rank s."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out[0, 0], t[0, 0], group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all``'s exchange of rows over the data group; its
    backward the same exchange of the cotangent (a tiled all-to-all is
    its own inverse: what went to rank j as tile j comes back from it as
    tile j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _sum(x, group, ctx: C.CommCtx) -> torch.Tensor:
    if AG.needs_grad(x):
        return _AllReduceSum.apply(x, group, ctx.bf16_wire)
    return _all_reduce(x, dist.ReduceOp.SUM, group, _wire(x, ctx))


def _gather(x, ctx: C.CommCtx) -> torch.Tensor:
    group = ctx.groups.model
    if AG.needs_grad(x):
        return _AllGather.apply(x, group, ctx.tp, ctx.bf16_wire)
    return _all_gather(x, group, ctx.tp)


@_reports("all-reduce", "model", _whole)
def psum(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return rank_sum(x)
    return _sum(_one(x), ctx.groups.model, ctx)


@_reports("reduce-scatter", "model", _per_rank)
def psum_scatter(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return C.scatter_rows(rank_sum(x), x.shape[0], ctx.dp)
    x = _one(x)
    if AG.needs_grad(x):
        return _ReduceScatter.apply(x, ctx.groups.model, ctx.tp,
                                    ctx.bf16_wire)[None]
    return _reduce_scatter(x, ctx.groups.model, ctx.tp, _wire(x, ctx))[None]


@_reports("all-gather", "model", _per_rank)
def all_gather(local: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        r = local.shape[0]
        full = C.gather_rows(local, ctx.dp)
        return (full[None] if r == 1
                else full.expand(r, *full.shape).contiguous())
    return _gather(_one(local), ctx)[None]


@_reports("all-gather", "model", _whole)
def gather_ranks(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return x
    _one(x)
    return _gather(x, ctx)


@_reports("all-reduce", "model", _whole)
def pmax(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    """Under ``process_group`` the max carries no gradient (its input is
    detached), as the cross-entropy's stability max carries none."""
    if not _grouped(ctx):
        return x.amax(dim=0)
    x = _one(x).detach()
    return _all_reduce(x, dist.ReduceOp.MAX, ctx.groups.model, x.dtype)


def token_shard_slice(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    """This process's (or each rank's) token range of a token-replicated
    (R, T, ...): ``context.token_shard_slice``'s placement.  Under
    ``process_group`` a slice, whose own backward (the cotangent in the
    rank's rows, zeros elsewhere) is the rank's slice of the rank axis's."""
    if not _grouped(ctx):
        return C.token_shard_slice(x, ctx)
    c = x.shape[1] // ctx.tp
    return x[:, ctx.rank * c:(ctx.rank + 1) * c]


@_reports("all-reduce", "data", _per_shard)
def psum_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        return C.psum_dp(x, ctx)
    return _sum(_one(x), ctx.groups.dp, ctx)[None]


@_reports("all-reduce", "data", _per_shard)
def pmax_dp(x: torch.Tensor, ctx: C.CommCtx) -> torch.Tensor:
    if not _grouped(ctx):
        if x.shape[0] != ctx.dp:
            raise ValueError(f"x has {x.shape[0]} data shards, "
                             f"ctx.dp={ctx.dp}")
        return x.amax(dim=0, keepdim=True).expand_as(x).contiguous()
    return _all_reduce(_one(x), dist.ReduceOp.MAX, ctx.groups.dp,
                       x.dtype)[None]


def _tiles(out, x, ctx):
    """An all-to-all's rows (R_x, D_loc, N, ...): one data shard's result
    bytes as a data-axis result that carries all R local ranks (a tensor
    the same on every rank, R_x = 1, counts R copies), the data group."""
    rows = out[0] if isinstance(out, tuple) else out
    return (_nbytes(rows) / rows.shape[1] * ctx.local_ranks / rows.shape[0],
            data_size(ctx))


def data_size(ctx: C.CommCtx) -> int:
    """The data axis's size, which ``all_to_all`` exchanges over: the
    rank axis's D_loc = ``ctx.dp``, or the data group's under
    ``process_group`` (``ctx.dp`` counts its pods too)."""
    return ctx.groups.data_size if _grouped(ctx) else ctx.dp


@_reports("all-to-all", "data", _tiles)
def all_to_all(x: torch.Tensor, ctx: C.CommCtx, *, ids=None):
    """``lax.all_to_all(x, "data", 0, 0, tiled=True)`` of each data
    shard's (N, ...): x (R_x, D_loc, N, ...) -> the same shape, data shard
    j holding tile j (rows ``[j·N/D, (j+1)·N/D)``) of every shard, shard
    by shard.  ``ids`` (R_x, D_loc, N), an integer per row (``ep2d``'s
    local expert ids), rides the same exchange and comes back beside it:
    (rows, ids).  A recorder sees one all-to-all of the rows' bytes (the
    ids add 1/d of them).  On the rank axis an index op over the D_loc =
    ``ctx.dp`` shards; under ``process_group`` ``all_to_all_single`` over
    the data group (one per pod; gloo takes CUDA tensors), with a
    backward where autograd records the rows (the exchange back)."""
    if not _grouped(ctx):
        def swap(t):
            dp, n = t.shape[1], t.shape[2]
            if dp != ctx.dp or n % dp:
                raise ValueError(f"{n} rows of {dp} data shards do not "
                                 f"tile over ctx.dp={ctx.dp}")
            return t.unflatten(2, (dp, n // dp)).transpose(1, 2).flatten(
                2, 3)
        return swap(x) if ids is None else (swap(x), swap(ids))
    n_data = data_size(ctx)
    if x.shape[:2] != (1, 1) or x.shape[2] % n_data:
        raise ValueError(f"a process holds one rank of one data shard, "
                         f"whose rows tile over {n_data}: x "
                         f"{tuple(x.shape)}")

    def swap(t):
        if n_data == 1:
            return t
        if AG.needs_grad(t):
            return _AllToAll.apply(t, ctx.groups.data)
        return _exchange(t, ctx.groups.data)
    return swap(x) if ids is None else (swap(x), swap(ids))
