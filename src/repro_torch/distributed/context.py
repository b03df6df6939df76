"""Communication context for the fused collective slots, as
``repro.distributed.context``.

The reference runs tensor parallelism as ``tp`` devices under
``shard_map``; every weight carries a per-shard leading axis.  This port
keeps that axis as a *rank axis* R = tp and holds all ranks in one process
on one device: a tensor that differs per rank is ``(R, ...)``, and each
collective is an operation over dim 0 (``psum`` a sum over R,
``psum_scatter(tiled)`` rank r's rows ``[r·C, (r+1)·C)``, ``all_gather``
the full ``(T, d)`` on every rank).  At tp=1 the rank axis has size 1.

The reference's ``data`` mesh axis is a second rank axis D = ``dp``.
Where data shards run independently (embeddings, dense layers, attention,
the sampler) D is folded into the batch: a tensor of token rows holds the
D shards' rows one after the other, shard d's ``T_loc`` tokens at rows
``[d·T_loc, (d+1)·T_loc)``.  Inside a data shard the model ranks split
that shard's tokens, as the reference's ``psum_scatter(tiled)`` does
within each shard: rank r holds rows ``[r·C, (r+1)·C)`` of every shard,
C = T_loc / R, shard by shard (``shard_rows``).  D shows up on its own
only where the reference communicates over ``data``: the MoE ``ep2d``
all-to-alls (``layers/moe.py``), the context-parallel decode combine
(``layers/attention.py``) and ``psum_dp``.

Two backends carry the ranks (``CommCtx.backend``):

* ``rank_axis`` (the default): every rank in one process on one device,
  as above; ``local_ranks`` = tp and the collectives are operations over
  dim 0 (the ``rank_axis`` branches of ``distributed/collectives.py``);
* ``process_group``: one model rank per process (one per card under
  NCCL, CPU processes under gloo), over the ``torch.distributed`` groups
  of ``launch.mesh.init_groups``.  Every per-rank tensor keeps its leading
  rank axis, of size ``local_ranks`` = 1, holding this process's rank
  ``rank``; the collectives go over ``groups.model`` (and
  ``groups.data`` for ``psum_dp`` / ``pmax_dp``).  Each process holds
  one data shard's rows, so the data-shard placement above never shows
  in a process's tensors.

``bf16_wire`` is the reference's field: ``False`` reduces in float32 on
the wire and rounds once to x's dtype (``rank_sum``'s contract, up to the
order of the sum); ``True`` reduces in x's dtype (half the bytes of a
bf16 reduction).  The rank axis always sums in float32, rank 0 first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

BACKENDS = ("rank_axis", "process_group")


@dataclasses.dataclass(frozen=True)
class Groups:
    """This process's place in a (data, model) mesh of processes
    (``launch.mesh.init_groups``): its ``torch.distributed`` group over
    the model axis and over the data axis, its index in each and their
    sizes; and, for comm mode ``ring`` on CUDA, the model group's
    peer-mapped buffers that K1 reaches its peers through
    (``distributed.peer.attach``)."""
    model: Any = dataclasses.field(compare=False, repr=False)
    data: Any = dataclasses.field(compare=False, repr=False)
    model_rank: int
    data_rank: int
    model_size: int
    data_size: int
    peer: Any = dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class CommCtx:
    """What the fused collective ops need to know about the layout."""
    mode: str = "fused"            # vanilla | reordered | fused | ring | nocomm
    eps: float = 1e-6
    use_pallas: bool = False       # route add+norm to kernels K2 / K1
    tp: int = 1                    # model ranks (logical)
    comm_budget: float = 1.0       # SM-equivalent fraction -> K1's CTAs
    backend: str = "rank_axis"     # rank_axis | process_group
    dp: int = 1                    # data shards (logical)
    groups: Optional[Groups] = None    # process_group: the mesh's groups
    bf16_wire: bool = False        # reduce in x's dtype, not float32

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown comm backend {self.backend!r}; "
                             f"one of {BACKENDS}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {self.dp}")
        if self.backend == "process_group":
            g = self.groups
            if g is None:
                raise ValueError("backend 'process_group' needs the groups "
                                 "of launch.mesh.init_groups")
            if (self.tp, self.dp) != (g.model_size, g.data_size):
                raise ValueError(f"tp={self.tp}, dp={self.dp} against "
                                 f"groups of model size {g.model_size}, "
                                 f"data size {g.data_size}")

    @property
    def sharded_residual(self) -> bool:
        """fused/reordered/ring keep the residual stream token-sharded."""
        return self.mode in ("fused", "reordered", "ring")

    @property
    def process_group(self) -> bool:
        return self.backend == "process_group"

    @property
    def local_ranks(self) -> int:
        """The leading axis every per-rank tensor carries: tp on the rank
        axis, 1 in a process of a group."""
        return 1 if self.process_group else self.tp

    @property
    def rank(self) -> int:
        """The model rank of the first local rank: this process's under
        ``process_group``, 0 on the rank axis (whose ranks are
        ``arange(tp)``)."""
        return self.groups.model_rank if self.process_group else 0

    def tp_size(self) -> int:
        return self.tp


def shard_rows(t_tokens: int, dp: int) -> list:
    """Each data shard's token range ``[lo, hi)`` of a folded token axis
    of ``t_tokens`` rows."""
    if t_tokens % dp:
        raise ValueError(f"{t_tokens} tokens do not split over {dp} data "
                         f"shards")
    t_loc = t_tokens // dp
    return [(d * t_loc, (d + 1) * t_loc) for d in range(dp)]


def scatter_rows(full: torch.Tensor, r: int, dp: int = 1) -> torch.Tensor:
    """``psum_scatter(tiled)``'s row placement, data shard by data shard:
    a (T, ...) tensor of D shards' rows -> (R, T // R, ...), rank r
    holding rows ``[r·C, (r+1)·C)`` of each shard (C = T / (D·R)), shard
    after shard."""
    t = full.shape[0]
    c = t // (dp * r)
    if dp == 1:
        return full.reshape(r, c, *full.shape[1:])
    return full.reshape(dp, r, c, *full.shape[1:]).transpose(0, 1).reshape(
        r, dp * c, *full.shape[1:])


def gather_rows(local: torch.Tensor, dp: int = 1) -> torch.Tensor:
    """The inverse of ``scatter_rows``: (R, T // R, ...) -> (T, ...) in
    token order."""
    r, rows = local.shape[:2]
    if dp == 1:
        return local.reshape(r * rows, *local.shape[2:])
    return local.reshape(r, dp, rows // dp, *local.shape[2:]).transpose(
        0, 1).reshape(r * rows, *local.shape[2:])


def token_shard_slice(x: torch.Tensor, ctx: CommCtx) -> torch.Tensor:
    """Each rank's token range of a token-replicated ``(R, T, ...)``:
    ``(R, T // R, ...)``, rank r keeping rows ``[r·C, (r+1)·C)`` of each
    data shard's tokens (``scatter_rows``' placement)."""
    r, dp = x.shape[0], ctx.dp
    if r == 1:
        return x
    c = x.shape[1] // (r * dp)
    idx = torch.arange(r, device=x.device)
    # (R, D, R, C, ...) indexed at [r, :, r]: the advanced dims lead
    picked = x.reshape(r, dp, r, c, *x.shape[2:])[idx, :, idx]
    return picked.reshape(r, dp * c, *x.shape[2:])


def psum_dp(x: torch.Tensor, ctx: CommCtx) -> torch.Tensor:
    """The all-reduce over the data axis (gradient sync): a (D, ...)
    tensor of per-shard values -> their sum on every shard, (D, ...).
    Summed in float32, shard 0 first, rounded once to x's dtype."""
    if x.shape[0] != ctx.dp:
        raise ValueError(f"x has {x.shape[0]} data shards, ctx.dp={ctx.dp}")
    acc = x[0].float()
    for k in range(1, x.shape[0]):
        acc = acc + x[k].float()
    return acc.to(x.dtype).expand_as(x).contiguous()
