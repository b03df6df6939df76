"""Communication context for the fused collective slots, as
``repro.distributed.context``.

The reference runs tensor parallelism as ``tp`` devices under
``shard_map``; every weight carries a per-shard leading axis.  This port
keeps that axis as a *rank axis* R = tp and holds all ranks in one process
on one device: a tensor that differs per rank is ``(R, ...)``, and each
collective is an operation over dim 0 (``psum`` a sum over R,
``psum_scatter(tiled)`` rank r's rows ``[r·C, (r+1)·C)``, ``all_gather``
the full ``(T, d)`` on every rank).  At tp=1 the rank axis has size 1.

A ``torch.distributed`` process group (one rank per card) is queued in
ROADMAP.md; asking for one raises.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CommCtx:
    """What the fused collective ops need to know about the layout."""
    mode: str = "fused"            # vanilla | reordered | fused | ring | nocomm
    eps: float = 1e-6
    use_pallas: bool = False       # route add+norm to kernels K2 / K1
    tp: int = 1                    # size of the rank axis R
    comm_budget: float = 1.0       # SM-equivalent fraction -> K1's CTAs
    backend: str = "rank_axis"

    def __post_init__(self):
        if self.backend != "rank_axis":
            raise NotImplementedError(
                f"comm backend {self.backend!r} is not ported yet: only the "
                f"one-device rank axis is (ROADMAP.md: the process-group "
                f"CommCtx comes with the multi-card K1)")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")

    @property
    def sharded_residual(self) -> bool:
        """fused/reordered/ring keep the residual stream token-sharded."""
        return self.mode in ("fused", "reordered", "ring")

    def tp_size(self) -> int:
        return self.tp


def token_shard_slice(x: torch.Tensor, ctx: CommCtx) -> torch.Tensor:
    """Each rank's token range of a token-replicated ``(R, T, ...)``:
    ``(R, T // R, ...)``, rank r keeping rows ``[r·C, (r+1)·C)``."""
    r = x.shape[0]
    if r == 1:
        return x
    c = x.shape[1] // r
    idx = torch.arange(r, device=x.device)
    return x.reshape(r, r, c, *x.shape[2:])[idx, idx]
