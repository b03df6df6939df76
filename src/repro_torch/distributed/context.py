"""Communication context for the fused collective slots.

This slice runs at tp=1 with no process group: every collective around
the add+norm (psum, psum_scatter, all_gather) is the identity.  The
``torch.distributed`` version comes with the tp>1 slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCtx:
    """What the fused collective ops need to know about the layout."""
    mode: str = "fused"            # vanilla | reordered | fused | ring | nocomm
    eps: float = 1e-6
    use_pallas: bool = False       # route the fused add+norm to kernel K2
    tp: int = 1

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(
                "tensor parallelism > 1 is not ported yet (ROADMAP.md A4: "
                "CommCtx over a torch.distributed process group)")

    @property
    def sharded_residual(self) -> bool:
        """fused/reordered/ring keep the residual stream token-sharded."""
        return self.mode in ("fused", "reordered", "ring")

    def tp_size(self) -> int:
        return self.tp
