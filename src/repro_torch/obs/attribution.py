"""Per-forward weave-decision attribution (DESIGN.md §12), as
``repro.obs.attribution``.

Every model dispatch the engine runs gets one ``WeaveAttribution``
record: what the weave decision saw (tokens, threshold, wave unit), what
it chose (split + reason, straight from
``models.transformer.weave_decision_info`` — the SAME decision object
that increments ``EngineStats.weave_forwards``, so trace-derived weave
rates match the counter exactly), and what that choice is worth — the
§9 two-stream sim roofline's estimate of compute / comm / overlapped
virtual time for this forward (``sim.overlap_sim.step_attribution``).

The ``Attributor`` prices with ``HW(tile=pcfg.split_unit_for(tp))`` so
the sim's split decisions quantize at the same wave unit the engine
actually uses, and memoizes by (mode, tokens, budget): a steady decode
loop prices each distinct batch size once.  ``HW``'s other fields are
the sim's defaults, one H100's (``analysis/roofline.py``).

Since DESIGN.md §14 the decision may come from a tuned per-site overlap
plan rather than the global threshold: each record then carries the plan
id + tokens-bucket that keyed the plan entry, the sim pricing follows
the plan's method (``sim_method``) and resource budget, and a tuned
split point is priced explicitly instead of re-derived by the sim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models.transformer import WeaveInfo
from repro_torch.sim.overlap_sim import HW, step_attribution


@dataclasses.dataclass(frozen=True)
class WeaveAttribution:
    """One forward step's weave decision + estimated time breakdown."""
    kind: str            # prefill | decode | verify | packed
    b: int
    s: int
    tokens_real: int     # non-pad tokens committed by this forward
    tokens_static: int   # b * s — what the split decision saw
    weave: bool
    reason: str          # split | below_min_tokens | below_wave_floor |
    #                      weave_disabled | paged_pool_unsplit |
    #                      plan_split | plan_unsplit
    split: Optional[Tuple[int, int]]
    method: str          # tokenweave | ringweave | ring | fuseonly |
    #                      reordered | vanilla
    threshold: int
    unit: int
    est_compute: float
    est_comm: float
    est_overlapped: float
    est_makespan: float
    plan_id: int = 0     # overlap plan that decided (0 = global threshold)
    bucket: str = ""     # tokens-bucket the plan lookup keyed on
    budget: float = 1.0  # comm resource-budget fraction the plan granted

    def args(self) -> dict:
        """JSON-able Chrome-trace ``args`` payload; carries every field
        ``validate_chrome_trace`` requires of a forward span."""
        return {
            "kind": self.kind,
            "weave": self.weave,
            "reason": self.reason,
            "tokens": self.tokens_static,
            "tokens_real": self.tokens_real,
            "threshold": self.threshold,
            "split": list(self.split) if self.split else None,
            "method": self.method,
            "plan_id": self.plan_id,
            "bucket": self.bucket,
            "est_compute": round(self.est_compute, 9),
            "est_comm": round(self.est_comm, 9),
            "est_overlapped": round(self.est_overlapped, 9),
        }


class Attributor:
    """Prices forward steps on the §9 sim roofline for trace spans."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, tp: int):
        self.cfg = cfg
        self.pcfg = pcfg
        self.tp = max(int(tp), 1)
        self.hw = HW(tile=pcfg.split_unit_for(self.tp))
        self._cache: Dict[Tuple, Dict[str, float]] = {}

    def price(self, mode: str, tokens: int,
              split: Optional[Tuple[int, int]] = None,
              budget: float = 1.0) -> Dict[str, float]:
        key = (mode, tokens, split, budget)
        got = self._cache.get(key)
        if got is None:
            got = self._cache[key] = step_attribution(
                self.cfg, mode, max(tokens, 1), tp=self.tp, hw=self.hw,
                split=split,
                comm_budget=None if budget == 1.0 else budget)
        return got

    def attribute(self, info: WeaveInfo, *, b: int, s: int, n_real: int,
                  kind: str) -> WeaveAttribution:
        if info.sim_method:
            # a tuned plan entry forced this pricing mode (DESIGN.md §14);
            # checked BEFORE info.weave so a fused plan split prices as
            # ringweave, not as the composed tokenweave
            method = info.sim_method
        elif info.weave:
            method = "tokenweave"
        else:
            method = {"fused": "fuseonly",
                      "reordered": "reordered"}.get(self.pcfg.comm_mode,
                                                    "vanilla")
        # a tuned (plan_split) weave carries an explicit split point the
        # sim must price verbatim; legacy splits re-derive inside the sim
        # (identical by construction, and token counts may be row counts)
        split = (info.split if info.weave and info.reason == "plan_split"
                 and info.axis == "packed" else None)
        est = self.price(method, b * s, split=split, budget=info.budget)
        return WeaveAttribution(
            kind=kind, b=b, s=s, tokens_real=n_real, tokens_static=b * s,
            weave=info.weave, reason=info.reason, split=info.split,
            method=method, threshold=info.threshold, unit=info.unit,
            est_compute=est["compute"], est_comm=est["comm"],
            est_overlapped=est["overlapped"], est_makespan=est["makespan"],
            plan_id=info.plan_id, bucket=info.bucket, budget=info.budget)
