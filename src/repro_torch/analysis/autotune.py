"""Offline overlap-plan autotuner (DESIGN.md §14), as
``repro.analysis.autotune``.

Searches, per (site, tokens-bucket, tp, model family), over the overlap
scheme the engine should run at that key — method ∈ {none, weave,
fused-unsplit, fused}, the weave's prefix-wave split fraction, and the
comm resource-budget fraction — by pricing every candidate with the §9
two-stream sim (``sim.overlap_sim.step_attribution``) under a calibrated
``HW`` (``HW.from_calibration``, DESIGN.md §13) or the roofline
defaults, which in the port are one H100's (``analysis/roofline.py``).
The fused methods dispatch the AllReduce-RMSNorm kernel K1 and are
priced from their resource grant (``ring_channels(budget)``, the
paper's 2-8 SM knob: K1's CTAs, ``core.splitting.ring_ctas``) via the
sim's ``ring``/``ringweave`` modes — not the generic contention model.  The
winner per bucket minimizes the simulated makespan, ties broken toward
more overlapped virtual time and then toward the earlier candidate in
the deterministic preference order (fused@0.5/full-budget first — the
one-kernel ring path strictly dominates the composed path in the model,
so ties collapse to the canonical fused weave).

The result is a versioned JSON plan cache (``core/policy.TunedPolicy``,
the reference's format) loaded by ``Engine`` / ``OnlineServer`` /
``ClusterServer`` at startup (``SchedulerConfig.plan_path``).  The
search is pure deterministic float math — same plan on every machine —
which is what lets a check regenerate and diff it
(``analysis/check_plan.py``).  Given the reference's ``HW`` fields it
writes the reference's plan entry for entry; the port's committed plan,
``analysis/plans/h100_default.json``, is a defaults run on one H100's
constants.

CLI (from ``src/``)::

    python -m repro_torch.analysis.autotune \
        --out repro_torch/analysis/plans/h100_default.json
    python -m repro_torch.analysis.autotune --calibration cal.json \
        --out tuned.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.policy import (PLAN_VERSION, PlanEntry, SITES,
                                     TunedPolicy)
from repro_torch.core.splitting import DEFAULT_BUCKET_EDGES, plan_split
from repro_torch.sim.overlap_sim import HW, step_attribution

PLAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plans")
H100_PLAN = os.path.join(PLAN_DIR, "h100_default.json")

# candidate grid: preference order matters — the FIRST candidate at the
# minimal (makespan, -overlapped) key wins, so ties collapse to the
# canonical balanced full-budget fused (ring-kernel) weave, then
# alternative fracs/budgets, then the composed weave, then the unsplit
# ring kernel, then no fused collective at all.
SPLIT_FRACS = (0.5, 0.25, 0.75)
BUDGETS = (1.0, 0.75, 0.5)
_SIM_MODE = {"fused": "ringweave", "weave": "tokenweave",
             "fused-unsplit": "ring", "none": "vanilla"}


@dataclasses.dataclass(frozen=True)
class TuneTarget:
    """One deployment the plan is tuned for: a model/parallelism pair and
    the wave quantum its engine splits at (``ParallelConfig.
    split_unit_for(tp)`` of the deployment's actual config — the sim must
    quantize at the same tile the engine's split decision uses)."""
    name: str
    cfg: ModelConfig
    tp: int
    family: str
    unit: int


def _bucket_rep(lo: int, hi: Optional[int]) -> int:
    """Representative token count priced for a bucket (mid-point;
    2*lo for the open last bucket)."""
    return 2 * lo if hi is None else (lo + hi + 1) // 2


def _buckets(edges: Tuple[int, ...]) -> List[Tuple[str, int]]:
    out = [(f"{lo}-{hi - 1}", _bucket_rep(lo, hi - 1))
           for lo, hi in zip(edges, edges[1:])]
    out.append((f"{edges[-1]}+", _bucket_rep(edges[-1], None)))
    return out


def _candidates(rep: int, unit: int) -> List[Tuple[str, float, float]]:
    """(method, split_frac, budget) grid, preference-ordered; split
    candidates (fused/weave) structurally infeasible at the
    representative size are dropped.  The fused methods search the
    budget axis as their ring-lane grant (``ring_channels``); the
    composed weave keeps the generic contention budget."""
    cands: List[Tuple[str, float, float]] = []
    for b in BUDGETS:
        for f in SPLIT_FRACS:
            if plan_split(rep, unit, f) is not None:
                cands.append(("fused", f, b))
    for b in BUDGETS:
        for f in SPLIT_FRACS:
            if plan_split(rep, unit, f) is not None:
                cands.append(("weave", f, b))
    for b in BUDGETS:
        cands.append(("fused-unsplit", 0.5, b))
    cands.append(("none", 0.5, 1.0))
    return cands


def tune_entries(target: TuneTarget, *, hw: Optional[HW] = None,
                 edges: Tuple[int, ...] = DEFAULT_BUCKET_EDGES
                 ) -> List[PlanEntry]:
    """Search every (site, bucket) of one target; returns plan entries.

    All four sites price identically in the token-level sim (the site
    distinction exists because the ENGINE's axes and floors differ), so
    one bucket search serves all sites — but entries are emitted per
    site, because that is the lookup key the runtime uses and a future
    site-aware cost model refines them independently."""
    hw = hw or HW(tile=target.unit)
    entries: List[PlanEntry] = []
    for bucket, rep in _buckets(edges):
        best_key = None
        best: Optional[Tuple[str, float, float]] = None
        for method, frac, budget in _candidates(rep, hw.tile):
            est = step_attribution(
                target.cfg, _SIM_MODE[method], rep, tp=target.tp, hw=hw,
                split=(plan_split(rep, hw.tile, frac)
                       if method in ("weave", "fused") else None),
                comm_budget=None if budget == 1.0 else budget)
            key = (round(est["makespan"], 15), -round(est["overlapped"], 15))
            if best_key is None or key < best_key:
                best_key, best = key, (method, frac, budget)
        method, frac, budget = best
        for site in SITES:
            entries.append(PlanEntry(site=site, bucket=bucket, tp=target.tp,
                                     family=target.family, method=method,
                                     split_frac=frac, budget=budget))
    return entries


def _plan_id(entries: List[PlanEntry]) -> int:
    """Deterministic nonzero id derived from the plan content, so any
    entry change is visible as a plan-id change in traces and metrics."""
    blob = json.dumps([dataclasses.asdict(e) for e in entries],
                      sort_keys=True).encode()
    return 1 + (zlib.crc32(blob) % 999_999)


def autotune_plan(targets: List[TuneTarget], *, hw: Optional[HW] = None,
                  edges: Tuple[int, ...] = DEFAULT_BUCKET_EDGES
                  ) -> TunedPolicy:
    """Tune every target and assemble one ``TunedPolicy`` plan cache."""
    entries: List[PlanEntry] = []
    for t in targets:
        entries.extend(tune_entries(
            t, hw=hw if hw is not None else HW(tile=t.unit), edges=edges))
    return TunedPolicy(plan_id=_plan_id(entries), version=PLAN_VERSION,
                       bucket_edges=edges, entries=tuple(entries))


def default_targets() -> List[TuneTarget]:
    """The committed plans cover the paper's serving model at its TP
    degree plus the tiny config every CPU test runs (DESIGN.md §14)."""
    from repro_torch.configs import get_config
    paper = get_config("llama3.3-70b")
    tiny = ModelConfig(name="tiny", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=128, dtype="float32")
    paper_pcfg = ParallelConfig()                       # split_unit 256
    tiny_pcfg = ParallelConfig(split_unit=16)           # conftest tiny_pcfg
    return [TuneTarget("llama3.3-70b/tp8", paper, 8, paper.family,
                       paper_pcfg.split_unit_for(8)),
            TuneTarget("tiny/tp1", tiny, 1, tiny.family,
                       tiny_pcfg.split_unit_for(1))]


def _target_hw(target: TuneTarget, cal: Optional[dict],
               hw: Optional[HW] = None) -> HW:
    """The target's HW: fitted from ``cal``, else ``hw`` (default: one
    H100's constants), at the target's wave quantum."""
    if cal is not None:
        base = HW.from_calibration(cal)
    else:
        base = hw if hw is not None else HW()
    return dataclasses.replace(base, tile=target.unit)


def build_default_plan(calibration: Optional[dict] = None, *,
                       hw: Optional[HW] = None) -> TunedPolicy:
    """The plan a check regenerates and diffs against the committed
    cache.  ``hw`` replaces the default constants (the calibration, where
    given, wins): the reference's ``HW`` fields give the reference's
    plan."""
    targets = default_targets()
    entries: List[PlanEntry] = []
    for t in targets:
        entries.extend(tune_entries(t, hw=_target_hw(t, calibration, hw)))
    return TunedPolicy(plan_id=_plan_id(entries), version=PLAN_VERSION,
                       bucket_edges=DEFAULT_BUCKET_EDGES,
                       entries=tuple(entries))


def _meta(calibration_path: Optional[str]) -> Dict[str, object]:
    return {
        "targets": [t.name for t in default_targets()],
        "search": {"split_fracs": list(SPLIT_FRACS),
                   "budgets": list(BUDGETS),
                   "objective": "lexicographic(makespan, -overlapped)"},
        "calibration": calibration_path or "defaults",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Tune the per-site overlap plan cache on the §9 sim "
                    "(DESIGN.md §14)",
        epilog="The committed analysis/plans/h100_default.json must "
               "equal the output of a defaults run (python -m "
               "repro_torch.analysis.check_plan --expect).")
    ap.add_argument("--out", required=True,
                    help="plan-cache JSON path to write")
    ap.add_argument("--calibration", default=None,
                    help="CalibrationReport JSON (analysis/calibration.py) "
                         "to tune under measured hardware; default: one "
                         "H100's roofline constants")
    args = ap.parse_args(argv)
    cal = None
    if args.calibration:
        with open(args.calibration) as f:
            cal = json.load(f)
    plan = build_default_plan(cal)
    plan.save(args.out, **_meta(args.calibration))
    print(f"wrote plan id {plan.plan_id} ({len(plan.entries)} entries) "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
