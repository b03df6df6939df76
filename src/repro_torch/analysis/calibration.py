"""Cost-model calibration: fit sim ``HW`` params to measured time
(DESIGN.md §13), as ``repro.analysis.calibration``.

The §9 roofline and everything priced on it (weave attribution, the
virtual clock's crossover numbers) run on hardcoded ``HW`` constants.
This module closes the loop against the wall clock:
``fit_calibration`` takes the steady-state per-forward samples a
``WallClockProfiler`` collected (each carrying method + token count +
fenced wall seconds), buckets them by (method, tokens), and fits the
three free parameters of the dispatch-time model

    measured(method, tokens) ~= step_attribution(..., hw)["makespan"]
                              = roofline(mfu_cap, ici) + overhead

by least squares on RELATIVE error (absolute error would let the
largest-token buckets drown out the small ones where ``overhead``
lives): ``overhead`` (fixed per-dispatch seconds) is linear in the
residual so it has a closed-form optimum for fixed (mfu_cap, ici)
(clamped at zero only after the search), and the search over
(mfu_cap, ici) runs in log space — a coarse grid seeding a 2-D
Nelder-Mead simplex — dependency-free and deterministic.

The result is a ``CalibrationReport``: fitted params, per-bucket
predicted-vs-measured relative error, worst-case divergence, and a
dispatch-granularity linear fit (``step_base`` + ``step_per_token`` ×
real tokens) for the OnlineServer virtual clock.  It round-trips
through JSON, loads back via ``HW.from_calibration`` /
``StepCost.from_calibration``, and — because report predictions are
computed with ``step_attribution`` under the fitted ``HW`` — reloading
and re-predicting reproduces the report's numbers exactly.
``export_to`` publishes the per-mode ``profile/predicted_vs_measured``
divergence gauges that scripts/check_calibration.py gates in CI; the
JSON is plain, so that script reads this package's reports too.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.sim.overlap_sim import (HBM_BW, HW, PEAK_FLOPS,
                                        step_attribution)

MFU_BOUNDS = (1e-4, 1.0)        # wide: CPU runs sit far below any peak
ICI_BOUNDS = (1e6, 1e13)        # bytes/s


@dataclasses.dataclass(frozen=True)
class TimingSample:
    """Minimal duck-type of ``obs.profiler.MeasuredForward`` — what the
    fit actually reads.  Synthetic tests construct these directly."""
    method: str
    tokens: int
    wall_s: float
    tokens_real: int = 0


def _tokens(s) -> int:
    t = getattr(s, "tokens", None)
    return int(t if t is not None else s.tokens_static)


@dataclasses.dataclass
class CalibrationReport:
    """Fitted cost-model params + divergence accounting (DESIGN.md §13)."""
    model: str
    tp: int
    tile: int
    n_layers: int
    peak: float
    hbm: float
    mfu_cap: float
    ici: float
    overhead: float            # fixed per-dispatch seconds
    step_base: float           # virtual-clock linear fit: wall seconds
    step_per_token: float      # ... per real token
    n_samples: int
    buckets: List[dict]        # {method, tokens, n, measured_s,
    #                             predicted_s, rel_err}
    per_mode_rel_err: Dict[str, float]
    worst_rel_err: float
    worst_bucket: str

    def hw(self) -> HW:
        return HW.from_calibration(self)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationReport":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationReport":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def export_to(self, registry) -> None:
        """Publish divergence + fitted params as gauges (CI-gated)."""
        for mode in sorted(self.per_mode_rel_err):
            registry.gauge("profile/predicted_vs_measured",
                           mode=mode).set(self.per_mode_rel_err[mode])
        registry.gauge("profile/calibration/mfu_cap").set(self.mfu_cap)
        registry.gauge("profile/calibration/ici_gbps").set(self.ici / 1e9)
        registry.gauge("profile/calibration/overhead_us").set(
            self.overhead * 1e6)
        registry.gauge("profile/calibration/worst_rel_err").set(
            self.worst_rel_err)
        registry.gauge("profile/calibration/n_samples").set(self.n_samples)


def _geomspace(lo: float, hi: float, n: int) -> List[float]:
    if n == 1:
        return [math.sqrt(lo * hi)]
    r = (hi / lo) ** (1.0 / (n - 1))
    return [lo * r ** i for i in range(n)]


def _nelder_mead2(f, x0: Tuple[float, float], *, step: float = 0.3,
                  iters: int = 200, tol: float = 1e-9
                  ) -> Tuple[float, float]:
    """Derivative-free 2-D minimizer (deterministic, no scipy).  The
    (mfu_cap, ici) objective is a narrow curved valley — coordinate
    descent zigzags and stalls there, a simplex tracks it."""
    pts = [x0, (x0[0] + step, x0[1]), (x0[0], x0[1] + step)]
    vals = [f(p) for p in pts]
    for _ in range(iters):
        order = sorted(range(3), key=vals.__getitem__)
        pts = [pts[i] for i in order]
        vals = [vals[i] for i in order]
        if max(abs(pts[2][0] - pts[0][0]),
               abs(pts[2][1] - pts[0][1])) < tol:
            break
        cx = (pts[0][0] + pts[1][0]) / 2
        cy = (pts[0][1] + pts[1][1]) / 2
        rx, ry = 2 * cx - pts[2][0], 2 * cy - pts[2][1]   # reflect
        fr = f((rx, ry))
        if fr < vals[0]:
            ex, ey = 3 * cx - 2 * pts[2][0], 3 * cy - 2 * pts[2][1]
            fe = f((ex, ey))                               # expand
            pts[2], vals[2] = ((ex, ey), fe) if fe < fr else ((rx, ry), fr)
        elif fr < vals[1]:
            pts[2], vals[2] = (rx, ry), fr
        else:
            kx = (cx + pts[2][0]) / 2                      # contract
            ky = (cy + pts[2][1]) / 2
            fk = f((kx, ky))
            if fk < vals[2]:
                pts[2], vals[2] = (kx, ky), fk
            else:                                          # shrink
                for i in (1, 2):
                    pts[i] = ((pts[0][0] + pts[i][0]) / 2,
                              (pts[0][1] + pts[i][1]) / 2)
                    vals[i] = f(pts[i])
    i = min(range(3), key=vals.__getitem__)
    return pts[i]


def fit_calibration(cfg: ModelConfig, samples: Iterable, *, tp: int,
                    tile: int, model: Optional[str] = None,
                    peak: float = PEAK_FLOPS, hbm: float = HBM_BW,
                    n_layers: int = 4) -> CalibrationReport:
    """Least-squares fit of (mfu_cap, ici, overhead) to steady samples.

    ``samples`` need ``method`` / ``wall_s`` / token-count attributes
    (``MeasuredForward`` or ``TimingSample``).  ``tile`` must be the wave
    unit the engine's ``Attributor`` priced with
    (``pcfg.split_unit_for(tp)``) so predictions quantize identically.
    """
    samples = [s for s in samples if not getattr(s, "warmup", False)]
    if not samples:
        raise ValueError("fit_calibration needs at least one steady sample")

    # -- bucket: (method, static tokens) -> mean measured seconds --------
    acc: Dict[Tuple[str, int], List[float]] = {}
    for s in samples:
        acc.setdefault((s.method, _tokens(s)), []).append(float(s.wall_s))
    keys = sorted(acc)
    meas = [sum(acc[k]) / len(acc[k]) for k in keys]
    wts = [float(len(acc[k])) for k in keys]
    # relative-error weights: w_i / y_i^2 turns (pred - y) into
    # (pred - y)/y inside the quadratic
    rws = [w / max(y, 1e-12) ** 2 for w, y in zip(wts, meas)]

    def roofline(mfu: float, ici: float) -> List[float]:
        hw = HW(peak=peak, hbm=hbm, ici=ici, tile=tile, mfu_cap=mfu)
        return [step_attribution(cfg, m, max(t, 1), tp=tp, hw=hw,
                                 n_layers=n_layers)["makespan"]
                for m, t in keys]

    def best_overhead(base: List[float]) -> float:
        # unclamped during the search: clamping mid-descent kinks the
        # objective and strands the coordinate descent in a local valley
        return (sum(rw * (y - b) for rw, y, b in zip(rws, meas, base))
                / sum(rws))

    def sse(mfu: float, ici: float) -> float:
        base = roofline(mfu, ici)
        ovh = best_overhead(base)
        return sum(rw * (y - b - ovh) ** 2
                   for rw, y, b in zip(rws, meas, base))

    # -- search in (log mfu, log ici): coarse grid seeds Nelder-Mead -----
    def clamp(v, lo, hi):
        return min(max(v, lo), hi)

    def obj(p):
        return sse(clamp(math.exp(p[0]), *MFU_BOUNDS),
                   clamp(math.exp(p[1]), *ICI_BOUNDS))

    grid = [(math.log(m), math.log(i))
            for m in _geomspace(*MFU_BOUNDS, 7)
            for i in _geomspace(*ICI_BOUNDS, 7)]
    x0 = min(grid, key=obj)
    xm, xi = _nelder_mead2(obj, x0)
    mfu = clamp(math.exp(xm), *MFU_BOUNDS)
    ici = clamp(math.exp(xi), *ICI_BOUNDS)
    overhead = max(best_overhead(roofline(mfu, ici)), 0.0)

    # -- final predictions under the FITTED HW (exact round-trip) --------
    fitted = HW(peak=peak, hbm=hbm, ici=ici, tile=tile, mfu_cap=mfu,
                overhead=overhead)
    buckets, per_mode_num, per_mode_den = [], {}, {}
    worst, worst_key = 0.0, ""
    for (m, t), y, w in zip(keys, meas, wts):
        pred = step_attribution(cfg, m, max(t, 1), tp=tp, hw=fitted,
                                n_layers=n_layers)["makespan"]
        rel = abs(pred - y) / max(y, 1e-12)
        buckets.append({"method": m, "tokens": t, "n": int(w),
                        "measured_s": y, "predicted_s": pred,
                        "rel_err": rel})
        per_mode_num[m] = per_mode_num.get(m, 0.0) + w * rel
        per_mode_den[m] = per_mode_den.get(m, 0.0) + w
        if rel > worst:
            worst, worst_key = rel, f"{m}/{t}"

    # -- dispatch-granularity linear fit for the virtual clock -----------
    xs = [float(getattr(s, "tokens_real", 0) or _tokens(s))
          for s in samples]
    ys = [float(s.wall_s) for s in samples]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    var = sum((x - mx) ** 2 for x in xs)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
             if var > 0 else 0.0)
    slope = max(slope, 0.0)
    intercept = max(my - slope * mx, 0.0)

    return CalibrationReport(
        model=model or cfg.name, tp=int(tp), tile=int(tile),
        n_layers=int(n_layers), peak=float(peak), hbm=float(hbm),
        mfu_cap=float(mfu), ici=float(ici), overhead=float(overhead),
        step_base=float(intercept), step_per_token=float(slope),
        n_samples=n, buckets=buckets,
        per_mode_rel_err={m: per_mode_num[m] / per_mode_den[m]
                          for m in sorted(per_mode_num)},
        worst_rel_err=float(worst), worst_bucket=worst_key)
