"""Measured-time profiler: wall-clock per-forward timings (DESIGN.md §13),
as ``repro.obs.profiler``.

Everything else in obs/ runs on *virtual* time — the §9 sim roofline
prices each forward and the trace/metrics record those estimates.  The
``WallClockProfiler`` adds the missing ground truth: it wraps each of
the engine's dispatches (the model call and the sampling or verification
up to the host copy of the tokens) with a fence on both sides and joins
each measurement to the SAME ``WeaveAttribution`` record the engine
emits for that forward — so every sample carries (tokens, mode, split,
method) next to its wall seconds.

The fence is ``torch.cuda.synchronize(device)``, before the timer starts
(the device queue left by earlier work drains) and before it stops (this
dispatch's own work drains).  It drains every stream of the device: an
event recorded on the current stream covers the weave's comm stream
only where the current stream waits for it, and a K1 launch at tp > 1
that nothing waits for would escape the timer.

The first ``warmup_per_key`` calls of each shape signature
(kind, batch, seq) are flagged ``warmup=True`` and dropped from the
steady-state statistics (they still appear in ``samples`` for
inspection, and a ``profile/warmup_excluded`` counter records how many
were dropped).  On the card the first call of a shape carries cuBLAS's
and the caching allocator's warm-up; the port's kernels are built before
any engine runs (``kernels/build.py``).

Steady samples land in three places:

  * ``MetricsRegistry``: ``profile/forward_us{mode=...,weave=...}``
    histograms (microseconds);
  * the Chrome trace: a parallel ``<track> [measured]`` track with
    ``cat="measured"`` complete spans (1 tick = 1 wall second, matching
    the virtual-time scale) so Perfetto shows measured durations next to
    the virtual spans they ground;
  * ``steady_samples()``: the raw joined records that
    ``analysis.calibration.fit_calibration`` consumes.

The profiler is pull-only: it never changes what the engine computes
(the wrapped function is called with identical arguments and its output
returned untouched), so profiled and unprofiled runs are token- and
step-identical (tests/test_torch_profiler.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.obs.attribution import WeaveAttribution
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder

MEASURED_TRACK_SUFFIX = " [measured]"
MEASURED_CAT = "measured"


@dataclasses.dataclass(frozen=True)
class MeasuredForward:
    """One timed dispatch joined to its weave-attribution record."""
    key: Tuple           # (kind, b, s) — the dispatch's shape signature
    kind: str            # prefill | decode | verify | packed
    method: str          # tokenweave | fuseonly | reordered | vanilla | ...
    weave: bool
    tokens_static: int   # b * s — what the split decision saw
    tokens_real: int     # non-pad tokens committed by this forward
    split: Optional[Tuple[int, int]]
    wall_s: float        # fenced wall-clock seconds for this dispatch
    est_makespan: float  # §9 roofline prediction under the attributor's HW
    warmup: bool         # first call on this shape: excluded


class WallClockProfiler:
    """Times engine dispatches; join happens at ``commit``.

    Lifecycle (all driven by the engine, see runtime/engine.py):

      1. ``attach(registry, trace=..., track=..., device=...)`` binds the
         sinks and the device whose streams the fence drains;
      2. ``wrap(fn)`` decorates one dispatch — the wrapper fences, times,
         and stashes the elapsed seconds as *pending*;
      3. ``commit(att)`` — called from the engine's single per-dispatch
         accounting site (``_note_forward``) — pops the pending timing
         and records the joined ``MeasuredForward``.

    Exactly one wrapped call happens between consecutive commits (the
    engine runs one model dispatch per ``_note_forward``), so the join
    needs no correlation ids.
    """

    def __init__(self, warmup_per_key: int = 1):
        self.warmup_per_key = max(int(warmup_per_key), 0)
        self.samples: List[MeasuredForward] = []
        self._seen: Dict[Tuple, int] = {}
        self._pending: Optional[float] = None
        self._registry: Optional[MetricsRegistry] = None
        self._trace: Optional[TraceRecorder] = None
        self._track = "engine"
        self._device: Optional[torch.device] = None

    # -- wiring ----------------------------------------------------------
    def attach(self, registry: Optional[MetricsRegistry] = None, *,
               trace: Optional[TraceRecorder] = None,
               track: str = "engine",
               device=None) -> "WallClockProfiler":
        self._registry = registry
        self._trace = trace
        self._track = track
        self._device = None if device is None else torch.device(device)
        return self

    def _fence(self) -> None:
        if self._device is None:
            raise RuntimeError("attach the profiler to a device before "
                               "timing: the fence drains that device")
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        # CPU tensors: PyTorch's CPU ops have finished when they return,
        # so there is nothing to drain

    def wrap(self, fn: Callable) -> Callable:
        """Fenced-timing decorator for one dispatch.

        The device is drained before the timer starts, so the timer
        measures only this call, and again before it stops, so all of
        this call's device work (every stream) is inside it; the output
        is returned unmodified: wrapping never changes what the engine
        computes.
        """
        def timed(*args, **kwargs):
            self._fence()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._fence()
            self._pending = time.perf_counter() - t0
            return out
        return timed

    # -- join ------------------------------------------------------------
    def commit(self, att: Optional[WeaveAttribution]) -> None:
        """Join the pending timing to this dispatch's attribution."""
        wall_s, self._pending = self._pending, None
        if wall_s is None or att is None:
            return
        skey = (att.kind, att.b, att.s)
        seen = self._seen.get(skey, 0)
        self._seen[skey] = seen + 1
        warmup = seen < self.warmup_per_key
        self.samples.append(MeasuredForward(
            key=skey, kind=att.kind, method=att.method, weave=att.weave,
            tokens_static=att.tokens_static, tokens_real=att.tokens_real,
            split=att.split, wall_s=wall_s,
            est_makespan=att.est_makespan, warmup=warmup))
        if warmup:
            if self._registry is not None:
                self._registry.counter("profile/warmup_excluded").inc()
            return
        if self._registry is not None:
            self._registry.histogram(
                "profile/forward_us", mode=att.kind,
                weave="on" if att.weave else "off").observe(wall_s * 1e6)
        if self._trace is not None:
            args = att.args()
            args["measured_us"] = round(wall_s * 1e6, 3)
            args["est_makespan"] = att.est_makespan
            self._trace.complete(
                self._track + MEASURED_TRACK_SUFFIX,
                f"measured/{att.kind}", self._trace.now, wall_s,
                cat=MEASURED_CAT, args=args)

    # -- readout ---------------------------------------------------------
    def steady_samples(self) -> List[MeasuredForward]:
        """Samples past the per-shape warmup window (calibration input)."""
        return [s for s in self.samples if not s.warmup]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-kind steady-state totals: count / total / mean wall sec."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self.steady_samples():
            row = out.setdefault(s.kind, {"n": 0, "total_s": 0.0})
            row["n"] += 1
            row["total_s"] += s.wall_s
        for row in out.values():
            row["mean_s"] = row["total_s"] / row["n"]
        return out
