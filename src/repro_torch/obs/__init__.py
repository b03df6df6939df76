"""Weave-aware observability layer (DESIGN.md §12, §13), as
``repro.obs``.

* ``metrics``      — typed registry (counters / gauges / histograms with
                     labels) that ``Engine`` and ``OnlineServer`` publish
                     through.
* ``trace``        — ``TraceRecorder`` structured events + nested spans on
                     the deterministic virtual clock, exported as
                     Chrome-trace / Perfetto JSON.
* ``attribution``  — the per-forward weave-decision record priced on the
                     §9 sim roofline.
* ``profiler``     — ``WallClockProfiler``: fenced per-dispatch wall time
                     on the card, joined to the attribution record, for
                     the ``analysis.calibration`` fit and the
                     ``[measured]`` trace track.
"""
from repro_torch.obs.attribution import Attributor, WeaveAttribution
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentile)
from repro_torch.obs.profiler import (MEASURED_CAT, MeasuredForward,
                                      WallClockProfiler)
from repro_torch.obs.trace import (TERMINAL_PHASES, TraceRecorder,
                                   export_chrome_trace,
                                   validate_chrome_trace,
                                   weave_counts_from_trace)

__all__ = [
    "Attributor", "WeaveAttribution",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile",
    "MEASURED_CAT", "MeasuredForward", "WallClockProfiler",
    "TERMINAL_PHASES", "TraceRecorder", "export_chrome_trace",
    "validate_chrome_trace", "weave_counts_from_trace",
]
