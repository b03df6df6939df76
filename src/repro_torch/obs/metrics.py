"""Typed metrics registry (DESIGN.md §12).

Counters, gauges and histograms with optional labels.  The runtime's
public ``stats`` objects (``EngineStats``, ``LatencyStats``,
``ClusterStats``) are thin read views over one of these registries —
every mutation goes through an instrument, so a registry ``snapshot()``
is the single source of truth the benchmark harness emits gated metrics
from (scripts/check_bench.py enforces that provenance).

Everything here is deterministic host-side bookkeeping: values come from
request/token counters and the virtual clock, never from wall time.
Instruments are cheap plain-attribute objects; the hot engine counters
are fetched once at construction and mutated via ``inc`` — no dict
lookup per step.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy default) over a copy —
    deterministic, no numpy dtype surprises in JSON metrics."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


class Counter:
    """Monotonically increasing integer-ish counter."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """Last-value (or running-max) instrument for derived/level metrics."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Exact-sample histogram: virtual-time latency distributions are
    small (one sample per request), so we keep the samples and compute
    percentiles exactly — the same math `LatencyStats` always used."""
    __slots__ = ("name", "labels", "values")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """One namespace of typed instruments.

    ``counter/gauge/histogram(name, **labels)`` get-or-create; asking for
    an existing name with a different kind is a type error (that is what
    makes the registry *typed*).  ``snapshot()`` flattens everything to a
    ``{key: float}`` dict — ``name`` or ``name{k=v,...}``, histograms as
    ``<name>/count`` and ``<name>/p50|p90|p99`` — which is exactly the
    shape ``benchmarks/run.py --json`` and the CI gate consume.
    """

    def __init__(self):
        self._instruments: Dict[Tuple[str, Tuple], object] = {}
        self._kind_of: Dict[Tuple[str, Tuple], str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str]):
        lk = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lk)
        inst = self._instruments.get(key)
        if inst is None:
            self._instruments[key] = inst = _KINDS[kind](name, lk)
            self._kind_of[key] = kind
            return inst
        if self._kind_of[key] != kind:
            raise TypeError(
                f"metric {name!r}{dict(lk) or ''} is a "
                f"{self._kind_of[key]}, not a {kind}")
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get("histogram", name, labels)

    def get(self, name: str, **labels: str) -> Optional[object]:
        """Peek an instrument without creating it (None when absent)."""
        lk = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        return self._instruments.get((name, lk))

    @staticmethod
    def _render(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in labels)
        return f"{name}{{{inner}}}"

    def snapshot(self, quantiles: Tuple[float, ...] = (0.5, 0.9, 0.99)
                 ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (name, lk), inst in sorted(self._instruments.items()):
            base = self._render(name, lk)
            if isinstance(inst, Histogram):
                out[f"{base}/count"] = float(inst.count)
                for q in quantiles:
                    out[f"{base}/p{int(q * 100)}"] = inst.percentile(q)
            else:
                out[base] = float(inst.value)
        return out
