"""Per-site overlap policy and the tuned plan cache, as
``repro.core.policy``.

* ``OverlapPlan`` — what to do at one (site, tokens-bucket, tp, family)
  key: method ∈ {``none``, ``weave``, ``fused-unsplit``, ``fused``}, the
  prefix-wave split fraction, and the comm budget fraction (K1's CTAs,
  ``core.splitting.ring_ctas``).
* ``ThresholdPolicy`` — the degenerate policy: the global token threshold,
  ``split_decision`` verbatim.  The default everywhere.
* ``TunedPolicy`` — a plan cache read from the reference's versioned JSON
  format (``benchmarks/plans/*.json``).  Lookups that miss fall back to
  the threshold decision, so a partial plan is always safe.

Decision sites mirror the engine's dispatch kinds: ``prefill`` (sequence
split), ``decode`` (batch), ``verify`` (γ+1 windows, batch) and
``packed`` (the flat token axis).  Policies are frozen and hashable so
they ride inside the frozen ``ParallelConfig``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.splitting import (DEFAULT_BUCKET_EDGES, SplitDecision,
                                        plan_split, split_decision,
                                        token_bucket)

SITES = ("prefill", "decode", "verify", "packed")
# none          — never split, generic comm path
# weave         — wave-aware token split, composed-collective comm
# fused-unsplit — the fused AllReduce-RMSNorm kernel (K1), no split; its
#                 budget sizes K1's grid
# fused         — K1 + wave-aware split: the full TokenWeave configuration
METHODS = ("none", "weave", "fused-unsplit", "fused")
PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """One resolved per-site overlap scheme."""
    site: str
    bucket: str
    method: str          # none | weave | fused-unsplit | fused
    split_frac: float    # prefix-wave fraction (weave/fused; 0.5 = balanced)
    budget: float        # comm budget fraction in (0, 1]
    plan_id: int


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One row of the tuned plan cache, keyed (site, bucket, tp, family)."""
    site: str
    bucket: str
    tp: int
    family: str
    method: str
    split_frac: float = 0.5
    budget: float = 1.0

    def validate(self) -> Optional[str]:
        """Schema check; returns a failure string or None (valid)."""
        if self.site not in SITES:
            return f"unknown site {self.site!r} (want one of {SITES})"
        if self.method not in METHODS:
            return f"unknown method {self.method!r} (want one of {METHODS})"
        if not (0.0 < self.split_frac < 1.0):
            return f"split_frac {self.split_frac} outside (0, 1)"
        if not (0.0 < self.budget <= 1.0):
            return f"budget {self.budget} outside (0, 1]"
        if self.tp < 1:
            return f"tp {self.tp} < 1"
        return None


class OverlapPolicy:
    """Interface: a per-site ``SplitDecision`` / ``OverlapPlan``.

    ``decide`` receives the arguments of the threshold decision (units
    along the split axis, wave unit, threshold, rectangularity) plus the
    plan key (site, tp, family) and ``bucket_tokens``, the true token
    count where the split axis is rows (decode/verify)."""
    plan_id: int = 0

    def decide(self, site: str, n_tokens: int, *, unit: int,
               min_tokens: int, row_multiple: int = 1, tp: int = 1,
               family: str = "dense",
               bucket_tokens: Optional[int] = None) -> SplitDecision:
        raise NotImplementedError

    def plan_for(self, site: str, tokens: int, *, tp: int = 1,
                 family: str = "dense") -> Optional[OverlapPlan]:
        """The tuned plan covering (site, bucket(tokens), tp, family), or
        None when the threshold fallback applies."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ThresholdPolicy(OverlapPolicy):
    """``split_decision`` verbatim, plan_id pinned 0."""
    plan_id: int = 0

    def decide(self, site: str, n_tokens: int, *, unit: int,
               min_tokens: int, row_multiple: int = 1, tp: int = 1,
               family: str = "dense",
               bucket_tokens: Optional[int] = None) -> SplitDecision:
        d = split_decision(n_tokens, unit=unit, min_tokens=min_tokens,
                           row_multiple=row_multiple)
        if bucket_tokens is not None and bucket_tokens != n_tokens:
            d = dataclasses.replace(d, bucket=token_bucket(bucket_tokens))
        return d

    def plan_for(self, site: str, tokens: int, *, tp: int = 1,
                 family: str = "dense") -> Optional[OverlapPlan]:
        return None


DEFAULT_POLICY = ThresholdPolicy()


@dataclasses.dataclass(frozen=True)
class TunedPolicy(OverlapPolicy):
    """Plan-cache-backed policy: per-(site, bucket, tp, family) entries.
    Keys with no entry fall back to the threshold decision."""
    plan_id: int = 1
    version: int = PLAN_VERSION
    bucket_edges: Tuple[int, ...] = DEFAULT_BUCKET_EDGES
    entries: Tuple[PlanEntry, ...] = ()
    _index: Dict = dataclasses.field(init=False, repr=False, compare=False,
                                     default_factory=dict)

    def __post_init__(self):
        idx = {(e.site, e.bucket, e.tp, e.family): e for e in self.entries}
        object.__setattr__(self, "_index", idx)

    def lookup(self, site: str, tokens: int, *, tp: int,
               family: str) -> Optional[PlanEntry]:
        bucket = token_bucket(tokens, self.bucket_edges)
        return self._index.get((site, bucket, int(tp), family))

    def plan_for(self, site: str, tokens: int, *, tp: int = 1,
                 family: str = "dense") -> Optional[OverlapPlan]:
        e = self.lookup(site, tokens, tp=tp, family=family)
        if e is None:
            return None
        return OverlapPlan(site=e.site, bucket=e.bucket, method=e.method,
                           split_frac=e.split_frac, budget=e.budget,
                           plan_id=self.plan_id)

    def decide(self, site: str, n_tokens: int, *, unit: int,
               min_tokens: int, row_multiple: int = 1, tp: int = 1,
               family: str = "dense",
               bucket_tokens: Optional[int] = None) -> SplitDecision:
        bt = bucket_tokens if bucket_tokens is not None else n_tokens
        e = self.lookup(site, bt, tp=tp, family=family)
        if e is None:
            # no tuned coverage: the threshold decision, stamped with this
            # plan's id (the bucket label shows the fallback key)
            d = split_decision(n_tokens, unit=unit, min_tokens=min_tokens,
                               row_multiple=row_multiple)
            return dataclasses.replace(d, plan_id=self.plan_id,
                                       bucket=token_bucket(
                                           bt, self.bucket_edges))
        eff_unit = math.lcm(unit, max(row_multiple, 1))
        if e.method in ("weave", "fused"):
            split = plan_split(n_tokens, eff_unit, e.split_frac)
            if split is not None:
                return SplitDecision(split, "plan_split", n_tokens,
                                     eff_unit, min_tokens, self.plan_id,
                                     e.bucket, e.budget)
            # fewer than two full waves at the effective quantum
            return SplitDecision(None, "below_wave_floor", n_tokens,
                                 eff_unit, min_tokens, self.plan_id,
                                 e.bucket, e.budget)
        return SplitDecision(None, "plan_unsplit", n_tokens, eff_unit,
                             min_tokens, self.plan_id, e.bucket, e.budget)

    # ---- versioned JSON plan cache --------------------------------------
    def to_doc(self, **meta) -> dict:
        doc = {
            "version": self.version,
            "plan_id": self.plan_id,
            "bucket_edges": list(self.bucket_edges),
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }
        doc.update(meta)
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "TunedPolicy":
        version = int(doc.get("version", -1))
        if version != PLAN_VERSION:
            raise ValueError(
                f"plan cache version {version} unsupported (this build "
                f"reads version {PLAN_VERSION})")
        names = {f.name for f in dataclasses.fields(PlanEntry)}
        entries = tuple(
            PlanEntry(**{k: v for k, v in e.items() if k in names})
            for e in doc.get("entries", ()))
        for e in entries:
            err = e.validate()
            if err:
                raise ValueError(f"invalid plan entry {e}: {err}")
        return cls(plan_id=int(doc.get("plan_id", 1)), version=version,
                   bucket_edges=tuple(int(x)
                                      for x in doc.get("bucket_edges",
                                                       DEFAULT_BUCKET_EDGES)),
                   entries=entries)

    def save(self, path: str, **meta) -> None:
        with open(path, "w") as f:
            json.dump(self.to_doc(**meta), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TunedPolicy":
        with open(path) as f:
            return cls.from_doc(json.load(f))


def load_policy(path: Optional[str]) -> OverlapPolicy:
    """A plan-cache path loads the tuned policy; None keeps the threshold
    default."""
    if not path:
        return DEFAULT_POLICY
    return TunedPolicy.load(path)
