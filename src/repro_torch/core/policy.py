"""Overlap policy: the degenerate global-threshold policy of
``repro.core.policy``.

``ThresholdPolicy`` is the default everywhere in the reference and the
only policy this port has so far; tuned plan caches (``TunedPolicy``,
``load_policy``) are queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.splitting import (SplitDecision, split_decision,
                                        token_bucket)


@dataclasses.dataclass(frozen=True)
class ThresholdPolicy:
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


DEFAULT_POLICY = ThresholdPolicy()
