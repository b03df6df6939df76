"""Wave-aware token splitting (paper §3.1), the packed-axis split and the
tuned plans' split (``plan_split``), and the comm budget's channel count,
as ``repro.core.splitting``.

The decisions are pure integer math and must equal the reference's
exactly: the split point decides which keys the suffix split's attention
sees through ``kv_prefix``.  The wave unit stays the reference's
(``ParallelConfig.split_unit_for``: lcm(256, tp)); retargeting it to CTAs
over the H100's 132 SMs is a separate change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def smart_split(n_tokens: int, unit: int) -> Optional[Tuple[int, int]]:
    """Split ``n_tokens`` into (L1, L2) wave-aware halves; None if
    unsplittable.  L1 holds full waves only; L2 carries the partial one."""
    if unit <= 0:
        raise ValueError(f"unit must be positive, got {unit}")
    if n_tokens < 2 * unit:
        return None
    total_waves = math.ceil(n_tokens / unit)
    l1 = (total_waves // 2) * unit
    return l1, n_tokens - l1


def naive_split(n_tokens: int) -> Tuple[int, int]:
    """Equal halves, ignoring wave quantization (paper's strawman)."""
    l1 = n_tokens // 2
    return l1, n_tokens - l1


def wave_count(n_tokens: int, unit: int) -> int:
    return math.ceil(n_tokens / unit)


DEFAULT_BUCKET_EDGES: Tuple[int, ...] = (
    0, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def token_bucket(n_tokens: int,
                 edges: Tuple[int, ...] = DEFAULT_BUCKET_EDGES) -> str:
    """Bucket label for a token count: ``"lo-hi"`` (inclusive) for bounded
    buckets, ``"lo+"`` for the open last bucket."""
    n = max(int(n_tokens), 0)
    for lo, hi in zip(edges, edges[1:]):
        if lo <= n < hi:
            return f"{lo}-{hi - 1}"
    return f"{edges[-1]}+"


@dataclasses.dataclass(frozen=True)
class SplitDecision:
    """The split chosen, or None plus why not (``below_min_tokens``,
    ``below_wave_floor``), with the parameters the decision saw."""
    split: Optional[Tuple[int, int]]
    reason: str
    n_tokens: int
    unit: int                 # effective wave quantum (lcm w/ row_multiple)
    min_tokens: int
    plan_id: int = 0
    bucket: str = ""
    budget: float = 1.0       # comm budget -> ring_channels()


def split_decision(n_tokens: int, *, unit: int, min_tokens: int,
                   row_multiple: int = 1) -> SplitDecision:
    """The global-threshold weave decision.  ``row_multiple`` keeps the
    split point a multiple of the batch size when (B, S) tokens are split
    along S."""
    eff_unit = math.lcm(unit, max(row_multiple, 1))
    bucket = token_bucket(n_tokens)
    if n_tokens < min_tokens:
        return SplitDecision(None, "below_min_tokens", n_tokens, eff_unit,
                             min_tokens, 0, bucket)
    if n_tokens < 2 * unit:
        return SplitDecision(None, "below_wave_floor", n_tokens, eff_unit,
                             min_tokens, 0, bucket)
    split = smart_split(n_tokens, eff_unit)
    return SplitDecision(split, "split" if split is not None
                         else "below_wave_floor", n_tokens, eff_unit,
                         min_tokens, 0, bucket)


def split_sizes_for_batch(n_tokens: int, *, unit: int, min_tokens: int,
                          row_multiple: int = 1
                          ) -> Optional[Tuple[int, int]]:
    """The split ``split_decision`` chooses, or None."""
    return split_decision(n_tokens, unit=unit, min_tokens=min_tokens,
                          row_multiple=row_multiple).split


def plan_split(n_tokens: int, unit: int, frac: float
               ) -> Optional[Tuple[int, int]]:
    """Wave-conserving split at a prefix-wave fraction (the tuned plans'
    form of ``smart_split``): the prefix takes ``floor(frac ·
    total_waves)`` full waves, clamped to [1, total_waves - 1];
    ``frac = 0.5`` is ``smart_split``."""
    if unit <= 0:
        raise ValueError(f"unit must be positive, got {unit}")
    if n_tokens < 2 * unit:
        return None
    total_waves = math.ceil(n_tokens / unit)
    k = min(max(int(frac * total_waves), 1), total_waves - 1)
    l1 = k * unit
    return l1, n_tokens - l1


def packed_split(n_tokens: int, *, unit: int, min_tokens: int
                 ) -> Optional[Tuple[int, int]]:
    """Weave decision for a packed hybrid iteration, in its global-
    threshold form: the flat packed axis needs no rectangularity
    (``row_multiple == 1``), and the decision sees the true combined
    iteration size.  A segment may straddle the cut; the suffix split's
    attention reads the prefix split's freshly written KV."""
    return split_sizes_for_batch(n_tokens, unit=unit, min_tokens=min_tokens,
                                 row_multiple=1)


# The comm budget of a plan (an SM-equivalent fraction in (0, 1]) maps to
#     channels = round(budget * MAX_RING_CHANNELS)
# as in the reference, deliberately not clamped to >= 1 (the reference's
# plan checker rejects budgets that map to zero; runtime callers clamp).
# In this port the channels are kernel K1's CTAs, one per SM: the paper's
# 2-8 SM grant.
MAX_RING_CHANNELS: int = 8


def ring_channels(budget: float) -> int:
    """SM-equivalent comm budget -> channel count for the fused kernel."""
    return int(round(float(budget) * MAX_RING_CHANNELS))


def ring_ctas(budget: float) -> int:
    """K1's grid for a comm budget: ``ring_channels`` clamped to [1, 8]."""
    return min(MAX_RING_CHANNELS, max(1, ring_channels(budget)))


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
