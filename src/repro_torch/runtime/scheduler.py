"""Iteration-level scheduler with Sarathi-style chunked prefill and
(optionally) paged-KV admission control.

Each engine iteration the scheduler emits:
  * a decode batch: one token for every DECODE-state request (if any), and
  * a prefill chunk: up to ``chunk_tokens`` tokens from WAITING/PREFILL
    requests with equal chunk lengths (rectangular batches keep shapes
    static; lengths are bucketed to powers of two to bound recompilation).

The two are dispatched as two forward calls per iteration (documented
simplification vs. packed ragged hybrid batches, DESIGN.md §6). TokenWeave
is applied inside the model per batch: chunks >= ``tokenweave_min_tokens``
take the two-split weave; small decode batches fall back to the unsplit
fused kernel — the same policy the paper uses for vLLM integration.

Paged mode (``SchedulerConfig.paged``) changes admission and accounting:

* a request is admitted only when the block manager has room for its miss
  suffix plus one decode block (FIFO head-of-line; no skipping, so no
  starvation), and its ``prefill_pos`` starts at the prefix-cache hit
  length — so only MISS tokens are charged against ``chunk_tokens`` and
  the weave-threshold decision (``tokenweave_min_tokens``) sees the true
  compute size of the batch, not the nominal prompt size.
* a running request can be preempted (DECODE -> WAITING, recompute): its
  blocks are freed and it re-enters the queue front with its generated
  tokens folded into the context (``Request.resumed``).

Speculative decoding (``spec_gamma > 0``) charges the verify batch —
gamma+1 tokens per decoding sequence — against ``chunk_tokens`` before
sizing the prefill chunk, so the combined iteration token count stays
bounded (DESIGN.md §8).

Packed mode (``packed=True``, DESIGN.md §6) replaces the two dispatches
with ONE plan per iteration: decode slots (1 token), speculative verify
windows (γ+1 tokens, worst case — the engine may shrink a draft), and
per-request prefill takes are concatenated along a single token axis.
Prefill takes need no rectangularity (the packed axis is ragged by
construction), so the whole remaining ``chunk_tokens`` budget is usable
every iteration, and the engine's single forward judges the weave
threshold against the TRUE combined token count.  Invariant (tests pin
it): ``PackedPlan.total_tokens <= chunk_tokens``, which requires
``chunk_tokens >= max_batch * (spec_gamma + 1)`` — validated here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

from repro_torch.runtime.requests import Request, State


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8              # cache slots
    chunk_tokens: int = 2048        # Sarathi chunk budget (vLLM default 2k)
    max_len: int = 4096
    prefill_bucket: int = 64        # chunk lengths rounded to this multiple
    # --- paged KV cache (vLLM-style block pool) ---
    paged: bool = False
    block_size: int = 16            # tokens per KV block
    num_blocks: int = 0             # 0 -> max_batch * ceil(max_len/block)
    prefix_caching: bool = True
    # --- speculative decoding (runtime/spec.py, DESIGN.md §8) ---
    spec_gamma: int = 0             # draft tokens per verify step (0 = off)
    spec_ngram: int = 3             # n-gram length of the default draft
    # --- packed hybrid batching (one forward per iteration, DESIGN.md §6) --
    packed: bool = False
    # --- online admission policy (runtime/server.py, DESIGN.md §10) ---
    # "fcfs": queue order (arrival order; preempted requests resume first).
    # "edf":  earliest-deadline-first among waiting requests (requests
    #         without a deadline sort last, FCFS among themselves).
    # A callable can be plugged directly via ``Scheduler(..., policy=fn)``.
    policy: str = "fcfs"
    # --- overlap policy plan cache (core/policy.py, DESIGN.md §14) ---
    # path to a tuned-plan JSON under benchmarks/plans/; the engine loads
    # it at startup and installs the TunedPolicy on the model's
    # ParallelConfig.  None keeps the degenerate global threshold.
    plan_path: Optional[str] = None

    def __post_init__(self):
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {self.policy!r}; known: "
                f"{sorted(ADMISSION_POLICIES)}")
        if self.packed:
            w = self.spec_gamma + 1
            if self.chunk_tokens < self.max_batch * w:
                raise ValueError(
                    f"packed mode needs chunk_tokens >= max_batch * "
                    f"(spec_gamma+1) = {self.max_batch * w} so mandatory "
                    f"decode/verify slots always fit the packed budget "
                    f"(got {self.chunk_tokens})")

    @property
    def max_blocks_per_req(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def effective_num_blocks(self) -> int:
        return self.num_blocks or self.max_batch * self.max_blocks_per_req

    def max_forward_tokens(self, tp: int = 1) -> int:
        """The most token rows one forward carries: a prefill group or a
        packed plan holds at most ``chunk_tokens`` (the engine pads a
        packed total to a multiple of lcm(prefill_bucket, tp)); a decode
        or verify step every slot's window."""
        unit = math.lcm(self.prefill_bucket, tp)
        return max(-(-self.chunk_tokens // unit) * unit,
                   self.max_batch * (self.spec_gamma + 1))


def _edf_key(r: Request):
    """Earliest-deadline-first: deadline-less requests sort after every
    deadline-carrying one and stay FCFS among themselves (stable sort on
    the queue preserves arrival/preemption order for ties)."""
    return (r.deadline if r.deadline is not None else float("inf"),)


# name -> sort key over waiting requests, or None to keep queue order.
# The sort is STABLE, so equal keys preserve arrival order and a preempted
# request (re-queued at the front) resumes before same-priority peers.
ADMISSION_POLICIES = {
    "fcfs": None,
    "edf": _edf_key,
}


@dataclasses.dataclass
class ScheduleStep:
    decode_slots: List[int]
    prefill: Optional[Tuple[List[Request], int]]  # (requests, chunk_len)


@dataclasses.dataclass
class PackedSegment:
    """One contiguous run of the packed token axis (DESIGN.md §6).

    kind encodes the cache interaction: ``prefill`` scatters ``n_tokens``
    new context positions; ``decode`` carries the single pending input;
    ``verify`` budgets a speculative window of 1 + gamma tokens (the
    engine packs 1 + len(draft) actual tokens, never more).  Query
    positions and causal extent derive from the owning request: a
    segment's tokens occupy absolute positions ``pos0 .. pos0+n-1`` and
    attend the request's cache rows up to their own position.
    """
    req: Request
    kind: str                       # "prefill" | "decode" | "verify"
    n_tokens: int                   # budgeted tokens (verify: worst case)


@dataclasses.dataclass
class PackedPlan:
    segments: List[PackedSegment]
    total_tokens: int               # sum of budgeted segment tokens
    # the overlap decision for this plan (a models.transformer.WeaveInfo),
    # stamped by the engine's overlap hint at planning time so the packed
    # planner and the forward dispatch consume ONE plan format
    # (DESIGN.md §14); None until the hint runs (or when no hint is wired)
    overlap: Optional[object] = None


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, block_mgr=None, policy=None,
                 on_admit=None, overlap_hint=None):
        self.cfg = cfg
        self.block_mgr = block_mgr          # BlockManager when cfg.paged
        self.waiting: List[Request] = []
        self.active: List[Optional[Request]] = [None] * cfg.max_batch
        self.finished: List[Request] = []
        # pluggable priority: explicit callable wins, else the named policy
        # (NB: ``policy`` here is the ADMISSION policy — the per-site
        # OVERLAP policy arrives through ``overlap_hint`` below)
        self.policy_key = (policy if policy is not None
                           else ADMISSION_POLICIES[cfg.policy])
        # observation-only admission hook (the engine's trace recorder,
        # DESIGN.md §12) — fired after the request lands in its slot
        self.on_admit = on_admit
        # tokens -> WeaveInfo: the engine's view of the active overlap
        # policy at the packed site (DESIGN.md §14); stamps
        # PackedPlan.overlap so the planner shares the dispatch's plan
        self.overlap_hint = overlap_hint

    # ---- admission -------------------------------------------------------
    def add(self, req: Request):
        self.waiting.append(req)

    def remove_waiting(self, req: Request) -> bool:
        """Drop a not-yet-admitted request (online cancellation)."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _admit(self):
        if self.policy_key is not None and len(self.waiting) > 1:
            self.waiting.sort(key=self.policy_key)   # stable: FCFS ties
        for slot in self._free_slots():
            if not self.waiting:
                break
            req = self.waiting[0]
            if self.block_mgr is not None:
                # one-shot: prefix-match + allocate (+1 decode-block
                # headroom), rolled back atomically on failure.
                # FIFO head-of-line: no skipping, so no starvation
                hit = self.block_mgr.allocate_prompt(req.rid,
                                                     req.context_tokens)
                if hit < 0:
                    break
                req.prefill_pos = hit
                req.prompt_hit_tokens = hit
            self.waiting.pop(0)
            req.slot = slot
            req.state = State.PREFILL
            self.active[slot] = req
            if self.on_admit is not None:
                self.on_admit(req)

    # ---- preemption ------------------------------------------------------
    def preempt(self, req: Request):
        """Recompute-mode preemption: blocks are gone (the engine freed
        them); the request re-prefills prompt + generated-so-far on its
        next admission.  Front of the queue so it resumes first."""
        assert req.state in (State.DECODE, State.PREFILL)
        self.active[req.slot] = None
        req.slot = None
        req.state = State.WAITING
        req.prefill_pos = 0
        req.prompt_hit_tokens = 0
        req.preemptions += 1
        req.resumed = bool(req.output)
        self.waiting.insert(0, req)

    # ---- one iteration ----------------------------------------------------
    def next_step(self) -> Optional[Union[ScheduleStep, "PackedPlan"]]:
        self._admit()
        decode_slots = [r.slot for r in self.active
                        if r is not None and r.state == State.DECODE]

        prefilling = [r for r in self.active
                      if r is not None and r.state == State.PREFILL]
        if self.cfg.packed:
            return self._next_packed(prefilling)
        prefill = None
        budget = self.cfg.chunk_tokens
        if self.cfg.spec_gamma and decode_slots:
            # speculative verify rides the same iteration as the chunk and
            # carries gamma+1 tokens per decoding sequence: charge them
            # against the chunk budget so the combined iteration token
            # count stays bounded (and the weave-threshold decision inside
            # the model sees honestly-sized batches on both calls)
            budget -= len(decode_slots) * (self.cfg.spec_gamma + 1)
        if prefilling and budget >= min(self.cfg.prefill_bucket,
                                        self.cfg.chunk_tokens):
            b = self.cfg.prefill_bucket
            # chunk length: bucketized max remaining MISS tokens, capped by
            # the budget (prefix-hit tokens are never re-charged)
            remains = [len(r.context_tokens) - r.prefill_pos
                       for r in prefilling]
            chunk = min(budget, max(remains))
            chunk = min(max(b, ((chunk + b - 1) // b) * b), budget)
            group, n_tok = [], 0
            for r in prefilling:
                if n_tok + chunk > budget and group:
                    break
                group.append(r)
                n_tok += chunk
            prefill = (group, chunk)

        if not decode_slots and prefill is None:
            return None
        return ScheduleStep(decode_slots=decode_slots, prefill=prefill)

    def _next_packed(self, prefilling: List[Request]) -> Optional[PackedPlan]:
        """Build one packed plan: mandatory decode/verify segments first
        (charged at their worst-case width), then per-request prefill
        takes filling the remaining ``chunk_tokens`` budget.  Prefill
        takes are ragged — no bucketing, no shared chunk length — so the
        budget is fully usable; the ENGINE pads only the plan total (to a
        recompilation bucket), never individual segments."""
        budget = self.cfg.chunk_tokens
        w = self.cfg.spec_gamma + 1 if self.cfg.spec_gamma else 1
        kind = "verify" if self.cfg.spec_gamma else "decode"
        segs = []
        for r in self.active:
            if r is not None and r.state == State.DECODE:
                segs.append(PackedSegment(req=r, kind=kind, n_tokens=w))
                budget -= w
        for r in prefilling:
            if budget <= 0:
                break
            take = min(budget, len(r.context_tokens) - r.prefill_pos)
            if take <= 0:
                continue
            segs.append(PackedSegment(req=r, kind="prefill", n_tokens=take))
            budget -= take
        if not segs:
            return None
        plan = PackedPlan(segments=segs,
                          total_tokens=sum(s.n_tokens for s in segs))
        if self.overlap_hint is not None:
            plan.overlap = self.overlap_hint(plan.total_tokens)
        return plan

    # ---- bookkeeping ------------------------------------------------------
    def finish(self, req: Request, step: int):
        req.state = State.DONE
        req.done_step = step
        self.active[req.slot] = None
        self.finished.append(req)

    def all_done(self) -> bool:
        return not self.waiting and all(r is None for r in self.active)
