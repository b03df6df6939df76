"""Continuous-batching inference engine, as ``repro.runtime.engine``
without speculative decoding.

Two dispatch schemes (``SchedulerConfig.packed``):

* two-dispatch — per iteration one decode step over ALL slots (inactive
  rows masked via position -1) and/or one rectangular prefill chunk for a
  group of admitted requests (Sarathi-style chunked prefill, lengths
  bucketed by the scheduler);
* packed — ONE forward per iteration: prefill segments and decode slots
  ride a single (1, T) token axis through ``ModelApi.packed_step``, so the
  weave threshold sees the true combined iteration size.

Two KV-cache backends (``SchedulerConfig.paged``):

* legacy slots — fixed (max_batch, max_len) rows per request, reset on
  finish so stale positions never leak into a reused slot;
* paged (``runtime/paging.py``) — a block pool with per-request block
  tables, prefix-cache sharing, LRU eviction, copy-on-write and
  recompute preemption (DECODE -> WAITING) when the pool runs dry.
  Admission charges only prefix-miss tokens against ``chunk_tokens``.

TokenWeave activates inside the model whenever a dispatch crosses the
active overlap policy's threshold (``SchedulerConfig.plan_path`` loads a
tuned plan).  Not ported yet, and refused with NotImplementedError:
speculative decoding, stochastic sampling, evacuate/handoff, and tracing
or profiling hooks (ROADMAP.md).

The engine serves at ``api.tp``: the tp ranks sit on the rank axis of
one device (``distributed/context.py``), and the params must carry that
axis.  It runs on CUDA unless it is given ``device="cpu"``; with no device
and no CUDA it raises.  The host builds every step's index arrays (block
tables, packed segment owners, positions) in numpy and hands them to the
model as CPU tensors, which moves them to the device once per forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.policy import load_policy
from repro_torch.core.splitting import pad_to_multiple
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TRX
from repro_torch.models.build import ModelApi
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import kv_cache as KC
from repro_torch.runtime import paging as PG
from repro_torch.runtime.paging import BlockManager
from repro_torch.runtime.requests import Request, State
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.scheduler import (PackedPlan, Scheduler,
                                           SchedulerConfig)


class EngineStats:
    """Read view over the engine's MetricsRegistry (``engine/*``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._steps = r.counter("engine/steps")
        self._prefill_tokens = r.counter("engine/prefill_tokens")
        self._decode_tokens = r.counter("engine/decode_tokens")
        self._completed = r.counter("engine/completed")
        self._cancelled = r.counter("engine/cancelled")
        self._expired = r.counter("engine/expired")
        self._forwards = r.counter("engine/forwards")
        self._weave_forwards = r.counter("engine/weave_forwards")
        self._forward_tokens = r.counter("engine/forward_tokens")
        self._max_forward_tokens = r.gauge("engine/max_forward_tokens")

    steps = property(lambda self: self._steps.value)
    prefill_tokens = property(lambda self: self._prefill_tokens.value)
    decode_tokens = property(lambda self: self._decode_tokens.value)
    completed = property(lambda self: self._completed.value)
    cancelled = property(lambda self: self._cancelled.value,
                         doc="User-initiated aborts.")
    expired = property(lambda self: self._expired.value,
                       doc="Deadline-expiry aborts.")
    forwards = property(lambda self: self._forwards.value,
                        doc="Model dispatches (2/iter two-dispatch peak).")
    weave_forwards = property(lambda self: self._weave_forwards.value,
                              doc="Dispatches whose shape fires the weave.")
    forward_tokens = property(lambda self: self._forward_tokens.value,
                              doc="Real (non-padding) tokens dispatched.")

    @property
    def max_forward_tokens(self) -> int:
        return int(self._max_forward_tokens.value)

    @property
    def weave_rate(self) -> float:
        return self.weave_forwards / self.forwards if self.forwards else 0.0

    @property
    def tokens_per_forward(self) -> float:
        return self.forward_tokens / self.forwards if self.forwards else 0.0




class Engine:
    def __init__(self, api: ModelApi, params, scfg: SchedulerConfig,
                 temperature: float = 0.0, *, device=None, obs=None,
                 profiler=None):
        self.device = resolve_device(device)
        for what, asked in (("speculative decoding", scfg.spec_gamma),
                            ("stochastic sampling", temperature > 0.0),
                            ("tracing", obs is not None),
                            ("profiling", profiler is not None)):
            if asked:
                raise NotImplementedError(f"{what} is not ported yet "
                                          f"(ROADMAP.md)")
        if scfg.plan_path:
            # the tuned plan goes on the model's ParallelConfig before
            # anything reads it: forward dispatch and packed planner alike
            api = dataclasses.replace(api, pcfg=dataclasses.replace(
                api.pcfg, overlap_policy=load_policy(scfg.plan_path)))
        emb = params["embedding"]["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params are on {emb.device}, engine on "
                             f"{self.device}")
        if emb.shape[0] != api.tp:
            raise ValueError(f"params hold {emb.shape[0]} ranks, the model "
                             f"API tp={api.tp}")
        self.api = api
        self.params = params
        self.scfg = scfg
        self.temperature = temperature
        self.metrics = MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self.metrics.gauge("engine/plan_id").set(
            getattr(api.pcfg.overlap_policy, "plan_id", 0))
        self._step_count = 0
        self.paged = bool(scfg.paged)
        self.packed = bool(scfg.packed)
        if self.packed:
            if api.pcfg.seq_shard_kv:
                raise ValueError("packed steps gather full cache rows "
                                 "locally; disable seq_shard_kv")
            if not self.paged and api.cfg.sliding_window:
                raise ValueError(
                    "packed scatter into a sliding-window ring buffer could "
                    "evict keys earlier packed queries still need; use the "
                    "paged backend (full-length storage, mask-enforced "
                    "windows)")
        if self.paged:
            self.block_mgr = BlockManager(
                scfg.effective_num_blocks, scfg.block_size,
                scfg.max_blocks_per_req, prefix_caching=scfg.prefix_caching)
            self.cache = api.init_paged_cache(scfg.effective_num_blocks,
                                              scfg.block_size,
                                              device=self.device)
        else:
            self.block_mgr = None
            self.cache = api.init_cache(scfg.max_batch, scfg.max_len,
                                        device=self.device)
        # the packed planner stamps each plan with the same decision the
        # packed forward will take, through a late-binding closure, so
        # install_overlap_policy swaps the planner's view too
        self.sched = Scheduler(
            scfg, block_mgr=self.block_mgr,
            overlap_hint=self._overlap_hint if self.packed else None)

    # ------------------------------------------------------------------
    # per-site overlap policy
    # ------------------------------------------------------------------
    def _overlap_hint(self, tokens: int) -> TRX.WeaveInfo:
        return TRX.weave_decision_info(
            1, tokens, tp=self.api.tp, pcfg=self.api.pcfg, packed=True,
            family=self.api.cfg.family)

    def install_overlap_policy(self, policy) -> None:
        """Swap the active overlap policy; in-flight requests and caches
        are untouched (a policy only picks split points)."""
        self.api = dataclasses.replace(
            self.api, pcfg=dataclasses.replace(self.api.pcfg,
                                               overlap_policy=policy))
        self.metrics.gauge("engine/plan_id").set(
            getattr(policy, "plan_id", 0))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def add_request(self, req: Request):
        if len(req.prompt) + 1 > self.scfg.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} + 1 exceeds max_len "
                f"{self.scfg.max_len} (rid={req.rid})")
        if self.paged:
            need = self.block_mgr.blocks_needed(len(req.prompt)) + 1
            if need > self.scfg.effective_num_blocks:
                raise ValueError(
                    f"prompt needs {need} blocks but the pool has only "
                    f"{self.scfg.effective_num_blocks} (rid={req.rid})")
        req.arrival_step = self._step_count
        self.sched.add(req)

    def abort(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel a live request at any point of its life (waiting, mid-
        prefill, mid-decode), releasing what it holds: its blocks (prefix-
        shared references included), its legacy slot (positions reset) and
        its scheduler entry.  Only between steps.  Returns False when the
        request had already finished."""
        if req.state == State.DONE:
            return False
        req.finish_reason = reason
        if reason == "expired":
            self.stats._expired.inc()
        else:
            self.stats._cancelled.inc()
        if req.state == State.WAITING:
            # not admitted: no slot and no blocks (a preempted request
            # freed its own)
            self.sched.remove_waiting(req)
            req.state = State.DONE
            return True
        if self.paged:
            # cached blocks park in the LRU, still hittable
            self.block_mgr.free_request(req.rid)
        else:
            KC.reset_slots(self.cache, [req.slot])
        self.sched.active[req.slot] = None
        req.slot = None
        req.state = State.DONE
        return True

    def evacuate(self) -> List[Request]:
        raise NotImplementedError("evacuate is not ported yet (ROADMAP.md A6)")

    def step(self) -> bool:
        """Run one engine iteration.  Returns False when idle."""
        plan = self.sched.next_step()
        if plan is None:
            return False
        self._step_count += 1
        self.stats._steps.inc()
        with torch.no_grad():
            if isinstance(plan, PackedPlan):
                self._run_packed(plan)
                return True
            if plan.prefill is not None:
                self._run_prefill(*plan.prefill)
            if plan.decode_slots:
                self._run_decode()
        return True

    def run(self, max_steps: int = 100000) -> List[Request]:
        while not self.sched.all_done() and max_steps > 0:
            max_steps -= 1
            if not self.step():
                if self.sched.waiting:
                    # nothing active and the queue head cannot be admitted
                    # (a preempted request whose regrown context outgrew
                    # the pool): surface it rather than drop it
                    rids = [r.rid for r in self.sched.waiting]
                    raise RuntimeError(
                        f"engine idle with unservable waiting request(s) "
                        f"{rids}: block pool too small for their context")
                break
        return self.sched.finished

    def _note_forward(self, b: int, s: int, n_real: int, *,
                      decode: bool = False, packed: bool = False):
        """Record one model dispatch: its (b, s) shape decides the weave,
        its real token count feeds tokens/forward."""
        st = self.stats
        st._forwards.inc()
        st._forward_tokens.inc(n_real)
        st._max_forward_tokens.set_max(n_real)
        info = TRX.weave_decision_info(b, s, tp=self.api.tp,
                                       pcfg=self.api.pcfg, decode=decode,
                                       packed=packed,
                                       paged_pool=self.paged and decode,
                                       family=self.api.cfg.family)
        self.metrics.counter("engine/site_forwards", site=info.site).inc()
        if info.weave:
            st._weave_forwards.inc()
            self.metrics.counter("engine/site_weave", site=info.site).inc()
        if info.comm_mode == "ring":
            # a tuned plan sent this site to the fused kernel (K1)
            self.metrics.counter("engine/site_fused", site=info.site).inc()

    # ------------------------------------------------------------------
    # paged-pool plumbing
    # ------------------------------------------------------------------
    def _apply_fixups(self):
        """Drain queued pool maintenance: pos resets of recycled blocks
        FIRST (a reset block may since have been handed out again, and a
        COW destination is overwritten entirely by its copy), then the
        copy-on-write copies."""
        resets = self.block_mgr.take_pending_resets()
        copies = self.block_mgr.take_pending_copies()
        if resets:
            PG.reset_blocks(self.cache, resets)
        if copies:
            PG.copy_blocks(self.cache, copies)

    def _preempt(self, victim: Request):
        self.block_mgr.free_request(victim.rid)
        self.block_mgr.stats.preemptions += 1
        self.sched.preempt(victim)

    def _ensure_decode_blocks(self) -> List[Request]:
        """Grow/COW the write-target block of every DECODE request; when
        the pool runs dry, preempt the youngest DECODE request (recompute
        mode) and retry.  Returns the surviving decode batch."""
        def decoding():
            return [r for r in self.sched.active
                    if r is not None and r.state == State.DECODE]
        for r in decoding():
            if r.length - 1 >= self.scfg.max_len:
                # context at the cache ceiling: stop early (truncated
                # output) rather than overflow the block table
                self._finish(r)
        for r in sorted(decoding(), key=lambda r: (r.arrival_step, r.rid)):
            while r.state == State.DECODE:
                if self.block_mgr.ensure_writable(r.rid, r.length - 1):
                    break
                victims = decoding()
                victim = max(victims, key=lambda v: (v.arrival_step, v.rid))
                self._preempt(victim)   # may be r itself -> loop exits
        return decoding()

    def _tables(self, rows: int, reqs) -> np.ndarray:
        """A (rows, width) block-table array holding each request's table
        at its slot, -1 elsewhere; width is the longest table (entries
        past it are all -1)."""
        tables = [self.block_mgr.tables[r.rid] for r in reqs]
        bt = np.full((rows, max(map(len, tables), default=1)), -1, np.int32)
        for r, t in zip(reqs, tables):
            bt[r.slot, :len(t)] = t
        return bt

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # per-request commits, shared by both dispatch schemes
    # ------------------------------------------------------------------
    def _commit_prefill(self, r: Request, tok: int):
        """After a chunk advanced ``r.prefill_pos``: register the filled
        blocks and, when the context is complete, commit the first sampled
        token (dropped for recompute-readmissions, whose pending decode
        input was already emitted) and move to DECODE."""
        if self.paged:
            self.block_mgr.register_filled(r.rid, r.context_tokens,
                                           r.prefill_pos)
        if r.prefill_done:
            if r.handoff_after_prefill:
                raise NotImplementedError("KV handoff is not ported yet "
                                          "(ROADMAP.md A6)")
            if r.resumed:
                r.resumed = False
            else:
                r.output.append(tok)
                r.first_token_step = self._step_count
            r.state = State.DECODE
            self._maybe_finish(r)

    def _commit_decode(self, r: Request, tok: int):
        n_written = r.length  # positions [0, length-1] now in cache
        r.output.append(tok)
        self.stats._decode_tokens.inc()
        if self.paged and n_written % self.scfg.block_size == 0:
            # a block just filled: make it hittable for future prompts
            self.block_mgr.register_filled(
                r.rid, r.prompt + r.output[:-1], n_written)
        self._maybe_finish(r)

    # ------------------------------------------------------------------
    # two-dispatch
    # ------------------------------------------------------------------
    def _run_prefill(self, group: List[Request], chunk: int):
        b_sel = len(group)
        tokens = np.zeros((b_sel, chunk), np.int64)
        positions = np.full((b_sel, chunk), -1, np.int32)
        offsets = np.zeros(b_sel, np.int64)
        last_idx = np.zeros(b_sel, np.int64)
        for i, r in enumerate(group):
            ctx = r.context_tokens
            take = min(chunk, len(ctx) - r.prefill_pos)
            tokens[i, :take] = ctx[r.prefill_pos:r.prefill_pos + take]
            positions[i, :take] = np.arange(r.prefill_pos,
                                            r.prefill_pos + take)
            offsets[i] = r.prefill_pos
            last_idx[i] = take - 1
            r.prefill_pos += take

        if self.paged:
            self._apply_fixups()
            bt = np.stack([self.block_mgr.table_array(r.rid) for r in group])
            # attended as prefix: the blocks written before this chunk
            # (the rest of each table holds unwritten cells only, pos -1)
            width = max([self.block_mgr.blocks_needed(int(o))
                         for o in offsets] + [1])
            rows = PG.gather_block_rows(self.cache,
                                        self._tensor(bt[:, :width]))
        else:
            slot_ids = self._tensor(np.array([r.slot for r in group],
                                             np.int64))
            rows = KC.gather_slots(self.cache, slot_ids)
        logits, kv = self.api.prefill(
            self.params, self._tensor(tokens), rows, self._tensor(positions),
            last_idx=self._tensor(last_idx))
        if self.paged:
            PG.insert_chunk_paged(self.cache, kv, torch.from_numpy(bt),
                                  positions=torch.from_numpy(positions))
        else:
            KC.insert_chunk(self.cache, kv, self._tensor(offsets), slot_ids)
        tok = sample(logits, vocab_size=self.api.cfg.vocab_size,
                     temperature=self.temperature).cpu().numpy()
        n_real = int((positions >= 0).sum())
        self.stats._prefill_tokens.inc(n_real)
        self._note_forward(b_sel, chunk, n_real)
        for i, r in enumerate(group):
            self._commit_prefill(r, int(tok[i]))

    def _run_decode(self):
        if self.paged:
            reqs = self._ensure_decode_blocks()
            if not reqs:
                return
            self._apply_fixups()
        else:
            reqs = [r for r in self.sched.active
                    if r is not None and r.state == State.DECODE]
        bmax = self.scfg.max_batch
        tokens = np.zeros((bmax, 1), np.int64)
        positions = np.full((bmax, 1), -1, np.int32)
        for r in reqs:
            tokens[r.slot, 0] = r.output[-1]
            positions[r.slot, 0] = r.length - 1
        if self.paged:
            logits, self.cache = self.api.decode_step(
                self.params, self._tensor(tokens), self.cache,
                torch.from_numpy(positions),
                block_tables=torch.from_numpy(self._tables(bmax, reqs)))
        else:
            logits, self.cache = self.api.decode_step(
                self.params, self._tensor(tokens), self.cache,
                self._tensor(positions))
        tok = sample(logits, vocab_size=self.api.cfg.vocab_size,
                     temperature=self.temperature).cpu().numpy()
        self._note_forward(bmax, 1, len(reqs), decode=True)
        for r in list(reqs):
            self._commit_decode(r, int(tok[r.slot]))

    # ------------------------------------------------------------------
    # packed hybrid batching
    # ------------------------------------------------------------------
    def _run_packed(self, plan: PackedPlan):
        """ONE forward for the whole iteration: prefill segments and
        decode slots concatenated along a (1, T) token axis (T padded to
        lcm(prefill_bucket, tp)) through ``ModelApi.packed_step``, then
        one sample per segment."""
        if self.paged:
            # grow/COW the decode write cells first; this can preempt or
            # ceiling-finish DECODE requests, so re-filter the plan
            self._ensure_decode_blocks()
        segs = [s for s in plan.segments
                if s.req.state == (State.PREFILL if s.kind == "prefill"
                                   else State.DECODE)]
        if not segs:
            return
        if self.paged:
            self._apply_fixups()

        t_real = sum(s.n_tokens if s.kind == "prefill" else 1 for s in segs)
        t = pad_to_multiple(t_real, math.lcm(self.scfg.prefill_bucket,
                                             self.api.tp))
        bmax = self.scfg.max_batch
        tokens = np.zeros((1, t), np.int64)
        positions = np.full((1, t), -1, np.int32)
        seg_slots = np.full(t, -1, np.int32)
        sample_idx = np.full((bmax, 1), -1, np.int32)
        cur = 0
        for s in segs:
            r, m = s.req, s.req.slot
            if s.kind == "prefill":
                take = s.n_tokens
                tokens[0, cur:cur + take] = \
                    r.context_tokens[r.prefill_pos:r.prefill_pos + take]
                positions[0, cur:cur + take] = np.arange(
                    r.prefill_pos, r.prefill_pos + take)
                r.prefill_pos += take
            else:
                take = 1
                tokens[0, cur] = r.output[-1]
                positions[0, cur] = r.length - 1
            seg_slots[cur:cur + take] = m
            sample_idx[m, 0] = cur + take - 1
            cur += take

        kw = {}
        if self.paged:
            kw["block_tables"] = torch.from_numpy(
                self._tables(bmax, [s.req for s in segs]))
        logits, self.cache = self.api.packed_step(
            self.params, self._tensor(tokens), self.cache,
            torch.from_numpy(positions), seg_slots=torch.from_numpy(seg_slots),
            sample_idx=torch.from_numpy(sample_idx), **kw)
        emit = sample(logits, vocab_size=self.api.cfg.vocab_size,
                      temperature=self.temperature).cpu().numpy()
        self._note_forward(1, t, t_real, packed=True)
        for s in segs:
            r = s.req
            if s.kind == "prefill":
                self.stats._prefill_tokens.inc(s.n_tokens)
                self._commit_prefill(r, int(emit[r.slot]))
            else:
                self._commit_decode(r, int(emit[r.slot]))

    def _maybe_finish(self, r: Request):
        if len(r.output) >= r.max_new_tokens:
            self._finish(r)

    def _finish(self, r: Request):
        if self.paged:
            # final registration, then drop refs: cached blocks park in
            # the LRU (still hittable), private ones recycle
            self.block_mgr.register_filled(
                r.rid, r.prompt + r.output[:-1], r.length - 1)
            self.block_mgr.free_request(r.rid)
        else:
            # stale positions of a finished request must not leak into
            # the slot's next owner
            KC.reset_slots(self.cache, [r.slot])
        r.finish_reason = r.finish_reason or "stop"
        self.sched.finish(r, self._step_count)
        self.stats._completed.inc()
