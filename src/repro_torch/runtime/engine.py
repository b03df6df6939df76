"""Continuous-batching inference engine, as ``repro.runtime.engine``.

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

Speculative decoding (``SchedulerConfig.spec_gamma > 0``,
``runtime/spec.py``): decode iterations become gamma+1-token verify
windows.  A draft proposes on the host, ONE multi-token forward scores
every window (``verify_step`` over slots or the pool; a verify segment
of 1 + |draft| tokens in a packed step), verification commits the
longest accepted prefix + 1 token, and rejected KV is rolled back by
block-table truncation (paged) or left to the overwrite-before-query
invariant (slots: the next window rewrites each stale cell before any
query can see it).  Greedy spec output is token-identical to plain
greedy decoding.

Sampling is greedy at temperature 0; above it, temperature/top-k/top-p
filtering and Gumbel-max draws (rejection sampling for verify windows)
from one ``torch.Generator`` on the engine's device, seeded by ``seed``,
so stochastic runs are reproducible for a fixed request order.  Each
step brings its sampled ids (and accept counts) to the host once.

TokenWeave activates inside the model whenever a dispatch crosses the
active overlap policy's threshold (``SchedulerConfig.plan_path`` loads a
tuned plan).

Observability (``obs/``), off by default: ``obs=TraceRecorder()`` records
request lifecycle events and one step span per iteration with one
forward span per dispatch carrying its weave attribution, priced on the
§9 sim; ``profiler=WallClockProfiler()`` times each dispatch (the model
call and its sampling up to the host copy of the tokens) between two
fences on the device and joins it to the same attribution record.
Neither changes a token or a step.  ``EngineStats.latency`` holds the
per-request latencies the online server (``runtime/server.py``) stamps.

Disaggregated serving (``runtime/cluster.py``): a request marked
``handoff_after_prefill`` is parked once its prefill completes
(``_park_for_handoff``: its KV payload copied to the host, its blocks and
slot released) and waits in ``handoff_ready`` until the cluster moves it
to a decode replica, whose ``adopt_request`` implants the payload and
resumes decoding with no re-prefill.  ``evacuate`` releases everything a
dead replica's engine holds and returns its requests reset for a
recompute requeue.

Families: the transformer's (dense, MoE, and vlm text-only: no M-RoPE
ids are passed, so it rotates by plain RoPE, as the reference's engine
serves it) on every path above, and ssm
over legacy slots with the two-dispatch scheme only (its state has no
token axis: packed, speculative and paged runs are refused with the
reference's messages); an ssm prefill chunk is exact (no padding enters
the recurrence), reads its rows of the state cache (zeroed for a fresh
request) and writes them back, and a finished slot needs no reset.  The
hybrid and encdec families are served by direct ``ModelApi.prefill`` /
``decode_step`` calls, as the reference serves them; the engine refuses
them.

The engine serves at ``api.tp``: the tp ranks sit on the rank axis of
one device (``distributed/context.py``), and the params must carry that
axis.  Under ``api.groups`` (the ``process_group`` backend at data size
1, every family above) each process runs its own Engine on the same
requests with one model rank's params: the scheduler is deterministic,
every rank samples the same token (``sampler.sample`` over the model
group) and verifies the same windows (``spec.verify_tokens`` over it;
a ``ModelDraft`` runs its own rank's draft over the same groups, so
its proposals agree), and the host-side commits and rollbacks follow
from those, so all ranks take the same steps.  It runs
on CUDA unless it is given ``device="cpu"``; with no device and no CUDA
it raises.  The host builds every step's index arrays (block
tables, packed segment owners, positions) in numpy and hands them to the
model as CPU tensors, which moves them to the device once per forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.policy import load_policy
from repro_torch.core.splitting import pad_to_multiple
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TRX
from repro_torch.models.build import ModelApi
from repro_torch.obs.attribution import Attributor, WeaveAttribution
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.metrics import percentile as _percentile
from repro_torch.obs.profiler import WallClockProfiler
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime import kv_cache as KC
from repro_torch.runtime import paging as PG
from repro_torch.runtime import spec as SP
from repro_torch.runtime.paging import BlockManager
from repro_torch.runtime.requests import Request, State, reset_for_requeue
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.scheduler import (PackedPlan, Scheduler,
                                           SchedulerConfig)


def _same_groups(a: ModelApi, b: ModelApi) -> bool:
    """Whether two ModelApis run at one tp over the same process groups:
    ``Groups`` compares only ranks and sizes, so the ``torch.distributed``
    groups themselves are compared by identity."""
    if (a.tp, a.groups) != (b.tp, b.groups):
        return False
    return a.groups is None or (a.groups.model is b.groups.model
                                and a.groups.data is b.groups.data)


@dataclasses.dataclass
class Handoff:
    """A request parked for prefill->decode migration: the request object
    plus the KV it computed, ``n_tokens`` committed context positions
    whose block payload was extracted (to the host) before the exporter
    released its references."""
    req: Request
    n_tokens: int
    payload: dict


class LatencyStats:
    """Per-request serving latencies in VIRTUAL time (runtime/server.py's
    deterministic clock) plus SLO attainment.

    ``slo_total`` counts every request whose outcome the service is
    accountable for: completions and deadline expiries.  User-initiated
    cancellations are excluded — the client walked away, the server did
    not fail it.  ``goodput`` is the SLO-attainment fraction (requests
    served within their deadline / accountable requests).

    A view over ``latency/*`` instruments in a MetricsRegistry, so a
    ``snapshot()`` and this object can never disagree."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self._ttft = self.registry.histogram("latency/ttft")
        self._tpot = self.registry.histogram("latency/tpot")
        self._e2e = self.registry.histogram("latency/e2e")
        self._slo_total = self.registry.counter("latency/slo_total")
        self._slo_met = self.registry.counter("latency/slo_met")

    ttft = property(lambda self: self._ttft.values)
    tpot = property(lambda self: self._tpot.values)
    e2e = property(lambda self: self._e2e.values)
    slo_total = property(lambda self: self._slo_total.value)
    slo_met = property(lambda self: self._slo_met.value)

    def record(self, r) -> None:
        if r.finish_reason != "cancelled":
            self._slo_total.inc()
            self._slo_met.inc(int(r.slo_ok))
        if r.ttft is not None:
            self._ttft.observe(r.ttft)
        if r.tpot is not None:
            self._tpot.observe(r.tpot)
        if r.e2e_latency is not None:
            self._e2e.observe(r.e2e_latency)

    @property
    def goodput(self) -> float:
        return self.slo_met / self.slo_total if self.slo_total else 0.0

    def percentile(self, metric: str, q: float) -> float:
        return _percentile(getattr(self, metric), q)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"goodput": self.goodput,
                                 "requests": float(self.slo_total)}
        for m in ("ttft", "tpot", "e2e"):
            for q in (0.5, 0.9, 0.99):
                out[f"{m}_p{int(q * 100)}"] = self.percentile(m, q)
        return out


class SpecStatsView:
    """``SpecStats``' API over the registry's ``spec/*`` counters."""

    def __init__(self, registry: MetricsRegistry):
        self._verify_steps = registry.counter("spec/verify_steps")
        self._draft_proposed = registry.counter("spec/draft_proposed")
        self._draft_accepted = registry.counter("spec/draft_accepted")
        self._emitted = registry.counter("spec/emitted")

    verify_steps = property(lambda self: self._verify_steps.value)
    draft_proposed = property(lambda self: self._draft_proposed.value)
    draft_accepted = property(lambda self: self._draft_accepted.value)
    emitted = property(lambda self: self._emitted.value)
    acceptance_rate = SP.SpecStats.acceptance_rate
    tokens_per_step = SP.SpecStats.tokens_per_step


class EngineStats:
    """Read view over the engine's MetricsRegistry (``engine/*``, and
    ``spec/*`` through ``spec``, ``latency/*`` through ``latency``)."""

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
        self.spec = SpecStatsView(r)
        self.latency = LatencyStats(r)

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
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, draft: Optional[SP.DraftProposer] = None,
                 seed: int = 0, *, device=None,
                 obs: Optional[TraceRecorder] = None,
                 obs_track: str = "engine",
                 profiler: Optional[WallClockProfiler] = None):
        self.device = resolve_device(device)
        if scfg.plan_path:
            # the tuned plan goes on the model's ParallelConfig before
            # anything reads it: forward dispatch and packed planner alike
            api = dataclasses.replace(api, pcfg=dataclasses.replace(
                api.pcfg, overlap_policy=load_policy(scfg.plan_path)))
        emb = params["embedding"]["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params are on {emb.device}, engine on "
                             f"{self.device}")
        local = api.comm_ctx.local_ranks
        if emb.shape[0] != local:
            raise ValueError(f"params hold {emb.shape[0]} ranks, the model "
                             f"API holds {local} of tp={api.tp}")
        if api.ep > 1:
            raise NotImplementedError(
                f"the engine serves at data size 1, not ep={api.ep}, as the "
                f"reference's engine does: it passes each step's tokens "
                f"replicated against a cache sharded over the data axis; "
                f"call ModelApi.prefill / decode_step for a data axis")
        self.api = api
        self.params = params
        self.scfg = scfg
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.metrics = MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self.metrics.gauge("engine/plan_id").set(
            getattr(api.pcfg.overlap_policy, "plan_id", 0))
        # tracing and profiling are None by default: every hook is behind
        # an ``is not None`` guard, and when on they only observe, so
        # traced or profiled runs are token- and step-identical
        self.obs = obs
        self.obs_track = obs_track
        self.profiler = profiler
        if profiler is not None:
            profiler.attach(self.metrics, trace=obs, track=obs_track,
                            device=self.device)
        self._attributor = (Attributor(api.cfg, api.pcfg, api.tp)
                            if obs is not None or profiler is not None
                            else None)
        self._step_forwards: List[WeaveAttribution] = []
        self._step_count = 0
        if api.cfg.family == "hybrid":
            raise NotImplementedError(
                "the hybrid family is served by direct ModelApi.prefill / "
                "decode_step calls, as the reference serves it: the engine "
                "cannot hold its {'mamba', 'shared'} cache")
        if api.cfg.family == "encdec":
            raise NotImplementedError(
                "the encdec family is served by direct ModelApi.prefill / "
                "decode_step calls, as the reference serves it: the engine "
                "has no frames to encode and cannot hold its {'self', "
                "'cross'} cache")
        self._is_ssm = api.cfg.family == "ssm"
        self.paged = bool(scfg.paged)
        self.packed = bool(scfg.packed)
        if self.packed:
            if self._is_ssm:
                raise ValueError("packed hybrid batching scatters per-token "
                                 "KV; ssm state has no token axis — use the "
                                 "two-dispatch path")
            if api.pcfg.seq_shard_kv:
                raise ValueError("packed steps gather full cache rows "
                                 "locally; disable seq_shard_kv")
            if not self.paged and api.cfg.sliding_window:
                raise ValueError(
                    "packed scatter into a sliding-window ring buffer could "
                    "evict keys earlier packed queries still need; use the "
                    "paged backend (full-length storage, mask-enforced "
                    "windows)")
        self.spec_gamma = int(scfg.spec_gamma)
        self.draft = None
        if self.spec_gamma:
            if self._is_ssm:
                raise ValueError("speculative decoding rolls back KV "
                                 "positions; ssm state has no token axis")
            if api.pcfg.seq_shard_kv:
                raise ValueError("speculative verify writes full KV rows "
                                 "locally; disable seq_shard_kv")
            if not self.paged and api.cfg.sliding_window:
                raise ValueError(
                    "legacy-slot sliding-window ring buffers cannot hold a "
                    "multi-token verify window (a later write could evict a "
                    "key an earlier query needs); use the paged backend")
            self.draft = draft if draft is not None else SP.make_draft(
                "ngram", self.spec_gamma, ngram=scfg.spec_ngram)
            d_api = getattr(self.draft, "api", None)
            if d_api is not None and not _same_groups(d_api, api):
                raise ValueError(
                    f"the model draft runs at tp={d_api.tp} over groups "
                    f"{d_api.groups}, the target at tp={api.tp} over "
                    f"{api.groups}: every rank must propose the same "
                    f"tokens from its own rank's draft")
            if self.draft.gamma < self.spec_gamma:
                raise ValueError(
                    f"draft gamma {self.draft.gamma} < scheduler "
                    f"spec_gamma {self.spec_gamma}")
        # one stream of draws, seeded here, feeds prefill, decode and
        # verify sampling alike; greedy steps draw nothing
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.paged and self._is_ssm:
            raise ValueError("paged KV cache requires attention layers; "
                             "ssm state caches stay on the slot path")
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
            on_admit=self._obs_admit if obs is not None else None,
            overlap_hint=self._overlap_hint if self.packed else None)
        # requests parked by ``_park_for_handoff`` wait here for the
        # cluster to migrate them
        self.handoff_ready: List[Handoff] = []
        self._stacked_payload = PG.payload_stacked(api.cfg, api.pcfg)

    # ------------------------------------------------------------------
    # per-site overlap policy
    # ------------------------------------------------------------------
    def _overlap_hint(self, tokens: int) -> TRX.WeaveInfo:
        return TRX.weave_decision_info(
            1, tokens, tp=self.api.tp, pcfg=self.api.pcfg, packed=True,
            family=self.api.cfg.family)

    def install_overlap_policy(self, policy) -> None:
        """Swap the active overlap policy; in-flight requests and caches
        are untouched (a policy only picks split points).  The attributor
        is rebuilt, so later trace spans price the new plan."""
        self.api = dataclasses.replace(
            self.api, pcfg=dataclasses.replace(self.api.pcfg,
                                               overlap_policy=policy))
        if self._attributor is not None:
            self._attributor = Attributor(self.api.cfg, self.api.pcfg,
                                          self.api.tp)
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
        if self.obs is not None:
            self.obs.request_event(req.rid, "queued")

    def _obs_admit(self, req: Request) -> None:
        """Scheduler admission hook (only wired when tracing is on)."""
        self.obs.request_event(req.rid, "admit", args={"slot": req.slot})

    def metrics_snapshot(self) -> Dict[str, float]:
        """Sync the derived gauges, then flatten the registry."""
        m = self.metrics
        st = self.stats
        m.gauge("engine/weave_rate").set(st.weave_rate)
        m.gauge("engine/tokens_per_forward").set(st.tokens_per_forward)
        for (name, lk), inst in list(m._instruments.items()):
            if name != "engine/site_forwards" or not inst.value:
                continue
            labels = dict(lk)
            w = m.get("engine/site_weave", **labels)
            m.gauge("engine/site_weave_rate", **labels).set(
                (w.value if w is not None else 0) / inst.value)
            fz = m.get("engine/site_fused", **labels)
            m.gauge("engine/site_fused_rate", **labels).set(
                (fz.value if fz is not None else 0) / inst.value)
        m.gauge("spec/acceptance_rate").set(st.spec.acceptance_rate)
        m.gauge("spec/tokens_per_step").set(st.spec.tokens_per_step)
        m.gauge("latency/goodput").set(st.latency.goodput)
        if self.block_mgr is not None:
            bs = self.block_mgr.stats
            m.gauge("paging/hit_rate").set(bs.hit_rate)
            m.gauge("paging/preemptions").set(bs.preemptions)
            m.gauge("paging/evictions").set(bs.evictions)
        return m.snapshot()

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
        if self.obs is not None:
            self.obs.request_event(
                req.rid, "expire" if reason == "expired" else "cancel",
                args={"reason": reason})
        if req.state == State.WAITING:
            # not admitted: no slot and no blocks (a preempted request
            # freed its own)
            self.sched.remove_waiting(req)
            req.state = State.DONE
            return True
        if req.slot is None:
            # parked for handoff: the exporter already released its blocks
            # and slot; only the handoff queue holds it
            self.handoff_ready = [h for h in self.handoff_ready
                                  if h.req is not req]
            req.state = State.DONE
            return True
        if self.paged:
            # cached blocks park in the LRU, still hittable
            self.block_mgr.free_request(req.rid)
        elif not self._is_ssm:
            KC.reset_slots(self.cache, [req.slot])
        self.sched.active[req.slot] = None
        req.slot = None
        req.state = State.DONE
        return True

    # ------------------------------------------------------------------
    # disaggregated prefill/decode KV handoff (runtime/cluster.py)
    # ------------------------------------------------------------------
    def _park_for_handoff(self, r: Request):
        """Export the request's KV and detach it from this engine: the
        payload is copied to the host (the migration's network copy), then
        every exporter-side reference is released (shared prefix blocks
        keep their other readers, private ones recycle) and the slot frees
        for the next prefill.  The request (DECODE, its first token
        committed) waits in ``handoff_ready``."""
        if not self.paged:
            raise ValueError("KV handoff requires the paged backend "
                             "(legacy slot rows cannot be exported)")
        n_tokens = r.prefill_pos          # committed context now in cache
        blocks = self.block_mgr.export_blocks(r.rid, n_tokens)
        payload = PG.extract_blocks(self.cache, blocks,
                                    stacked=self._stacked_payload)
        self.block_mgr.free_request(r.rid)
        self.sched.active[r.slot] = None
        r.slot = None
        self.handoff_ready.append(Handoff(req=r, n_tokens=n_tokens,
                                          payload=payload))
        if self.obs is not None:
            self.obs.request_event(r.rid, "handoff_export",
                                   args={"n_tokens": n_tokens})

    def take_handoffs(self) -> List[Handoff]:
        out, self.handoff_ready = self.handoff_ready, []
        return out

    def evacuate(self) -> List[Request]:
        """Dead-replica recovery: release every resource of every live
        request this engine owns (paged blocks with their prefix-shared
        references, legacy slots, parked handoffs, scheduler entries) and
        return the requests reset for re-admission elsewhere (WAITING,
        recompute semantics like preemption).  Sweeping the pool back to
        empty is what makes a requeue that skips the release visible to
        ``ClusterServer.check_quiescent``."""
        out: List[Request] = []
        for h in self.take_handoffs():
            # exporter-side references were released at park
            out.append(reset_for_requeue(h.req))
        for r in list(self.sched.waiting):
            self.sched.remove_waiting(r)
            out.append(reset_for_requeue(r))
        for slot, r in enumerate(self.sched.active):
            if r is None:
                continue
            if self.paged:
                self.block_mgr.free_request(r.rid)
            elif not self._is_ssm:
                KC.reset_slots(self.cache, [r.slot])
            self.sched.active[slot] = None
            out.append(reset_for_requeue(r))
        return out

    def adopt_request(self, req: Request, n_tokens: int, payload) -> bool:
        """Adopt a migrated DECODE request: rebuild its block table here
        (sharing this pool's prefix-cache hits, implanting the payload into
        the rest), re-register its prefix-cache entries and place it in a
        free slot; decoding resumes from the migrated KV.  Returns False
        (nothing changed, retry later) when no slot is free or the pool
        cannot cover it."""
        if not self.paged:
            raise ValueError("adopt_request requires the paged backend")
        if req.state != State.DECODE:
            raise ValueError(f"rid={req.rid} is {req.state}, not DECODE")
        free = [i for i, r in enumerate(self.sched.active) if r is None]
        if not free:
            return False
        ctx = req.prompt + req.output[:-1]
        assert n_tokens <= len(ctx), (req.rid, n_tokens, len(ctx))
        imported = self.block_mgr.import_blocks(req.rid, ctx[:n_tokens],
                                                n_tokens)
        if imported is None:
            return False
        table, copy_idx = imported
        # drain queued pool maintenance first: a freshly allocated table
        # entry may still carry a pending pos reset from its previous
        # owner, which would clobber the implant if applied after it
        self._apply_fixups()
        if copy_idx:
            PG.implant_blocks(self.cache, PG.select_payload(payload, copy_idx),
                              [table[i] for i in copy_idx])
        self.block_mgr.register_filled(req.rid, ctx, n_tokens)
        req.handoff_after_prefill = False
        req.migrations += 1
        req.slot = free[0]
        req.arrival_step = self._step_count
        self.sched.active[req.slot] = req
        if self.obs is not None:
            self.obs.request_event(req.rid, "handoff_adopt",
                                   args={"slot": req.slot})
        return True

    def step(self) -> bool:
        """Run one engine iteration.  Returns False when idle."""
        obs = self.obs
        if obs is not None:
            # offline engines self-clock one tick per step (a no-op once
            # the server has synced), stamped before next_step() so
            # admission events land at step time
            obs.auto(float(self._step_count))
            self._step_forwards = []
        plan = self.sched.next_step()
        if plan is None:
            return False
        self._step_count += 1
        self.stats._steps.inc()
        packed = isinstance(plan, PackedPlan)
        with torch.no_grad():
            if packed:
                self._run_packed(plan)
            else:
                if plan.prefill is not None:
                    self._run_prefill(*plan.prefill)
                if plan.decode_slots:
                    if self.spec_gamma:
                        self._run_verify()
                    else:
                        self._run_decode()
        if obs is not None:
            self._obs_emit_step(packed=packed)
        return True

    def _obs_emit_step(self, packed: bool) -> None:
        """Emit this iteration's step span plus one nested forward span
        per model dispatch, carrying the weave attribution record.  All
        spans start at the step's clock stamp with sim-roofline
        durations; the step span covers its longest forward, so nesting
        holds however far the owner clock advances."""
        obs = self.obs
        fwds = self._step_forwards
        t0 = obs.now
        durs = [max(a.est_makespan, 1e-9) for a in fwds]
        obs.complete(self.obs_track,
                     "step/packed" if packed else "step/two_dispatch",
                     t0, max(durs, default=1e-9), cat="step",
                     args={"step": self._step_count, "forwards": len(fwds)})
        for a, d in zip(fwds, durs):
            args = a.args()
            args["step"] = self._step_count
            obs.complete(self.obs_track, f"forward/{a.kind}", t0, d,
                         cat="forward", args=args)
        self._step_forwards = []

    def _prof_wrap(self, fn: Callable) -> Callable:
        """Fenced wall-clock timing around one dispatch when a
        ``WallClockProfiler`` is attached; identity otherwise."""
        return fn if self.profiler is None else self.profiler.wrap(fn)

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
                      decode: bool = False, packed: bool = False,
                      kind: str = "prefill"):
        """Record one model dispatch: its (b, s) shape decides the weave,
        its real token count feeds tokens/forward.  The same decision
        object feeds the counters and, when tracing or profiling, the
        attribution record, so trace-derived weave rates equal
        ``EngineStats.weave_rate``."""
        st = self.stats
        st._forwards.inc()
        st._forward_tokens.inc(n_real)
        st._max_forward_tokens.set_max(n_real)
        info = TRX.weave_decision_info(b, s, tp=self.api.tp,
                                       pcfg=self.api.pcfg, decode=decode,
                                       packed=packed,
                                       paged_pool=self.paged and decode,
                                       family=self.api.cfg.family)
        site = info.site or kind
        self.metrics.counter("engine/site_forwards", site=site).inc()
        if info.weave:
            st._weave_forwards.inc()
            self.metrics.counter("engine/site_weave", site=site).inc()
        if info.comm_mode == "ring":
            # a tuned plan sent this site to the fused kernel (K1)
            self.metrics.counter("engine/site_fused", site=site).inc()
        if self._attributor is not None:
            att = self._attributor.attribute(info, b=b, s=s, n_real=n_real,
                                             kind=kind)
            if self.obs is not None:
                self._step_forwards.append(att)
            if self.profiler is not None:
                # join the timing _prof_wrap stashed for this dispatch
                self.profiler.commit(att)

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
        if self.obs is not None:
            self.obs.request_event(victim.rid, "preempt")

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
    # sampling and verification: one copy to the host per step
    # ------------------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        """Each row's token id from (R, B, 1, V_loc) logits."""
        return sample(logits, vocab_size=self.api.cfg.vocab_size,
                      temperature=self.temperature, top_k=self.top_k,
                      top_p=self.top_p, generator=self.generator,
                      ctx=self.api.comm_ctx).cpu().numpy()

    def _verify(self, logits, draft: np.ndarray):
        """(n_acc, emit) per row from (R, B, gamma+1, V_loc) logits and
        the (B, gamma) drafts, -1 = none."""
        n_acc, emit = SP.verify_tokens(
            logits, torch.from_numpy(draft), self.generator,
            vocab_size=self.api.cfg.vocab_size, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, ctx=self.api.comm_ctx)
        out = torch.stack([n_acc, emit.long()]).cpu().numpy()
        return out[0], out[1]

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
            if r.resumed:
                r.resumed = False
            else:
                r.output.append(tok)
                r.first_token_step = self._step_count
            r.state = State.DECODE
            if self.obs is not None:
                self.obs.request_event(r.rid, "prefill_done",
                                       args={"tokens": r.prefill_pos})
            self._maybe_finish(r)
            if r.state != State.DONE and r.handoff_after_prefill:
                self._park_for_handoff(r)

    def _commit_decode(self, r: Request, tok: int):
        n_written = r.length  # positions [0, length-1] now in cache
        r.output.append(tok)
        self.stats._decode_tokens.inc()
        if self.paged and n_written % self.scfg.block_size == 0:
            # a block just filled: make it hittable for future prompts
            self.block_mgr.register_filled(
                r.rid, r.prompt + r.output[:-1], n_written)
        self._maybe_finish(r)

    def _commit_verify(self, r: Request, prop: List[int], n_acc: int,
                       emit: int):
        """Commit the longest accepted draft prefix + the corrected/bonus
        token and roll back rejected KV (paged: block-table truncation,
        then only blocks holding committed tokens are registered; slots
        need none by the overwrite-before-query invariant)."""
        n = min(n_acc, len(prop))
        base_len = r.length          # L: the window wrote L-1 .. L-1+|prop|
        r.output.extend(prop[:n] + [emit])
        st = self.stats.spec
        st._draft_proposed.inc(len(prop))
        st._draft_accepted.inc(n)
        st._emitted.inc(n + 1)
        self.stats._decode_tokens.inc(n + 1)
        if self.paged:
            self.block_mgr.truncate(r.rid, base_len + n)
            self.block_mgr.register_filled(
                r.rid, r.prompt + r.output[:-1], base_len + n)
        self._maybe_finish(r)

    # ------------------------------------------------------------------
    # two-dispatch
    # ------------------------------------------------------------------
    def _run_prefill(self, group: List[Request], chunk: int):
        b_sel = len(group)
        if self._is_ssm:
            # ssm chunks must be exact (no pads): shrink to min remainder
            chunk = min(min(len(r.context_tokens) - r.prefill_pos
                            for r in group), chunk)
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

        def dispatch():
            if self.paged:
                # attended as prefix: the blocks written before this chunk
                # (the rest of each table holds unwritten cells, pos -1)
                width = max([self.block_mgr.blocks_needed(int(o))
                             for o in offsets] + [1])
                rows = PG.gather_block_rows(self.cache,
                                            self._tensor(bt[:, :width]))
            else:
                slot_ids = self._tensor(np.array([r.slot for r in group],
                                                 np.int64))
                rows = (KC.gather_state_rows(self.cache, slot_ids,
                                             fresh=self._tensor(offsets == 0))
                        if self._is_ssm else
                        KC.gather_slots(self.cache, slot_ids))
            logits, kv = self.api.prefill(
                self.params, self._tensor(tokens), rows,
                self._tensor(positions), last_idx=self._tensor(last_idx))
            if self._is_ssm:
                KC.scatter_state_rows(self.cache, slot_ids, kv)
            elif self.paged:
                PG.insert_chunk_paged(self.cache, kv, torch.from_numpy(bt),
                                      positions=torch.from_numpy(positions))
            else:
                KC.insert_chunk(self.cache, kv, self._tensor(offsets),
                                slot_ids)
            return self._sample(logits)
        tok = self._prof_wrap(dispatch)()
        n_real = int((positions >= 0).sum())
        self.stats._prefill_tokens.inc(n_real)
        self._note_forward(b_sel, chunk, n_real, kind="prefill")
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
        def dispatch():
            if self.paged:
                logits, self.cache = self.api.decode_step(
                    self.params, self._tensor(tokens), self.cache,
                    torch.from_numpy(positions),
                    block_tables=torch.from_numpy(self._tables(bmax, reqs)))
            else:
                logits, self.cache = self.api.decode_step(
                    self.params, self._tensor(tokens), self.cache,
                    self._tensor(positions))
            return self._sample(logits)
        tok = self._prof_wrap(dispatch)()
        self._note_forward(bmax, 1, len(reqs), decode=True, kind="decode")
        for r in list(reqs):
            self._commit_decode(r, int(tok[r.slot]))

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _grow_for_draft(self, r: Request, want: int) -> int:
        """Grow the paged blocks for the draft positions ``length ..
        length-1+want`` as far as the pool allows; a draft that cannot
        grow is shrunk (draft tokens are optional), no peer preempted.
        Returns the number of draft tokens whose cell is writable."""
        for j in range(1, want + 1):
            if not self.block_mgr.ensure_writable(r.rid, r.length - 1 + j):
                return j - 1
        return want

    def _capped_drafts(self, reqs: List[Request]) -> Dict[int, List[int]]:
        """Draft proposals for these DECODE requests, capped so the window
        never overshoots max_new_tokens (a verify always commits one
        extra token) or the cache ceiling, and shrunk to the paged blocks
        that can grow.  Shared by both dispatch schemes."""
        props = self.draft.propose([r.prompt + r.output for r in reqs])
        capped: Dict[int, List[int]] = {}
        for r, prop in zip(reqs, props):
            cap = min(self.spec_gamma, r.max_new_tokens - len(r.output) - 1,
                      self.scfg.max_len - r.length)
            prop = [int(t) for t in prop[:max(cap, 0)]]
            if self.paged and prop:
                prop = prop[:self._grow_for_draft(r, len(prop))]
            capped[r.rid] = prop
        return capped

    def _run_verify(self):
        """One speculative iteration over every DECODE request: draft,
        ONE (max_batch, gamma+1) verify forward, commit the accepted
        prefix + 1 token per request, roll back the rest."""
        gamma = self.spec_gamma
        if self.paged:
            reqs = self._ensure_decode_blocks()   # the input cell is due
        else:
            reqs = [r for r in self.sched.active
                    if r is not None and r.state == State.DECODE]
        if not reqs:
            return
        capped = self._capped_drafts(reqs)
        if not any(capped.values()):
            # nothing drafted: a gamma+1-wide window would pay (gamma+1)x
            # decode compute for one token per request
            self._run_decode()
            return
        if self.paged:
            self._apply_fixups()

        bmax = self.scfg.max_batch
        s_v = gamma + 1
        tokens = np.zeros((bmax, s_v), np.int64)
        positions = np.full((bmax, s_v), -1, np.int32)
        draft = np.full((bmax, gamma), -1, np.int64)
        for r in reqs:
            prop = capped[r.rid]
            tokens[r.slot, 0] = r.output[-1]
            positions[r.slot, 0] = r.length - 1
            tokens[r.slot, 1:1 + len(prop)] = prop
            positions[r.slot, 1:1 + len(prop)] = np.arange(
                r.length, r.length + len(prop))
            draft[r.slot, :len(prop)] = prop
        kw = {}
        if self.paged:
            kw["block_tables"] = torch.from_numpy(self._tables(bmax, reqs))

        def dispatch():
            logits, self.cache = self.api.verify_step(
                self.params, self._tensor(tokens), self.cache,
                torch.from_numpy(positions), **kw)
            return self._verify(logits, draft)
        n_acc, emit = self._prof_wrap(dispatch)()
        self._note_forward(bmax, s_v,
                           sum(1 + len(capped[r.rid]) for r in reqs),
                           decode=True, kind="verify")
        self.stats.spec._verify_steps.inc()
        for r in list(reqs):
            self._commit_verify(r, capped[r.rid], int(n_acc[r.slot]),
                                int(emit[r.slot]))

    # ------------------------------------------------------------------
    # packed hybrid batching
    # ------------------------------------------------------------------
    def _run_packed(self, plan: PackedPlan):
        """ONE forward for the whole iteration: prefill segments, decode
        slots and verify windows concatenated along a (1, T) token axis
        (T padded to lcm(prefill_bucket, tp)) through
        ``ModelApi.packed_step``; then one sample per segment, or with
        speculation one verification over (max_batch, gamma+1) windows
        whose (n_acc, emit) commit every kind of segment (a row with no
        draft verifies to the plain sample of its window row 0)."""
        gamma = self.spec_gamma
        w = gamma + 1 if gamma else 1
        if self.paged:
            # grow/COW the decode write cells first; this can preempt or
            # ceiling-finish DECODE requests, so re-filter the plan
            self._ensure_decode_blocks()
        segs = [s for s in plan.segments
                if s.req.state == (State.PREFILL if s.kind == "prefill"
                                   else State.DECODE)]
        if not segs:
            return
        props: Dict[int, List[int]] = {}
        vreqs = [s.req for s in segs if s.kind == "verify"]
        if vreqs:
            props = self._capped_drafts(vreqs)
        if self.paged:
            self._apply_fixups()

        def seg_len(s):
            if s.kind == "prefill":
                return s.n_tokens
            return 1 + len(props.get(s.req.rid, ()))

        t_real = sum(seg_len(s) for s in segs)
        t = pad_to_multiple(t_real, math.lcm(self.scfg.prefill_bucket,
                                             self.api.tp))
        bmax = self.scfg.max_batch
        tokens = np.zeros((1, t), np.int64)
        positions = np.full((1, t), -1, np.int32)
        seg_slots = np.full(t, -1, np.int32)
        sample_idx = np.full((bmax, w), -1, np.int32)
        draft = np.full((bmax, gamma), -1, np.int64)
        cur = 0
        for s in segs:
            r, m = s.req, s.req.slot
            if s.kind == "prefill":
                take = s.n_tokens
                tokens[0, cur:cur + take] = \
                    r.context_tokens[r.prefill_pos:r.prefill_pos + take]
                positions[0, cur:cur + take] = np.arange(
                    r.prefill_pos, r.prefill_pos + take)
                sample_idx[m, 0] = cur + take - 1
                r.prefill_pos += take
            else:
                # the pending input at L-1, then the draft at L, L+1, ..
                prop = props.get(r.rid, [])
                take = 1 + len(prop)
                tokens[0, cur] = r.output[-1]
                tokens[0, cur + 1:cur + take] = prop
                positions[0, cur:cur + take] = np.arange(
                    r.length - 1, r.length - 1 + take)
                sample_idx[m, :take] = np.arange(cur, cur + take)
                draft[m, :len(prop)] = prop
            seg_slots[cur:cur + take] = m
            cur += take

        kw = {}
        if self.paged:
            kw["block_tables"] = torch.from_numpy(
                self._tables(bmax, [s.req for s in segs]))
        def dispatch():
            logits, self.cache = self.api.packed_step(
                self.params, self._tensor(tokens), self.cache,
                torch.from_numpy(positions),
                seg_slots=torch.from_numpy(seg_slots),
                sample_idx=torch.from_numpy(sample_idx), **kw)
            if w > 1:
                return self._verify(logits, draft)
            return None, self._sample(logits)
        n_acc, emit = self._prof_wrap(dispatch)()
        self._note_forward(1, t, t_real, packed=True, kind="packed")
        if vreqs:
            self.stats.spec._verify_steps.inc()
        for s in segs:
            r = s.req
            if s.kind == "prefill":
                self.stats._prefill_tokens.inc(s.n_tokens)
                self._commit_prefill(r, int(emit[r.slot]))
            elif s.kind == "decode":
                self._commit_decode(r, int(emit[r.slot]))
            else:
                self._commit_verify(r, props.get(r.rid, []),
                                    int(n_acc[r.slot]), int(emit[r.slot]))

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
        elif not self._is_ssm:
            # stale positions of a finished request must not leak into
            # the slot's next owner (ssm: the next prefill zeroes its row)
            KC.reset_slots(self.cache, [r.slot])
        r.finish_reason = r.finish_reason or "stop"
        self.sched.finish(r, self._step_count)
        self.stats._completed.inc()
        if self.obs is not None:
            self.obs.request_event(r.rid, "finish",
                                   args={"reason": r.finish_reason,
                                         "tokens": len(r.output)})
