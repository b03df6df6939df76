"""Continuous-batching inference engine, the legacy-slot two-dispatch
subset of ``repro.runtime.engine``.

Per iteration: one decode step over ALL cache slots (inactive slots are
masked via position -1) and/or one rectangular prefill chunk for a group of
admitted requests (Sarathi-style chunked prefill, lengths bucketed by the
scheduler).  TokenWeave activates inside the model whenever a dispatch
crosses ``tokenweave_min_tokens``.  Slots are invalidated on finish so
stale positions never leak into a reused slot.

Not ported yet, and refused with NotImplementedError when requested: the
paged pool, packed hybrid batching, speculative decoding, tuned overlap
plans, stochastic sampling, abort/evacuate/handoff, and tracing or
profiling hooks (ROADMAP.md).

The engine serves at ``api.tp``: the tp ranks sit on the rank axis of
one device (``distributed/context.py``), and the params must carry that
axis.  It runs on CUDA unless it is given ``device="cpu"``; with no device
and no CUDA it raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as TRX
from repro_torch.models.build import ModelApi
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import kv_cache as KC
from repro_torch.runtime.requests import Request, State
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.scheduler import Scheduler, SchedulerConfig


class EngineStats:
    """Read view over the engine's MetricsRegistry (``engine/*``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._steps = r.counter("engine/steps")
        self._prefill_tokens = r.counter("engine/prefill_tokens")
        self._decode_tokens = r.counter("engine/decode_tokens")
        self._completed = r.counter("engine/completed")
        self._forwards = r.counter("engine/forwards")
        self._weave_forwards = r.counter("engine/weave_forwards")
        self._forward_tokens = r.counter("engine/forward_tokens")
        self._max_forward_tokens = r.gauge("engine/max_forward_tokens")

    steps = property(lambda self: self._steps.value)
    prefill_tokens = property(lambda self: self._prefill_tokens.value)
    decode_tokens = property(lambda self: self._decode_tokens.value)
    completed = property(lambda self: self._completed.value)
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
        for what, asked in (("paged KV cache", scfg.paged),
                            ("packed hybrid batching", scfg.packed),
                            ("speculative decoding", scfg.spec_gamma),
                            ("tuned overlap plans", scfg.plan_path),
                            ("stochastic sampling", temperature > 0.0),
                            ("tracing", obs is not None),
                            ("profiling", profiler is not None)):
            if asked:
                raise NotImplementedError(f"{what} is not ported yet "
                                          f"(ROADMAP.md)")
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
        self._step_count = 0
        self.cache = api.init_cache(scfg.max_batch, scfg.max_len,
                                    device=self.device)
        self.sched = Scheduler(scfg)

    # ------------------------------------------------------------------
    def add_request(self, req: Request):
        if len(req.prompt) + 1 > self.scfg.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} + 1 exceeds max_len "
                f"{self.scfg.max_len} (rid={req.rid})")
        req.arrival_step = self._step_count
        self.sched.add(req)

    def abort(self, req: Request, reason: str = "cancelled") -> bool:
        raise NotImplementedError("abort is not ported yet (ROADMAP.md A6)")

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
            if plan.prefill is not None:
                self._run_prefill(*plan.prefill)
            if plan.decode_slots:
                self._run_decode()
        return True

    def run(self, max_steps: int = 100000) -> List[Request]:
        while not self.sched.all_done() and max_steps > 0:
            max_steps -= 1
            if not self.step():
                break
        return self.sched.finished

    def _note_forward(self, b: int, s: int, n_real: int, *,
                      decode: bool = False):
        """Record one model dispatch: its (b, s) shape decides the weave,
        its real token count feeds tokens/forward."""
        st = self.stats
        st._forwards.inc()
        st._forward_tokens.inc(n_real)
        st._max_forward_tokens.set_max(n_real)
        info = TRX.weave_decision_info(b, s, tp=self.api.tp,
                                       pcfg=self.api.pcfg, decode=decode,
                                       family=self.api.cfg.family)
        self.metrics.counter("engine/site_forwards", site=info.site).inc()
        if info.weave:
            st._weave_forwards.inc()
            self.metrics.counter("engine/site_weave", site=info.site).inc()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    def _commit_prefill(self, r: Request, tok: int):
        """After a chunk advanced ``r.prefill_pos``: when the context is
        complete, commit the first sampled token and move to DECODE."""
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
        r.output.append(tok)
        self.stats._decode_tokens.inc()
        self._maybe_finish(r)

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

        slot_ids = self._tensor(np.array([r.slot for r in group], np.int64))
        rows = KC.gather_slots(self.cache, slot_ids)
        logits, kv = self.api.prefill(
            self.params, self._tensor(tokens), rows, self._tensor(positions),
            last_idx=self._tensor(last_idx))
        KC.insert_chunk(self.cache, kv, self._tensor(offsets), slot_ids)
        tok = sample(logits, vocab_size=self.api.cfg.vocab_size,
                     temperature=self.temperature).cpu().numpy()
        n_real = int((positions >= 0).sum())
        self.stats._prefill_tokens.inc(n_real)
        self._note_forward(b_sel, chunk, n_real)
        for i, r in enumerate(group):
            self._commit_prefill(r, int(tok[i]))

    def _run_decode(self):
        reqs = [r for r in self.sched.active
                if r is not None and r.state == State.DECODE]
        bmax = self.scfg.max_batch
        tokens = np.zeros((bmax, 1), np.int64)
        positions = np.full((bmax, 1), -1, np.int32)
        for r in reqs:
            tokens[r.slot, 0] = r.output[-1]
            positions[r.slot, 0] = r.length - 1
        logits, self.cache = self.api.decode_step(
            self.params, self._tensor(tokens), self.cache,
            self._tensor(positions))
        tok = sample(logits, vocab_size=self.api.cfg.vocab_size,
                     temperature=self.temperature).cpu().numpy()
        self._note_forward(bmax, 1, len(reqs), decode=True)
        for r in list(reqs):
            self._commit_decode(r, int(tok[r.slot]))

    def _maybe_finish(self, r: Request):
        if len(r.output) >= r.max_new_tokens:
            self._finish(r)

    def _finish(self, r: Request):
        # stale positions of a finished request must not leak into the
        # slot's next owner
        KC.reset_slots(self.cache, [r.slot])
        r.finish_reason = r.finish_reason or "stop"
        self.sched.finish(r, self._step_count)
        self.stats._completed.inc()
