"""Online serving frontend (DESIGN.md §10), as ``repro.runtime.server``:
continuous batching with arrival-aware admission on top of the offline
``Engine``.

The offline engine drains a queue that exists in full before ``run()``;
live serving has none of that — requests ARRIVE, stream their tokens out,
get cancelled, and carry deadlines.  ``OnlineServer`` adds exactly that
layer while keeping every engine iteration bit-identical to the offline
path, so the paper-level guarantee transfers: on the same trace, online
greedy output is token-identical to offline greedy output (pinned by
tests/test_torch_server.py, and on the card by chip_smoke.py's online
phase).

Determinism: time is VIRTUAL.  The clock advances by a configurable cost
per engine step (``StepCost``: base + per-token), requests are admitted
when ``arrival_time <= clock``, and the clock jumps to the next arrival
when the engine goes idle.  No wall clock enters any metric, so TTFT /
TPOT / e2e percentiles and goodput (``EngineStats.latency``) are exact,
replayable counters.  ``StepCost.from_calibration`` grounds the clock in
the card's measured forwards: one virtual tick per wall second.

Lifecycle events between steps (engine steps are atomic):

* admission   — pending requests whose arrival_time has passed enter the
                engine's scheduler (policy-ordered: FCFS or EDF).
* streaming   — tokens committed by the step are pushed through the
                per-request ``on_token`` callback, stamped with the
                post-step virtual time (first token stamps TTFT).
* cancellation — ``cancel(rid, at=...)`` schedules a client disconnect;
                the engine releases the slot / paged blocks / prefix-cache
                refs via ``Engine.abort`` (mid-prefill and mid-verify
                cancels are exercised in tests/test_torch_server.py).
* deadline    — a request past its ``deadline`` is expired (when
                ``expire_on_deadline``) or allowed to finish late; either
                way it counts against goodput, never as a server failure.

Scaling past one engine is the cluster layer's job: runtime/cluster.py
runs N engines on the same virtual-clock axis behind a router, reusing
``StepCost`` for per-replica step timing; runtime/http_api.py serves one
``OnlineServer`` over HTTP.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.policy import load_policy
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request, State

# on_token(request, token_id, virtual_time)
TokenCallback = Callable[[Request, int, float], None]


@dataclasses.dataclass
class StepCost:
    """Virtual duration of one engine iteration.  ``per_token`` makes the
    clock load-dependent (heavier packed iterations take longer), which is
    what shifts TTFT/TPOT and the weave rate with offered load; the
    default is one tick per step."""
    base: float = 1.0
    per_token: float = 0.0

    def of(self, n_forward_tokens: int) -> float:
        return self.base + self.per_token * n_forward_tokens

    @classmethod
    def from_calibration(cls, cal) -> "StepCost":
        """Measured-grounded virtual clock (DESIGN.md §13): ``base`` /
        ``per_token`` come from the dispatch-granularity linear fit of
        measured wall seconds vs real tokens in a ``CalibrationReport``
        (analysis/calibration.py) — one virtual tick per wall second."""
        def get(key):
            return cal[key] if isinstance(cal, dict) else getattr(cal, key)
        return cls(base=float(get("step_base")),
                   per_token=float(get("step_per_token")))


@dataclasses.dataclass
class ServerConfig:
    step_cost: StepCost = dataclasses.field(default_factory=StepCost)
    # abort past-deadline requests (releasing their resources) instead of
    # letting them finish late; both outcomes count against goodput
    expire_on_deadline: bool = False
    max_steps: int = 1_000_000
    # tuned overlap-plan cache to install on the engine at server startup
    # (core/policy.py, DESIGN.md §14); None keeps the engine's own policy
    plan_path: Optional[str] = None


class OnlineServer:
    """Arrival-aware serving loop over one ``Engine``.

    Usage::

        srv = OnlineServer(engine)
        for r in poisson_arrivals(trace, rate=0.5, seed=0):
            srv.submit(r, on_token=stream_fn)
        srv.cancel(rid=3, at=17.0)          # optional client disconnect
        done = srv.run()                     # completed requests
        stats = engine.stats.latency.summary()
    """

    def __init__(self, engine: Engine, cfg: Optional[ServerConfig] = None):
        self.engine = engine
        self.cfg = cfg or ServerConfig()
        if self.cfg.plan_path:
            # serving deployments ship a tuned per-site overlap plan
            # (DESIGN.md §14); installed before the first step so every
            # dispatch and the packed planner see it
            engine.install_overlap_policy(load_policy(self.cfg.plan_path))
        self.clock = 0.0
        self.requests: List[Request] = []           # every submit, any fate
        self.completed: List[Request] = []
        self.aborted: List[Request] = []            # cancelled + expired
        self._pending: List[Tuple[float, int, Request]] = []  # sorted
        self._cancels: List[Tuple[float, int]] = []  # (time, rid), sorted
        self._by_rid: Dict[int, Request] = {}
        self._emitted: Dict[int, int] = {}          # rid -> tokens streamed
        self._callbacks: Dict[int, TokenCallback] = {}
        self._finished_cursor = 0   # scan sched.finished incrementally

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, req: Request,
               on_token: Optional[TokenCallback] = None) -> None:
        if req.rid in self._by_rid:
            raise ValueError(f"duplicate rid {req.rid}")
        if req.arrival_time < self.clock:
            raise ValueError(
                f"request {req.rid} arrives at {req.arrival_time} but the "
                f"clock is already at {self.clock}")
        self.requests.append(req)
        self._by_rid[req.rid] = req
        self._emitted[req.rid] = 0
        if on_token is not None:
            self._callbacks[req.rid] = on_token
        bisect.insort(self._pending, (req.arrival_time, req.rid, req))

    def cancel(self, rid: int, at: Optional[float] = None) -> None:
        """Schedule a client disconnect at virtual time ``at`` (default:
        the current clock — processed before the next step)."""
        if rid not in self._by_rid:
            raise ValueError(f"unknown rid {rid}")
        t = self.clock if at is None else at
        if t < self.clock:
            raise ValueError(f"cancel time {t} is in the past "
                             f"(clock {self.clock})")
        bisect.insort(self._cancels, (t, rid))

    # ------------------------------------------------------------------
    # event processing (between engine steps)
    # ------------------------------------------------------------------
    def _admit_arrivals(self) -> None:
        while self._pending and self._pending[0][0] <= self.clock:
            _, _, req = self._pending.pop(0)
            req.admit_time = self.clock   # entered the engine queue
            if self.engine.obs is not None:
                # stamped at the true arrival instant (<= clock), BEFORE
                # the engine's "queued" event for this rid; requests
                # cancelled pre-arrival never reach here, so their
                # lifecycle thread starts at the cancel itself
                self.engine.obs.request_event(
                    req.rid, "arrival", ts=req.arrival_time,
                    args={"deadline": req.deadline})
            self.engine.add_request(req)

    def _process_cancels(self) -> None:
        while self._cancels and self._cancels[0][0] <= self.clock:
            _, rid = self._cancels.pop(0)
            req = self._by_rid[rid]
            if req.state == State.DONE:
                continue                  # finished before the disconnect
            self._retire(req, "cancelled")

    def _expire_deadlines(self) -> None:
        if not self.cfg.expire_on_deadline:
            return    # let late requests finish; slo_ok still marks them
        for req in list(self.engine.sched.active) + self.engine.sched.waiting:
            if req is None or req.deadline is None:
                continue
            if req.state != State.DONE and self.clock >= req.deadline:
                self._retire(req, "expired")
        # not-yet-arrived requests cannot expire: deadlines are e2e SLOs
        # measured from arrival, so arrival_time < deadline by construction

    def _retire(self, req: Request, reason: str) -> None:
        if any(r is req for _, _, r in self._pending):
            # cancelled before it even arrived: never reaches the engine,
            # and never served — no latencies to record (its clock-now
            # "finish" precedes its arrival, which would poison the e2e
            # percentiles the CI gate consumes)
            self._pending = [(t, rid, r) for t, rid, r in self._pending
                             if r is not req]
            req.state = State.DONE
            req.finish_reason = reason
            if reason == "expired":
                self.engine.stats._expired.inc()
            else:
                self.engine.stats._cancelled.inc()
            if self.engine.obs is not None:
                # the engine never saw this request, so its abort-path
                # terminal event cannot fire — emit it here
                self.engine.obs.request_event(
                    req.rid, "expire" if reason == "expired" else "cancel",
                    args={"reason": reason, "pre_arrival": True})
            self.aborted.append(req)
            return
        self.engine.abort(req, reason)
        req.finish_time = self.clock
        self.aborted.append(req)
        self.engine.stats.latency.record(req)

    def _stream_new_tokens(self) -> None:
        """Push tokens committed by the last step (or, after an idle jump,
        nothing) through callbacks; stamp TTFT/finish on the way.  Only
        the active slots and requests finished SINCE the last step are
        scanned (a finished request never produces tokens again), keeping
        the per-step host work flat in trace length."""
        new_finished = self.engine.sched.finished[self._finished_cursor:]
        for req in self.engine.sched.active + new_finished:
            if req is None or req.rid not in self._emitted:
                continue
            seen = self._emitted[req.rid]
            new = req.output[seen:]
            if not new:
                continue
            if seen == 0 and req.first_token_time is None:
                req.first_token_time = self.clock
            cb = self._callbacks.get(req.rid)
            if cb is not None:
                for tok in new:
                    cb(req, tok, self.clock)
            self._emitted[req.rid] = len(req.output)

    def _collect_finished(self) -> None:
        fin = self.engine.sched.finished
        for req in fin[self._finished_cursor:]:
            if req.finish_time is None and req.rid in self._by_rid:
                req.finish_time = self.clock
                self.completed.append(req)
                self.engine.stats.latency.record(req)
        self._finished_cursor = len(fin)

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def _next_event_time(self) -> Optional[float]:
        times = []
        if self._pending:
            times.append(self._pending[0][0])
        if self._cancels:
            times.append(self._cancels[0][0])
        return min(times) if times else None

    def pump(self, max_steps: Optional[int] = None) -> int:
        """Live-serving drain (for an HTTP front end, DESIGN.md §15):
        process every due cancel/expiry/arrival and step the engine until
        it goes idle (or ``max_steps`` iterations), then RETURN instead of
        blocking — unlike ``run()``, new submissions may land between
        pumps, so going idle is not the end of the world.  Streaming,
        latency stamping and the unservable-request guard are identical
        to ``run()``; returns the number of engine steps taken."""
        eng = self.engine
        steps = 0
        while True:
            if eng.obs is not None:
                eng.obs.sync(self.clock)
            self._process_cancels()
            self._expire_deadlines()
            self._admit_arrivals()
            tokens_before = eng.stats.forward_tokens
            if not eng.step():
                nxt = self._next_event_time()
                if nxt is not None:
                    # a future-scheduled cancel/arrival: jump like run()
                    self.clock = max(self.clock, nxt)
                    continue
                if eng.sched.waiting:
                    rids = [r.rid for r in eng.sched.waiting]
                    raise RuntimeError(
                        f"server idle with unservable waiting request(s) "
                        f"{rids}: block pool too small for their context")
                return steps
            steps += 1
            self.clock += self.cfg.step_cost.of(
                eng.stats.forward_tokens - tokens_before)
            self._stream_new_tokens()
            self._collect_finished()
            if max_steps is not None and steps >= max_steps:
                return steps

    def run(self) -> List[Request]:
        """Serve until every submitted request reached a terminal state
        (completed, cancelled, or expired).  Returns completions in finish
        order; cancelled/expired requests are in ``self.aborted``."""
        eng = self.engine
        steps = 0
        while True:
            if eng.obs is not None:
                # the server owns the virtual clock: stamp the recorder
                # before any lifecycle event or step span of this tick
                eng.obs.sync(self.clock)
            self._process_cancels()
            self._expire_deadlines()
            self._admit_arrivals()
            tokens_before = eng.stats.forward_tokens
            progressed = eng.step()
            if progressed:
                steps += 1
                if steps > self.cfg.max_steps:
                    raise RuntimeError(
                        f"server exceeded max_steps={self.cfg.max_steps}")
                self.clock += self.cfg.step_cost.of(
                    eng.stats.forward_tokens - tokens_before)
                self._stream_new_tokens()
                self._collect_finished()
                continue
            # engine idle: jump to the next arrival/cancel, or stop
            nxt = self._next_event_time()
            if nxt is not None:
                self.clock = max(self.clock, nxt)
                continue
            if eng.sched.waiting:
                rids = [r.rid for r in eng.sched.waiting]
                raise RuntimeError(
                    f"server idle with unservable waiting request(s) "
                    f"{rids}: block pool too small for their context")
            break
        return self.completed
