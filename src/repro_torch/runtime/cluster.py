"""Cluster serving layer, as ``repro.runtime.cluster``: multi-engine
routing with prefix affinity and disaggregated prefill/decode KV handoff.

``ClusterServer`` fronts N independent ``Engine`` replicas — each with its
own block pool, prefix cache, and scheduler — behind a pluggable router:

* ``round_robin``       — cycle through the fleet (the stateless baseline).
* ``least_loaded``      — fewest queued tokens on the virtual clock
                          (remaining prefill + remaining decode budget of
                          everything the replica owns).
* ``prefix_affinity``   — route by the same blake2b chain keys the prefix
                          cache computes (prefix_cache.py), so shared-
                          prompt traffic lands on the replica whose blocks
                          are already hot; ties fall back to least-loaded.

A router is any callable ``route(cluster, req, candidates, t) -> Replica``
that depends only on replica state at virtual time ``t``; the names above
resolve through ``ROUTERS``.

**Disaggregated mode** (replicas carry roles): external arrivals are
routed over the *prefill* fleet; once a request's chunked prefill
completes (its first token sampled), the engine parks it
(``Engine._park_for_handoff``, the payload copied to the host) and the
cluster migrates its KV to a *decode* replica —
``BlockManager.export_blocks`` / ``import_blocks`` move the block table
with refcounts correct on both sides, ``extract_blocks`` /
``implant_blocks`` the cells, and the prefix-cache entries are
re-registered on the importer (full-block hits there are shared instead
of copied).  The handoff takes virtual time (``MigrationCost``), modeled
as an internal arrival at the decode replica.

**Determinism.**  Time is the virtual clock of runtime/server.py:
per-replica clocks advance by ``StepCost`` per engine step, and the
cluster executes one global event order — the earliest of (cancel, kill,
dead-replica detection, route, replica step), replicas tied on time by
index.  Routing at time t happens only once no replica has work strictly
before t, so router inputs are replayable state; with greedy sampling the
emitted tokens are batch-composition-invariant, so cluster outputs are
token-identical to a single engine on the same trace for EVERY router.

**Wire transport**: ``ClusterConfig.wire="loopback"`` routes every arrival
envelope and KV-migration payload through the versioned frame codec
(runtime/transport.py) — a real encode→decode round trip with frame/byte
accounting and payload-proportional virtual latency (``wire_per_byte``),
deterministic because no socket is involved.  Real replicas plug in the
same way: ``Replica(name, RemoteEngine(host, port))`` drives an engine
hosted in another process over TCP with the same codec.

**Failure handling**: replicas heartbeat by ticking;
``kill_replica(name, at)`` models a machine crash on the virtual clock
(the replica stops heartbeating and ticking at ``at``), and the detector
declares it dead once ``heartbeat_timeout`` passes without a heartbeat —
on real sockets a failed RPC (``ReplicaGone``) is the missed heartbeat.
Detection requeues every request the dead replica owned (queued, parked,
in-flight adoption, waiting, active) onto surviving replicas with
recompute semantics (``Engine.evacuate`` + ``reset_for_requeue``) —
refcount-correct, which ``check_quiescent`` still verifies over the dead
replica's pool.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.engine import Engine, Handoff
from repro_torch.runtime.prefix_cache import chain_hashes
from repro_torch.runtime.requests import Request, State, reset_for_requeue
from repro_torch.runtime.server import StepCost
from repro_torch.runtime.transport import (LoopbackTransport, ReplicaGone,
                                     handoff_from_wire, handoff_to_wire,
                                     request_from_wire, request_to_wire)


@dataclasses.dataclass
class MigrationCost:
    """Virtual duration of one prefill->decode KV handoff.  The default is
    one tick flat; ``per_token`` models payload-proportional transfer time
    (NVLink/ICI copy in a real deployment).  A documented simplification
   : the cost is pure latency — it never occupies either
    replica's compute stream."""
    base: float = 1.0
    per_token: float = 0.0

    def of(self, n_tokens: int) -> float:
        return self.base + self.per_token * n_tokens


@dataclasses.dataclass
class ClusterConfig:
    router: object = "round_robin"    # name in ROUTERS, or a callable
    step_cost: StepCost = dataclasses.field(default_factory=StepCost)
    migration_cost: MigrationCost = dataclasses.field(
        default_factory=MigrationCost)
    max_steps: int = 1_000_000        # total engine steps across the fleet
    # tuned overlap-plan cache installed on EVERY replica engine at
    # cluster startup (core/policy.py); None keeps each
    # engine's own policy
    plan_path: Optional[str] = None
    # --- wire transport ---
    # None: in-process object passing (the default).  "loopback":
    # every arrival envelope and migration payload round-trips the frame
    # codec (runtime/transport.py) with byte accounting — deterministic,
    # no sockets.  Socket replicas need no cluster flag: RemoteEngine
    # carries its own channel.
    wire: Optional[str] = None
    wire_per_byte: float = 0.0        # virtual secs/byte added to handoffs
    # --- failure handling ---
    # a replica is declared dead this long (virtual) after its last
    # heartbeat (= last completed tick, or the kill time)
    heartbeat_timeout: float = 3.0


class ClusterStats:
    """Thin read view over the cluster's MetricsRegistry (``cluster/*``
    counters), always equal to what ``metrics_snapshot()`` exports."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        r = self.registry
        # handoffs dispatched onto the wire
        self._migrations_started = r.counter("cluster/migrations_started")
        # prefix_affinity routing decisions / ... that found >= 1 hot block
        self._affinity_routed = r.counter("cluster/affinity_routed")
        self._affinity_hits = r.counter("cluster/affinity_hits")
        self._cancelled = r.counter("cluster/cancelled")
        # failure handling
        self._replica_deaths = r.counter("cluster/replica_deaths")
        self._requeued = r.counter("cluster/requeued")

    @property
    def migrations_started(self) -> int:
        return self._migrations_started.value

    @property
    def affinity_routed(self) -> int:
        return self._affinity_routed.value

    @property
    def affinity_hits(self) -> int:
        return self._affinity_hits.value

    @property
    def cancelled(self) -> int:
        return self._cancelled.value

    @property
    def replica_deaths(self) -> int:
        return self._replica_deaths.value

    @property
    def requeued(self) -> int:
        return self._requeued.value

    @property
    def affinity_hit_rate(self) -> float:
        return (self.affinity_hits / self.affinity_routed
                if self.affinity_routed else 0.0)


class Replica:
    """One engine plus its virtual clock and event queues.  Replicas model
    independent machines sharing nothing but the wall-clock axis: routed
    arrivals and migrations enter through time-stamped queues, and
    ``tick`` admits whatever is due before running one engine step."""

    def __init__(self, name: str, engine: Engine, role: str = "mixed",
                 step_cost: Optional[StepCost] = None):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self.name = name
        self.engine = engine
        self.role = role
        # one recorder, one track per replica: claim the
        # engine's default track name so fleet traces don't collide
        if engine.obs is not None and engine.obs_track == "engine":
            engine.obs_track = name
        # an explicit per-replica cost (heterogeneous fleet) wins over the
        # cluster-wide default; None is filled in by ClusterServer
        self.step_cost = step_cost
        self.clock = 0.0
        # liveness: a dead replica stops ticking at once,
        # but the ROUTER keeps sending to it until the detector declares
        # it dead (``detected``) — requests routed inside that window
        # strand in its queue and are requeued at detection, the
        # realistic cost of failure detection by timeout
        self.alive = True
        self.detected = False
        self.last_heartbeat = 0.0
        self._pending: List[Tuple[float, int, Request]] = []   # arrivals
        self._adopt: List[Tuple[float, int, Handoff]] = []     # migrations
        self._finished_cursor = 0

    # ---- event ingress ---------------------------------------------------
    def submit(self, req: Request, at: float) -> None:
        bisect.insort(self._pending, (at, req.rid, req))

    def queue_adoption(self, at: float, handoff: Handoff) -> None:
        bisect.insort(self._adopt, (at, handoff.req.rid, handoff))

    # ---- scheduling ------------------------------------------------------
    def next_work_time(self) -> Optional[float]:
        """Earliest virtual time this replica can make progress: now if the
        engine holds any request, else its next queued arrival/adoption,
        else None (quiescent or dead)."""
        if not self.alive:
            return None
        if (self.engine.sched.waiting
                or any(r is not None for r in self.engine.sched.active)):
            return self.clock
        times = []
        if self._pending:
            times.append(self._pending[0][0])
        if self._adopt:
            times.append(self._adopt[0][0])
        return min(times) if times else None

    def _admit_due(self) -> None:
        while self._pending and self._pending[0][0] <= self.clock:
            _, _, req = self._pending.pop(0)
            req.admit_time = self.clock
            if self.engine.obs is not None:
                self.engine.obs.request_event(
                    req.rid, "arrival", ts=req.arrival_time,
                    args={"replica": self.name, "deadline": req.deadline})
            self.engine.add_request(req)
        # adoptions are head-of-line like paged admission: if the oldest
        # migrated request cannot land (no slot / no blocks), younger ones
        # wait behind it — no reordering, no starvation
        while self._adopt and self._adopt[0][0] <= self.clock:
            _, _, h = self._adopt[0]
            if not self.engine.adopt_request(h.req, h.n_tokens, h.payload):
                break
            self._adopt.pop(0)

    def tick(self) -> bool:
        """Admit due events, run ONE engine step, advance the clock by its
        cost.  Returns False when the engine made no progress."""
        if self.engine.obs is not None:
            # this replica owns the recorder's clock for the duration of
            # its tick: admission/adoption/step events stamp at its time
            self.engine.obs.sync(self.clock)
        self._admit_due()
        before = self.engine.stats.forward_tokens
        if not self.engine.step():
            return False
        if self.step_cost is None:          # standalone use, no cluster
            self.step_cost = StepCost()
        self.clock += self.step_cost.of(
            self.engine.stats.forward_tokens - before)
        self.last_heartbeat = self.clock
        return True

    def take_new_finished(self) -> List[Request]:
        fin = self.engine.sched.finished
        out = fin[self._finished_cursor:]
        self._finished_cursor = len(fin)
        return out

    # ---- router inputs ---------------------------------------------------
    def load(self) -> int:
        """Queued tokens at the current virtual clock: remaining prefill
        plus remaining decode budget of every request this replica owns in
        any pre-terminal stage (queued arrival, in-flight adoption,
        waiting, active)."""
        reqs = ([r for _, _, r in self._pending]
                + [h.req for _, _, h in self._adopt]
                + list(self.engine.sched.waiting)
                + [r for r in self.engine.sched.active if r is not None])
        return sum(max(len(r.context_tokens) - r.prefill_pos, 0)
                   + max(r.max_new_tokens - len(r.output), 0)
                   for r in reqs)

    def prefix_hit_blocks(self, hashes: Sequence[int]) -> int:
        """Leading full-block prefix hits this replica's cache would serve
        a prompt with the given chain hashes (0 on legacy-slot engines)."""
        mgr = self.engine.block_mgr
        if mgr is None or not mgr.prefix_caching:
            return 0
        return len(mgr.prefix.match(hashes))


# --------------------------------------------------------------------------
# routers — route(cluster, req, candidates, t) -> Replica.  Pure functions
# of replica state at virtual time t (the router contract); the sort
# keys make every tie-break explicit and deterministic.
# --------------------------------------------------------------------------

def route_round_robin(cluster: "ClusterServer", req: Request,
                      cands: List[Replica], t: float) -> Replica:
    key = tuple(c.name for c in cands)
    i = cluster._rr.get(key, 0)
    cluster._rr[key] = i + 1
    return cands[i % len(cands)]


def route_least_loaded(cluster: "ClusterServer", req: Request,
                       cands: List[Replica], t: float) -> Replica:
    return min(enumerate(cands), key=lambda ic: (ic[1].load(), ic[0]))[1]


def route_prefix_affinity(cluster: "ClusterServer", req: Request,
                          cands: List[Replica], t: float) -> Replica:
    """Most leading prompt blocks already hot wins; ties (including the
    cold 0-hit case) fall back to least-loaded, then fleet order."""
    bs = cluster._block_size(cands)
    hashes = chain_hashes(req.prompt, bs)
    hits = [c.prefix_hit_blocks(hashes) for c in cands]
    best = max(hits)
    cluster.stats._affinity_routed.inc()
    if best > 0:
        cluster.stats._affinity_hits.inc()
    pool = [(i, c) for i, c in enumerate(cands) if hits[i] == best]
    return min(pool, key=lambda ic: (ic[1].load(), ic[0]))[1]


ROUTERS: Dict[str, Callable] = {
    "round_robin": route_round_robin,
    "least_loaded": route_least_loaded,
    "prefix_affinity": route_prefix_affinity,
}


class ClusterServer:
    """Deterministic multi-replica serving loop.  Usage::

        reps = [Replica(f"r{i}", engine_i) for i in range(3)]
        cs = ClusterServer(reps, ClusterConfig(router="prefix_affinity"))
        for r in poisson_arrivals(trace, rate=0.5, seed=0):
            cs.submit(r)
        done = cs.run()
        cs.summary()     # per-replica weave rates, migrations, affinity

    Disaggregated mode is enabled by replica roles: with any
    ``prefill``/``decode`` replicas present, arrivals enter through the
    prefill fleet (``handoff_after_prefill`` set) and completed prefills
    migrate to the decode fleet under the same router policy."""

    def __init__(self, replicas: List[Replica],
                 cfg: Optional[ClusterConfig] = None):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas = replicas
        self.cfg = cfg or ClusterConfig()
        self.router = (self.cfg.router if callable(self.cfg.router)
                       else ROUTERS[self.cfg.router])
        for rep in replicas:
            if rep.step_cost is None:
                rep.step_cost = self.cfg.step_cost
        if self.cfg.plan_path:
            # one tuned plan for the whole fleet: each
            # replica installs the same policy, so routing decisions never
            # change which overlap scheme a request's tokens see
            from repro_torch.core.policy import load_policy
            policy = load_policy(self.cfg.plan_path)
            for rep in replicas:
                rep.engine.install_overlap_policy(policy)

        prefill = [r for r in replicas if r.role == "prefill"]
        decode = [r for r in replicas if r.role == "decode"]
        mixed = [r for r in replicas if r.role == "mixed"]
        self.disaggregated = bool(prefill or decode)
        if self.disaggregated:
            if not (prefill and decode):
                raise ValueError("disaggregated mode needs at least one "
                                 "prefill AND one decode replica")
            if mixed:
                raise ValueError("mixed replicas cannot join a "
                                 "disaggregated fleet")
            for rep in prefill + decode:
                if not rep.engine.paged:
                    raise ValueError(
                        f"replica {rep.name!r}: KV handoff requires the "
                        f"paged backend on every replica")
            self.ingress = prefill
            self.decode_fleet = decode
        else:
            self.ingress = mixed
            self.decode_fleet = []

        if self.cfg.wire not in (None, "loopback"):
            raise ValueError(f"unknown wire mode {self.cfg.wire!r} "
                             f"(expected None or 'loopback')")
        self.wire = (LoopbackTransport() if self.cfg.wire == "loopback"
                     else None)
        self.metrics = MetricsRegistry()
        self.stats = ClusterStats(self.metrics)
        # the fleet shares ONE recorder (first traced engine wins): one
        # lifecycle thread per rid across migrations, one track per replica
        self.obs = next((rep.engine.obs for rep in replicas
                         if rep.engine.obs is not None), None)
        self.requests: List[Request] = []
        self.completed: List[Request] = []
        self.aborted: List[Request] = []
        self.placement: Dict[int, str] = {}   # rid -> ingress replica name
        self._arrivals: List[Tuple[float, int, Request]] = []
        self._cancels: List[Tuple[float, int]] = []
        self._by_rid: Dict[int, Request] = {}
        self._rr: Dict[Tuple[str, ...], int] = {}
        self._by_name: Dict[str, Replica] = {r.name: r for r in replicas}
        # failure injection/detection event queues
        self._kills: List[Tuple[float, str]] = []
        self._detects: List[Tuple[float, str]] = []

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.rid in self._by_rid:
            raise ValueError(f"duplicate rid {req.rid}")
        self.requests.append(req)
        self._by_rid[req.rid] = req
        bisect.insort(self._arrivals, (req.arrival_time, req.rid, req))

    def cancel(self, rid: int, at: Optional[float] = None) -> None:
        """Schedule a client disconnect at virtual time ``at`` — honored
        wherever the request then lives: unrouted, queued at a replica,
        admitted (``Engine.abort`` releases slot/blocks/prefix refs), or
        mid-migration (the handoff is dropped; the exporter already
        released everything at park, the importer never allocated)."""
        if rid not in self._by_rid:
            raise ValueError(f"unknown rid {rid}")
        t = self._by_rid[rid].arrival_time if at is None else at
        bisect.insort(self._cancels, (t, rid))

    def kill_replica(self, name: str, at: float) -> None:
        """Fault injection: model a machine crash at
        virtual time ``at``.  The replica stops heartbeating and ticking;
        everything it owns is requeued onto surviving replicas once the
        detector fires at ``at + heartbeat_timeout``.  Requests routed to
        it in the detection window strand in its queue until then — the
        realistic cost of failure detection by timeout."""
        if name not in self._by_name:
            raise ValueError(f"unknown replica {name!r}")
        bisect.insort(self._kills, (at, name))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _block_size(self, cands: List[Replica]) -> int:
        sizes = {c.engine.scfg.block_size for c in cands
                 if c.engine.block_mgr is not None}
        if not sizes:
            raise ValueError("prefix_affinity needs paged replicas")
        if len(sizes) != 1:
            raise ValueError(f"prefix_affinity needs one fleet-wide "
                             f"block_size, got {sorted(sizes)}")
        return sizes.pop()

    def _routable(self, fleet: List[Replica], what: str) -> List[Replica]:
        """Router candidates: every replica not yet DETECTED dead — the
        frontend cannot know about a crash before the detector fires, so
        the detection window routes into a dead replica's queue."""
        cands = [r for r in fleet if not r.detected]
        if not cands:
            raise RuntimeError(f"no alive {what} replica left in the fleet")
        return cands

    def _wire_transfer(self, kind: str, obj: object) -> Tuple[object, int]:
        """Round-trip one envelope through the loopback codec with frame
        and byte accounting (the ``cluster/wire/*`` metrics)."""
        got, nbytes = self.wire.transfer(kind, obj)
        self.metrics.counter("cluster/wire/frames").inc()
        self.metrics.counter("cluster/wire/bytes").inc(nbytes)
        self.metrics.histogram("cluster/wire/frame_bytes").observe(nbytes)
        return got, nbytes

    def _route_arrival(self) -> None:
        t, _, req = self._arrivals.pop(0)
        if self.wire is not None:
            # the envelope a socket frontend would send: round-trip it
            # through the codec so the wire schema stays honest even in
            # the deterministic twin.  The decoded copy is only checked —
            # the cluster keeps routing the ORIGINAL object so identity-
            # based bookkeeping (cancel, placement) is unchanged.
            got, _ = self._wire_transfer("submit", request_to_wire(req))
            decoded = request_from_wire(got)
            assert (decoded.rid, decoded.prompt) == (req.rid, req.prompt)
        target = self.router(self, req,
                             self._routable(self.ingress, "ingress"), t)
        self.placement[req.rid] = target.name
        if self.disaggregated:
            req.handoff_after_prefill = True
        target.submit(req, at=t)

    def _dispatch_handoffs(self, rep: Replica) -> None:
        for h in rep.engine.take_handoffs():
            self.stats._migrations_started.inc()
            delay = self.cfg.migration_cost.of(h.n_tokens)
            if self.wire is not None:
                # KV payload crosses the codec for real: the adopted
                # blocks are the decoded bytes, and the transfer adds
                # payload-proportional virtual latency
                got, nbytes = self._wire_transfer(
                    "handoff", handoff_to_wire(h))
                h = handoff_from_wire(got, req=h.req)
                delay += self.cfg.wire_per_byte * nbytes
                self.metrics.histogram("cluster/wire/latency").observe(
                    self.cfg.wire_per_byte * nbytes)
            target = self.router(self, h.req,
                                 self._routable(self.decode_fleet,
                                                "decode"), rep.clock)
            if self.obs is not None and self.wire is not None:
                # per-replica wire track: replica clocks can leapfrog, so
                # a single shared track would break trace monotonicity
                self.obs.complete(
                    f"wire/{rep.name}", f"migrate/{h.req.rid}",
                    ts=rep.clock, dur=delay, cat="wire",
                    args={"n_tokens": h.n_tokens, "to": target.name})
            target.queue_adoption(rep.clock + delay, h)

    def _collect_finished(self, rep: Replica) -> None:
        for req in rep.take_new_finished():
            req.finish_time = rep.clock
            self.completed.append(req)

    def _process_cancel(self) -> None:
        t, rid = self._cancels.pop(0)
        req = self._by_rid[rid]
        if req.state == State.DONE:
            return
        # 1. not yet routed
        for i, (_, r_rid, _) in enumerate(self._arrivals):
            if r_rid == rid:
                self._arrivals.pop(i)
                self._mark_cancelled(req, t)
                return
        for rep in self.replicas:
            # 2. routed but not yet admitted
            for i, (_, p_rid, _) in enumerate(rep._pending):
                if p_rid == rid:
                    rep._pending.pop(i)
                    self._mark_cancelled(req, t)
                    return
            # 3. mid-migration: exporter freed at park, importer never
            #    allocated — dropping the handoff releases everything
            for i, (_, a_rid, _) in enumerate(rep._adopt):
                if a_rid == rid:
                    rep._adopt.pop(i)
                    self._mark_cancelled(req, t)
                    return
            # 4. owned by a replica engine (waiting or active)
            sched = rep.engine.sched
            if req in sched.waiting or any(r is req for r in sched.active):
                if rep.engine.obs is not None:
                    # stamp the abort's terminal event at the owning
                    # replica's time (>= every prior event of this rid)
                    rep.engine.obs.sync(max(rep.clock, t))
                rep.engine.abort(req, "cancelled")
                req.finish_time = rep.clock
                self.stats._cancelled.inc()
                self.aborted.append(req)
                return
        raise AssertionError(f"rid {rid} not found anywhere in the cluster")

    def _mark_cancelled(self, req: Request, t: float) -> None:
        """Cancel a request no engine owns (unrouted, pre-admission, or
        mid-migration): the engine abort path can't emit its terminal
        lifecycle event, so the cluster does — exactly one terminal per
        rid either way."""
        req.state = State.DONE
        req.finish_reason = "cancelled"
        self.stats._cancelled.inc()
        if self.obs is not None:
            self.obs.request_event(req.rid, "cancel", ts=t,
                                   args={"reason": "cancelled"})
        self.aborted.append(req)

    # ------------------------------------------------------------------
    # failure handling
    # ------------------------------------------------------------------
    def _mark_dead(self, rep: Replica, t: float) -> None:
        rep.alive = False
        rep.clock = max(rep.clock, t)
        self.stats._replica_deaths.inc()
        if self.obs is not None:
            self.obs.instant(rep.name, "replica_dead", ts=rep.clock,
                             cat="fault")
        bisect.insort(self._detects,
                      (rep.clock + self.cfg.heartbeat_timeout, rep.name))

    def _process_kill(self) -> None:
        t, name = self._kills.pop(0)
        rep = self._by_name[name]
        if rep.alive:
            self._mark_dead(rep, t)

    def _schedule_death(self, rep: Replica) -> None:
        """A socket replica died mid-RPC (``ReplicaGone``): the failed
        call is the missed heartbeat, so detection fires one timeout after
        the replica's last observed progress."""
        if rep.alive:
            self._mark_dead(rep, rep.clock)

    def _process_detect(self) -> None:
        """Declare a replica dead and requeue everything it owned —
        queued arrivals and in-flight adoptions (cluster-side), plus
        parked/waiting/active requests (``Engine.evacuate``) — onto
        surviving ingress replicas with recompute semantics.  DONE
        requests already left the replica via ``_collect_finished``."""
        t, name = self._detects.pop(0)
        rep = self._by_name[name]
        rep.detected = True            # out of every router candidate set
        stranded = ([req for _, _, req in rep._pending]
                    + [h.req for _, _, h in rep._adopt])
        rep._pending.clear()
        rep._adopt.clear()
        for req in stranded:
            reset_for_requeue(req)
        evacuated = rep.engine.evacuate()
        for req in stranded + evacuated:
            if req.state == State.DONE:
                continue
            # re-admission is a fresh arrival at detection time; keeping
            # the original arrival_time would re-emit the rid's "arrival"
            # instant in the past and break per-thread trace monotonicity
            req.arrival_time = t
            if self.disaggregated:
                req.handoff_after_prefill = True
            target = self.router(self, req,
                                 self._routable(self.ingress, "ingress"), t)
            self.placement[req.rid] = target.name
            self.stats._requeued.inc()
            if self.obs is not None:
                self.obs.request_event(
                    req.rid, "requeue", ts=t,
                    args={"from": name, "to": target.name,
                          "recovered_tokens": len(req.output)})
            target.submit(req, at=t)

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Serve until every submitted request reached a terminal state.
        One global deterministic event order: the earliest of (cancel,
        kill, detect, route, replica step); at equal times cancels run
        first, then kills, then detections, then routing, then the
        lowest-index replica steps."""
        steps = 0
        while True:
            t_cancel = self._cancels[0][0] if self._cancels else None
            t_kill = self._kills[0][0] if self._kills else None
            t_detect = self._detects[0][0] if self._detects else None
            t_route = self._arrivals[0][0] if self._arrivals else None
            work = [(w, i) for i, rep in enumerate(self.replicas)
                    if (w := rep.next_work_time()) is not None]
            t_work = min(work)[0] if work else None
            times = [t for t in (t_cancel, t_kill, t_detect, t_route,
                                 t_work) if t is not None]
            if not times:
                break
            t = min(times)
            if t_cancel is not None and t_cancel <= t:
                self._process_cancel()
                continue
            if t_kill is not None and t_kill <= t:
                self._process_kill()
                continue
            if t_detect is not None and t_detect <= t:
                self._process_detect()
                continue
            if t_route is not None and t_route <= t:
                self._route_arrival()
                continue
            _, i = min(w for w in work if w[0] <= t)
            rep = self.replicas[i]
            rep.clock = max(rep.clock, t)
            try:
                progressed = rep.tick()
            except ReplicaGone:
                # a socket replica died mid-RPC: treat the failed call as
                # the missed heartbeat and let the detector requeue
                self._schedule_death(rep)
                continue
            if progressed:
                steps += 1
                if steps > self.cfg.max_steps:
                    raise RuntimeError(
                        f"cluster exceeded max_steps={self.cfg.max_steps}")
                self._dispatch_handoffs(rep)
                self._collect_finished(rep)
                continue
            # replica had work on paper but the engine made no progress:
            # nothing else in the cluster can unblock it (pools are
            # per-replica), so surface it like Engine.run does
            stuck = [r.rid for r in rep.engine.sched.waiting]
            stuck += [h.req.rid for _, _, h in rep._adopt]
            raise RuntimeError(
                f"replica {rep.name!r} idle with unservable request(s) "
                f"{stuck}: block pool or slots too small")
        return self.completed

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def check_quiescent(self) -> None:
        """End-of-trace invariant sweep (tests + fault injection lean on
        this): every block table released and every refcount back to zero
        on every replica — a leaking ``import_blocks``/``free_request`` is
        caught here, not silently absorbed.  Dead LOCAL replicas are still
        swept (``evacuate`` is what empties them, so a leaky evacuation
        trips here); remote replicas sweep host-side via their own
        ``check_quiescent`` RPC."""
        for rep in self.replicas:
            if hasattr(rep.engine, "check_quiescent"):
                rep.engine.check_quiescent()   # RemoteEngine
                continue
            mgr = rep.engine.block_mgr
            if mgr is None:
                continue
            assert not mgr.tables, (rep.name, list(mgr.tables))
            leaked = [b for b in range(mgr.alloc.num_blocks)
                      if mgr.alloc.ref[b]]
            assert not leaked, (rep.name, leaked)

    def summary(self) -> Dict[str, float]:
        """Deterministic cluster counters: per-replica weave rate and
        tokens/forward, migration count, affinity hit rate, and the
        decode-fleet aggregate weave rate (the disaggregation payoff metric).
        ``migrations`` counts COMPLETED handoffs (adoptions) — a handoff
        cancelled on the wire is in ``stats.migrations_started`` only."""
        done = sum(rep.engine.block_mgr.stats.migrations_in
                   for rep in self.replicas
                   if rep.engine.block_mgr is not None)
        out: Dict[str, float] = {
            "migrations": float(done),
            "affinity_hit_rate": self.stats.affinity_hit_rate,
            "completed": float(len(self.completed)),
        }
        for rep in self.replicas:
            st = rep.engine.stats
            out[f"{rep.name}/weave_rate"] = st.weave_rate
            out[f"{rep.name}/tokens_per_forward"] = st.tokens_per_forward
        if self.decode_fleet:
            fwd = sum(r.engine.stats.forwards for r in self.decode_fleet)
            wv = sum(r.engine.stats.weave_forwards
                     for r in self.decode_fleet)
            out["decode_fleet/weave_rate"] = wv / fwd if fwd else 0.0
        return out

    def metrics_snapshot(self) -> Dict[str, float]:
        """Registry flatten: ``cluster/*`` counters plus every
        ``summary()`` value synced into a ``summary/<key>`` gauge."""
        for k, v in self.summary().items():
            self.metrics.gauge(f"summary/{k}").set(v)
        return self.metrics.snapshot()
