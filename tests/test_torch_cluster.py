"""The PyTorch port's cluster serving layer (``runtime/cluster.py``) against
the JAX reference, on the CPU.

The scenarios of tests/test_cluster.py are written once and run by both
packages' ``ClusterServer`` over their engines (the port's on the CPU) on
the same trace and the same tiny model: every router, prefix-affinity
stickiness, least-loaded placement, disaggregated prefill/decode with
migration latency and with a loopback wire (``wire_per_byte > 0``),
cancels mid-migration, after adoption and before routing, adoption
head-of-line blocking, kills mid-prefill, mid-decode and mid-migration,
detection-window stranding, a kill after the trace drained, the
leaky-``evacuate``, leaky-``import_blocks`` and decref-skipping faults
that ``check_quiescent`` must catch, and the loopback wire matching the
wireless cluster.  Each request's output, state, ``admit_time`` /
``first_token_time`` / ``finish_time``, migrations and requeues, the
placement, ``summary()``, ``metrics_snapshot()`` (wire frames and bytes
included), the replicas' clocks and liveness must be equal; tokens also
equal the reference single engine's.  A traced disaggregated run with a
kill exports the reference's Chrome trace.

Plus the wire-cluster column of tests/test_differential.py (traces
3000 + trial for ``WIRE_TRIALS``): in-process, loopback and (paged)
disaggregated loopback clusters of the port, each token-identical to the
reference's single engine.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.obs import TraceRecorder as JTraceRecorder
from repro.obs import export_chrome_trace as j_export
from repro.runtime import cluster as JCL
from repro.runtime import requests as JRQ
from repro.runtime import server as JSRV

from repro_torch.obs import (TraceRecorder, export_chrome_trace,
                             validate_chrome_trace)
from repro_torch.runtime import cluster as TCL
from repro_torch.runtime import requests as TRQ
from repro_torch.runtime import server as TSRV
from test_torch_engine_paged import _gen_trace
from test_torch_obs import ref_hw, t_engine, torch_model

__all__ = ["ref_hw", "torch_model"]   # fixtures

# tests/test_cluster.py's engine (the fixtures' max_batch, chunk, bucket)
SCHED = dict(max_len=96, paged=True, block_size=8)
# test_differential's wire-cluster traces run here: seeds 3000 + trial for
# these trials, the first three of its 25 (what the suite's time budget
# allows beside the scenarios; tests/test_differential.py runs all 25
# against the reference itself)
WIRE_TRIALS = (0, 1, 2)


@pytest.fixture
def pkgs(tiny_engine_builder, torch_model):
    def t(**kw):
        return t_engine(torch_model, **{**SCHED, **kw})

    def j(**kw):
        return tiny_engine_builder(**{**SCHED, **kw})

    return {"j": SimpleNamespace(engine=j, cl=JCL, rq=JRQ, srv=JSRV,
                                 Rec=JTraceRecorder, export=j_export),
            "t": SimpleNamespace(engine=t, cl=TCL, rq=TRQ, srv=TSRV,
                                 Rec=TraceRecorder,
                                 export=export_chrome_trace)}


def _trace(ns, n=6, seed=3, out=4, rate=0.5):
    rng = np.random.RandomState(seed)
    reqs = [ns.rq.Request(rid=i, prompt=[int(t) for t in rng.randint(
        0, 128, size=rng.randint(10, 30))], max_new_tokens=out)
        for i in range(n)]
    return ns.rq.poisson_arrivals(reqs, rate=rate, seed=seed)


def _single(ns, trace):
    eng = ns.engine()
    for r in trace:
        eng.add_request(ns.rq.Request(rid=r.rid, prompt=list(r.prompt),
                                      max_new_tokens=r.max_new_tokens))
    return {r.rid: list(map(int, r.output)) for r in eng.run()}


def _outcome(cs):
    st = cs.stats
    return {
        "requests": {r.rid: (list(map(int, r.output)), r.state.value,
                             r.finish_reason, r.arrival_time, r.admit_time,
                             r.first_token_time, r.finish_time,
                             r.migrations, r.requeues, r.preemptions)
                     for r in cs.requests},
        "completed": [r.rid for r in cs.completed],
        "aborted": [r.rid for r in cs.aborted],
        "placement": dict(cs.placement),
        "summary": cs.summary(),
        "metrics": cs.metrics_snapshot(),
        "stats": (st.migrations_started, st.affinity_routed,
                  st.affinity_hits, st.cancelled, st.replica_deaths,
                  st.requeued),
        "replicas": [(rep.name, rep.role, rep.alive, rep.detected,
                      rep.clock, rep.engine.stats.steps,
                      rep.engine.stats.forwards, rep.engine.stats.completed,
                      rep.engine.stats.cancelled)
                     for rep in cs.replicas],
        "trace": getattr(cs, "doc", None),
    }


def _quiescent(cs) -> str:
    """``check_quiescent``'s verdict: "ok" or the leak it caught."""
    try:
        cs.check_quiescent()
    except AssertionError as e:
        return f"leak: {e}"
    return "ok"


def both(pkgs, scenario, **kw):
    """Run ``scenario(ns, **kw) -> cs`` in both packages; the outcomes and
    the quiescence verdicts must be equal.  Returns the port's cs and the
    reference single engine's tokens on the scenario's trace (when it
    has one, ``cs.single_trace``)."""
    out = {}
    for name in ("j", "t"):
        cs = scenario(pkgs[name], **kw)
        out[name] = (cs, _outcome(cs), _quiescent(cs))
    assert out["t"][1] == out["j"][1]
    assert out["t"][2].startswith("ok") == out["j"][2].startswith("ok")
    cs = out["t"][0]
    cs.quiescent = out["t"][2]
    trace = getattr(out["j"][0], "single_trace", None)
    cs.single = _single(pkgs["j"], trace) if trace is not None else None
    return cs


def _outputs(cs):
    return {r.rid: list(map(int, r.output)) for r in cs.completed}


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def routed(ns, router):
    reps = [ns.cl.Replica(f"r{i}", ns.engine()) for i in range(3)]
    cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(router=router))
    for r in _trace(ns):
        cs.submit(r)
    cs.run()
    cs.single_trace = _trace(ns)
    return cs


@pytest.mark.parametrize("router", sorted(JCL.ROUTERS))
def test_every_router_matches_reference(pkgs, router):
    assert sorted(TCL.ROUTERS) == sorted(JCL.ROUTERS)
    cs = both(pkgs, routed, router=router)
    assert _outputs(cs) == cs.single
    assert cs.quiescent == "ok"


def affinity(ns):
    reps = [ns.cl.Replica(f"r{i}", ns.engine()) for i in range(3)]
    cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
        router="prefix_affinity"))
    trace = ns.rq.grouped_prefix_trace(3, 4, prefix_len=24, tail_len=6,
                                       output_len=4, vocab=128, seed=3)
    for r in ns.rq.poisson_arrivals(trace, rate=0.4, seed=5):
        cs.submit(r)
    cs.run()
    return cs


def test_prefix_affinity_groups_stick(pkgs):
    cs = both(pkgs, affinity)
    assert cs.stats.affinity_hit_rate > 0 and cs.quiescent == "ok"
    p = cs.placement
    assert len(p) == 12
    for rid in sorted(p):
        if rid >= 3:                            # group seen before
            assert p[rid] == p[rid % 3], (rid, p)


def least_loaded(ns):
    reps = [ns.cl.Replica(f"r{i}", ns.engine()) for i in range(2)]
    cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
        router="least_loaded"))
    for i in range(2):
        cs.submit(ns.rq.Request(rid=i, prompt=list(range(1, 21)),
                                max_new_tokens=32, arrival_time=0.0))
    cs.run()
    return cs


def test_least_loaded_prefers_idle_replica(pkgs):
    cs = both(pkgs, least_loaded)
    assert [rep.engine.stats.completed for rep in cs.replicas] == [1, 1]


# --------------------------------------------------------------------------
# disaggregated prefill/decode migration
# --------------------------------------------------------------------------

def disagg(ns, n=5, migration_base=1.0, wire=None, wire_per_byte=0.0,
           decode_kw=None, out=4, rate=0.5, cancel=None, prompt=None):
    reps = [ns.cl.Replica("p0", ns.engine(), role="prefill"),
            ns.cl.Replica("d0", ns.engine(**(decode_kw or {})),
                          role="decode")]
    cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
        router="round_robin",
        migration_cost=ns.cl.MigrationCost(base=migration_base),
        wire=wire, wire_per_byte=wire_per_byte))
    if prompt is not None:                   # one request, maybe cancelled
        max_new, at_arrival, at_cancel = cancel
        cs.submit(ns.rq.Request(rid=0, prompt=list(prompt),
                                max_new_tokens=max_new,
                                arrival_time=at_arrival))
        cs.cancel(0, at=at_cancel)
    else:
        for r in _trace(ns, n=n, out=out, rate=rate):
            cs.submit(r)
        cs.single_trace = _trace(ns, n=n, out=out, rate=rate)
    cs.run()
    return cs


@pytest.mark.parametrize("wire", [None, "loopback"])
def test_disagg_with_migration_latency(pkgs, wire):
    cs = both(pkgs, disagg, migration_base=7.5, wire=wire,
              wire_per_byte=2e-5 if wire else 0.0)
    assert _outputs(cs) == cs.single
    assert cs.summary()["migrations"] == 5 and cs.quiescent == "ok"
    assert all(r.migrations == 1 for r in cs.completed)
    if wire:
        snap = cs.metrics_snapshot()
        # 5 submit envelopes + 5 KV handoffs crossed the codec
        assert snap["cluster/wire/frames"] == 10 == cs.wire.frames
        assert snap["cluster/wire/bytes"] == cs.wire.bytes > 0
        assert snap["cluster/wire/latency/count"] == 5


@pytest.mark.parametrize("case", ["mid_migration", "after_adoption",
                                  "before_routing"])
def test_cancel_at_every_stage(pkgs, case):
    # (max_new_tokens, arrival, cancel time) and the migration latency
    kw = {"mid_migration": dict(cancel=(8, 0.0, 50.0), migration_base=1e3),
          "after_adoption": dict(cancel=(500, 0.0, 30.0)),
          "before_routing": dict(cancel=(4, 10.0, 5.0))}[case]
    cs = both(pkgs, disagg, prompt=list(range(1, 21)), **kw)
    req = cs.requests[0]
    assert cs.completed == [] and cs.aborted == [req]
    assert req.finish_reason == "cancelled" and cs.quiescent == "ok"
    adopted = cs.replicas[1].engine.block_mgr.stats.migrations_in
    assert adopted == (case == "after_adoption")
    if case == "before_routing":
        assert all(rep.engine.stats.steps == 0 for rep in cs.replicas)


def test_adoption_head_of_line_blocks_until_slot_frees(pkgs):
    cs = both(pkgs, disagg, n=3, out=8, rate=5.0,
              decode_kw=dict(max_batch=2))
    assert _outputs(cs) == cs.single
    assert cs.summary()["migrations"] == 3 and cs.quiescent == "ok"


def wire_vs_wireless(ns, wire):
    return disagg(ns, n=4, wire=wire)


def test_wire_loopback_matches_wireless_cluster(pkgs):
    wired = both(pkgs, wire_vs_wireless, wire="loopback")
    wireless = both(pkgs, wire_vs_wireless, wire=None)
    assert _outputs(wired) == _outputs(wireless) == wired.single
    assert wired.wire.frames == 8 and wireless.wire is None


# --------------------------------------------------------------------------
# failure handling: kill -> heartbeat-timeout detection -> requeue
# --------------------------------------------------------------------------

def killed(ns, case):
    if case == "mid_migration":
        reps = [ns.cl.Replica("p0", ns.engine(), role="prefill"),
                ns.cl.Replica("d0", ns.engine(), role="decode"),
                ns.cl.Replica("d1", ns.engine(), role="decode")]
        cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
            router="round_robin",
            migration_cost=ns.cl.MigrationCost(base=50.0)))
        trace = [ns.rq.Request(rid=0, prompt=list(range(1, 21)),
                               max_new_tokens=6, arrival_time=0.0)]
        kill = ("d0", 10.0)      # while the handoff rides the wire
    else:
        reps = [ns.cl.Replica(f"r{i}", ns.engine()) for i in range(2)]
        cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
            router="round_robin", heartbeat_timeout=5.0
            if case == "stranding" else 3.0,
            wire="loopback" if case == "wire" else None))
        if case == "mid_prefill":
            # long prompts, a kill after the first tick: r0 dies while
            # its requests still chunk-prefill (no output yet)
            trace = [ns.rq.Request(rid=i, prompt=list(range(1, 81)),
                                   max_new_tokens=4, arrival_time=0.0)
                     for i in range(2)]
            kill = ("r0", 1.5)
        elif case == "stranding":
            # r1 is routed to the dead-but-undetected replica
            trace = [ns.rq.Request(rid=i, prompt=list(range(1, 11)),
                                   max_new_tokens=2, arrival_time=float(i))
                     for i in range(2)]
            kill = ("r1", 0.5)
        else:
            trace = _trace(ns, n={"wire": 4}.get(case, 6))
            kill = {"mid_decode": ("r0", 8.0), "wire": ("r1", 6.0),
                    "after_finish": ("r0", 10_000.0)}[case]
    for r in trace:
        cs.submit(r)
    cs.kill_replica(*kill)
    cs.run()
    cs.single_trace = [ns.rq.Request(rid=r.rid, prompt=list(r.prompt),
                                     max_new_tokens=r.max_new_tokens)
                       for r in trace]
    return cs


@pytest.mark.parametrize("case", ["mid_decode", "mid_prefill",
                                  "mid_migration", "stranding", "wire",
                                  "after_finish"])
def test_kill_requeues_token_identical(pkgs, case):
    cs = both(pkgs, killed, case=case)
    assert _outputs(cs) == cs.single and cs.quiescent == "ok"
    assert cs.stats.replica_deaths == 1
    requeued = [r for r in cs.completed if r.requeues]
    if case == "after_finish":
        assert not requeued and cs.stats.requeued == 0
        return
    assert requeued and all(r.requeues == 1 for r in requeued)
    if case == "mid_migration":
        req = cs.requests[0]
        assert req.migrations == 1 and cs.stats.migrations_started == 2
        assert [rep.engine.block_mgr.stats.migrations_in
                for rep in cs.replicas] == [0, 0, 1]
    if case == "stranding":
        assert cs.requests[1].admit_time >= 0.5 + 5.0


# --------------------------------------------------------------------------
# fault injection: the quiescence sweep must bite
# --------------------------------------------------------------------------

def leaky(ns, fault):
    if fault == "evacuate":
        reps = [ns.cl.Replica(f"r{i}", ns.engine()) for i in range(2)]
        cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
            router="round_robin"))
        eng0 = reps[0].engine

        def leaky_evacuate():
            out = list(eng0.sched.waiting) + [
                x for x in eng0.sched.active if x is not None]
            eng0.sched.waiting = []
            eng0.sched.active = [None] * len(eng0.sched.active)
            return [ns.rq.reset_for_requeue(r) for r in out]  # no free

        eng0.evacuate = leaky_evacuate
        trace = _trace(ns, n=4, out=24)
        cs.kill_replica("r0", at=1.0)       # r0 still holds active slots
        cs.single_trace = _trace(ns, n=4, out=24)
    else:
        reps = [ns.cl.Replica("p0", ns.engine(), role="prefill"),
                ns.cl.Replica("d0", ns.engine(), role="decode")]
        cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
            router="round_robin"))
        mgr = reps[1].engine.block_mgr
        if fault == "import_blocks":
            real_import = mgr.import_blocks

            def leaky_import(rid, context, n_tokens, **kw):
                got = real_import(rid, context, n_tokens, **kw)
                if got is not None:
                    mgr.alloc.share(got[0][0])       # an extra reference
                return got

            mgr.import_blocks = leaky_import
        else:
            def broken_free(rid):
                mgr.tables.pop(rid, None)           # forgets every decref
                mgr._reg_cursor.pop(rid, None)

            mgr.free_request = broken_free
        trace = _trace(ns, n=2)
    for r in trace:
        cs.submit(r)
    cs.run()
    return cs


@pytest.mark.parametrize("fault", ["evacuate", "import_blocks",
                                   "free_request"])
def test_leaks_are_caught_by_quiescence_sweep(pkgs, fault):
    cs = both(pkgs, leaky, fault=fault)
    assert cs.quiescent.startswith("leak")
    if fault == "evacuate":
        assert _outputs(cs) == cs.single     # recovery itself still works
        assert cs.stats.requeued >= 1


# --------------------------------------------------------------------------
# a traced disaggregated run with a kill: the reference's Chrome trace
# --------------------------------------------------------------------------

def traced(ns):
    rec = ns.Rec()
    reps = [ns.cl.Replica(name, ns.engine(obs=rec), role=role)
            for name, role in (("p0", "prefill"), ("d0", "decode"),
                               ("d1", "decode"))]
    cs = ns.cl.ClusterServer(reps, ns.cl.ClusterConfig(
        router="round_robin", wire="loopback", wire_per_byte=1e-5,
        migration_cost=ns.cl.MigrationCost(base=2.0)))
    for r in _trace(ns, n=4, out=8):
        cs.submit(r)
    cs.kill_replica("d1", at=6.0)
    cs.run()
    cs.doc = json.loads(json.dumps(ns.export(rec)))
    cs.single_trace = _trace(ns, n=4, out=8)
    return cs


def test_traced_disagg_with_kill_exports_reference_trace(pkgs, ref_hw):
    cs = both(pkgs, traced)
    assert _outputs(cs) == cs.single and cs.quiescent == "ok"
    assert validate_chrome_trace(cs.doc) == []
    names = {e["name"] for e in cs.doc["traceEvents"]
             if e.get("cat") == "request"}
    assert {"handoff_export", "handoff_adopt", "requeue"} <= names, names


# --------------------------------------------------------------------------
# configuration checks (the port alone)
# --------------------------------------------------------------------------

def test_cluster_configuration_is_validated(pkgs):
    ns = pkgs["t"]
    slow = TSRV.StepCost(base=2.0)
    reps = [TCL.Replica("a", ns.engine(), step_cost=slow),
            TCL.Replica("b", ns.engine())]
    TCL.ClusterServer(reps, TCL.ClusterConfig())
    assert reps[0].step_cost is slow and reps[1].step_cost is not None
    with pytest.raises(ValueError, match="paged"):
        TCL.ClusterServer([TCL.Replica("p0", ns.engine(paged=False),
                                       role="prefill"),
                           TCL.Replica("d0", ns.engine(), role="decode")])
    with pytest.raises(ValueError, match="prefill AND one decode"):
        TCL.ClusterServer([TCL.Replica("p0", ns.engine(), role="prefill")])
    with pytest.raises(ValueError, match="mixed"):
        TCL.ClusterServer([TCL.Replica("p0", ns.engine(), role="prefill"),
                           TCL.Replica("d0", ns.engine(), role="decode"),
                           TCL.Replica("m0", ns.engine())])
    with pytest.raises(ValueError, match="wire mode"):
        TCL.ClusterServer([TCL.Replica("r0", ns.engine())],
                          TCL.ClusterConfig(wire="carrier-pigeon"))
    cs = TCL.ClusterServer([TCL.Replica("r0", ns.engine())])
    with pytest.raises(ValueError, match="unknown replica"):
        cs.kill_replica("nope", at=1.0)


# --------------------------------------------------------------------------
# the wire-cluster column of tests/test_differential.py
# --------------------------------------------------------------------------

def _drive_cluster(engines, prompts, outs, roles=None, wire=None):
    roles = roles or ["mixed"] * len(engines)
    reps = [TCL.Replica(f"r{i}", e, role=role)
            for i, (e, role) in enumerate(zip(engines, roles))]
    cs = TCL.ClusterServer(reps, TCL.ClusterConfig(router="round_robin",
                                                   wire=wire))
    for i, (p, n) in enumerate(zip(prompts, outs)):
        cs.submit(TRQ.Request(rid=i, prompt=[int(t) for t in p],
                              max_new_tokens=n, arrival_time=0.25 * i))
    done = cs.run()
    cs.check_quiescent()
    return {r.rid: r.output for r in done}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "legacy"])
@pytest.mark.parametrize("trial", WIRE_TRIALS)
def test_differential_wire_cluster(trial, paged, tiny_engine_builder,
                                   torch_model):
    prompts, outs, _, _ = _gen_trace(np.random.RandomState(3000 + trial))
    kw = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16,
              block_size=16, paged=paged)
    single = tiny_engine_builder(**kw)
    for i, (p, n) in enumerate(zip(prompts, outs)):
        single.add_request(JRQ.Request(rid=i, prompt=list(p),
                                       max_new_tokens=n))
    ref = {r.rid: r.output for r in single.run()}
    assert sorted(ref) == list(range(len(prompts)))

    def engines():
        return [t_engine(torch_model, **kw) for _ in range(2)]

    assert _drive_cluster(engines(), prompts, outs) == ref, "inproc"
    assert _drive_cluster(engines(), prompts, outs, wire="loopback") == \
        ref, "loopback"
    if paged:
        # disaggregated: every KV-migration payload crosses the codec too
        assert _drive_cluster(engines(), prompts, outs,
                              roles=["prefill", "decode"],
                              wire="loopback") == ref, "disagg_loopback"
