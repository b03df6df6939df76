"""The PyTorch port's online serving front end (``runtime/server.py``)
against the JAX reference, on the scenarios of tests/test_server.py:
online output token-identical to offline (packed and two-dispatch), a
cancel mid-prefill and mid-verify that releases blocks and prefix
references, a cancel before arrival, deadline expiry and a late finish,
EDF admission, and late arrivals that never starve admitted decodes.

Each scenario is written once and run by both packages' ``OnlineServer``
over their engines on the same tiny model and weights (the port's on the
CPU).  The port must give the reference's streamed ``(rid, token, t)``
sequence on the virtual clock, each request's output,
``first_token_time``, ``finish_time`` and finish reason, the
``LatencyStats`` summary (TTFT, TPOT and e2e percentiles, goodput) and
the cancel/expire counts; the port's pool drains.  One more scenario
traces an online run with Poisson arrivals and expiring deadlines and
holds the exported trace equal to the reference's.
"""
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.obs import TraceRecorder as JTraceRecorder
from repro.obs import export_chrome_trace as j_export
from repro.runtime import requests as JRQ
from repro.runtime import server as JSRV

from repro_torch.obs import (TERMINAL_PHASES, TraceRecorder,
                             export_chrome_trace, validate_chrome_trace)
from repro_torch.runtime import requests as TRQ
from repro_torch.runtime import server as TSRV
from test_torch_obs import ref_hw, t_engine, torch_model

__all__ = ["ref_hw", "torch_model"]   # fixtures


@pytest.fixture
def pkgs(tiny_engine_builder, torch_model):
    """The two packages' serving pieces behind one namespace each."""
    return {
        "j": SimpleNamespace(engine=tiny_engine_builder, rq=JRQ, srv=JSRV,
                             Rec=JTraceRecorder, export=j_export),
        "t": SimpleNamespace(engine=functools.partial(t_engine, torch_model),
                             rq=TRQ, srv=TSRV, Rec=TraceRecorder,
                             export=export_chrome_trace)}


def _reqs(ns, rng, n, in_lo=8, in_hi=30, out=4, arrival=None):
    reqs = [ns.rq.Request(
        rid=i, prompt=[int(t) for t in rng.randint(
            0, 128, size=rng.randint(in_lo, in_hi))],
        max_new_tokens=out) for i in range(n)]
    if arrival is not None:
        ns.rq.replay_arrivals(reqs, arrival)
    return reqs


def _leak_check(eng):
    mgr = eng.block_mgr
    if mgr is None:
        return
    assert not mgr.tables, list(mgr.tables)
    leaked = [b for b in range(mgr.alloc.num_blocks) if mgr.alloc.ref[b]]
    assert not leaked, leaked


def _server(ns, eng, cfg=None):
    """An ``OnlineServer`` whose every submit also records each streamed
    ``(rid, token, t)`` in ``srv.streamed``, before the caller's own
    callback."""
    srv = ns.srv.OnlineServer(eng, cfg)
    srv.streamed = []
    submit = srv.submit

    def tapped(req, on_token=None):
        def cb(rq, tok, at):
            srv.streamed.append((rq.rid, int(tok), float(at)))
            if on_token is not None:
                on_token(rq, tok, at)
        submit(req, on_token=cb)
    srv.submit = tapped
    return srv


def _outcome(srv):
    eng = srv.engine
    return {
        "streamed": srv.streamed,
        "requests": {r.rid: (list(map(int, r.output)), r.first_token_time,
                             r.finish_time, r.finish_reason, r.admit_time)
                     for r in srv.requests},
        "completed": [r.rid for r in srv.completed],
        "aborted": [r.rid for r in srv.aborted],
        "latency": eng.stats.latency.summary(),
        "counts": (eng.stats.completed, eng.stats.cancelled,
                   eng.stats.expired, eng.stats.steps, eng.stats.forwards),
        "clock": srv.clock,
    }


def serve_both(pkgs, scenario, **kw):
    """Run ``scenario(ns, **kw) -> srv`` in both packages; the outcomes
    must be equal.  Returns the port's (srv, outcome)."""
    out = {}
    for name in ("j", "t"):
        srv = scenario(pkgs[name], **kw)
        assert srv.streamed
        out[name] = (srv, _outcome(srv))
    assert out["t"][1] == out["j"][1]
    _leak_check(out["t"][0].engine)
    return out["t"]


# --------------------------------------------------------------------------
# scenarios (tests/test_server.py), written once for both packages
# --------------------------------------------------------------------------

ARRIVALS = [0.0, 2.0, 2.5, 9.0, 11.0]


def _online(ns, packed):
    eng = ns.engine(paged=True, packed=packed, block_size=16)
    srv = _server(ns, eng, ns.srv.ServerConfig(
        step_cost=ns.srv.StepCost(base=1.0, per_token=0.02)))
    for r in _reqs(ns, np.random.RandomState(3), 5, arrival=ARRIVALS):
        srv.submit(r)
    srv.run()
    return srv


@pytest.mark.parametrize("packed", [False, True], ids=["two", "packed"])
def test_online_token_identical_to_offline(packed, pkgs):
    srv, out = serve_both(pkgs, _online, packed=packed)
    ns = pkgs["t"]
    eng = ns.engine(paged=True, packed=packed, block_size=16)
    for r in _reqs(ns, np.random.RandomState(3), 5, arrival=ARRIVALS):
        eng.add_request(r)
    ref = {r.rid: r.output for r in eng.run()}
    _leak_check(eng)
    assert {r.rid: r.output for r in srv.completed} == ref
    per_rid = {}
    for rid, tok, _ in out["streamed"]:
        per_rid.setdefault(rid, []).append(tok)
    assert per_rid == ref
    times = [at for *_, at in out["streamed"]]
    assert times == sorted(times)
    lat = srv.engine.stats.latency
    assert len(lat.ttft) == 5 and len(lat.e2e) == 5 and lat.goodput == 1.0
    for r in srv.completed:
        assert r.ttft is not None and r.ttft >= 0
        assert r.e2e_latency >= r.ttft


def _cancel_mid_prefill(ns):
    rng = np.random.RandomState(5)
    shared = [int(t) for t in rng.randint(0, 128, size=32)]
    eng = ns.engine(paged=True, block_size=16, chunk_tokens=16,
                    prefix_caching=True)
    srv = _server(ns, eng)
    warm = ns.rq.Request(rid=0, prompt=shared + [1, 2], max_new_tokens=2)
    warm.arrival_time = 0.0
    srv.submit(warm)
    victim = ns.rq.Request(rid=1, prompt=shared + list(range(3, 40)),
                           max_new_tokens=4)
    victim.arrival_time = 6.0
    srv.submit(victim)
    srv.cancel(1, at=7.5)
    srv.run()
    return srv


def test_cancel_mid_prefill_releases_blocks_and_prefix_refs(pkgs):
    srv, out = serve_both(pkgs, _cancel_mid_prefill)
    victim = srv.requests[1]
    assert out["completed"] == [0]
    assert victim.finish_reason == "cancelled"
    assert victim.state == TRQ.State.DONE and not victim.output
    assert 0 < victim.prefill_pos < len(victim.prompt)
    assert victim.prompt_hit_tokens > 0
    assert srv.engine.stats.cancelled == 1
    assert len(srv.engine.block_mgr.prefix) > 0


def _cancel_mid_verify(ns, packed):
    eng = ns.engine(paged=True, packed=packed, block_size=16, spec_gamma=3,
                    max_len=256)
    srv = _server(ns, eng)
    motif = [int(t) for t in np.random.RandomState(6).randint(0, 128, 10)]

    def on_token(rq, tok, at):
        if len(rq.output) == 3:
            srv.cancel(1)
    for i in range(3):
        r = ns.rq.Request(rid=i, prompt=motif * 3, max_new_tokens=12)
        r.arrival_time = 0.0
        srv.submit(r, on_token=on_token if i == 1 else None)
    srv.run()
    return srv


@pytest.mark.parametrize("packed", [False, True], ids=["two", "packed"])
def test_cancel_mid_verify_releases_blocks(packed, pkgs):
    srv, out = serve_both(pkgs, _cancel_mid_verify, packed=packed)
    assert set(out["completed"]) == {0, 2}
    victim = srv.aborted[0]
    assert victim.rid == 1 and victim.finish_reason == "cancelled"
    assert 3 <= len(victim.output) < 12
    assert srv.engine.stats.spec.verify_steps > 0
    assert all(len(r.output) == 12 for r in srv.completed)


def _cancel_before_arrival(ns):
    eng = ns.engine(paged=True)
    srv = _server(ns, eng)
    a, b = _reqs(ns, np.random.RandomState(7), 2, arrival=[0.0, 50.0])
    srv.submit(a)
    srv.submit(b)
    srv.cancel(1, at=10.0)
    srv.run()
    return srv


def test_cancel_before_arrival_never_reaches_engine(pkgs):
    srv, out = serve_both(pkgs, _cancel_before_arrival)
    b = srv.requests[1]
    assert out["completed"] == [0]
    assert b.finish_reason == "cancelled" and b.admit_time is None
    assert srv.engine.stats.cancelled == 1
    e2e = srv.engine.stats.latency.e2e
    assert len(e2e) == 1 and all(x >= 0 for x in e2e)


def _deadline_expiry(ns):
    eng = ns.engine(paged=True)
    srv = _server(ns, eng, ns.srv.ServerConfig(
        expire_on_deadline=True))
    reqs = _reqs(ns, np.random.RandomState(8), 4, out=6,
                 arrival=[0.0, 0.5, 1.0, 1.5])
    reqs[2].deadline = reqs[2].arrival_time + 2.0
    for r in reqs:
        srv.submit(r)
    srv.run()
    return srv


def test_deadline_expiry_counts_against_goodput_not_failure(pkgs):
    srv, out = serve_both(pkgs, _deadline_expiry)
    assert set(out["completed"]) == {0, 1, 3}
    r2 = next(r for r in srv.requests if r.rid == 2)
    assert r2.finish_reason == "expired" and not r2.slo_ok
    st = srv.engine.stats
    assert st.expired == 1 and st.cancelled == 0
    assert (st.latency.slo_total, st.latency.slo_met) == (4, 3)
    assert st.latency.goodput == pytest.approx(0.75)


def _late_finish(ns):
    eng = ns.engine(paged=True)
    srv = _server(ns, eng)
    reqs = _reqs(ns, np.random.RandomState(9), 2, out=5, arrival=[0.0, 0.0])
    reqs[1].deadline = 0.5
    for r in reqs:
        srv.submit(r)
    srv.run()
    return srv


def test_deadline_late_finish_without_expiry(pkgs):
    srv, out = serve_both(pkgs, _late_finish)
    late = srv.requests[1]
    assert set(out["completed"]) == {0, 1}
    assert len(late.output) == 5
    assert late.finish_reason == "stop" and not late.slo_ok
    assert srv.engine.stats.expired == 0
    assert srv.engine.stats.latency.goodput == pytest.approx(0.5)


def _admission(ns, policy):
    rng = np.random.RandomState(10)
    eng = ns.engine(paged=True, max_batch=1, policy=policy)
    srv = _server(ns, eng)
    blocker = ns.rq.Request(rid=0, prompt=list(range(8)), max_new_tokens=8)
    blocker.arrival_time = 0.0
    srv.submit(blocker)
    deadlines = {1: 200.0, 2: 50.0, 3: 100.0}
    for rid in (1, 2, 3):
        r = ns.rq.Request(rid=rid,
                          prompt=[int(t) for t in rng.randint(0, 128, 10)],
                          max_new_tokens=2, deadline=deadlines[rid])
        r.arrival_time = 1.0 + 0.1 * rid
        srv.submit(r)
    srv.run()
    return srv


@pytest.mark.parametrize("policy,order", [("fcfs", [1, 2, 3]),
                                          ("edf", [2, 3, 1])])
def test_edf_policy_admits_by_deadline(policy, order, pkgs):
    srv, _ = serve_both(pkgs, _admission, policy=policy)
    got = [rid for _, rid in sorted((r.first_token_time, r.rid)
                                    for r in srv.completed if r.rid != 0)]
    assert got == order


def _late_flood(ns, policy):
    eng = ns.engine(paged=True, max_batch=2, policy=policy)
    srv = _server(ns, eng)
    rng = np.random.RandomState(11)
    for r in _reqs(ns, rng, 2, out=10, arrival=[0.0, 0.0]):
        srv.submit(r)
    flood = [ns.rq.Request(rid=10 + i,
                           prompt=[int(t) for t in rng.randint(0, 128, 12)],
                           max_new_tokens=2, deadline=6.0 + i)
             for i in range(6)]
    for i, r in enumerate(flood):
        r.arrival_time = 2.0 + 0.1 * i
        srv.submit(r)
    srv.run()
    return srv


@pytest.mark.parametrize("policy", ["fcfs", "edf"])
def test_late_arrivals_never_starve_admitted_decodes(policy, pkgs):
    srv, out = serve_both(pkgs, _late_flood, policy=policy)
    assert len(out["completed"]) == 8
    early = [r for r in srv.requests if r.rid < 2]
    last_flood = max(r.finish_time for r in srv.requests if r.rid >= 10)
    for r in early:
        assert len(r.output) == 10 and r.preemptions == 0
        assert r.finish_time <= last_flood


def _traced_poisson(ns):
    rec = ns.Rec(request_ns="online/")
    eng = ns.engine(paged=True, packed=True, obs=rec)
    srv = _server(ns, eng, ns.srv.ServerConfig(
        step_cost=ns.srv.StepCost(base=1.0, per_token=0.05),
        expire_on_deadline=True))
    rng = np.random.RandomState(4)
    reqs = [ns.rq.Request(
        rid=i, prompt=[int(t) for t in rng.randint(
            0, 128, size=rng.randint(8, 30))], max_new_tokens=6)
        for i in range(6)]
    for r in ns.rq.poisson_arrivals(reqs, rate=0.4, seed=9):
        r.deadline = r.arrival_time + 5.0
        srv.submit(r)
    srv.cancel(5, at=0.5)
    srv.run()
    return srv


def test_traced_online_run_matches_reference(pkgs, ref_hw):
    """Poisson arrivals, tight deadlines that expire, a cancel: the
    exported trace (arrival events at the true arrival instants, one
    terminal per request) equals the reference's."""
    srv, out = serve_both(pkgs, _traced_poisson)
    jsrv = _traced_poisson(pkgs["j"])
    eng = srv.engine
    assert eng.stats.expired > 0
    doc = export_chrome_trace(eng.obs)
    assert validate_chrome_trace(doc) == []
    assert json.loads(json.dumps(doc)) == \
        json.loads(json.dumps(j_export(jsrv.engine.obs)))
    by_rid = {}
    for ev in eng.obs.events:
        if ev["kind"] == "request":
            by_rid.setdefault(ev["rid"], []).append(ev)
    assert len(by_rid) == 6
    for evs in by_rid.values():
        assert sum(e["phase"] in TERMINAL_PHASES for e in evs) == 1
    arr = {e["rid"]: e["ts"] for evs in by_rid.values() for e in evs
           if e["phase"] == "arrival"}
    for r in srv.requests:
        if r.admit_time is not None:
            assert arr[f"online/{r.rid}"] == r.arrival_time
    assert eng.metrics_snapshot() == jsrv.engine.metrics_snapshot()


def test_pump_serves_like_run(pkgs):
    """``pump`` returns when the engine goes idle, so submissions can land
    between pumps; pumped to the end it serves what ``run`` serves."""
    ns = pkgs["t"]
    srv = _online(ns, packed=True)
    eng = ns.engine(paged=True, packed=True, block_size=16)
    pumped = ns.srv.OnlineServer(eng, ns.srv.ServerConfig(
        step_cost=ns.srv.StepCost(base=1.0, per_token=0.02)))
    reqs = _reqs(ns, np.random.RandomState(3), 5, arrival=ARRIVALS)
    for r in reqs[:2]:
        pumped.submit(r)
    steps = pumped.pump(max_steps=1)
    assert steps == 1
    for r in reqs[2:]:
        pumped.submit(r)
    while pumped.pump():
        pass
    assert {r.rid: r.output for r in pumped.completed} == \
        {r.rid: r.output for r in srv.completed}
    _leak_check(eng)


def test_server_refusals(pkgs):
    ns = pkgs["t"]
    srv = ns.srv.OnlineServer(ns.engine(paged=True))
    a, b = _reqs(ns, np.random.RandomState(12), 2, arrival=[1.0, 2.0])
    srv.submit(a)
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(a)
    with pytest.raises(ValueError, match="unknown"):
        srv.cancel(99)
    srv.clock = 5.0
    with pytest.raises(ValueError, match="clock"):
        srv.submit(b)
    with pytest.raises(ValueError, match="past"):
        srv.cancel(0, at=1.0)
    tight = ns.srv.OnlineServer(ns.engine(paged=True), ns.srv.ServerConfig(
        max_steps=2))
    for r in _reqs(ns, np.random.RandomState(13), 1, out=6, arrival=[0.0]):
        tight.submit(r)
    with pytest.raises(RuntimeError, match="max_steps"):
        tight.run()
    sc = ns.srv.StepCost.from_calibration({"step_base": 1.5,
                                           "step_per_token": 0.25})
    assert sc.of(2) == 2.0
