"""The PyTorch port's tracing (``obs/trace.py``, ``obs/attribution.py``)
and the engine hooks that feed it, against the JAX reference.

* The validator cases of tests/test_obs.py, built through both packages'
  ``TraceRecorder``: equal exported documents and equal problem lists.
* Eight of the 25 test_differential traces (seeds 1000 + trial), two in
  each of four columns (``two_legacy``, ``two_paged``, ``packed_paged``
  with gamma forced to 0, and ``spec_packed_paged`` with the trace's own
  gamma), served by the reference ``Engine`` and the port's
  ``Engine(device="cpu")`` with a ``TraceRecorder`` each: the exported
  Chrome traces are equal after a JSON round trip, ``metrics_snapshot()``
  is equal key by key, the trace's weave counts equal the engine's, and
  the port's traced run is token- and step-identical to its untraced one.

The sim prices every forward span; the port's ``Attributor`` is given
the reference's ``HW`` field values (``ref_hw``), so the comparison is
exact.  Its own defaults (one H100) are held in tests/test_torch_sim.py.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

from repro.obs import TraceRecorder as JTraceRecorder
from repro.obs import export_chrome_trace as j_export
from repro.obs import validate_chrome_trace as j_validate
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.sim.overlap_sim import HW as JHW

from repro_torch.obs import (TERMINAL_PHASES, TraceRecorder,
                             export_chrome_trace, validate_chrome_trace,
                             weave_counts_from_trace)
from repro_torch.obs import attribution as TA
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.sim.overlap_sim import HW as THW
from test_torch_engine_paged import (SCHED, _drained, _drive, _gen_trace,
                                     fused_plan_path, torch_model)

__all__ = ["fused_plan_path", "torch_model"]   # fixtures

# the JAX test fixture's scheduler defaults (tests/conftest.py)
ENGINE_DEFAULTS = dict(max_batch=4, chunk_tokens=48, max_len=128,
                        prefill_bucket=16)
COLUMNS = {"two_legacy": dict(paged=False, packed=False),
           "two_paged": dict(paged=True, packed=False),
           "packed_paged": dict(paged=True, packed=True),
           "spec_packed_paged": dict(paged=True, packed=True)}
# (trial, column): each column once with a cancellation, once without
TRACE_CASES = [(0, "two_legacy"), (2, "two_legacy"), (4, "two_paged"),
               (23, "two_paged"), (20, "packed_paged"), (24, "packed_paged"),
               (3, "spec_packed_paged"), (5, "spec_packed_paged")]


@pytest.fixture
def ref_hw(monkeypatch):
    """Make the port's ``Attributor`` price on the reference's HW field
    values (the wave unit still comes from the ParallelConfig)."""
    fields = {k: v for k, v in dataclasses.asdict(JHW()).items()
              if k != "tile"}
    monkeypatch.setattr(TA, "HW", functools.partial(THW, **fields))


def t_engine(torch_model, *, obs=None, obs_track="engine", profiler=None,
             temperature=0.0, draft=None, seed=0, **scfg_kw):
    """The port's engine with the JAX fixture's scheduler defaults."""
    api, tparams = torch_model
    scfg = TSched(**{**ENGINE_DEFAULTS, **scfg_kw})
    return TEngine(api, tparams, scfg, temperature=temperature,
                   draft=draft, seed=seed, device="cpu", obs=obs,
                   obs_track=obs_track, profiler=profiler)


def roundtrip(doc):
    return json.loads(json.dumps(doc))


def trace_case(trial: int, column: str):
    """The trace's prompts, budgets and cancels, and the scheduler
    config of its column (gamma forced to 0 outside the spec column)."""
    prompts, outs, gamma, cancels = _gen_trace(
        np.random.RandomState(1000 + trial))
    if column.startswith("spec"):
        assert gamma > 0
    else:
        gamma = 0
    return prompts, outs, cancels, {**SCHED, **COLUMNS[column],
                                    "spec_gamma": gamma}


def drive_both(tiny_engine_builder, torch_model, trial, column, **kw):
    """Serve one trace through both engines with ``kw``: obs/profiler
    factories, each called with the package ("j" or "t") of the engine it
    builds for.  Returns (jeng, teng, got, want)."""
    prompts, outs, cancels, cfg = trace_case(trial, column)
    jkw = {k: f("j") for k, f in kw.items()}
    tkw = {k: f("t") for k, f in kw.items()}
    jeng = tiny_engine_builder(**cfg, **jkw)
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    teng = t_engine(torch_model, **cfg, **tkw)
    got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
    _drained(teng)
    return jeng, teng, got, want


# --------------------------------------------------------------------------
# recorder + export + validator (hand-built traces, tests/test_obs.py)
# --------------------------------------------------------------------------

def _forward_args(**over):
    a = dict(kind="prefill", weave=True, reason="split", tokens=64,
             tokens_real=64, threshold=32, split=[32, 32],
             method="tokenweave", plan_id=0, bucket="64-127",
             est_compute=1.0, est_comm=0.5, est_overlapped=0.4)
    a.update(over)
    return a


def _valid(Rec):
    rec = Rec()
    rec.complete("eng", "step/packed", 0.0, 2.0, cat="step",
                 args={"step": 0, "forwards": 1})
    rec.complete("eng", "forward/packed", 0.0, 2.0, cat="forward",
                 args=_forward_args())
    rec.request_event(1, "queued", ts=0.0)
    rec.request_event(1, "admit", ts=0.5)
    rec.request_event(1, "finish", ts=2.0)
    rec.instant("eng", "mark", ts=1.0, args={"x": 1})
    return rec


def _forward_escapes_step(Rec):
    rec = Rec()
    rec.complete("eng", "step/packed", 0.0, 1.0, cat="step")
    rec.complete("eng", "forward/packed", 0.5, 2.0, cat="forward",
                 args=_forward_args())
    return rec


def _backwards(Rec):
    rec = Rec()
    rec.complete("eng", "step/a", 5.0, 1.0, cat="step")
    rec.complete("eng", "step/b", 1.0, 1.0, cat="step")
    return rec


def _missing_attribution(Rec):
    rec = Rec()
    a = _forward_args()
    del a["est_overlapped"]
    rec.complete("eng", "step/packed", 0.0, 1.0, cat="step")
    rec.complete("eng", "forward/packed", 0.0, 1.0, cat="forward", args=a)
    return rec


def _missing_terminal(Rec):
    rec = Rec()
    rec.request_event(3, "queued", ts=0.0)
    rec.request_event(3, "admit", ts=1.0)
    return rec


def _double_terminal(Rec):
    rec = Rec()
    rec.request_event(3, "queued", ts=0.0)
    rec.request_event(3, "admit", ts=1.0)
    rec.request_event(3, "finish", ts=2.0)
    rec.request_event(3, "cancel", ts=3.0)
    return rec


def _merged_namespaces(Rec):
    recs = [Rec(request_ns="a/"), Rec(request_ns="b/")]
    for rec in recs:
        rec.request_event(0, "queued", ts=0.0)
        rec.request_event(0, "admit", ts=0.0)
        rec.request_event(0, "finish", ts=1.0)
    return recs


VALIDATOR_CASES = {
    "valid": (_valid, None),
    "forward_escapes_step": (_forward_escapes_step, "step"),
    "backwards": (_backwards, "backwards"),
    "missing_attribution": (_missing_attribution, "est_overlapped"),
    "missing_terminal": (_missing_terminal, "terminal"),
    "double_terminal": (_double_terminal, "terminal"),
    "merged_namespaces": (_merged_namespaces, None),
}


@pytest.mark.parametrize("case", sorted(VALIDATOR_CASES))
def test_validator_cases_match_reference(case, tmp_path):
    build, needle = VALIDATOR_CASES[case]
    tdoc = export_chrome_trace(build(TraceRecorder),
                               path=str(tmp_path / "t.json"))
    jdoc = j_export(build(JTraceRecorder))
    assert roundtrip(tdoc) == roundtrip(jdoc)
    assert json.loads((tmp_path / "t.json").read_text()) == roundtrip(jdoc)
    fails = validate_chrome_trace(tdoc)
    assert fails == j_validate(jdoc)
    if needle is None:
        assert fails == []
    else:
        assert any(needle in f.lower() for f in fails), fails


def test_validator_rejects_malformed_documents():
    for doc in ({}, {"traceEvents": 3},
                {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0}]},
                {"traceEvents": [{"name": "a", "ph": "X", "pid": 1,
                                  "tid": 0, "ts": 0.0, "dur": -1.0}]},
                {"traceEvents": [{"name": "a", "ph": "i", "pid": 1,
                                  "tid": 0, "ts": "x"}]}):
        fails = validate_chrome_trace(doc)
        assert fails and fails == j_validate(doc)


def test_recorder_clock_never_reads_wall_time():
    """``auto`` stamps the offline clock until an owner ``sync``s; then
    it is a no-op.  Request events take the clock unless given a ts."""
    rec = TraceRecorder(request_ns="ns/")
    rec.auto(3.0)
    rec.request_event(1, "queued")
    rec.sync(10.0)
    rec.auto(4.0)
    rec.request_event(1, "admit")
    assert rec.now == 10.0
    assert [(e["rid"], e["ts"]) for e in rec.events] == [("ns/1", 3.0),
                                                         ("ns/1", 10.0)]
    assert TERMINAL_PHASES == ("finish", "cancel", "expire")


# --------------------------------------------------------------------------
# engine integration
# --------------------------------------------------------------------------

def test_tracing_is_off_by_default(torch_model):
    eng = t_engine(torch_model, paged=True)
    assert eng.obs is None and eng.profiler is None
    assert eng._attributor is None
    eng.add_request(TRequest(rid=0, prompt=list(range(1, 9)),
                             max_new_tokens=3))
    eng.run()
    assert eng.stats.completed == 1
    assert eng._step_forwards == []


@pytest.mark.parametrize("trial,column", TRACE_CASES)
def test_engine_trace_equals_reference(trial, column, tiny_engine_builder,
                                       torch_model, ref_hw):
    jeng, teng, got, want = drive_both(
        tiny_engine_builder, torch_model, trial, column,
        obs=lambda pkg: JTraceRecorder() if pkg == "j" else TraceRecorder())
    assert got == want
    tdoc = export_chrome_trace(teng.obs)
    assert roundtrip(tdoc) == roundtrip(j_export(jeng.obs))
    assert validate_chrome_trace(tdoc) == []
    assert teng.metrics_snapshot() == jeng.metrics_snapshot()
    st = teng.stats
    assert weave_counts_from_trace(teng.obs) == (st.weave_forwards,
                                                 st.forwards) != (0, 0)
    steps = [e for e in teng.obs.events
             if e["kind"] == "span" and e["cat"] == "step"]
    assert len(steps) == st.steps
    phases = [e["phase"] for e in teng.obs.events if e["kind"] == "request"]
    for p in ("queued", "admit", "prefill_done", "finish"):
        assert p in phases
    if trace_case(trial, column)[2]:
        assert "cancel" in phases

    # tracing only observes: the untraced port run is identical
    prompts, outs, cancels, cfg = trace_case(trial, column)
    plain = t_engine(torch_model, **cfg)
    assert _drive(plain, TRequest, TState.DONE, prompts, outs,
                  cancels) == got
    assert (plain.stats.steps, plain.stats.forwards) == (st.steps,
                                                         st.forwards)


def test_trace_cases_cover_cancels_and_spec():
    cases = [trace_case(t, c) for t, c in TRACE_CASES]
    assert sum(bool(c) for _, _, c, _ in cases) == 4
    assert all(cfg["spec_gamma"] > 0 for t, c in TRACE_CASES
               for *_, cfg in [trace_case(t, c)] if c.startswith("spec"))


def test_preempt_events_and_snapshot_match_reference(tiny_engine_builder,
                                                     torch_model, ref_hw):
    """A starved pool (9 blocks of 16, 4 requests of 30 tokens): both
    engines preempt; the traces (``preempt`` events included) and the
    snapshots (paging gauges included) are equal."""
    rng = np.random.RandomState(77)
    prompts = [[int(t) for t in rng.randint(0, 128, 30)] for _ in range(4)]
    cfg = dict(SCHED, paged=True, packed=False, max_batch=4, num_blocks=9,
               prefix_caching=False)
    jeng = tiny_engine_builder(**cfg, obs=JTraceRecorder())
    want = _drive(jeng, JRequest, JState.DONE, prompts, [12] * 4, {})
    teng = t_engine(torch_model, **cfg, obs=TraceRecorder())
    got = _drive(teng, TRequest, TState.DONE, prompts, [12] * 4, {})
    assert got == want
    assert teng.block_mgr.stats.preemptions > 0
    phases = [e["phase"] for e in teng.obs.events if e["kind"] == "request"]
    assert "preempt" in phases
    assert roundtrip(export_chrome_trace(teng.obs)) == \
        roundtrip(j_export(jeng.obs))
    assert teng.metrics_snapshot() == jeng.metrics_snapshot()


def test_policy_swap_rebuilds_attributor(torch_model, fused_plan_path):
    """``install_overlap_policy`` rebuilds the attributor, so forward
    spans after the swap price the new plan (method ringweave/ring)."""
    from repro_torch.core.policy import load_policy
    eng = t_engine(torch_model, obs=TraceRecorder(), paged=True,
                   packed=True, block_size=16)
    before = eng._attributor
    eng.install_overlap_policy(load_policy(fused_plan_path))
    assert eng._attributor is not before
    assert eng._attributor.pcfg.overlap_policy is \
        eng.api.pcfg.overlap_policy
    eng.add_request(TRequest(rid=0, prompt=list(range(1, 60)),
                             max_new_tokens=3))
    eng.run()
    methods = {e["args"]["method"] for e in eng.obs.events
               if e["kind"] == "span" and e["cat"] == "forward"}
    assert methods <= {"ring", "ringweave"} and methods
    plan_ids = {e["args"]["plan_id"] for e in eng.obs.events
                if e["kind"] == "span" and e["cat"] == "forward"}
    assert plan_ids == {424242}
