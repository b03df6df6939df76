"""The PyTorch port's measured-time profiler (``obs/profiler.py``) and
cost-model calibration (``analysis/calibration.py``), against the JAX
reference.

* Profiling only observes: over the eight traces of test_torch_obs.py the
  port's profiled engine is token- and step-identical to its unprofiled
  one, and its samples carry the reference's keys, kinds, methods, token
  counts and warm-up flags; the ``profile/warmup_excluded`` counter and
  the ``profile/forward_us`` histogram counts equal the reference's; the
  ``[measured]`` track's span names and args, ``measured_us`` aside, equal
  the reference's.
* The fence: on a CUDA device the wrapper synchronizes the device (every
  stream) before the timer starts and before it stops; on the CPU there
  is nothing to drain; unattached, it refuses to time.
* The calibration tests of tests/test_profiler.py (planted parameters
  recovered, a linear step cost, empty and warm-up-only inputs refused,
  the exact JSON round trip, export to the registry), each with the
  port's report equal to the reference's on the same synthetic samples
  (``peak`` and ``hbm`` passed as the reference's defaults).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis.calibration import TimingSample as JTimingSample
from repro.analysis.calibration import fit_calibration as j_fit
from repro.configs.base import ModelConfig as JModelConfig
from repro.obs import WallClockProfiler as JProfiler
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.server import StepCost as JStepCost
from repro.sim.overlap_sim import HW as JHW
from repro.sim.overlap_sim import step_attribution as j_step_attribution

from repro_torch.analysis.calibration import (CalibrationReport,
                                              TimingSample, fit_calibration)
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.obs import (MEASURED_CAT, MetricsRegistry, TraceRecorder,
                             WallClockProfiler, export_chrome_trace,
                             validate_chrome_trace)
from repro_torch.obs.profiler import MEASURED_TRACK_SUFFIX
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.server import StepCost
from repro_torch.sim.overlap_sim import HW, step_attribution
from test_torch_engine_paged import _drive
from test_torch_obs import (TRACE_CASES, drive_both, ref_hw, t_engine,
                            torch_model, trace_case)

__all__ = ["ref_hw", "torch_model"]   # fixtures


def _profile_keys(snap):
    return {k: v for k, v in snap.items() if k.startswith("profile/")
            and (k.endswith("/count") or k == "profile/warmup_excluded")}


def _sample_record(s):
    return (s.key, s.kind, s.method, s.weave, s.tokens_static,
            s.tokens_real, s.split, s.est_makespan, s.warmup)


# --------------------------------------------------------------------------
# profiler on vs off, and against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("trial,column", TRACE_CASES)
def test_profiled_engine_matches_reference(trial, column,
                                           tiny_engine_builder, torch_model,
                                           ref_hw):
    jeng, teng, got, want = drive_both(
        tiny_engine_builder, torch_model, trial, column,
        profiler=lambda pkg: JProfiler() if pkg == "j"
        else WallClockProfiler())
    assert got == want
    jprof, tprof = jeng.profiler, teng.profiler
    assert isinstance(tprof, WallClockProfiler)
    assert len(tprof.samples) == teng.stats.forwards > 0
    assert all(s.wall_s > 0.0 for s in tprof.samples)
    assert [_sample_record(s) for s in tprof.samples] == \
        [_sample_record(s) for s in jprof.samples]
    assert _profile_keys(teng.metrics.snapshot()) == \
        _profile_keys(jeng.metrics.snapshot())
    assert set(tprof.summary()) == set(jprof.summary())

    prompts, outs, cancels, cfg = trace_case(trial, column)
    plain = t_engine(torch_model, **cfg)
    assert _drive(plain, TRequest, TState.DONE, prompts, outs,
                  cancels) == got
    assert (plain.stats.steps, plain.stats.forwards) == \
        (teng.stats.steps, teng.stats.forwards)


def test_warmup_exclusion_and_histograms(torch_model):
    """The first call of each (kind, b, s) is a warm-up: one per shape,
    excluded from the steady samples and histograms, and counted."""
    prof = WallClockProfiler(warmup_per_key=1)
    eng = t_engine(torch_model, paged=True, profiler=prof)
    prompts = [list(range(2, 26)), list(range(3, 27)), list(range(4, 28))]
    _drive(eng, TRequest, TState.DONE, prompts, [5, 5, 5], {})
    shapes = {s.key for s in prof.samples}
    warm = [s for s in prof.samples if s.warmup]
    assert len(warm) == len(shapes)
    for key in shapes:
        assert next(s for s in prof.samples if s.key == key).warmup
    assert len(prof.steady_samples()) == len(prof.samples) - len(warm)
    snap = eng.metrics.snapshot()
    assert snap["profile/warmup_excluded"] == len(warm)
    assert sum(v for k, v in snap.items()
               if k.startswith("profile/forward_us{")
               and k.endswith("/count")) == len(prof.steady_samples())
    summ = prof.summary()
    assert sum(r["n"] for r in summ.values()) == len(prof.steady_samples())
    for row in summ.values():
        assert row["mean_s"] == row["total_s"] / row["n"]


def test_measured_track_matches_reference(tiny_engine_builder, torch_model,
                                          ref_hw):
    from repro.obs import TraceRecorder as JTraceRecorder
    from repro.obs import export_chrome_trace as j_export
    cfg = dict(paged=True)
    prompts = [list(range(2, 34)), list(range(5, 29))]
    jeng = tiny_engine_builder(**cfg, obs=JTraceRecorder(),
                               profiler=JProfiler())
    _drive(jeng, JRequest, JState.DONE, prompts, [4, 4], {})
    teng = t_engine(torch_model, **cfg, obs=TraceRecorder(),
                    profiler=WallClockProfiler())
    _drive(teng, TRequest, TState.DONE, prompts, [4, 4], {})

    def measured(doc):
        out = []
        for ev in doc["traceEvents"]:
            if ev.get("cat") == MEASURED_CAT:
                assert ev["args"]["measured_us"] > 0 and ev["dur"] > 0
                args = {k: v for k, v in ev["args"].items()
                        if k != "measured_us"}
                out.append((ev["name"], ev["ph"], args))
        return out

    tdoc = export_chrome_trace(teng.obs)
    assert validate_chrome_trace(tdoc) == []
    got = measured(tdoc)
    assert got == measured(j_export(jeng.obs))
    assert len(got) == len(teng.profiler.steady_samples()) > 0
    tracks = {ev["track"] for ev in teng.obs.events
              if ev.get("cat") == MEASURED_CAT}
    assert tracks == {"engine" + MEASURED_TRACK_SUFFIX}


def test_profiler_off_by_default(torch_model):
    eng = t_engine(torch_model, paged=True)
    assert eng.profiler is None
    assert not any(k.startswith("profile/")
                   for k in eng.metrics.snapshot())


# --------------------------------------------------------------------------
# the fence
# --------------------------------------------------------------------------

def test_fence_synchronizes_the_cuda_device_on_both_sides(monkeypatch):
    """On a CUDA device, ``torch.cuda.synchronize(device)`` (which drains
    every stream, the weave's comm stream included) runs before the timer
    starts and before it stops, around the call; the output is returned
    untouched."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: log.append(("sync", device)))
    prof = WallClockProfiler().attach(device="cuda:0")

    def dispatch(x, *, y):
        log.append(("call", x, y))
        return x + y
    assert prof.wrap(dispatch)(2, y=3) == 5
    dev = torch.device("cuda:0")
    assert log == [("sync", dev), ("call", 2, 3), ("sync", dev)]
    assert prof._pending is not None and prof._pending >= 0.0


def test_fence_on_cpu_and_unattached(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    prof = WallClockProfiler().attach(device="cpu")
    assert prof.wrap(lambda: 7)() == 7
    assert calls == []                     # CPU ops are done on return
    with pytest.raises(RuntimeError, match="attach"):
        WallClockProfiler().wrap(lambda: 7)()


def test_commit_without_pending_or_attribution_records_nothing():
    prof = WallClockProfiler().attach(MetricsRegistry(), device="cpu")
    prof.commit(None)
    prof.wrap(lambda: None)()
    prof.commit(None)                      # the timing is dropped
    assert prof.samples == [] and prof._pending is None


# --------------------------------------------------------------------------
# calibration fit (tests/test_profiler.py's cases, against the reference)
# --------------------------------------------------------------------------

REF_HW = JHW()


def _big_cfgs():
    j = JModelConfig(name="llama-like", family="dense", num_layers=32,
                     d_model=4096, num_heads=32, num_kv_heads=8,
                     head_dim=128, d_ff=14336, vocab_size=32000,
                     dtype="bfloat16")
    return j, TModelConfig(**dataclasses.asdict(j))


def _synthetic(cfg, planted, tp):
    out = []
    for method in ("vanilla", "fuseonly", "tokenweave"):
        for t in (8, 64, 256, 1024, 4096, 16384):
            y = j_step_attribution(cfg, method, t, tp=tp,
                                   hw=planted)["makespan"]
            out += [(method, t, y)] * 3
    return out


def _fit_both(samples, **kw):
    """The port's and the reference's reports on the same samples, the
    port given the reference's peak and hbm."""
    jcfg, tcfg = _big_cfgs()
    jrep = j_fit(jcfg, [JTimingSample(method=m, tokens=t, wall_s=y,
                                      tokens_real=t)
                        for m, t, y in samples], **kw)
    trep = fit_calibration(tcfg, [TimingSample(method=m, tokens=t,
                                               wall_s=y, tokens_real=t)
                                  for m, t, y in samples],
                           peak=REF_HW.peak, hbm=REF_HW.hbm, **kw)
    assert trep.to_dict() == jrep.to_dict()
    return trep


def test_fit_recovers_planted_params():
    jcfg, _ = _big_cfgs()
    planted = JHW(tile=256, mfu_cap=0.42, ici=37e9, overhead=35e-6)
    rep = _fit_both(_synthetic(jcfg, planted, 8), tp=8, tile=256)
    assert rep.mfu_cap == pytest.approx(planted.mfu_cap, rel=0.01)
    assert rep.ici == pytest.approx(planted.ici, rel=0.01)
    assert rep.overhead == pytest.approx(planted.overhead, rel=0.01)
    assert rep.worst_rel_err < 1e-6
    assert set(rep.per_mode_rel_err) == {"vanilla", "fuseonly",
                                         "tokenweave"}


def test_fit_linear_step_cost():
    samples = [("vanilla", t, 2e-3 + 5e-6 * t) for t in (16, 64, 256, 1024)]
    rep = _fit_both(samples, tp=8, tile=256)
    assert rep.step_base == pytest.approx(2e-3, rel=1e-6)
    assert rep.step_per_token == pytest.approx(5e-6, rel=1e-6)
    sc, jsc = StepCost.from_calibration(rep), JStepCost.from_calibration(
        rep.to_dict())
    assert (sc.base, sc.per_token) == (jsc.base, jsc.per_token)
    assert sc.of(100) == pytest.approx(2e-3 + 5e-6 * 100, rel=1e-6)


def test_fit_refuses_empty_and_warmup_only_and_skips_warmup():
    _, tcfg = _big_cfgs()
    with pytest.raises(ValueError, match="steady"):
        fit_calibration(tcfg, [], tp=8, tile=256)

    class Warm:
        method, tokens, tokens_real, wall_s, warmup = \
            "vanilla", 256, 256, 999.0, True
    with pytest.raises(ValueError, match="steady"):
        fit_calibration(tcfg, [Warm(), Warm()], tp=8, tile=256)
    jcfg, _ = _big_cfgs()
    good = _synthetic(jcfg, JHW(tile=256, mfu_cap=0.5, ici=50e9), 8)
    rep = fit_calibration(
        tcfg, [TimingSample(method=m, tokens=t, wall_s=y, tokens_real=t)
               for m, t, y in good] + [Warm(), Warm()],
        tp=8, tile=256, peak=REF_HW.peak, hbm=REF_HW.hbm)
    assert rep.worst_rel_err < 1e-6
    assert rep.n_samples == len(good)


def test_report_roundtrip_exact(tmp_path):
    jcfg, tcfg = _big_cfgs()
    planted = JHW(tile=256, mfu_cap=0.37, ici=45e9, overhead=20e-6)
    rep = _fit_both(_synthetic(jcfg, planted, 8), tp=8, tile=256)
    path = str(tmp_path / "cal.json")
    rep.save(path)
    back = CalibrationReport.load(path)
    assert back.to_dict() == rep.to_dict()
    hw = HW.from_calibration(back)
    assert hw == rep.hw()
    for b in back.buckets:
        pred = step_attribution(tcfg, b["method"], max(b["tokens"], 1),
                                tp=back.tp, hw=hw,
                                n_layers=back.n_layers)["makespan"]
        assert pred == b["predicted_s"]
    # the reference reads the port's JSON to the same report
    from repro.analysis.calibration import CalibrationReport as JReport
    assert JReport.load(path).to_dict() == rep.to_dict()
    sc = StepCost.from_calibration(back)
    assert (sc.base, sc.per_token) == (rep.step_base, rep.step_per_token)


def test_export_to_registry():
    jcfg, _ = _big_cfgs()
    planted = JHW(tile=256, mfu_cap=0.5, ici=60e9, overhead=10e-6)
    rep = _fit_both(_synthetic(jcfg, planted, 8), tp=8, tile=256)
    reg, jreg = MetricsRegistry(), JRegistry()
    rep.export_to(reg)
    from repro.analysis.calibration import CalibrationReport as JReport
    JReport.from_dict(rep.to_dict()).export_to(jreg)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    for mode in rep.per_mode_rel_err:
        assert (snap[f"profile/predicted_vs_measured{{mode={mode}}}"]
                == rep.per_mode_rel_err[mode])
    assert snap["profile/calibration/mfu_cap"] == rep.mfu_cap


def test_fit_on_engine_samples(torch_model):
    """The fit takes a profiled engine's steady samples directly (CPU
    wall time: the numbers mean nothing for a device, only the plumbing
    is checked) and predicts a finite positive time for every bucket."""
    prof = WallClockProfiler()
    eng = t_engine(torch_model, paged=True, packed=True, profiler=prof)
    prompts = [list(range(2, 40)), list(range(3, 30)), list(range(7, 50))]
    _drive(eng, TRequest, TState.DONE, prompts, [6, 6, 6], {})
    rep = fit_calibration(eng.api.cfg, prof.steady_samples(), tp=1,
                          tile=eng.api.pcfg.split_unit_for(1))
    assert rep.n_samples == len(prof.steady_samples()) > 0
    assert all(np.isfinite(b["predicted_s"]) and b["predicted_s"] > 0
               for b in rep.buckets)
