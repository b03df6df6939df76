"""The port's overlap-plan autotuner (``analysis/autotune.py``), its plan
checker (``analysis/check_plan.py``) and an engine served from a tuned
plan, against the reference's.

Given the reference's ``HW`` fields (v5e) the port's search must write the
reference's committed plan (``benchmarks/plans/default.json``, read only)
and the reference's ``build_default_plan()`` entry for entry, plan id
included; the same with a calibration.  Under the port's defaults (one
H100) it must write the committed ``analysis/plans/h100_default.json``.
The engine test serves the H100 plan's tp=8 entries at tp=2 (the plan
has no tp=2 target) on the CPU: every forward's ``WeaveInfo.budget`` is
its entry's, K1's grid is ``ring_ctas`` of it, and the greedy tokens are
the threshold policy's.
"""
import copy
import dataclasses
import json
import os

import pytest
import torch

from repro.analysis import autotune as JA
from repro.sim import overlap_sim as JS

from repro_torch.analysis import autotune as TA
from repro_torch.analysis import check_plan as CP
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.policy import TunedPolicy
from repro_torch.core.splitting import ring_ctas
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.sim.overlap_sim import HW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "benchmarks", "plans", "default.json")
CAL = {"peak": 610e12, "hbm": 2.9e12, "ici": 1.7e11, "mfu_cap": 0.41,
       "overhead": 3.5e-5, "tile": 256}


def _plan_fields(doc):
    return {k: doc[k] for k in ("version", "plan_id", "bucket_edges",
                                "entries")}


def _ref_hw() -> HW:
    return HW(**dataclasses.asdict(JS.HW()))


def test_reference_hw_writes_the_committed_plan():
    port = TA.build_default_plan(hw=_ref_hw()).to_doc()
    with open(COMMITTED) as f:
        committed = json.load(f)
    assert _plan_fields(port) == _plan_fields(committed)
    assert port == JA.build_default_plan().to_doc()


def test_calibration_writes_the_references_plan():
    port = TA.build_default_plan(CAL).to_doc()
    ref = JA.build_default_plan(CAL).to_doc()
    assert port == ref
    assert port["plan_id"] != TA.build_default_plan().plan_id


def test_defaults_run_writes_the_h100_plan(tmp_path):
    out = tmp_path / "plan.json"
    assert TA.main(["--out", str(out)]) == 0
    with open(TA.H100_PLAN) as f:
        committed = json.load(f)
    assert json.loads(out.read_text()) == committed
    with open(out) as f, open(TA.H100_PLAN) as g:
        assert f.read() == g.read()
    # one H100's constants, not the reference's: a plan of its own
    assert committed["plan_id"] != TA.build_default_plan(
        hw=_ref_hw()).plan_id


def test_check_plan_passes_the_h100_plan(capsys):
    assert CP.main([TA.H100_PLAN, "--expect", TA.H100_PLAN]) == 0
    assert "matches committed plan" in capsys.readouterr().out


def _zero_cta(doc):
    e = next(e for e in doc["entries"]
             if e["method"] in ("fused", "fused-unsplit"))
    e["budget"] = 0.01            # round(0.01 * 8) = 0 CTAs
    return ("maps to 0 K1 CTAs",)


def _duplicate(doc):
    doc["entries"].append(dict(doc["entries"][3]))
    return ("duplicate entry key",)


@pytest.mark.parametrize("fault", [_zero_cta, _duplicate],
                         ids=["zero_cta_budget", "duplicate_key"])
def test_check_plan_fails_one_line_per_fault(fault, tmp_path, capsys):
    with open(TA.H100_PLAN) as f:
        doc = json.load(f)
    want = fault(doc)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(doc))
    assert CP.main([str(path)]) == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("  - ")]
    assert len(lines) == len(want)
    for ln, w in zip(lines, want):
        assert w in ln
    assert len(CP.check_plan(doc)) == 1


# --------------------------------------------------------------------------
# an engine served from the plan
# --------------------------------------------------------------------------

TINY = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=128, dtype="float32")
PCFG = ParallelConfig(tokenweave=True, comm_mode="ring", remat=False,
                      split_unit=16, tokenweave_min_tokens=32,
                      attn_impl="pallas", use_pallas_norm=True)


def retarget(plan: TunedPolicy, tp_from: int, tp_to: int) -> TunedPolicy:
    """The plan's ``tp_from`` entries granted at ``tp_to``."""
    entries = tuple(dataclasses.replace(e, tp=tp_to) for e in plan.entries
                    if e.tp == tp_from)
    return dataclasses.replace(plan, entries=entries)


def _serve(api, params, plan_path=None):
    eng = Engine(api, params,
                 SchedulerConfig(max_batch=4, chunk_tokens=96, max_len=160,
                                 prefill_bucket=16, plan_path=plan_path),
                 device="cpu")
    g = torch.Generator().manual_seed(3)
    for rid, n in enumerate((90, 40, 70, 12)):
        eng.add_request(Request(rid=rid, prompt=torch.randint(
            0, 128, (n,), generator=g).tolist(), max_new_tokens=5))
    return {r.rid: r.output for r in eng.run()}


def test_engine_serves_the_h100_plan(tmp_path, monkeypatch):
    plan = retarget(TunedPolicy.load(TA.H100_PLAN), 8, 2)
    path = tmp_path / "h100_tp2.json"
    plan.save(str(path))
    api = build_model(TINY, PCFG, tp=2)
    params = api.init(0, device="cpu")
    threshold = _serve(api, params)

    infos, grids = [], []
    decide = transformer.weave_decision_info
    k1 = ops._k1

    def spy_decide(*a, **kw):
        info = decide(*a, **kw)
        infos.append(info)
        return info

    def spy_k1(*a, ctas, **kw):
        grids.append((ctas, infos[-1].budget))
        return k1(*a, ctas=ctas, **kw)

    monkeypatch.setattr(transformer, "weave_decision_info", spy_decide)
    monkeypatch.setattr(ops, "_k1", spy_k1)
    tuned = _serve(api, params, plan_path=str(path))
    assert tuned == threshold
    assert infos and grids
    index = {(e.site, e.bucket, e.tp, e.family): e for e in plan.entries}
    for info in infos:
        entry = index.get((info.site, info.bucket, 2, "dense"))
        assert info.plan_id == plan.plan_id
        assert info.budget == (entry.budget if entry else 1.0), info
    budgets = {b for _, b in grids}
    assert budgets == {0.5}           # the H100 plan grants K1 4 CTAs
    assert all(ctas == ring_ctas(b) for ctas, b in grids)
    # the tuned engine split where the threshold one would not, or cut
    # elsewhere: the plan really changed the forwards
    assert any(i.reason in ("plan_split", "plan_unsplit") for i in infos)


def test_retarget_keeps_only_the_source_tp():
    plan = TunedPolicy.load(TA.H100_PLAN)
    got = retarget(plan, 8, 2)
    assert {e.tp for e in got.entries} == {2}
    assert len(got.entries) == sum(e.tp == 8 for e in plan.entries)
    assert copy.deepcopy(got).plan_id == plan.plan_id
