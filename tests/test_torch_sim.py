"""The PyTorch port's §9 sim (``sim/overlap_sim.py``) and roofline
constants (``analysis/roofline.py``) against the reference's.

The sim is pure Python: given ``HW`` objects with equal fields, every
public function must return bit-equal floats in both packages, over a
grid of modes × tokens × tp ∈ {1, 2, 8} × comm budgets, for a dense and
a MoE configuration.  Each case runs twice: under the reference's
defaults (TPU v5e) and under the port's (one H100), both passed to both
packages explicitly.  Separate tests hold the port's defaults to the
H100 data sheet and apart from the reference's.
"""
import dataclasses

import pytest

from repro.analysis import roofline as JR
from repro.configs.llama3_70b import CONFIG as J_LLAMA
from repro.configs.mixtral_8x22b import CONFIG as J_MIXTRAL
from repro.sim import overlap_sim as JS

from repro_torch.analysis import roofline as TR
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.sim import overlap_sim as TS

MODES = ("vanilla", "reordered", "fuseonly", "tokenweave", "ring",
         "ringweave", "nocomm")
TOKENS = (1, 7, 64, 300, 1000, 4096)
TPS = (1, 2, 8)
BUDGETS = (None, 0.5, 0.25)


def _cfgs(jcfg):
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


CFGS = {"llama": _cfgs(J_LLAMA), "mixtral": _cfgs(J_MIXTRAL)}


def _hws(which: str, **over):
    """Equal-field HW objects in both packages: the reference's default
    constants ("ref") or the port's ("port"), with ``over`` applied."""
    base = JS.HW() if which == "ref" else TS.HW()
    fields = {**dataclasses.asdict(base), **over}
    return JS.HW(**fields), TS.HW(**fields)


def _ops(ops):
    return [dataclasses.asdict(o) for o in ops]


# --------------------------------------------------------------------------
# defaults: one H100, not v5e
# --------------------------------------------------------------------------

def test_roofline_constants_are_the_h100s():
    """NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
    HBM3, 900 GB/s NVLink per GPU (both directions); a ring step sends at
    one direction's rate."""
    assert TR.PEAK_FLOPS == 989e12
    assert TR.HBM_BW == 3.35e12
    assert TR.NVLINK_BW == 900e9
    assert TR.ICI_EFF == 450e9
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_EFF"):
        assert getattr(TR, name) != getattr(JR, name), name


def test_sim_defaults_are_the_h100s():
    hw = TS.HW()
    assert (hw.peak, hw.hbm, hw.ici) == (TR.PEAK_FLOPS, TR.HBM_BW,
                                          TR.ICI_EFF)
    jhw = JS.HW()
    assert (hw.tile, hw.mfu_cap, hw.overhead) == (jhw.tile, jhw.mfu_cap,
                                                  jhw.overhead)
    assert (hw.peak, hw.hbm, hw.ici) != (jhw.peak, jhw.hbm, jhw.ici)
    # the defaults reach every priced function
    cfg = CFGS["llama"][1]
    assert TS.step_attribution(cfg, "tokenweave", 1000) == \
        TS.step_attribution(cfg, "tokenweave", 1000, hw=TS.HW())


def test_hw_from_calibration_defaults():
    """A partial calibration loads against the port's (H100) defaults; a
    full one gives the reference's fields exactly."""
    assert TS.HW.from_calibration({}) == TS.HW()
    part = TS.HW.from_calibration({"mfu_cap": 0.3, "ici": 7e9})
    assert part == dataclasses.replace(TS.HW(), mfu_cap=0.3, ici=7e9)
    full = {"peak": 1e14, "hbm": 2e12, "ici": 3e10, "tile": 128,
            "mfu_cap": 0.45, "overhead": 2.5e-5, "ignored": 1}
    assert dataclasses.asdict(TS.HW.from_calibration(full)) == \
        dataclasses.asdict(JS.HW.from_calibration(full))

    class Report:
        mfu_cap, overhead = 0.2, 1e-4
    assert TS.HW.from_calibration(Report()) == dataclasses.replace(
        TS.HW(), mfu_cap=0.2, overhead=1e-4)


# --------------------------------------------------------------------------
# bit-equal under equal HW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ref", "port"])
@pytest.mark.parametrize("model", sorted(CFGS))
def test_per_op_costs_bit_equal(model, which):
    jcfg, tcfg = CFGS[model]
    jhw, thw = _hws(which, tile=128)
    for t in TOKENS:
        assert TS._quantize(t, thw) == JS._quantize(t, jhw)
        assert TS.t_gemm(t, 3.5e8, 1.2e8, thw) == \
            JS.t_gemm(t, 3.5e8, 1.2e8, jhw)
        assert TS.t_norm(t, jcfg.d_model, thw, fused=True) == \
            JS.t_norm(t, jcfg.d_model, jhw, fused=True)
        assert TS.t_norm(t, jcfg.d_model, thw, fused=False) == \
            JS.t_norm(t, jcfg.d_model, jhw, fused=False)
        assert TS.t_ring_norm(t, jcfg.d_model, thw) == \
            JS.t_ring_norm(t, jcfg.d_model, jhw)
        for tp in TPS:
            assert TS.t_attn_layer(tcfg, t, 2 * t + 5, tp, thw) == \
                JS.t_attn_layer(jcfg, t, 2 * t + 5, tp, jhw)
            assert TS.t_ffn_layer(tcfg, t, tp, thw) == \
                JS.t_ffn_layer(jcfg, t, tp, jhw)
            assert TS.t_allreduce(t, jcfg.d_model, tp, thw) == \
                JS.t_allreduce(t, jcfg.d_model, tp, jhw)
            assert TS.t_rs_or_ag(t, jcfg.d_model, tp, thw) == \
                JS.t_rs_or_ag(t, jcfg.d_model, tp, jhw)


@pytest.mark.parametrize("which", ["ref", "port"])
@pytest.mark.parametrize("mode", MODES)
def test_schedules_bit_equal(mode, which):
    """layer_ops (op by op), simulate, layer_latency, e2e_latency and
    step_attribution over tokens × tp × budgets, both models."""
    jhw, thw = _hws(which, overhead=3e-5)
    for jcfg, tcfg in CFGS.values():
        for t in TOKENS:
            for tp in TPS:
                for budget in BUDGETS:
                    kw = dict(comm_budget=budget)
                    jops = JS.layer_ops(jcfg, mode, t, 2 * t, tp, jhw, **kw)
                    tops = TS.layer_ops(tcfg, mode, t, 2 * t, tp, thw, **kw)
                    assert _ops(tops) == _ops(jops)
                    assert TS.simulate(tops) == JS.simulate(jops)
                    kw.update(tp=tp, n_layers=3)
                    assert TS.layer_latency(tcfg, mode, t, hw=thw, **kw) \
                        == JS.layer_latency(jcfg, mode, t, hw=jhw, **kw)
                    assert TS.e2e_latency(tcfg, mode, t, hw=thw, **kw) \
                        == JS.e2e_latency(jcfg, mode, t, hw=jhw, **kw)
                    assert TS.step_attribution(tcfg, mode, t, hw=thw,
                                               **kw) == \
                        JS.step_attribution(jcfg, mode, t, hw=jhw, **kw)


@pytest.mark.parametrize("split", [(256, 44), (512, 488), (64, 936)])
def test_pinned_split_and_naive_split_bit_equal(split):
    jcfg, tcfg = CFGS["llama"]
    jhw, thw = _hws("port")
    for mode in ("tokenweave", "ringweave"):
        t = sum(split)
        assert TS.step_attribution(tcfg, mode, t, tp=8, hw=thw,
                                   split=split) == \
            JS.step_attribution(jcfg, mode, t, tp=8, hw=jhw, split=split)
        assert TS.layer_latency(tcfg, mode, t, tp=8, hw=thw, smart=False) \
            == JS.layer_latency(jcfg, mode, t, tp=8, hw=jhw, smart=False)


def test_budget_out_of_range_refused_alike():
    jcfg, tcfg = CFGS["llama"]
    jhw, thw = _hws("port")
    for mode in ("fuseonly", "ring"):
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError, match="comm_budget"):
                JS.layer_ops(jcfg, mode, 64, 64, 8, jhw, comm_budget=bad)
            with pytest.raises(ValueError, match="comm_budget"):
                TS.layer_ops(tcfg, mode, 64, 64, 8, thw, comm_budget=bad)
    with pytest.raises(RuntimeError, match="cycle"):
        TS.simulate([TS.Op("a", "compute", 1.0, ("b",)),
                     TS.Op("b", "comm", 1.0, ("a",))])


@pytest.mark.parametrize("which", ["ref", "port"])
def test_spec_and_packed_summaries_bit_equal(which):
    jhw, thw = _hws(which)
    for jcfg, tcfg in CFGS.values():
        for gamma, alpha in ((0, 0.0), (3, 0.6), (5, 0.9)):
            assert TS.expected_tokens_per_step(gamma, alpha) == \
                JS.expected_tokens_per_step(gamma, alpha)
            for batch in (1, 32, 128):
                assert TS.spec_decode_latency(
                    tcfg, "tokenweave", batch, gamma, alpha, hw=thw) == \
                    JS.spec_decode_latency(jcfg, "tokenweave", batch, gamma,
                                           alpha, hw=jhw)
            assert TS.spec_decode_summary(tcfg, 64, gamma, alpha,
                                          hw=thw) == \
                JS.spec_decode_summary(jcfg, 64, gamma, alpha, hw=jhw)
        for d, c in ((16, 200), (200, 400), (64, 2048)):
            for mode in ("fuseonly", "tokenweave"):
                assert TS.packed_hybrid_latency(tcfg, mode, d, c,
                                                hw=thw) == \
                    JS.packed_hybrid_latency(jcfg, mode, d, c, hw=jhw)
            assert TS.packed_summary(tcfg, d, c, hw=thw) == \
                JS.packed_summary(jcfg, d, c, hw=jhw)


@pytest.mark.parametrize("which", ["ref", "port"])
def test_online_and_cluster_summaries_bit_equal(which):
    jhw, thw = _hws(which)
    jcfg, tcfg = CFGS["llama"]
    rates = [0.5, 5.0, 50.0, 500.0]
    for packed in (True, False):
        assert TS.online_load_mix(tcfg, "tokenweave", 20.0, hw=thw,
                                  packed=packed) == \
            JS.online_load_mix(jcfg, "tokenweave", 20.0, hw=jhw,
                               packed=packed)
    assert TS.online_summary(tcfg, rates, hw=thw) == \
        JS.online_summary(jcfg, rates, hw=jhw)
    assert TS.online_crossover_rate(tcfg, rates, hw=thw) == \
        JS.online_crossover_rate(jcfg, rates, hw=jhw)
    assert TS.decode_fleet_mix(tcfg, "tokenweave", 30.0, hw=thw) == \
        JS.decode_fleet_mix(jcfg, "tokenweave", 30.0, hw=jhw)
    assert TS.cluster_summary(tcfg, rates, 4, n_decode=2, hw=thw) == \
        JS.cluster_summary(jcfg, rates, 4, n_decode=2, hw=jhw)
    assert TS.cluster_crossover_rate(tcfg, rates, 4, hw=thw) == \
        JS.cluster_crossover_rate(jcfg, rates, 4, hw=jhw)
