"""The port's mixture-of-experts layer (``layers/moe.py``) and the MoE
models built on it, against the JAX reference, in float32 on the CPU.

In process (tp=1): ``moe_forward`` in the ``expert`` (olmoe-1b-7b) and
``ffn`` (mixtral-8x22b) partitionings, reduced, at capacity_factor 1.25
(some assignments drop) and 8.0 (none do), with and without
``norm_topk_prob``: output and aux loss within 1e-5, and the routing and
the drop pattern equal.  Zero rows early in the token order (all router
logits equal, as for a padding row) pin the tie order and the drops they
cause.  The expert offsets of ranks in ``expert`` mode are checked
against the reference's per-shard dispatch, and a wrong offset is caught.
The reduced MoE models, every weight perturbed, run prefill and decode
with the weave off (``tests/test_torch_configs.py`` has it on): logits,
KV and each MoE layer's input at every row within 1e-4.

On 4 XLA host devices in one subprocess (``conftest.run_distributed``):
``moe_forward`` at tp=2 and tp=4, each rank's partial output and their
sum held to the reference's per-shard outputs and ``psum``; the MoE
models at tp=2 in comm mode ``ring``, weave on and off (logits, KV, each
MoE input on each rank); and one packed trace over the paged pool at
tp=2 ``ring`` per model, tokens equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from conftest import run_distributed
from repro import configs as jconfigs
from repro.layers import moe as JM

from repro_torch.configs import base as tbase
from repro_torch.layers import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.weights import from_jax_params
from test_torch_configs import (MOE, check_model_step, check_step,
                                decode_inputs, model_pair, port_step,
                                prefill_inputs)
from test_torch_engine_paged import _drained, _drive, _gen_trace

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
BY_MODE = {"ffn": "mixtral-8x22b", "expert": "olmoe-1b-7b"}
B, S = 2, 24                     # the layer's input: T = 48 tokens
SKEW = 1.0
TESTS = os.path.dirname(os.path.abspath(__file__))


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def layer_cfg(mode, cf=1.25, norm_topk=None):
    cfg = jconfigs.get_config(BY_MODE[mode]).reduced()
    kw = {"capacity_factor": cf}
    if norm_topk is not None:
        kw["norm_topk_prob"] = norm_topk
    return dataclasses.replace(cfg, **kw)


def layer_params(jparams):
    """The reference's MoE params (numpy) -> the port's: the router's
    replicated axis dropped, the expert weights' shard axis kept."""
    return {k: torch.from_numpy(np.array(v[0] if k == "router" else v))
            for k, v in jparams.items()}


def layer_input(cfg, seed, zero_rows=0):
    """Seeded rows sharing one direction, so that routing is skewed (as a
    trained model's is) and some experts overflow at capacity 1.25."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, cfg.d_model) + SKEW * rng.randn(cfg.d_model)
    x[0, :zero_rows] = 0.0
    return x.astype(np.float32)


def ref_layer(mesh, params, x, cfg):
    return jax.jit(jax.shard_map(
        lambda p, x: JM.moe_forward(p, x, cfg), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))(
            params, jnp.asarray(x))


def ref_dispatch(params, x, cfg, *, lo=0, n_local=None):
    """The reference's routing and capacity dispatch on the flat tokens
    (outside shard_map): (topi, buf, slot)."""
    xt = jnp.asarray(x.reshape(-1, cfg.d_model))
    topw, topi, _ = JM._route(xt, params["router"], cfg)
    t, k = topi.shape
    cap = max(int(np.ceil(t * k / cfg.num_experts * cfg.capacity_factor)), 4)
    buf, slot, _ = JM._capacity_dispatch(
        xt, topi, topw, n_local=n_local or cfg.num_experts, lo=lo,
        capacity=cap)
    return np.asarray(topi), np.asarray(buf), np.asarray(slot), cap


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("mode", ["ffn", "expert"])
def test_moe_forward_matches_reference(mode, cf, norm_topk, mesh11):
    cfg = layer_cfg(mode, cf, norm_topk)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    jp = JM.init_moe_params(jax.random.PRNGKey(1), cfg, 1)
    x = layer_input(cfg, 2)
    j_out, j_aux = ref_layer(mesh11, jp, x, cfg)
    tp_ = layer_params(jp)
    t_out, t_aux = TM.moe_forward(tp_, torch.from_numpy(x)[None], tcfg)
    assert t_out.shape == (1, B, S, cfg.d_model) and t_aux.shape == (1,)
    _close(t_out[0], j_out)
    _close(t_aux[0], j_aux)

    j_topi, _, j_slot, cap = ref_dispatch(jp, x, cfg)
    xt = torch.from_numpy(x.reshape(1, -1, cfg.d_model))
    topw, topi, _ = TM._route(xt, tp_["router"], tcfg)
    np.testing.assert_array_equal(topi[0].numpy(), j_topi)
    slot = TM._capacity_dispatch(xt, topi, topw, n_local=cfg.num_experts,
                                 lo=TM.expert_offsets(tcfg, 1, "cpu"),
                                 capacity=cap)[1]
    np.testing.assert_array_equal(slot[0].numpy(), j_slot)
    dropped = int((j_slot < 0).sum())
    assert (dropped > 0) == (cf == 1.25), dropped


@pytest.mark.parametrize("mode", ["ffn", "expert"])
def test_zero_rows_early_pin_ties_and_drop_order(mode, mesh11):
    """Rows 0..15 of the token order are zero, so all their router logits
    tie: both packages give them experts 0 and 1 (ties to the lower
    index), which fills those experts early and drops later real tokens'
    assignments to expert 1, at the same places."""
    cfg = layer_cfg(mode)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    jp = JM.init_moe_params(jax.random.PRNGKey(7), cfg, 1)
    x = layer_input(cfg, 8, zero_rows=16)
    j_out, j_aux = ref_layer(mesh11, jp, x, cfg)
    t_out, t_aux = TM.moe_forward(layer_params(jp),
                                  torch.from_numpy(x)[None], tcfg)
    _close(t_out[0], j_out)
    _close(t_aux[0], j_aux)
    j_topi, _, j_slot, cap = ref_dispatch(jp, x, cfg)
    np.testing.assert_array_equal(j_topi[:16], [[0, 1]] * 16)
    xt = torch.from_numpy(x.reshape(1, -1, cfg.d_model))
    topw, topi, _ = TM._route(xt, layer_params(jp)["router"], tcfg)
    np.testing.assert_array_equal(topi[0].numpy(), j_topi)
    slot = TM._capacity_dispatch(xt, topi, topw, n_local=cfg.num_experts,
                                 lo=TM.expert_offsets(tcfg, 1, "cpu"),
                                 capacity=cap)[1]
    np.testing.assert_array_equal(slot[0].numpy(), j_slot)
    # the drops fall after the zero rows' assignments, on expert 1
    dropped = np.nonzero(j_slot < 0)[0]
    assert len(dropped) and dropped.min() >= 2 * 16
    assert set(j_topi.reshape(-1)[dropped]) == {1}


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, size=(64, 16)).astype(np.float32)
    x[0] = 1.0
    for k in (1, 2, 8):
        jv, ji = lax.top_k(jnp.asarray(x), k)
        tv, ti = TM.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert TM.top_k(torch.from_numpy(x[:1]), 4)[1].tolist() == [[0, 1, 2, 3]]


def test_expert_offsets_place_ranks_and_a_wrong_offset_is_caught():
    """``expert`` mode at tp=2 (2 experts a rank): each rank's dispatch
    equals the reference's shard with lo = r·E/tp; with every rank at
    lo = 0 rank 1's buffers hold the wrong experts' tokens."""
    cfg = layer_cfg("expert")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    tp, e_loc = 2, cfg.num_experts // 2
    jp = JM.init_moe_params(jax.random.PRNGKey(5), cfg, 1)
    x = layer_input(cfg, 6)
    lo = TM.expert_offsets(tcfg, tp, "cpu")
    assert lo.tolist() == [0, e_loc]
    assert TM.expert_offsets(
        dataclasses.replace(tcfg, moe_partition="ffn"), 4, "cpu"
    ).tolist() == [0, 0, 0, 0]
    xt = torch.from_numpy(x.reshape(1, -1, cfg.d_model)).expand(tp, -1, -1)
    topw, topi, _ = TM._route(xt, layer_params(jp)["router"], tcfg)
    want = [ref_dispatch(jp, x, cfg, lo=r * e_loc, n_local=e_loc)
            for r in range(tp)]
    cap = want[0][3]

    def dispatch(offsets):
        return TM._capacity_dispatch(xt, topi, topw, n_local=e_loc,
                                     lo=offsets, capacity=cap)

    buf, slot, _ = dispatch(lo)
    for r in range(tp):
        _close(buf[r], want[r][1])
        np.testing.assert_array_equal(slot[r].numpy(), want[r][2])
    buf, slot, _ = dispatch(torch.zeros(tp, dtype=torch.long))
    assert not np.array_equal(slot[1].numpy(), want[1][2])
    assert not np.allclose(buf[1].numpy(), want[1][1])


def test_init_params_shapes_and_router_dtype():
    """The port's random MoE weights: the reference's shapes, the router
    replicated and float32 under bf16, E % tp and f % tp refused."""
    for mode, tp in (("ffn", 4), ("expert", 2)):
        cfg = tbase.ModelConfig(**dataclasses.asdict(layer_cfg(mode)))
        p = TT.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16,
                           tp=tp)
        e_loc, f_loc = TM.local_sizes(cfg, tp)
        moe = p["layers"][0]["moe"]
        assert "mlp" not in p["layers"][0]
        assert moe["router"].shape == (cfg.d_model, cfg.num_experts)
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].shape == (tp, e_loc, cfg.d_model, f_loc)
        assert moe["w_down"].shape == (tp, e_loc, f_loc, cfg.d_model)
        assert moe["w_up"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="num_experts"):
        TM.local_sizes(tbase.ModelConfig(
            **dataclasses.asdict(layer_cfg("expert"))), 8)
    with pytest.raises(ValueError, match="moe_d_ff"):
        TM.local_sizes(tbase.ModelConfig(
            **dataclasses.asdict(layer_cfg("ffn"))), 128)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("name", MOE)
def test_moe_model_weave_off_matches(name, phase, mesh11, monkeypatch):
    pair = model_pair(jconfigs.get_config(name).reduced(), seed=3)
    check_model_step(mesh11, pair, phase=phase, weave=False,
                     seed=21 if phase == "prefill" else 22,
                     monkeypatch=monkeypatch)


# --------------------------------------------------------------------------
# tp = 2 and 4: the reference on XLA host devices, in one subprocess
# --------------------------------------------------------------------------

PCFG_TP = dict(comm_mode="ring", use_pallas_norm=False)
SCHED_TP = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16,
                block_size=16, paged=True, packed=True)
PHASES = {("prefill", True): 31, ("prefill", False): 32,
          ("decode", True): 33, ("decode", False): 34}

_JAX_SIDE = r"""
import dataclasses, json, sys
sys.path.insert(0, TESTS)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import configs as C
from repro.layers import moe as JM
from repro.models.build import build_model
from repro.runtime.engine import Engine
from repro.runtime.requests import Request, State
from repro.runtime.scheduler import SchedulerConfig
import test_torch_configs as H
from test_torch_engine_paged import _drive, _gen_trace

BY_MODE, PCFG_TP, SCHED_TP, PHASES = BY_MODE_, PCFG_TP_, SCHED_TP_, PHASES_
B, S = B_, S_
out = {}


def mesh_of(tp):
    return jax.make_mesh((1, tp), ('data', 'model'),
                         devices=jax.devices()[:tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def save_tree(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + '/'.join(p.key for p in k)] = np.asarray(v)


# the layer: every rank's partial output, their psum, the aux loss
for tp in (2, 4):
    mesh = mesh_of(tp)
    for mode, name in BY_MODE.items():
        cfg = C.get_config(name).reduced()
        p = JM.init_moe_params(jax.random.PRNGKey(10 + tp), cfg, tp)
        x = np.random.RandomState(tp).randn(B, S, cfg.d_model)
        x = x.astype(np.float32)
        def f(p, x, cfg=cfg):
            o, a = JM.moe_forward(p, x, cfg)
            return o[None], jax.lax.psum(o, 'model'), a
        o, s, a = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(JM.moe_param_specs(cfg), P()),
            out_specs=(P('model'), P(), P()), check_vma=False))(p, x)
        pre = f'layer/{mode}/{tp}/'
        save_tree(pre + 'params/', p)
        out[pre + 'x'], out[pre + 'ranks'] = x, np.asarray(o)
        out[pre + 'sum'], out[pre + 'aux'] = np.asarray(s), np.asarray(a)

# the models at tp=2 ring: steps with each MoE input kept, one packed trace
mesh = mesh_of(2)
orig = JM.moe_forward
class Patch:
    setattr = staticmethod(setattr)
for name in BY_MODE.values():
    cfg, jparams, jpcfg, *_ = H.model_pair(C.get_config(name).reduced(),
                                           seed=7, tp=2, **PCFG_TP)
    api = build_model(cfg, jpcfg, tp=2)
    save_tree(f'model/{name}/params/', jparams)
    specs = (api.specs(), api.cache_specs())
    for (phase, weave), seed in PHASES.items():
        make = H.prefill_inputs if phase == 'prefill' else H.decode_inputs
        inp = make(cfg, weave=weave, seed=seed)
        JM.moe_forward = orig
        jstore, _ = H.capture_moe_inputs(Patch)
        lg, kv = H.ref_step(mesh, cfg, jpcfg, jparams, inp, phase=phase,
                            specs=specs)
        pre = f'model/{name}/{phase}/{int(weave)}/'
        out[pre + 'logits'] = np.asarray(lg)
        save_tree(pre + 'kv/', {k: dict(zip('kvp', v)) if phase == 'prefill'
                                else {'k': v['k'], 'v': v['v'], 'p': v['pos']}
                                for k, v in kv.items()})
        for (label, rank), a in jstore.items():
            out[pre + f'moe_in/{label}/{rank}'] = a
    JM.moe_forward = orig
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1000))
    eng = Engine(api, mesh, jparams, SchedulerConfig(**SCHED_TP))
    got = _drive(eng, Request, State.DONE, prompts, outs, cancels)
    out[f'engine/{name}'] = np.asarray(json.dumps({
        'tokens': {str(k): v for k, v in got.items()},
        'forwards': eng.stats.forwards,
        'weave_forwards': eng.stats.weave_forwards}))
np.savez(PATH, **out)
print('PASS')
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_tp") / "ref.npz"
    code = _JAX_SIDE
    for key, val in (("TESTS", repr(TESTS)), ("PATH", repr(str(path))),
                     ("BY_MODE_", repr(BY_MODE)), ("PCFG_TP_", repr(PCFG_TP)),
                     ("SCHED_TP_", repr(SCHED_TP)), ("PHASES_", repr(PHASES)),
                     ("B_", repr(B)), ("S_", repr(S))):
        code = code.replace(key, val, 1)
    run_distributed(code, n_devices=4, timeout=600)
    return dict(np.load(path))


def _nest(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


@pytest.mark.parametrize("mode", ["ffn", "expert"])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_forward_matches_reference_on_ranks(jax_side, tp, mode):
    pre = f"layer/{mode}/{tp}/"
    cfg = tbase.ModelConfig(**dataclasses.asdict(layer_cfg(mode)))
    params = layer_params(_nest(jax_side, pre + "params/"))
    assert params["w_gate"].shape[:2] == (tp, TM.local_sizes(cfg, tp)[0])
    x = torch.from_numpy(jax_side[pre + "x"])[None].expand(tp, -1, -1, -1)
    out, aux = TM.moe_forward(params, x, cfg)
    assert out.shape == (tp, B, S, cfg.d_model)
    _close(out, jax_side[pre + "ranks"])
    _close(out.sum(0), jax_side[pre + "sum"])
    for r in range(tp):
        _close(aux[r], jax_side[pre + "aux"])


def _port_tp2(jax_side, name):
    cfg = jconfigs.get_config(name).reduced()
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    pcfg = tbase.ParallelConfig(
        comm_mode="ring", attn_impl="pallas", use_pallas_norm=True,
        tokenweave=True, remat=False, split_unit=16, tokenweave_min_tokens=32,
        scan_layers=False)
    params = from_jax_params(_nest(jax_side, f"model/{name}/params/"), tcfg,
                             pcfg, device="cpu")
    return cfg, tcfg, pcfg, params


@pytest.mark.parametrize("weave", [True, False], ids=["weave", "unsplit"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("name", MOE)
def test_moe_model_tp2_ring_matches(jax_side, name, phase, weave,
                                    monkeypatch):
    cfg, tcfg, pcfg, params = _port_tp2(jax_side, name)
    make = prefill_inputs if phase == "prefill" else decode_inputs
    inp = make(cfg, weave=weave, seed=PHASES[phase, weave])
    b, s = inp["tokens"].shape
    assert TT.weave_decision_info(b, s, tp=2, pcfg=pcfg,
                                  decode=phase == "decode").weave == weave
    seen = []
    orig = TM.moe_forward

    def keep(p, x, c):
        seen.append(x.clone())
        return orig(p, x, c)

    monkeypatch.setattr(TM, "moe_forward", keep)
    got = port_step(params, tcfg, pcfg, inp, phase=phase, tp=2)
    pre = f"model/{name}/{phase}/{int(weave)}/"
    kv = _nest(jax_side, pre + "kv/")
    if phase == "prefill":
        kv = {k: tuple(v[n] for n in "kvp") for k, v in kv.items()}
    else:
        kv = {k: {"k": v["k"], "v": v["v"], "pos": v["p"]}
              for k, v in kv.items()}
    check_step(got, (jax_side[pre + "logits"], kv), phase=phase)
    labels = {k for k in jax_side if k.startswith(pre + "moe_in/")}
    assert len(seen) == cfg.num_layers * (1 + weave)
    assert len(labels) == 2 * len(seen)
    for key in labels:
        label, rank = map(int, key.rsplit("/", 2)[1:])
        _close(seen[label][rank], jax_side[key], MODEL_TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_packed_engine_tp2_ring_matches(jax_side, name):
    _, tcfg, pcfg, params = _port_tp2(jax_side, name)
    want = json.loads(str(jax_side[f"engine/{name}"]))
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1000))
    eng = TEngine(t_build_model(tcfg, pcfg, tp=2), params,
                  TSched(**SCHED_TP), device="cpu")
    with torch.no_grad():
        got = _drive(eng, TRequest, TState.DONE, prompts, outs, cancels)
    _drained(eng)
    assert {str(k): v for k, v in got.items()} == want["tokens"]
    assert (eng.stats.forwards, eng.stats.weave_forwards) == \
        (want["forwards"], want["weave_forwards"])
    assert eng.stats.weave_forwards > 0
