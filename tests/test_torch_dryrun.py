"""The port's launch shapes (``launch/shapes.py``), meta-device dry run
(``launch/dryrun.py``), op counts (``analysis/op_costs.py``) and roofline
(``analysis/roofline.py``) against the reference's.

* ``SHAPES``, ``cell_applicable``, ``input_specs`` and ``model_flops``
  equal the reference's;
* per-device parameter, ZeRO-1 optimizer-state and cache bytes equal the
  reference's ``jax.eval_shape`` trees under its specs, one config per
  family on the 16x16 mesh (every batch folded over the data axes) and
  two on 2x16x16 (the ep2d model's experts over data alone);
* the tiny model at tp=2 (a 64-token prefill with the weave's two
  splits, and a decode step): collective counts by kind, wire bytes by
  kind and FLOPs per device equal the reference's HLO analyzer
  (``repro.analysis.hlo.analyze_text``) on the same calls, run in one
  2-device reference subprocess.  The analyzer reads the compiled
  module's text (as the reference's dry run does): this jax prints the
  lowered module's names without the ``%`` its parser expects.  Both
  count attention as computed, every query against every key of its
  block, so the FLOPs are equal with no tolerance; ``model_flops``
  counts causal attention at half instead, and the LM head on every
  token (``test_useful_ratio_counts_half_the_attention`` states the
  ratio);
* ``run_cell``'s record has the reference's keys.
The sampler is left out of the HLO comparison: the reference's greedy
argmax is a pmax and a pmin (two all-reduces), the port's one all-gather
of (max, id) pairs (``layers/embedding.sharded_argmax``).
"""
import dataclasses
import json
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import run_distributed
from repro.analysis import roofline as JR
from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.launch import shapes as JSH
from repro.models.build import build_model as j_build_model
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.optimizer import opt_state_specs as j_opt_state_specs

from repro_torch.analysis import op_costs
from repro_torch.analysis import roofline as TR
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.kernels import ar_rmsnorm as K1
from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import fused_rmsnorm as K2
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as TSH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.build import build_model as t_build_model

NAMES = list_configs()
FAMILY_CONFIGS = {"dense": "gemma3-1b", "moe": "olmoe-1b-7b",
                  "ssm": "falcon-mamba-7b", "hybrid": "zamba2-7b",
                  "encdec": "whisper-base", "vlm": "qwen2-vl-7b"}
# (config, shape whose cache is held, multi-pod); the params and the
# ZeRO-1 state are train_4k's.  Every family's batch folds over the data
# axes (fold > 1), ep2d's experts over data alone under a pod axis
BYTE_CASES = [("gemma3-1b", "long_500k", False),
              ("qwen3-moe-235b-a22b", "decode_32k", False),
              ("falcon-mamba-7b", "decode_32k", False),
              ("zamba2-7b", "long_500k", False),
              ("whisper-base", "decode_32k", False),
              ("qwen2-vl-7b", "decode_32k", False),
              ("qwen3-14b", "decode_32k", True),
              ("qwen3-moe-235b-a22b", "decode_32k", True),
              ("zamba2-7b", "decode_32k", False)]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shapes_and_applicability_equal_the_references():
    assert {k: dataclasses.asdict(v) for k, v in TSH.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSH.SHAPES.items()}
    for name in NAMES:
        for s in JSH.SHAPES:
            assert TSH.cell_applicable(t_get_config(name), TSH.SHAPES[s]) \
                == JSH.cell_applicable(j_get_config(name), JSH.SHAPES[s])


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_input_specs_equal_the_references(family, mesh11):
    name = FAMILY_CONFIGS[family]
    for s in JSH.SHAPES:
        ref = JSH.input_specs(j_get_config(name), JSH.SHAPES[s], mesh11,
                              ("data",))
        got = TSH.input_specs(t_get_config(name), TSH.SHAPES[s])
        assert set(got) == set(ref), (name, s)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (name, s, k)
            assert _dtype_name(v.dtype) == str(ref[k].dtype), (name, s, k)


def _device_bytes(tree, specs, sizes) -> float:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0.0
    for leaf, spec in zip(leaves, spec_leaves):
        div = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    div *= sizes[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize / div
    return total


def _reference_bytes(name, shape_name, multi_pod):
    """Per-device bytes of the reference's params, ZeRO-1 optimizer state
    and cache: ``jax.eval_shape`` trees under its specs."""
    cfg, shape = j_get_config(name), JSH.SHAPES[shape_name]
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    pcfg = JParallelConfig(dp_axes=dp_axes, comm_mode="fused",
                           tokenweave=True,
                           seq_shard_kv=shape.long_context,
                           attn_impl="chunked")
    api = j_build_model(cfg, pcfg, tp=16, ep=16)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    pspec = api.specs()
    dp = math.prod(sizes[a] for a in dp_axes)
    cache = jax.eval_shape(lambda: api.init_cache(shape.global_batch,
                                                  shape.seq_len))
    return {"params": _device_bytes(params, pspec, sizes),
            "opt": _device_bytes(
                jax.eval_shape(j_init_opt_state, params),
                j_opt_state_specs(params, pspec, dp_axes, dp), sizes),
            "cache": _device_bytes(cache, api.cache_specs(
                batch1=shape.global_batch == 1), sizes)}


@pytest.mark.parametrize("name,shape_name,multi_pod", BYTE_CASES,
                         ids=[f"{n}-{s}-{'2x16x16' if m else '16x16'}"
                              for n, s, m in BYTE_CASES])
def test_per_device_bytes_equal_the_references(name, shape_name, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    _, _, train = DR.build_cell(name, "train_4k", mesh, multi_pod=multi_pod)
    _, _, serve = DR.build_cell(name, shape_name, mesh, multi_pod=multi_pod)
    if not TSH.SHAPES[shape_name].long_context:
        assert serve["_layout"].fold == mesh.dp_size(
            ("pod", "data") if multi_pod else ("data",))
    got = {"params": train["_bytes"]["params"], "opt": train["_bytes"]["opt"],
           "cache": serve["_bytes"]["cache"]}
    assert serve["_bytes"]["params"] == got["params"]
    assert got == _reference_bytes(name, shape_name, multi_pod)


def _cell_meta(shape):
    n_tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
                else shape.global_batch)
    return dict(n_tokens=n_tokens, train=shape.kind == "train",
                decode_context=shape.seq_len if shape.kind == "decode" else 0,
                seq_len=shape.seq_len)


def test_model_flops_equal_the_references():
    for name in NAMES:
        for s, shape in JSH.SHAPES.items():
            kw = _cell_meta(shape)
            n = kw.pop("n_tokens")
            assert TR.model_flops(t_get_config(name), n, **kw) == \
                JR.model_flops(j_get_config(name), n, **kw), (name, s)


# --------------------------------------------------------------------------
# op counts against the reference's HLO analyzer
# --------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128, dtype="float32")
PCFG = dict(tokenweave=True, comm_mode="fused", remat=False, split_unit=16,
            tokenweave_min_tokens=32)
PREFILL = (2, 32)           # (B, S): 64 tokens, the weave's two splits
DECODE = (4, 64)            # (B, cache slots)

_REF_HLO = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.analysis.hlo import analyze_text
from repro.configs.base import ModelConfig, ParallelConfig
from repro.models.build import build_model
cfg = ModelConfig(**%(tiny)r)
pcfg = ParallelConfig(**%(pcfg)r)
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
api = build_model(cfg, pcfg, tp=2)
params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
pspec = api.specs()
KINDS = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all",
         "collective-permute")

def costs(text):
    mc = analyze_text(text)
    counts = {}
    for k in KINDS:
        # only kind k left a collective: the dynamic count is k's
        other = "|".join(re.escape(o) for o in KINDS if o != k)
        only = re.sub(r" (%%s)(-start|-done)?\(" %% other, " copy(", text)
        n = analyze_text(only).num_collectives_dynamic
        if n:
            counts[k] = n
    return {"flops": mc.flops, "by_kind": mc.by_kind, "counts": counts,
            "wire": mc.wire_bytes}

def lowered(fn, *args, in_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=P(), check_vma=False)).lower(*args)

b, s = %(prefill)r
i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
def prefill(params, tokens, positions):
    return api.mod.prefill(params, tokens, None, cfg=cfg, pcfg=pcfg,
                           positions=positions)[0]
out = {"prefill": costs(lowered(prefill, params, i32(b, s), i32(b, s),
                                in_specs=(pspec, P(), P())
                                ).compile().as_text())}
b, c = %(decode)r
cache = jax.eval_shape(lambda: api.init_cache(b, c))
def decode(params, tokens, cache, positions):
    return api.mod.decode_step(params, tokens, cache, cfg=cfg, pcfg=pcfg,
                               positions=positions)[0]
out["decode"] = costs(lowered(decode, params, i32(b, 1), cache, i32(b, 1),
                              in_specs=(pspec, P(), api.cache_specs(), P())
                              ).compile().as_text())
print(json.dumps(out))
print("PASS")
"""


@pytest.fixture(scope="module")
def reference_hlo_costs():
    out = run_distributed(_REF_HLO % dict(tiny=TINY, pcfg=PCFG,
                                          prefill=PREFILL, decode=DECODE),
                          n_devices=2)
    return json.loads(out.strip().splitlines()[-2])


def _port_costs(kind):
    api = t_build_model(ModelConfig(**TINY), ParallelConfig(**PCFG), tp=2)
    params = api.init(0, device="meta")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    if kind == "prefill":
        b, s = PREFILL
        _, c = op_costs.measure(api.prefill, params, i32(b, s), None,
                                i32(b, s), devices=2, ride=2)
    else:
        b, slots = DECODE
        cache = api.init_cache(b, slots, device="meta")
        _, c = op_costs.measure(api.decode_step, params, i32(b, 1), cache,
                                i32(b, 1), devices=2, ride=2)
    return c


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_costs_equal_the_references_hlo(kind, reference_hlo_costs):
    ref = reference_hlo_costs[kind]
    got = _port_costs(kind)
    counts = {}
    for col in got.collectives:
        counts[col.kind] = counts.get(col.kind, 0) + 1
    assert counts == ref["counts"] and counts
    assert got.by_kind == pytest.approx(ref["by_kind"], rel=0, abs=0)
    assert got.wire_bytes == ref["wire"]
    assert got.flops == ref["flops"] > 0
    assert op_costs.collective_summary(got)["num_ops_dynamic"] == \
        sum(ref["counts"].values())


def test_useful_ratio_counts_half_the_attention():
    """A 64-token prefill of the tiny model at tp=1 with no weave:
    FlopCounterMode counts every query against every key (4·L·H·dh·S²
    per row), where ``model_flops`` counts half of it; the LM head runs
    on the last token only, where ``model_flops`` counts it (2·N·T, N
    with the embedding and the head) on every token."""
    cfg = ModelConfig(**TINY)
    api = t_build_model(cfg, ParallelConfig(**{**PCFG, "tokenweave": False}))
    params = api.init(0, device="meta")
    b, s = PREFILL
    pos = torch.empty((b, s), dtype=torch.int32, device="meta")
    _, c = op_costs.measure(api.prefill, params, pos, None, pos)
    d, dh, h, f, v = (cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.d_ff,
                      cfg.vocab_size)
    proj = 2 * d * dh * (2 * h + 2 * cfg.num_kv_heads) + 2 * 3 * d * f
    attn = 4 * cfg.num_layers * h * dh * s * s * b
    assert c.flops == cfg.num_layers * proj * b * s + attn + 2 * d * v * b
    mf = TR.model_flops(cfg, b * s, train=False, seq_len=s)
    assert mf - 2 * cfg.active_param_count() * b * s == attn / 2
    roof = TR.analyze(c, cfg, n_devices=1, n_tokens_global=b * s,
                      train=False, seq_len=s)
    assert roof.useful_ratio == mf / c.flops
    assert roof.loop_multiplier == 1.0
    assert roof.collective_s == 0.0 and roof.dominant in ("compute",
                                                           "memory")


def test_run_cell_record_has_the_references_keys(tmp_path):
    out = tmp_path / "dryrun.json"
    rec = DR.run_cell("gemma3-1b", "decode_32k", multi_pod=False,
                      out_path=str(out))
    assert rec["status"] == "ok", rec.get("error")
    ref_keys = {"arch", "shape", "multi_pod", "n_devices", "kind",
                "seq_len", "n_tokens", "decode_context", "train", "tag",
                "mesh", "status", "lower_s", "compile_s", "memory",
                "roofline"}
    assert ref_keys <= set(rec)
    assert {"args", "out", "temp", "alias", "code"} <= set(rec["memory"])
    assert rec["memory"]["temp"] is None and rec["memory_note"]
    assert rec["memory"]["args"] == sum(rec["memory"][k] for k in (
        "params", "opt", "cache", "inputs"))
    assert set(rec["roofline"]) == {
        f.name for f in dataclasses.fields(JR.Roofline)}
    assert rec["roofline"]["loop_multiplier"] == 1.0
    saved = json.loads(out.read_text())
    assert list(saved) == ["gemma3-1b|decode_32k|16x16|baseline"]
    skipped = DR.run_cell("qwen3-14b", "long_500k", multi_pod=False)
    assert skipped["status"] == "skipped"


# --------------------------------------------------------------------------
# the kernel wrappers on meta tensors
# --------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_take_meta_tensors():
    """K1, K2 and K3 send meta tensors to their plain versions (shapes
    only), also inside autograd; any other non-CUDA device raises."""
    x, res, w = _meta(2, 8, 64), _meta(2, 4, 64), _meta(64)
    out, new_res = K1.ar_rmsnorm(x, res, w)
    assert out.device.type == new_res.device.type == "meta"
    assert (out.shape, new_res.shape) == (x.shape, res.shape)
    out, new_res = K2.fused_residual_rmsnorm(x[0], x[1], w)
    assert out.device.type == "meta" and out.shape == (8, 64)
    q, k = _meta(2, 16, 2, 2, 64), _meta(2, 16, 2, 64)
    pos = _meta(2, 16, dtype=torch.int32)
    o = K3.flash_attention(q, k, k, pos, pos, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape

    xg = _meta(8, 64, dtype=torch.float32).requires_grad_()
    out, _ = ops.fused_residual_rmsnorm(xg, xg, _meta(64, dtype=torch.float32),
                                        use_pallas=True)
    out.sum().backward()
    assert xg.grad.device.type == "meta" and xg.grad.shape == xg.shape
    qg = _meta(2, 16, 2, 2, 64, dtype=torch.float32).requires_grad_()
    kg = _meta(2, 16, 2, 64, dtype=torch.float32)
    o = ops.flash_attention(qg, kg, kg, pos, pos, causal=True)
    o.sum().backward()
    assert qg.grad.device.type == "meta"

    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        K1.ar_rmsnorm(other, other, other)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        K2.fused_residual_rmsnorm(other, other, other)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        K3.flash_attention(other, other, other, other, other, causal=True)


def test_dryrun_main_resumes_from_its_file(tmp_path, capsys):
    out = tmp_path / "runs" / "dryrun.json"
    argv = ["--arch", "whisper-base", "--shape", "decode_32k", "--out",
            str(out), "--skip-done"]
    DR.main(argv)
    first = json.loads(out.read_text())
    assert [v["status"] for v in first.values()] == ["ok"]
    DR.main(argv)
    assert "cached, skipping" in capsys.readouterr().out
    assert json.loads(out.read_text()) == first
    assert np.isfinite(first["whisper-base|decode_32k|16x16|baseline"]
                       ["roofline"]["memory_s"])
