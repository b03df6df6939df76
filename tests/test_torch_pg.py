"""The port's ``process_group`` backend (``CommCtx`` over ``torch.distributed``
groups, ``launch.mesh.init_groups``) in CPU processes over gloo, held to
the rank-axis path on the same inputs and, at tp=2, to the JAX reference.

Two worlds are spawned once for the module (``torch.multiprocessing.spawn``,
a ``file://`` store): world 2 runs the meshes (data 1, model 2) and
(data 2, model 1), world 4 the meshes (data 1, model 4) and (data 2,
model 2); world 2 then runs ``launch.serve``'s main.  Every rank runs
every case of a mesh and writes its results to an ``.npz``; the tests
read them and compute the rank-axis side here.
The reference runs at tp=2 in one subprocess (XLA host devices,
``conftest.run_distributed``) on weights the port draws and hands over in
the reference's layout (``weights.to_jax_layout``), while the worlds run.

Comm mode ``ring`` runs K1's cross-rank wrapper, whose CPU form is its
plain version over the group (``kernels/ar_rmsnorm_peer.py``): held to the
rank axis's ``ring`` (comm_norm, engine tokens, the launcher) and to the
jnp oracle ``repro.kernels.ref.ring_ar_rmsnorm_ref``.

Tolerances: float32 collectives 1e-6 relative; bf16 sums with
``bf16_wire=False`` within one bf16 ulp of ``rank_sum``, with
``bf16_wire=True`` within 2^-7 relative Frobenius (and different from the
float32 wire on an input whose partial sums round differently in bf16);
comm_norm 1e-6; model logits, KV and caches 1e-5; tokens equal; against the
reference logits within 1e-4 (``test_torch_tp.TOL``); K1's plain version
against the oracle within 1e-5 in float32 and one bf16 ulp in bf16 (the
group sums in gloo's order, the oracle rank 0 first).
"""
import dataclasses
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import run_distributed

from repro_torch.configs import base as tbase
from repro_torch.core import fused_collectives as tfc
from repro_torch.distributed import collectives as TCL
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.kernels.ar_rmsnorm import rank_sum
from repro_torch.launch.mesh import init_groups, make_mesh
from repro_torch.layers.embedding import (sharded_argmax,
                                          sharded_softmax_xent)
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.weights import from_jax_params, take_rank, to_jax_layout

TOL_REF = 1e-4
CFG = dict(name="tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
           vocab_size=125, dtype="float32")   # 125: the vocab is padded
PCFG = dict(tokenweave=True, remat=False, split_unit=16,
            tokenweave_min_tokens=32)
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16)
PACKED = dict(SCHED, paged=True, packed=True, block_size=16)
STOCHASTIC = dict(temperature=0.8, top_p=0.9)
WORLDS = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
MODES = ("vanilla", "reordered", "fused", "ring", "nocomm")
N_REF = 2                         # two-dispatch reference traces at tp=2


def _cfg():
    return tbase.ModelConfig(**CFG)


def _pcfg(**kw):
    return tbase.ParallelConfig(comm_mode=kw.pop("comm_mode", "fused"),
                                attn_impl="pallas", use_pallas_norm=True,
                                **PCFG, **kw)


# --------------------------------------------------------------------------
# inputs, made from seeds on both sides
# --------------------------------------------------------------------------

def _coll_inputs(tp, dp=1, seed=0):
    """(tp, dp·T, d) partials, each data shard's T rows one after the
    other; (dp, n) per-shard values for the ``_dp`` pair."""
    rng = np.random.RandomState(seed + 10 * tp + dp)
    x = rng.randn(tp, dp * 4 * tp, 48).astype(np.float32)
    x *= np.exp2(rng.randint(-6, 6, size=x.shape)).astype(np.float32)
    y = rng.randn(dp, 40).astype(np.float32)
    return x, y


def _wire_input(tp):
    """bf16 partials whose sum rounds differently when each partial sum
    is rounded to bf16: rank 0 holds 1, the others 2^-9 (exactly 1 +
    (tp-1)·2^-9 in float32)."""
    x = np.full((tp, 8 * tp, 16), 2.0 ** -9, np.float32)
    x[0] = 1.0
    return x


def _cn_inputs(tp):
    rng = np.random.RandomState(100 + tp)
    t, d = 6 * tp, 64
    return (rng.randn(tp, t, d).astype(np.float32),
            rng.randn(t, d).astype(np.float32),
            (np.abs(rng.randn(d)) + 0.5).astype(np.float32),
            (np.abs(rng.randn(d)) + 0.5).astype(np.float32))


def _params(tp, seed=3):
    """The tiny model's weights at ``tp`` ranks, drawn by the port."""
    return TT.init_params(_cfg(), seed=seed, device="cpu", tp=tp)


def _cache_inputs(tp, b, c, seed, lengths=None):
    """A random slot cache (per layer (tp, B, C, kv, dh) and (B, C)) with
    row i holding ``lengths[i]`` positions (random unless given), and one
    decode step's ids."""
    cfg = _cfg()
    lay = TT.A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(1, c - 4, size=b)
    layers = []
    for _ in range(cfg.num_layers):
        shape = (tp, b, c, lay.kv_store, cfg.head_dim)
        pos = np.full((b, c), -1, np.int32)
        for i, n in enumerate(lengths):
            pos[i, :n] = np.arange(n)
        layers.append({"k": rng.randn(*shape).astype(np.float32),
                       "v": rng.randn(*shape).astype(np.float32),
                       "pos": pos})
    tokens = rng.randint(0, cfg.vocab_size, (b, 1))
    return layers, tokens, lengths


def _torch_cache(layers, rank=None, slots=None):
    """numpy cache -> torch; one model rank's heads and a slot range of
    each layer when given."""
    out = []
    for lay in layers:
        k, v, pos = lay["k"], lay["v"], lay["pos"]
        if rank is not None:
            k, v = k[rank:rank + 1], v[rank:rank + 1]
        if slots is not None:
            k, v, pos = (k[:, :, slots], v[:, :, slots], pos[:, slots])
        out.append({n: torch.from_numpy(np.ascontiguousarray(a))
                    for n, a in (("k", k), ("v", v), ("pos", pos))})
    return out


def _traces(trial0, n):
    """Seeded engine traces: (prompts, new tokens), as test_torch_tp's."""
    out = []
    for trial in range(trial0, trial0 + n):
        rng = np.random.RandomState(trial)
        prompts = [[int(t) for t in rng.randint(0, CFG["vocab_size"],
                                                int(rng.randint(3, 60)))]
                   for _ in range(int(rng.randint(2, 6)))]
        out.append((prompts, [int(rng.randint(2, 7)) for _ in prompts]))
    return out


def _packed_trace(seed):
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(0, CFG["vocab_size"], 40)]
    prompts = [shared[:int(rng.randint(16, 41))]
               + [int(t) for t in rng.randint(0, CFG["vocab_size"],
                                              int(rng.randint(1, 30)))]
               for _ in range(5)]
    return prompts, [int(rng.randint(2, 9)) for _ in prompts]


ENGINE_TRACES = {"two": (SCHED, _traces(7000, N_REF)),
                 "packed": (PACKED, [_packed_trace(7100)])}


def _serve(api, params, sched, prompts, outs, **kw):
    eng = Engine(api, params, SchedulerConfig(**sched), device="cpu", **kw)
    for i, (p, n) in enumerate(zip(prompts, outs)):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
    got = {r.rid: r.output for r in eng.run()}
    if eng.block_mgr is not None:            # the pool drained
        assert not eng.block_mgr.tables and not any(eng.block_mgr.alloc.ref)
    return [got[i] for i in range(len(prompts))]


def _sampler_logits(tp):
    """Vocab-sharded logits with no near-tie: a permutation of values
    0.37 apart, so neither the top-p threshold nor an argmax sits within
    rounding of another value."""
    rng = np.random.RandomState(40 + tp)
    v_loc, b = 12, 5
    vals = np.stack([rng.permutation(tp * v_loc) * 0.37 / 4
                     for _ in range(b)]).astype(np.float32)
    return vals.reshape(b, 1, tp, v_loc).transpose(2, 0, 1, 3).copy()


# --------------------------------------------------------------------------
# the worlds: every rank runs every case of its mesh
# --------------------------------------------------------------------------

def _case_collectives(groups, out, dp):
    tp, r, d = groups.model_size, groups.model_rank, groups.data_rank
    x, y = _coll_inputs(tp, dp)
    t_loc = x.shape[1] // dp
    mine = torch.from_numpy(x[r:r + 1, d * t_loc:(d + 1) * t_loc])
    for dtype, wire in (("f32", False), ("bf16", False), ("bf16", True)):
        ctx = CommCtx(tp=tp, dp=dp, backend="process_group", groups=groups,
                      bf16_wire=wire)
        xt = mine if dtype == "f32" else mine.bfloat16()
        key = f"{dtype}/{int(wire)}"
        out[f"psum/{key}"] = TCL.psum(xt, ctx).float().numpy()
        out[f"psum_scatter/{key}"] = TCL.psum_scatter(xt, ctx).float().numpy()
        out[f"all_gather/{key}"] = TCL.all_gather(
            TCL.token_shard_slice(xt, ctx), ctx).float().numpy()
        out[f"pmax/{key}"] = TCL.pmax(xt, ctx).float().numpy()
        yt = torch.from_numpy(y[d:d + 1])
        yt = yt if dtype == "f32" else yt.bfloat16()
        out[f"psum_dp/{key}"] = TCL.psum_dp(yt, ctx).float().numpy()
        out[f"pmax_dp/{key}"] = TCL.pmax_dp(yt, ctx).float().numpy()
    if dp == 1:
        w = torch.from_numpy(_wire_input(tp)[r:r + 1]).bfloat16()
        for wire in (False, True):
            ctx = CommCtx(tp=tp, backend="process_group", groups=groups,
                          bf16_wire=wire)
            out[f"wire/{int(wire)}"] = TCL.psum(w, ctx).float().numpy()


def _case_comm_norm(groups, out):
    tp, r = groups.model_size, groups.model_rank
    x, res, w, wp = (torch.from_numpy(a) for a in _cn_inputs(tp))
    t, d = res.shape
    for mode in MODES:
        ctx = CommCtx(mode=mode, use_pallas=True, tp=tp,
                      backend="process_group", groups=groups)
        res_in = (res.reshape(tp, t // tp, d)[r:r + 1]
                  if ctx.sharded_residual else res[None])
        for post in (False, True):
            o, nr = tfc.comm_norm(x[r:r + 1], res_in.clone(), w, ctx=ctx,
                                  weight_post=wp if post else None)
            out[f"cn/{mode}/{int(post)}/out"] = o.numpy()
            out[f"cn/{mode}/{int(post)}/res"] = nr.numpy()


def _k1_inputs(tp, dtype):
    """Every rank's partial (tp, T, d) and residual chunk (tp, T/tp, d) and
    the weight, numpy-seeded."""
    rng = np.random.RandomState(200 + tp)
    t, d = 8 * tp, 32
    x = rng.randn(tp, t, d).astype(np.float32)
    res = rng.randn(tp, t // tp, d).astype(np.float32)
    w = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
    if dtype == "bf16":               # values a bf16 holds exactly
        x, res, w = (_bf16(a).float().numpy() for a in (x, res, w))
    return x, res, w


def _case_k1_peer(groups, out):
    """K1's cross-rank wrapper on this rank's share (its plain version
    over the group on the CPU)."""
    from repro_torch.kernels.ar_rmsnorm_peer import ar_rmsnorm_peer
    tp, r = groups.model_size, groups.model_rank
    ctx = CommCtx(mode="ring", use_pallas=True, tp=tp,
                  backend="process_group", groups=groups)
    for dtype in ("f32", "bf16"):
        x, res, w = (torch.from_numpy(a) for a in _k1_inputs(tp, dtype))
        if dtype == "bf16":
            x, res, w = x.bfloat16(), res.bfloat16(), w.bfloat16()
        o, nr = ar_rmsnorm_peer(x[r:r + 1], res[r:r + 1], w, ctx)
        out[f"k1p/{dtype}/out"] = o.float().numpy()
        out[f"k1p/{dtype}/res"] = nr.float().numpy()


def _argmax_logits(tp):
    """Small integer logits: ties within and across ranks, and the
    largest value in the padded vocab tail (which must never win)."""
    lg = np.random.RandomState(70 + tp).randint(0, 4, size=(tp, 3, 2, 10))
    lg[-1, 0, 0, -3:] = 9
    return lg.astype(np.float32)


def _case_argmax(groups, out):
    tp, r = groups.model_size, groups.model_rank
    ctx = CommCtx(tp=tp, backend="process_group", groups=groups)
    lg = torch.from_numpy(_argmax_logits(tp)[r:r + 1])
    out["argmax"] = sharded_argmax(lg, vocab_size=tp * 10 - 3,
                                   ctx=ctx).numpy()


def _case_model(groups, out):
    """Prefill (weave on) and decode through ``ModelApi`` on one rank."""
    tp, r = groups.model_size, groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=tp, groups=groups)
    params = take_rank(_params(tp), r, _cfg())
    b, chunk = 2, 48
    layers, _, _ = _cache_inputs(tp, b, 64, seed=5, lengths=[10, 3])
    tokens, positions = _prefill_inputs(b, chunk)
    lg, kv = api.prefill(params, tokens, _torch_cache(layers, r), positions,
                         last_idx=torch.tensor([chunk - 1, chunk - 6]))
    out["pf/logits"] = lg.numpy()
    for i, (k, v, _) in enumerate(kv):
        out[f"pf/k{i}"], out[f"pf/v{i}"] = k.numpy(), v.numpy()
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=6)
    cache = _torch_cache(layers, r)
    lg, cache = api.decode_step(params, torch.from_numpy(tokens), cache,
                                _decode_positions(lengths))
    out["dc/logits"] = lg.numpy()
    for i, lay in enumerate(cache):
        for n in ("k", "v", "pos"):
            out[f"dc/{n}{i}"] = lay[n].numpy()


def _prefill_inputs(b, chunk):
    rng = np.random.RandomState(8)
    tokens = torch.from_numpy(rng.randint(0, CFG["vocab_size"], (b, chunk)))
    positions = torch.full((b, chunk), -1, dtype=torch.int32)
    for i, (start, take) in enumerate(((10, chunk), (3, chunk - 5))):
        positions[i, :take] = torch.arange(start, start + take)
    return tokens, positions


def _decode_positions(lengths):
    pos = torch.from_numpy(lengths[:, None].astype(np.int32))
    pos[1, 0] = -1                       # an inactive slot
    return pos


def _case_engine(groups, out):
    tp, r = groups.model_size, groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=tp, groups=groups)
    params = take_rank(_params(tp), r, _cfg())
    ring = build_model(_cfg(), _pcfg(comm_mode="ring"), tp=tp,
                       groups=groups)
    for name, (sched, traces) in ENGINE_TRACES.items():
        for kind, kw in (("greedy", {}), ("stochastic", STOCHASTIC)):
            toks = [_serve(api, params, sched, p, n, seed=11, **kw)
                    for p, n in traces]
            out[f"eng/{name}/{kind}"] = np.asarray(json.dumps(toks))
        out[f"eng/{name}/ring"] = np.asarray(json.dumps(
            [_serve(ring, params, sched, p, n) for p, n in traces]))
    ctx = api.comm_ctx
    lg = torch.from_numpy(_sampler_logits(tp)[r:r + 1])
    for s in range(3):
        gen = torch.Generator().manual_seed(s)
        out[f"sampler/{s}"] = sample(lg, vocab_size=tp * 12 - 2,
                                     generator=gen, ctx=ctx,
                                     **STOCHASTIC).numpy()


def _case_reference(groups, out, ref_params):
    """tp=2: the reference's weights, one rank's slice of them."""
    r = groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=2, groups=groups)
    params = from_jax_params(ref_params, _cfg(), _pcfg(), device="cpu",
                             rank=r)
    for name, (sched, traces) in ENGINE_TRACES.items():
        out[f"ref/{name}"] = np.asarray(json.dumps(
            [_serve(api, params, sched, p, n) for p, n in traces]))
    b, chunk = 2, 48
    tokens, positions = _prefill_inputs(b, chunk)
    cache = api.init_cache(b, 64, device="cpu")
    lg, _ = api.prefill(params, tokens, cache, positions,
                        last_idx=torch.tensor([chunk - 1, chunk - 6]))
    out["ref/logits"] = lg.numpy()


CP_STEPS = 3


def _case_cp_decode(groups, out):
    """Context-parallel decode: each data rank holds C/D slots."""
    tp, dp = groups.model_size, groups.data_size
    r, d = groups.model_rank, groups.data_rank
    pcfg = _pcfg(seq_shard_kv=True)
    api = build_model(_cfg(), pcfg, tp=tp, ep=dp, groups=groups)
    params = take_rank(_params(tp, seed=4), r, _cfg())
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=9)
    c = 32 // dp
    cache = _torch_cache(layers, r, slice(d * c, (d + 1) * c))
    assert cache[0]["k"].shape == api.init_cache(4, 32, device="cpu")[0][
        "k"].shape
    tok, pos = torch.from_numpy(tokens), _decode_positions(lengths)
    for step in range(CP_STEPS):
        lg, cache = api.decode_step(params, tok, cache, pos)
        out[f"cp/logits{step}"] = lg.numpy()
        tok = sample(lg, vocab_size=CFG["vocab_size"],
                     ctx=api.comm_ctx)[:, None]
        out[f"cp/tokens{step}"] = tok.numpy()
        pos = torch.where(pos >= 0, pos + 1, pos)
    for i, lay in enumerate(cache):
        for n in ("k", "v", "pos"):
            out[f"cp/{n}{i}"] = lay[n].numpy()


def _worker(rank, world, tmp, ref_path):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    ref_params = None
    for n_data, n_model in WORLDS[world]:
        groups = init_groups(make_mesh((n_data, n_model), ("data", "model")),
                             backend="gloo", init_method=(
                                 f"file://{tmp}/store_{n_data}x{n_model}"),
                             rank=rank, world_size=world)
        out = {"coords": np.asarray([groups.data_rank, groups.model_rank]),
               "backend": np.asarray(dist.get_backend())}
        _case_collectives(groups, out, n_data)
        if n_data == 1:
            _case_argmax(groups, out)
            _case_comm_norm(groups, out)
            _case_k1_peer(groups, out)
            _case_model(groups, out)
            _case_engine(groups, out)
            if n_model == 2:
                ref_params = dict(np.load(ref_path))
                _case_reference(groups, out, _nest(ref_params))
        else:
            _case_cp_decode(groups, out)
        np.savez(f"{tmp}/{n_data}x{n_model}_r{rank}.npz", **out)
        dist.destroy_process_group()
    if world == 2:
        _case_serve(rank, tmp)


SERVE = ["--arch", "llama3.3-70b", "--reduced", "--prompt-lens", "20,9",
         "--new-tokens", "3", "--seed", "2"]


def _case_serve(rank, tmp):
    """``launch.serve``'s main in a world of 2 over gloo, in comm modes
    ``fused`` (its default) and ``ring``."""
    import contextlib
    import io
    from repro_torch.launch import serve
    for mode in ("fused", "ring"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(SERVE + ["--device", "cpu",
                                     "--init-method",
                                     f"file://{tmp}/store_serve_{mode}",
                                     "--rank", str(rank), "--world-size",
                                     "2"]
                            + (["--comm-mode", mode] if mode != "fused"
                               else []))
        name = "serve" if mode == "fused" else f"serve_{mode}"
        np.savez(f"{tmp}/{name}_r{rank}.npz", rc=np.asarray(rc),
                 line=np.asarray(buf.getvalue()))


def _nest(flat):
    """'a/b/c' keys -> nested dict of numpy arrays."""
    tree = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _flat(tree, prefix=""):
    """A parameter tree (dicts, lists of layers) -> {'a/b/c': numpy}."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy()
    return out


# --------------------------------------------------------------------------
# the reference at tp=2, in a subprocess
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import ModelConfig, ParallelConfig
from repro.models import transformer as T
from repro.models.build import build_model
from repro.runtime.engine import Engine
from repro.runtime.requests import Request
from repro.runtime.scheduler import SchedulerConfig

CFG, PCFG, TRACES, PARAMS, OUT = CFG_, PCFG_, TRACES_, PARAMS_, OUT_
mesh = jax.make_mesh((1, 2), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = ModelConfig(**CFG)
pcfg = ParallelConfig(comm_mode='fused', use_pallas_norm=False, **PCFG)
api = build_model(cfg, pcfg, tp=2)
tree = {}
for key, a in np.load(PARAMS).items():
    *path, leaf = key.split('/')
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = jnp.asarray(a)
out = {}
for name, (sched, traces) in TRACES.items():
    jit_cache, toks = {}, []
    for prompts, outs in traces:
        eng = Engine(api, mesh, tree, SchedulerConfig(**sched),
                     jit_cache=jit_cache)
        for i, (p, n) in enumerate(zip(prompts, outs)):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
        got = {r.rid: r.output for r in eng.run()}
        toks.append([got[i] for i in range(len(prompts))])
    out['ref/' + name] = np.asarray(json.dumps(toks))
b, chunk = 2, 48
rng = np.random.RandomState(8)
tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
positions = np.full((b, chunk), -1, np.int32)
for i, (start, take) in enumerate(((10, chunk), (3, chunk - 5))):
    positions[i, :take] = np.arange(start, start + take)
last = np.array([chunk - 1, chunk - 6], np.int32)
cache = api.init_cache(b, 64)
f = jax.jit(jax.shard_map(
    lambda p, t, c, pos, li: T.prefill(p, t, c, cfg=cfg, pcfg=pcfg,
                                       positions=pos, last_idx=li)[0],
    mesh=mesh, in_specs=(api.specs(), P(), api.cache_specs(), P(), P()),
    out_specs=P(None, None, 'model'), check_vma=False))
out['ref/logits'] = np.asarray(f(tree, tokens, cache, positions, last))
np.savez(OUT, **out)
print('PASS')
"""


def _reference_code(params_path, out_path):
    code = _JAX_SIDE
    traces = {k: (sched, v) for k, (sched, v) in ENGINE_TRACES.items()}
    for key, val in (("CFG_", repr(CFG)), ("PCFG_", repr(PCFG)),
                     ("TRACES_", repr(traces)),
                     ("PARAMS_", repr(str(params_path))),
                     ("OUT_", repr(str(out_path)))):
        code = code.replace(key, val, 1)
    return code


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn both worlds (and start the reference subprocess) once; ->
    {(data, model): [rank 0's results, rank 1's, ...]}, "ref": the
    reference's npz, "params": the tp=2 weights it ran."""
    tmp = tmp_path_factory.mktemp("pg")
    params = _params(2)
    flat = _flat(to_jax_layout(params, _cfg(), _pcfg()))
    np.savez(tmp / "ref_params.npz", **flat)
    ref_error = []

    def reference():
        try:
            run_distributed(_reference_code(tmp / "ref_params.npz",
                                            tmp / "ref.npz"),
                            n_devices=2, timeout=600)
        except BaseException as e:           # re-raised after the join
            ref_error.append(e)
    ref = threading.Thread(target=reference)
    ref.start()
    # the workers import src/ through sys.path: without PYTHONPATH their
    # interpreters skip src/sitecustomize.py, which would load jax
    saved = os.environ.pop("PYTHONPATH", None)
    try:
        procs = [mp.spawn(_worker, args=(world, str(tmp),
                                         str(tmp / "ref_params.npz")),
                          nprocs=world, join=False) for world in WORLDS]
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    try:
        for ctx in procs:
            while not ctx.join():
                pass
    except BaseException:
        for ctx in procs:
            for p in ctx.processes:
                p.kill()
        raise
    finally:
        ref.join()
    if ref_error:
        raise ref_error[0]
    got = {mesh: [dict(np.load(tmp / f"{mesh[0]}x{mesh[1]}_r{w}.npz"))
                  for w in range(mesh[0] * mesh[1])]
           for meshes in WORLDS.values() for mesh in meshes}
    for name in ("serve", "serve_ring"):
        got[name] = [dict(np.load(tmp / f"{name}_r{w}.npz"))
                     for w in range(2)]
    got["ref"] = dict(np.load(tmp / "ref.npz"))
    got["params"] = params
    return got


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [m for ms in WORLDS.values() for m in ms])
def test_init_groups_coordinates_follow_the_mesh(worlds, mesh):
    coords = np.stack([r["coords"] for r in worlds[mesh]])
    want = np.arange(mesh[0] * mesh[1]).reshape(mesh)
    for w, (d, m) in enumerate(coords):
        assert want[d, m] == w
    assert all(str(r["backend"]) == "gloo" for r in worlds[mesh])


# --------------------------------------------------------------------------
# collectives against the rank-axis branch
# --------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _expected(op, x, y, tp, dp, dtype, d, r):
    """The rank-axis result that process (data d, model r) should hold."""
    cast = torch.from_numpy if dtype == "f32" else _bf16
    t_loc = x.shape[1] // dp
    if op in ("psum", "pmax"):
        shard = cast(np.ascontiguousarray(x[:, d * t_loc:(d + 1) * t_loc]))
        ctx = CommCtx(tp=tp)
        out = TCL.psum(shard, ctx) if op == "psum" else TCL.pmax(shard, ctx)
        return out.float().numpy()
    ctx = CommCtx(tp=tp, dp=dp)
    xt, yt = cast(x), cast(y)
    if op == "psum_scatter":
        c = t_loc // tp
        out = TCL.psum_scatter(xt, ctx)[r:r + 1, d * c:(d + 1) * c]
    elif op == "all_gather":
        out = TCL.all_gather(TCL.token_shard_slice(xt, ctx), ctx)[
            r:r + 1, d * t_loc:(d + 1) * t_loc]
    else:
        fn = TCL.psum_dp if op == "psum_dp" else TCL.pmax_dp
        out = fn(yt, ctx)[d:d + 1]
    return out.float().numpy()


def _bf16_ulp(a):
    a = np.abs(a.astype(np.float32))
    return np.spacing(a) * 2.0 ** 16


COLL_OPS = ("psum", "psum_scatter", "all_gather", "pmax", "psum_dp",
            "pmax_dp")


@pytest.mark.parametrize("wire", ["f32/0", "bf16/0", "bf16/1"])
@pytest.mark.parametrize("op", COLL_OPS)
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 1), (2, 2)])
def test_collective_matches_rank_axis(worlds, mesh, op, wire):
    dp, tp = mesh
    x, y = _coll_inputs(tp, dp)
    dtype = wire.split("/")[0]
    for w, res in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        ref = _expected(op, x, y, tp, dp, dtype, d, r)
        got = res[f"{op}/{wire}"]
        assert got.shape == ref.shape, (op, got.shape, ref.shape)
        if dtype == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        elif wire == "bf16/0" or op in ("pmax", "pmax_dp", "all_gather"):
            assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), op
        else:
            err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert err <= 2.0 ** -7, (op, err)


@pytest.mark.parametrize("tp", [2, 4])
def test_bf16_wire_changes_the_bf16_sum(worlds, tp):
    """rank 0 holds 1, the others 2^-9: the float32 wire rounds 1 +
    (tp-1)·2^-9 once (rank_sum's bits); the bf16 wire rounds every partial
    sum, so an order that adds 1 first loses the small terms."""
    x = _wire_input(tp)
    want = rank_sum(_bf16(x)).float().numpy()
    results = worlds[(1, tp)]
    for res in results:
        np.testing.assert_array_equal(res["wire/0"], want)
        err = np.linalg.norm(res["wire/1"] - want) / np.linalg.norm(want)
        assert err <= 2.0 ** -7
    if tp > 2:
        assert any((res["wire/1"] != res["wire/0"]).any() for res in results)
    else:
        # two terms: one rounding either way
        assert all((res["wire/1"] == res["wire/0"]).all() for res in results)


# --------------------------------------------------------------------------
# comm_norm, model, engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [2, 4])
def test_comm_norm_matches_rank_axis(worlds, tp, mode, post):
    x, res, w, wp = (torch.from_numpy(a) for a in _cn_inputs(tp))
    ctx = CommCtx(mode=mode, use_pallas=True, tp=tp)
    t, d = res.shape
    res_in = (res.reshape(tp, t // tp, d) if ctx.sharded_residual
              else res.expand(tp, t, d).contiguous())
    out, new_res = tfc.comm_norm(x, res_in, w, ctx=ctx,
                                 weight_post=wp if post else None)
    for r, got in enumerate(worlds[(1, tp)]):
        np.testing.assert_allclose(got[f"cn/{mode}/{int(post)}/out"],
                                   out[r:r + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[f"cn/{mode}/{int(post)}/res"],
                                   new_res[r:r + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_and_decode_match_rank_axis(worlds, tp):
    api = build_model(_cfg(), _pcfg(), tp=tp)
    params = _params(tp)
    b, chunk = 2, 48
    layers, _, _ = _cache_inputs(tp, b, 64, seed=5, lengths=[10, 3])
    tokens, positions = _prefill_inputs(b, chunk)
    assert TT.weave_decision_info(b, chunk, tp=tp, pcfg=api.pcfg).weave
    lg, kv = api.prefill(params, tokens, _torch_cache(layers), positions,
                         last_idx=torch.tensor([chunk - 1, chunk - 6]))
    layers, dtok, lengths = _cache_inputs(tp, 4, 32, seed=6)
    dlg, cache = api.decode_step(params, torch.from_numpy(dtok),
                                 _torch_cache(layers),
                                 _decode_positions(lengths))
    for r, got in enumerate(worlds[(1, tp)]):
        _close(got["pf/logits"], lg[r:r + 1].numpy())
        for i, (k, v, _) in enumerate(kv):
            _close(got[f"pf/k{i}"], k[r:r + 1].numpy())
            _close(got[f"pf/v{i}"], v[r:r + 1].numpy())
        _close(got["dc/logits"], dlg[r:r + 1].numpy())
        for i, lay in enumerate(cache):
            _close(got[f"dc/k{i}"], lay["k"][r:r + 1].numpy())
            _close(got[f"dc/v{i}"], lay["v"][r:r + 1].numpy())
            np.testing.assert_array_equal(got[f"dc/pos{i}"],
                                          lay["pos"].numpy())


@pytest.mark.parametrize("kind", ["greedy", "stochastic"])
@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
@pytest.mark.parametrize("tp", [2, 4])
def test_engine_tokens_equal_rank_axis(worlds, tp, engine, kind):
    api = build_model(_cfg(), _pcfg(), tp=tp)
    sched, traces = ENGINE_TRACES[engine]
    want = [_serve(api, _params(tp), sched, p, n, seed=11,
                   **(STOCHASTIC if kind == "stochastic" else {}))
            for p, n in traces]
    for got in worlds[(1, tp)]:
        assert json.loads(str(got[f"eng/{engine}/{kind}"])) == want


@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
@pytest.mark.parametrize("tp", [2, 4])
def test_ring_engine_tokens_equal_rank_axis(worlds, tp, engine):
    """Comm mode ``ring``: every slot through K1's cross-rank wrapper on
    each process against the rank axis's K1, greedy."""
    api = build_model(_cfg(), _pcfg(comm_mode="ring"), tp=tp)
    sched, traces = ENGINE_TRACES[engine]
    want = [_serve(api, _params(tp), sched, p, n) for p, n in traces]
    for got in worlds[(1, tp)]:
        assert json.loads(str(got[f"eng/{engine}/ring"])) == want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_k1_peer_plain_matches_the_oracle(worlds, tp, dtype):
    """Each rank's full normed output and its residual chunk from K1's
    cross-rank wrapper (its plain version over gloo) against
    ``ring_ar_rmsnorm_ref``'s for that rank."""
    import jax.numpy as jnp
    from repro.kernels.ref import ring_ar_rmsnorm_ref
    x, res, w = _k1_inputs(tp, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    outs, ress = ring_ar_rmsnorm_ref([jnp.asarray(a, jdt) for a in x],
                                     [jnp.asarray(a, jdt) for a in res],
                                     jnp.asarray(w, jdt))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(
        rtol=2.0 ** -7, atol=1e-6)
    for r, got in enumerate(worlds[(1, tp)]):
        np.testing.assert_allclose(got[f"k1p/{dtype}/out"][0],
                                   np.asarray(outs[r], np.float32), **tol)
        np.testing.assert_allclose(got[f"k1p/{dtype}/res"][0],
                                   np.asarray(ress[r], np.float32), **tol)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_argmax_ties_across_ranks(worlds, tp):
    lg = _argmax_logits(tp)
    want = sharded_argmax(torch.from_numpy(lg), vocab_size=tp * 10 - 3)
    assert int(want[0, 0]) < tp * 10 - 3            # the pad never wins
    for got in worlds[(1, tp)]:
        np.testing.assert_array_equal(got["argmax"], want.numpy())


@pytest.mark.parametrize("tp", [2, 4])
def test_stochastic_sample_equals_rank_axis(worlds, tp):
    lg = torch.from_numpy(_sampler_logits(tp))
    for s in range(3):
        want = sample(lg, vocab_size=tp * 12 - 2, generator=torch.Generator(
        ).manual_seed(s), **STOCHASTIC).numpy()
        for got in worlds[(1, tp)]:
            np.testing.assert_array_equal(got[f"sampler/{s}"], want)


@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
def test_engine_tokens_equal_reference_tp2(worlds, engine):
    want = json.loads(str(worlds["ref"][f"ref/{engine}"]))
    assert sum(len(t) for trace in want for t in trace) > 0
    for got in worlds[(1, 2)]:
        assert json.loads(str(got[f"ref/{engine}"])) == want


def test_prefill_logits_match_reference_tp2(worlds):
    want = worlds["ref"]["ref/logits"]                  # (B, 1, tp·V_loc)
    for r, got in enumerate(worlds[(1, 2)]):
        v_loc = got["ref/logits"].shape[-1]
        _close(got["ref/logits"][0], want[..., r * v_loc:(r + 1) * v_loc],
               TOL_REF)


# --------------------------------------------------------------------------
# context-parallel decode over the data group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_cp_decode_matches_rank_axis(worlds, mesh):
    dp, tp = mesh
    api = build_model(_cfg(), _pcfg(seq_shard_kv=True), tp=tp, ep=dp)
    params = _params(tp, seed=4)
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=9)
    cache = _torch_cache(layers)
    tok, pos = torch.from_numpy(tokens), _decode_positions(lengths)
    steps = []
    for _ in range(CP_STEPS):
        lg, cache = api.decode_step(params, tok, cache, pos)
        tok = sample(lg, vocab_size=CFG["vocab_size"])[:, None]
        steps.append((lg, tok))
        pos = torch.where(pos >= 0, pos + 1, pos)
    c = 32 // dp
    for w, got in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        for i, (lg, tok) in enumerate(steps):
            _close(got[f"cp/logits{i}"], lg[r:r + 1].numpy())
            np.testing.assert_array_equal(got[f"cp/tokens{i}"], tok.numpy())
        for i, lay in enumerate(cache):
            sl = slice(d * c, (d + 1) * c)
            _close(got[f"cp/k{i}"], lay["k"][r:r + 1, :, sl].numpy())
            np.testing.assert_array_equal(got[f"cp/pos{i}"],
                                          lay["pos"][:, sl].numpy())


# --------------------------------------------------------------------------
# refusals (in process: nothing here reaches a collective)
# --------------------------------------------------------------------------

def _fake_groups(model=2, data=1):
    return Groups(model=None, data=None, model_rank=0, data_rank=0,
                  model_size=model, data_size=data)


def _refusal(case):
    """What stays refused over the process_group backend: (the call,
    the words its NotImplementedError names)."""
    from repro_torch.configs import get_config

    def build(name, ep=1, **pcfg):
        return build_model(get_config(name).reduced(),
                           tbase.ParallelConfig(**pcfg), tp=2, ep=ep,
                           groups=_fake_groups(data=ep))

    def engine_spec(name):
        api = build(name)
        Engine(api, api.init(0, device="cpu"),
               SchedulerConfig(**dict(PACKED, spec_gamma=3)), device="cpu")

    def verify(name):
        api = build(name)
        api.verify_step(None, torch.zeros(1, 4, dtype=torch.long), None,
                        torch.zeros(1, 4, dtype=torch.int32))

    def train(name):
        api = build(name)
        api.train_loss(None, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                              "labels": torch.zeros(1, 4, dtype=torch.long)})
    return {
        "ep2d": (lambda: build("qwen3-moe-235b-a22b"), "ep2d.*A19"),
        "data_batch": (lambda: build("llama3.3-70b", ep=2),
                       "batch over the data group.*A19"),
        "hybrid_data": (lambda: build("zamba2-7b", ep=2, seq_shard_kv=True),
                        "hybrid family.*A19"),
        "moe_cp_data": (lambda: build("olmoe-1b-7b", ep=2,
                                      seq_shard_kv=True), "moe family"),
        "spec_moe": (lambda: engine_spec("mixtral-8x22b"), "speculative"),
        "verify_vlm": (lambda: verify("qwen2-vl-7b"), "verify"),
        "train_ssm": (lambda: train("falcon-mamba-7b"), "training"),
        "train_encdec": (lambda: train("whisper-base"), "training"),
    }[case]


@pytest.mark.parametrize("case", ["ep2d", "data_batch", "hybrid_data",
                                  "moe_cp_data", "spec_moe", "verify_vlm",
                                  "train_ssm", "train_encdec"])
def test_process_group_refuses_what_is_not_ported(case):
    """``ep2d`` (its all-to-alls need the data group), the batch over the
    data group, context-parallel decode of a family but the dense one,
    and speculative decoding, the verify step and training of a non-dense
    family raise NotImplementedError by name; every other family builds
    over groups (tests/test_torch_pg_families.py)."""
    call, words = _refusal(case)
    with pytest.raises(NotImplementedError, match=words):
        call()


def test_spec_verify_and_training_refuse_process_group():
    api = build_model(_cfg(), _pcfg(), tp=2, groups=_fake_groups())
    params = take_rank(_params(2), 0, _cfg())
    with pytest.raises(NotImplementedError, match="speculative"):
        Engine(api, params, SchedulerConfig(**dict(PACKED, spec_gamma=3)),
               device="cpu")
    with pytest.raises(NotImplementedError, match="verify"):
        api.verify_step(params, torch.zeros(1, 4, dtype=torch.long), None,
                        torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="training"):
        api.train_loss(params, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                                "labels": torch.zeros(1, 4,
                                                      dtype=torch.long)})
    ctx = CommCtx(tp=2, backend="process_group", groups=_fake_groups())
    with pytest.raises(NotImplementedError, match="sharded_softmax_xent"):
        sharded_softmax_xent(torch.zeros(1, 1, 4, 63),
                             torch.zeros(1, 4, dtype=torch.long),
                             vocab_size=125, ctx=ctx)


def test_comm_ctx_backends():
    with pytest.raises(ValueError, match="unknown comm backend"):
        CommCtx(backend="nccl")
    with pytest.raises(ValueError, match="init_groups"):
        CommCtx(tp=2, backend="process_group")
    with pytest.raises(ValueError, match="model size"):
        CommCtx(tp=4, backend="process_group", groups=_fake_groups())
    ra = CommCtx(tp=4)
    assert (ra.local_ranks, ra.rank, ra.backend) == (4, 0, "rank_axis")
    pg = CommCtx(tp=2, backend="process_group",
                 groups=dataclasses.replace(_fake_groups(), model_rank=1))
    assert (pg.local_ranks, pg.rank) == (1, 1)


def test_from_jax_params_rank_slices_per_rank_leaves():
    params = _params(2)
    ref = {k: v for k, v in _flat(to_jax_layout(params, _cfg(),
                                                _pcfg())).items()}
    full = from_jax_params(_nest(ref), _cfg(), _pcfg(), device="cpu")
    for r in range(2):
        one = from_jax_params(_nest(ref), _cfg(), _pcfg(), device="cpu",
                              rank=r)
        want = take_rank(full, r, _cfg())
        assert one["norm_first"].shape == (CFG["d_model"],)
        assert one["embedding"]["embed"].shape[0] == 1
        got, exp = _flat(one), _flat(want)
        assert got.keys() == exp.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], exp[k])


def _torch_leaves(tree):
    items = tree if isinstance(tree, list) else tree.values()
    for v in items:
        if isinstance(v, (dict, list)):
            yield from _torch_leaves(v)
        else:
            yield v


class _WholeLeaves(TorchDispatchMode):
    """Weak references to every op's output that holds all ``tp`` ranks;
    at each ``randn`` none of the earlier ones may be alive."""

    def __init__(self, tp):
        super().__init__()
        self.tp, self.refs, self.draws = tp, [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.randn:
            self.draws += 1
            assert all(w() is None for w in self.refs), \
                "a whole leaf outlived its cut"
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[0] == self.tp):
                self.refs.append(weakref.ref(t))
        return out


def test_init_one_rank_draws_each_leaf_whole_then_cuts():
    """``ModelApi.init`` under groups: rank r's leaves equal slice r of
    the tp-rank draw, each in a storage of its own, and no whole leaf is
    alive when the next is drawn, so the peak is one whole leaf beside
    the rank's tree, not the whole model."""
    cfg = dataclasses.replace(_cfg(), qkv_bias=True)
    full = TT.init_params(cfg, seed=5, device="cpu", tp=2)
    for r in range(2):
        api = build_model(cfg, _pcfg(), tp=2, groups=dataclasses.replace(
            _fake_groups(), model_rank=r))
        with _WholeLeaves(2) as seen:
            one = api.init(5, device="cpu")
        assert seen.draws > 4 and all(w() is None for w in seen.refs)
        got, want = _flat(one), _flat(take_rank(full, r, cfg))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        for leaf in _torch_leaves(one):
            assert leaf.untyped_storage().nbytes() == leaf.nbytes


def test_serve_launcher_matches_the_rank_axis_engine(worlds):
    """``python -m repro_torch.launch.serve`` in a world of 2 (mesh 1x2)
    over gloo: both
    ranks exit 0 (their tokens agree), rank 0 alone prints, and its
    tokens are the rank-axis engine's on the same seeded weights."""
    from repro_torch.configs import get_config
    assert [int(r["rc"]) for r in worlds["serve"]] == [0, 0]
    assert str(worlds["serve"][1]["line"]) == ""
    line = json.loads(str(worlds["serve"][0]["line"]))
    assert line["backend"] == "gloo" and line["ranks_agree"]
    assert line["world_size"] == 2
    cfg = get_config("llama3.3-70b").reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode="fused", attn_impl="pallas", use_pallas_norm=True), tp=2)
    params = api.init(2, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (20, 9)]
    want = _serve(api, params, dict(), prompts, [3, 3])
    assert line["tokens"] == want


def test_serve_launcher_ring_matches_the_rank_axis_ring_engine(worlds):
    """``launch.serve --comm-mode ring`` in a world of 2 over gloo: the
    ranks agree, and rank 0's tokens are the rank-axis engine's in comm
    mode ``ring`` on the same seeded weights."""
    from repro_torch.configs import get_config
    assert [int(r["rc"]) for r in worlds["serve_ring"]] == [0, 0]
    line = json.loads(str(worlds["serve_ring"][0]["line"]))
    assert line["comm_mode"] == "ring" and line["ranks_agree"]
    cfg = get_config("llama3.3-70b").reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode="ring", attn_impl="pallas", use_pallas_norm=True), tp=2)
    params = api.init(2, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (20, 9)]
    assert line["tokens"] == _serve(api, params, dict(), prompts, [3, 3])
