"""The port's data rank axis D (``distributed/context.py``) against the
JAX reference's ``data`` mesh axis, in float32 on the CPU.

The reference runs in one subprocess on 4 XLA host devices
(``conftest.run_distributed``), under ``shard_map`` on (``data``,
``model``) meshes as its own multidevice tests run it, and writes its
weights, inputs and outputs to an ``.npz`` that the port's side reads:

* ``psum_dp`` over a 4 x 1 mesh;
* ``comm_norm`` in every mode at 2 x 2, the batch over ``data``: the
  output and every (data shard, rank)'s residual slice, so that the port
  scatters each data shard's tokens over its ranks;
* ``moe_forward`` in ``ep2d`` at 2 x 2 (experts over ``data``, expert
  d_ff over ``model``, three all-to-alls), at capacity 8.0 against the
  dense oracle (tests/test_distributed.py's check) and at 1.0, where
  both dispatches drop, against each (data shard, rank)'s partial output;
* context-parallel ``attn_decode`` at 4 x 1 (tests/test_distributed.py's
  ``test_context_parallel_decode``, with a row at position -1 that writes
  the last slot): output within 2e-5 and the cache;
* the reduced qwen3-moe-235b-a22b (``ep2d``) at 2 x 2 with the batch over
  ``data``: prefill with the weave splitting the sequence and not, decode
  with the batch split taking the same rows of each data shard and not,
  in ``ring`` and ``fused``: logits within 1e-4, KV within 1e-5 of max(1,
  the leaf's largest magnitude), and the weave decision each data shard's
  forward took equal to the reference's;
* the reduced gemma3-1b (sliding and global layers) and zamba2-7b (the
  shared attention) decoding twice under ``seq_shard_kv`` at 4 x 1, and
  the ep2d model at 2 x 1, one row, from a seeded cache: logits within
  1e-4, caches and states within 1e-5;
* an engine trace of the reduced qwen3-moe-235b-a22b at tp=2 (data size
  1, as the reference's engine serves it), packed over the pool: tokens
  and forward counts equal.

The reduced falcon-mamba-7b, whisper-base and zamba2-7b at 2 x 2 with
the batch over ``data`` (their ``cache_specs``): a prefill the weave
cuts into a fresh cache, then two decode steps, in ``ring`` and
``fused``: logits within 1e-4, states and caches within 1e-5.

In process: the same ep2d model's engine at tp=1 over slots and packed
over the pool against the reference's, the kernels' input checks on the
data axis's tensors, the engine's refusal of a data axis, the ssm,
encdec and hybrid families' data shards each served as a one-shard run,
and the entry points' CUDA default.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_distributed
from repro import configs as jconfigs
from repro.models.build import build_model as j_build_model
from repro.runtime.engine import Engine as JEngine
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.configs import base as tbase
from repro_torch.core import fused_collectives as tfc
from repro_torch.distributed import context as TC
from repro_torch.layers import attention as TA
from repro_torch.layers import moe as TM
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.weights import from_jax_params
from test_torch_configs import global_heads, local_logits, port_caches
from test_torch_engine_paged import _drained, _drive, _gen_trace
from test_torch_hybrid import check_shared_cache, port_shared
from test_torch_pg import (SERVE_FAMILIES, SERVE_FRAMES, SERVE_LEN,
                           SERVE_ROWS, _cut, family_serve_inputs,
                           family_serve_steps)
from test_torch_ssm import check_state, close_state, to_port
from test_torch_vlm import check_kv

TESTS = os.path.dirname(os.path.abspath(__file__))
EP2D = "qwen3-moe-235b-a22b"
LOGIT_TOL, KV_TOL, CP_TOL, LAYER_TOL = 1e-4, 1e-5, 2e-5, 1e-5
PCFG = dict(tokenweave=True, remat=False, split_unit=16,
            tokenweave_min_tokens=32, scan_layers=False,
            use_pallas_norm=False)
# the ep2d model at 2 x 2: (phase, weave) -> (comm mode, batch rows, seed);
# 16 decode rows a data shard reach the decode split's floor at tp=2
MODEL_CASES = {("prefill", True): ("ring", 4, 61),
               ("prefill", False): ("fused", 4, 62),
               ("decode", True): ("fused", 32, 63),
               ("decode", False): ("ring", 8, 64)}
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=48,
             block_size=16)
COLUMNS = {"two_legacy": dict(paged=False, packed=False),
           "packed_paged": dict(paged=True, packed=True)}
TP2_COLUMNS = ("packed_paged",)    # tp=2: the packed weave over the pool
MODES = ("vanilla", "reordered", "fused", "ring", "nocomm")
# context-parallel decode: model -> data shards (the ep2d model's 4 reduced
# experts split over 2; its shards all dispatch the one row)
CP_MODELS = {"gemma3-1b": 4, "zamba2-7b": 4, "qwen3-moe-235b-a22b": 2}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def prefill_inputs(rng, cfg, b: int, chunk: int):
    """One chunk of ``b`` rows behind cached prefixes, row 1 ending in 5
    padding tokens (numpy, the reference's layout)."""
    from test_torch_configs import random_caches
    prior = [10, 3, 7, 0][:b]
    caches = random_caches(rng, cfg, b, 64, prior)
    tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
    positions = np.full((b, chunk), -1, np.int32)
    take = [chunk - 5 if i == 1 else chunk for i in range(b)]
    for i in range(b):
        positions[i, :take[i]] = np.arange(prior[i], prior[i] + take[i])
    last = np.array([t - 1 for t in take], np.int32)
    return dict(cache=caches, tokens=tokens, positions=positions, last=last)


def decode_inputs(rng, cfg, b: int):
    """One decode step over a slot cache of 32 cells, row 1 free
    (position -1) and row 2 writing past the row's end (numpy)."""
    from test_torch_configs import random_caches
    c = 32
    lengths = rng.randint(1, c, size=b)
    caches = random_caches(rng, cfg, b, c, lengths)
    tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    positions = lengths[:, None].astype(np.int32)
    positions[1, 0] = -1
    positions[2, 0] = c + 3
    return dict(cache=caches, tokens=tokens, positions=positions)


# --------------------------------------------------------------------------
# the reference's side, on 4 host devices
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import dataclasses, json, sys
sys.path.insert(0, TESTS)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import configs as C
from repro.configs.base import ModelConfig, ParallelConfig
from repro.core import fused_collectives as fc
from repro.distributed.context import CommCtx, psum_dp, token_shard_slice
from repro.layers import attention as JA
from repro.layers import moe as JM
from repro.models import hybrid as JH
from repro.models import transformer as JT
from repro.models.build import build_model
from repro.runtime.engine import Engine
from repro.runtime.requests import Request, State
from repro.runtime.scheduler import SchedulerConfig
import test_torch_dp as D
from test_torch_configs import perturb, random_caches
from test_torch_engine_paged import _drive, _gen_trace

out = {}
rng = np.random.RandomState(2100)


def mesh_of(dp, tp):
    return jax.make_mesh((dp, tp), ('data', 'model'),
                         devices=jax.devices()[:dp * tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def sm(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def save(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + '/'.join(str(getattr(p, 'key', getattr(p, 'idx', p)))
                              for p in k)] = np.asarray(v)


# psum_dp over 4 data shards
x = rng.randn(4, 3, 5).astype(np.float32)
out['psum/x'] = x
out['psum/y'] = np.asarray(sm(mesh_of(4, 1),
                              lambda a: psum_dp(a, CommCtx()),
                              (P('data'),), P('data'))(x))

# comm_norm at 2 x 2, 8 tokens a data shard: each (shard, rank)'s partial
m22 = mesh_of(2, 2)
x = rng.randn(2, 2, 8, 16).astype(np.float32)        # (data, model, T, d)
res_full = rng.randn(2, 8, 16).astype(np.float32)    # (data, T, d)
w = (1 + 0.1 * rng.randn(16)).astype(np.float32)
out['cn/x'], out['cn/res'], out['cn/w'] = x, res_full, w
for mode in D.MODES:
    for reduce in (True, False):
        ctx = CommCtx(mode=mode)
        def f(xs, r, w, ctx=ctx, reduce=reduce):
            xs = xs[0, 0]
            if not reduce:
                xs = jax.lax.psum(xs, 'model')
            r = r[0]
            if ctx.sharded_residual:
                r = token_shard_slice(r, ctx)
            o, nr = fc.comm_norm(xs, r, w, ctx=ctx, reduce_input=reduce)
            return o[None, None], nr[None, None]
        o, nr = sm(m22, f, (P('data', 'model'), P('data'), P()),
                   (P('data', 'model'), P('data', 'model')))(x, res_full, w)
        out[f'cn/{mode}/{int(reduce)}/out'] = np.asarray(o)
        out[f'cn/{mode}/{int(reduce)}/res'] = np.asarray(nr)

# ep2d layer at 2 x 2: the dense oracle at capacity 8, drops at 1.25
for cf in (8.0, 1.0):
    cfg = ModelConfig(name='t', family='moe', num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
                      num_experts=8, num_experts_per_tok=2, moe_d_ff=16,
                      capacity_factor=cf, moe_partition='ep2d',
                      dtype='float32')
    p = JM.init_moe_params(jax.random.PRNGKey(3), cfg, 2, 2)
    x = jax.random.normal(jax.random.PRNGKey(4), (4, 12, 32))
    def f(p, x, cfg=cfg):
        o, a = JM.moe_forward(p, x, cfg)
        return o[None, None], jax.lax.psum(o, 'model'), a[None]
    o, s, a = sm(m22, f, (JM.moe_param_specs(cfg), P('data')),
                 (P('data', 'model'), P('data'), P('data')))(p, x)
    pre = f'ep2d/{cf}/'
    save(pre + 'params/', p)
    out[pre + 'x'], out[pre + 'ranks'] = np.asarray(x), np.asarray(o)
    out[pre + 'sum'], out[pre + 'aux'] = np.asarray(s), np.asarray(a)

# context-parallel attn_decode at 4 x 1 (+ a row at position -1)
cfg = ModelConfig(name='t', family='dense', num_layers=1, d_model=32,
                  num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
                  vocab_size=64, dtype='float32')
lay = JA.attention_layout(1, 4, 2, 8)
p = JA.init_attention_params(jax.random.PRNGKey(0), cfg, 1)
B, Cn = 3, 64
k = rng.randn(B, Cn, 2, 8).astype(np.float32)
v = rng.randn(B, Cn, 2, 8).astype(np.float32)
pos = np.where(np.arange(Cn)[None] < 50, np.arange(Cn)[None], -1)
pos = np.broadcast_to(pos, (B, Cn)).astype(np.int32).copy()
x = rng.randn(B, 1, 32).astype(np.float32)
positions = np.array([[50], [57], [-1]], np.int32)
def cp(k, v, pos, x, ps):
    o, c = JA.attn_decode(p, x, {'k': k, 'v': v, 'pos': pos}, positions=ps,
                          cfg=cfg, lay=lay, theta=1e4, seq_axis=('data',))
    return o, c
seq = P(None, 'data')
o, c = sm(mesh_of(4, 1), cp, (seq, seq, seq, P(), P()),
          (P(), {'k': seq, 'v': seq, 'pos': seq}))(k, v, pos, x, positions)
save('cp/params/', p)
out.update({'cp/k': k, 'cp/v': v, 'cp/pos': pos, 'cp/x': x,
            'cp/positions': positions, 'cp/out': np.asarray(o)})
save('cp/cache/', c)

# the reduced ep2d model at 2 x 2, the batch over data
decisions = []
orig_info = JT.weave_decision_info
def record(b, s, **kw):
    info = orig_info(b, s, **kw)
    decisions.append([b, s, bool(kw.get('decode')), info.weave,
                      list(info.split or []), info.reason])
    return info
JT.weave_decision_info = record
cfg = C.get_config(D.EP2D).reduced()
for (phase, weave), (mode, b, seed) in D.MODEL_CASES.items():
    pcfg = ParallelConfig(comm_mode=mode, **D.PCFG)
    api = build_model(cfg, pcfg, tp=2, ep=2)
    params = perturb(api.init(jax.random.PRNGKey(9)), 10)
    r = np.random.RandomState(seed)
    pspec, cspec = api.specs(), api.cache_specs()
    kvs = P('data', None, 'model', None)
    bs = P('data')
    if phase == 'prefill':
        inp = D.prefill_inputs(r, cfg, b, 48 if weave else 8)
        def fn(p, t, c, ps, li):
            return JT.prefill(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps,
                              last_idx=li)[:2]
        args = ('tokens', 'cache', 'positions', 'last')
        kv_out = {f'layer_{i}': (kvs, kvs, P('data', None))
                  for i in range(cfg.num_layers)}
    else:
        inp = D.decode_inputs(r, cfg, b)
        def fn(p, t, c, ps):
            return JT.decode_step(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps)
        args = ('tokens', 'cache', 'positions')
        kv_out = cspec
    decisions.clear()
    lg, kv = sm(m22, fn, (pspec,) + tuple(cspec if a == 'cache' else bs
                                          for a in args),
                (P('data', None, 'model'), kv_out))(
        params, *(inp[a] for a in args))
    pre = f'model/{phase}/{int(weave)}/'
    save(pre + 'params/', params)
    save(pre + 'in/', inp)
    out[pre + 'logits'] = np.asarray(lg)
    save(pre + 'kv/', kv)
    out[pre + 'decisions'] = np.asarray(json.dumps(decisions))
JT.weave_decision_info = orig_info

# gemma3 (sliding + global), zamba2 and the ep2d model decoding under
# seq_shard_kv
for name, dp in D.CP_MODELS.items():
    cfg = C.get_config(name).reduced()
    pcfg = ParallelConfig(comm_mode='fused', seq_shard_kv=True, **D.PCFG)
    api = build_model(cfg, pcfg, tp=1, ep=dp)
    params = perturb(api.init(jax.random.PRNGKey(11)), 12)
    r = np.random.RandomState(70)
    if cfg.family == 'hybrid':
        cache = jax.tree.map(
            lambda a: (0.5 * r.randn(*a.shape)).astype(np.float32)
            if a.dtype != jnp.int32 else np.array(a), api.init_cache(1, 64))
        cache['shared']['pos'][:, 0, :50] = np.arange(50)
        mod = JH
    else:
        cache = random_caches(r, cfg, 1, 64, [50])
        mod = JT
    cspec = api.cache_specs(batch1=True)
    pre = f'cp_model/{name}/'
    save(pre + 'params/', params)
    save(pre + 'cache/', cache)
    def g(p, t, c, ps, mod=mod, cfg=cfg, pcfg=pcfg):
        return mod.decode_step(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps)
    step = sm(mesh_of(dp, 1), g, (api.specs(), P(), cspec, P()),
              (P(None, None, 'model'), cspec))
    for i, at in enumerate((50, 70)):
        tok = r.randint(0, cfg.vocab_size, (1, 1)).astype(np.int32)
        ps = np.array([[at]], np.int32)
        lg, cache = step(params, tok, cache, ps)
        out[pre + f'{i}/tokens'], out[pre + f'{i}/positions'] = tok, ps
        out[pre + f'{i}/logits'] = np.asarray(lg)
        save(pre + f'{i}/cache/', cache)

# the ssm, encdec and hybrid families at 2 x 2, the batch over data: a
# woven prefill into a fresh cache, then two decode steps (comm mode
# fused: without Pallas kernels the reference's ring falls back to it)
from repro.models import encdec as JE
from test_torch_pg import (SERVE_FAMILIES, SERVE_FRAMES, SERVE_LEN,
                           SERVE_ROWS, SERVE_SLOTS, SERVE_STEPS,
                           family_serve_inputs)
bs, lg_spec = P('data'), P('data', None, 'model')
kv5 = P(None, 'data', None, 'model', None)
chunk = (kv5, kv5, P(None, 'data', None))
for name in SERVE_FAMILIES:
    cfg = C.get_config(name).reduced()
    pcfg = ParallelConfig(comm_mode='fused', **D.PCFG)
    api = build_model(cfg, pcfg, tp=2, ep=2)
    params = perturb(api.init(jax.random.PRNGKey(15)), 16)
    pre = f'fam/{name}/'
    save(pre + 'params/', params)
    inp = family_serve_inputs(cfg)
    tokens = inp['tokens'].astype(np.int32)
    pspec, cspec = api.specs(), api.cache_specs()
    init = jax.tree.map(np.asarray, api.init_cache(
        SERVE_ROWS, SERVE_SLOTS, **({'enc_len': SERVE_FRAMES}
                                    if cfg.family == 'encdec' else {})))
    if cfg.family == 'encdec':
        def pf(p, x, t):
            return JE.prefill(p, {'frames': x, 'tokens': t}, None, cfg=cfg,
                              pcfg=pcfg)[:2]
        lg, o = sm(m22, pf, (pspec, bs, bs),
                   (lg_spec, {'self': chunk, 'cross': cspec['cross']}))(
            params, inp['frames'], tokens)
        cache = {'self': {n: np.array(a) for n, a in init['self'].items()},
                 'cross': jax.tree.map(np.asarray, o['cross'])}
        part, into = o['self'], cache['self']
    else:
        def pf(p, t, c, ps):
            return api.mod.prefill(p, t, c, cfg=cfg, pcfg=pcfg,
                                   positions=ps)[:2]
        positions = np.tile(np.arange(SERVE_LEN, dtype=np.int32),
                            (SERVE_ROWS, 1))
        lg, o = sm(m22, pf, (pspec, bs, cspec, bs),
                   (lg_spec, cspec if cfg.family == 'ssm' else
                    {'mamba': cspec['mamba'], 'shared': chunk}))(
            params, tokens, init, positions)
        if cfg.family == 'ssm':
            cache, part = jax.tree.map(np.asarray, o), None
        else:
            cache = {'mamba': jax.tree.map(np.asarray, o['mamba']),
                     'shared': {n: np.array(a) for n, a in
                                init['shared'].items()}}
            part, into = o['shared'], cache['shared']
    if part is not None:
        for j, n in enumerate(('k', 'v', 'pos')):
            into[n][:, :, :SERVE_LEN] = np.asarray(part[j])
    out[pre + 'logits0'] = np.asarray(lg)
    def dc(p, t, c, ps):
        return api.mod.decode_step(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps)
    step = sm(m22, dc, (pspec, bs, cspec, bs), (lg_spec, cspec))
    for i in range(SERVE_STEPS):
        ps = np.full((SERVE_ROWS, 1), SERVE_LEN + i, np.int32)
        lg, cache = step(params, inp['decode'][i].astype(np.int32), cache,
                         ps)
        out[pre + f'logits{i + 1}'] = np.asarray(lg)
    save(pre + 'cache/', cache)

# the ep2d model's engine at tp=2, data size 1
cfg = dataclasses.replace(C.get_config(D.EP2D).reduced(),
                          capacity_factor=1.25)
pcfg = ParallelConfig(comm_mode='ring', **D.PCFG)
api = build_model(cfg, pcfg, tp=2)
params = perturb(api.init(jax.random.PRNGKey(13)), 14)
save('engine/params/', params)
m12 = mesh_of(1, 2)
prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1100))
for column in D.TP2_COLUMNS:
    eng = Engine(api, m12, params,
                 SchedulerConfig(**D.SCHED, **D.COLUMNS[column]))
    got = _drive(eng, Request, State.DONE, prompts, outs, cancels)
    out[f'engine/{column}'] = np.asarray(json.dumps({
        'tokens': {str(k): v for k, v in got.items()},
        'forwards': eng.stats.forwards,
        'weave_forwards': eng.stats.weave_forwards}))
np.savez(PATH, **out)
print('PASS')
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp") / "ref.npz"
    code = _JAX_SIDE.replace("TESTS", repr(TESTS), 1).replace(
        "PATH", repr(str(path)), 1)
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _tuples(node):
    """``_nest``'s dicts keyed "0", "1", ... back into tuples."""
    if isinstance(node, dict) and node and all(k.isdigit() for k in node):
        return tuple(_tuples(node[str(i)]) for i in range(len(node)))
    return node


# --------------------------------------------------------------------------
# psum_dp and comm_norm over the data axis
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_psum_dp_matches_reference(jax_side):
    x = jax_side["psum/x"]
    got = TC.psum_dp(_t(x), TC.CommCtx(dp=4))
    _close(got, jax_side["psum/y"], LAYER_TOL)
    with pytest.raises(ValueError, match="data shards"):
        TC.psum_dp(_t(x), TC.CommCtx(dp=2))


@pytest.mark.slow
@pytest.mark.parametrize("reduce", [True, False], ids=["reduce", "complete"])
@pytest.mark.parametrize("mode", MODES)
def test_comm_norm_scatters_each_data_shard(jax_side, mode, reduce):
    """The port's comm_norm over D = 2 data shards' tokens (folded, shard
    after shard) at R = 2: the normed output on every rank, and rank r's
    residual holding rows [r·C, (r+1)·C) of every shard, as each
    (data shard, rank) of the reference holds them."""
    x, res, w = (jax_side[f"cn/{k}"] for k in ("x", "res", "w"))
    dp, tp, t_loc, d = x.shape
    ctx = TC.CommCtx(mode=mode, tp=tp, dp=dp, use_pallas=True)
    tx = _t(x.transpose(1, 0, 2, 3).reshape(tp, dp * t_loc, d))
    if not reduce:
        tx = tx.sum(0, keepdim=True).expand(tp, -1, -1).contiguous()
    full = _t(res.reshape(dp * t_loc, d))
    if ctx.sharded_residual:
        tres = TC.token_shard_slice(full.expand(tp, -1, -1), ctx)
    else:
        tres = full.expand(tp, -1, -1).contiguous()
    out, new_res = tfc.comm_norm(tx, tres, _t(w), ctx=ctx,
                                 reduce_input=reduce)
    pre = f"cn/{mode}/{int(reduce)}/"
    want_out, want_res = jax_side[pre + "out"], jax_side[pre + "res"]
    # reference (data, model, rows, d) -> the port's (R, D·rows, d)
    _close(out, want_out.transpose(1, 0, 2, 3).reshape(tp, -1, d),
           LAYER_TOL)
    _close(new_res, want_res.transpose(1, 0, 2, 3).reshape(tp, -1, d),
           LAYER_TOL)


def test_token_shard_slice_and_scatter_rows_agree():
    """A replicated token axis sliced per rank equals the scatter of its
    rank-0 copy: rank r gets rows [r·C, (r+1)·C) of each data shard."""
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(1, 24, 3)
    ctx = TC.CommCtx(tp=3, dp=2)
    got = TC.token_shard_slice(x.expand(3, -1, -1), ctx)
    assert torch.equal(got, TC.scatter_rows(x[0], 3, 2))
    assert torch.equal(got[1, :4], x[0, 4:8])
    assert torch.equal(got[1, 4:], x[0, 16:20])
    assert torch.equal(TC.gather_rows(got, 2), x[0])


# --------------------------------------------------------------------------
# the ep2d layer and the context-parallel decode layer
# --------------------------------------------------------------------------

def _moe_cfg(cf):
    return tbase.ModelConfig(
        name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=64, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=16, capacity_factor=cf,
        moe_partition="ep2d", dtype="float32")


def _dense_oracle(params, x, cfg):
    """Every token through its top-k experts, no capacity: the ep2d
    weights (D, R, E/D, ...) put back together per expert."""
    d = x.shape[-1]
    wg, wu, wd = (params[k].numpy() for k in ("w_gate", "w_up", "w_down"))
    ep, tp, e_loc = wg.shape[:3]
    wg = wg.transpose(0, 2, 3, 1, 4).reshape(ep * e_loc, d, -1)
    wu = wu.transpose(0, 2, 3, 1, 4).reshape(ep * e_loc, d, -1)
    wd = wd.transpose(0, 2, 1, 3, 4).reshape(ep * e_loc, -1, d)
    t = x.reshape(-1, d)
    probs = torch.softmax(t @ params["router"], -1)
    topw, topi = TM.top_k(probs, cfg.num_experts_per_tok)
    topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros_like(t)
    for e in range(ep * e_loc):
        h = torch.nn.functional.silu(t @ _t(wg[e])) * (t @ _t(wu[e]))
        out += torch.where(topi == e, topw, 0.).sum(-1)[:, None] * (
            h @ _t(wd[e]))
    return out.reshape(x.shape)


@pytest.mark.slow
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_ep2d_layer_matches_reference_and_dense_oracle(jax_side, cf):
    """moe_forward(dp=2) at R = 2: each (data shard, rank)'s partial
    output, their sum and the aux loss equal the reference's; at capacity
    8 (nothing drops) the sum is the dense oracle at the reference's own
    tolerance; at 1.0 both dispatches drop (the second's drops depend on
    the order the source shards' rows arrive in)."""
    pre = f"ep2d/{cf}/"
    cfg = _moe_cfg(cf)
    params = {k: _t(v[0] if k == "router" else v)
              for k, v in _nest(jax_side, pre + "params/").items()}
    x = _t(jax_side[pre + "x"])
    dp, tp = params["w_gate"].shape[:2]
    seen = []
    orig = TM._ep2d_dispatch

    def keep(*a, **kw):
        got = orig(*a, **kw)
        seen.append(got)
        return got
    TM._ep2d_dispatch = keep
    try:
        out, aux = TM.moe_forward(params, x.expand(tp, -1, -1, -1), cfg,
                                  dp=dp)
    finally:
        TM._ep2d_dispatch = orig
    ranks = jax_side[pre + "ranks"]                  # (D, R, B/D, S, d)
    want = np.concatenate([ranks[d] for d in range(dp)], axis=1)
    _close(out, want, LAYER_TOL)
    _close(out.sum(0), jax_side[pre + "sum"], LAYER_TOL)
    _close(aux, np.broadcast_to(jax_side[pre + "aux"], (tp, dp)), LAYER_TOL)
    (_, slot, slot2), = seen
    if cf == 8.0:
        np.testing.assert_allclose(out.sum(0).numpy(),
                                   _dense_oracle(params, x, cfg).numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert bool((slot >= 0).all())
    else:
        assert bool((slot < 0).any()), "the first dispatch dropped nothing"
        kept1 = int((slot >= 0).sum())
        assert int((slot2 >= 0).sum()) < kept1, "nothing dropped on arrival"


def test_ep2d_shapes_and_refusals():
    cfg = _moe_cfg(1.25)
    p = TM.init_moe_params(torch.Generator().manual_seed(0), cfg, 2, 4,
                           device="cpu", dtype=torch.bfloat16)
    assert p["w_gate"].shape == (4, 2, 2, 32, 8)
    assert p["w_down"].shape == (4, 2, 2, 8, 32)
    assert p["router"].dtype == torch.float32
    with pytest.raises(ValueError, match="num_experts=8 is not a multiple"):
        TM.local_sizes(cfg, 2, 3)
    with pytest.raises(ValueError, match="moe_d_ff=16 is not a multiple"):
        TM.local_sizes(cfg, 32, 2)
    x = torch.zeros(2, 4, 3, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(D, R\) = \(4, 2\)"):
        TM.moe_forward(p, x, cfg, dp=2)
    with pytest.raises(ValueError, match="do not split over 3"):
        TM.moe_forward(p, x, cfg, dp=3)


@pytest.mark.slow
def test_context_parallel_decode_matches_reference(jax_side):
    """attn_decode(seq_shards=4) over a 64-slot cache (16 a shard): the
    output within 2e-5 of the reference's flash-decoding combine, the
    token written at its global slot on its owner, and the row at
    position -1 writing the last slot as the reference's does."""
    cfg = tbase.ModelConfig(name="t", family="dense", num_layers=1,
                            d_model=32, num_heads=4, num_kv_heads=2,
                            head_dim=8, d_ff=64, vocab_size=64,
                            dtype="float32")
    lay = TA.attention_layout(1, 4, 2, 8)
    params = {k: _t(v) for k, v in _nest(jax_side, "cp/params/").items()}
    cache = {n: _t(jax_side[f"cp/{n}"])[None] if n != "pos"
             else _t(jax_side["cp/pos"]) for n in ("k", "v", "pos")}
    x = _t(jax_side["cp/x"])[None]
    ps = _t(jax_side["cp/positions"])
    out, got = TA.attn_decode(params, x, cache, positions=ps, cfg=cfg,
                              lay=lay, theta=1e4, seq_shards=4)
    _close(out[0], jax_side["cp/out"], CP_TOL)
    for n in ("k", "v"):
        _close(got[n][0], jax_side[f"cp/cache/{n}"], LAYER_TOL)
    np.testing.assert_array_equal(got["pos"].numpy(),
                                  jax_side["cp/cache/pos"])
    assert int(got["pos"][2, 63]) == -1 and int(got["pos"][1, 57]) == 57
    with pytest.raises(ValueError, match="does not split over 5"):
        TA.attn_decode(params, x, cache, positions=ps, cfg=cfg, lay=lay,
                       theta=1e4, seq_shards=5)


def test_context_parallel_decode_equals_unsharded():
    """With every row at a position >= 0 the flash-decoding combine over
    D chunks computes the unsharded decode, D = 1, 2 and 8."""
    cfg = tbase.ModelConfig(name="t", family="dense", num_layers=1,
                            d_model=32, num_heads=4, num_kv_heads=2,
                            head_dim=8, d_ff=64, vocab_size=64,
                            dtype="float32")
    lay = TA.attention_layout(1, 4, 2, 8)
    g = torch.Generator().manual_seed(5)
    params = {n: torch.randn(1, 32, 16 if n != "wq" else 32, generator=g)
              for n in ("wq", "wk", "wv")}
    params["wo"] = torch.randn(1, 32, 32, generator=g)
    cache = {"k": torch.randn(1, 2, 64, 2, 8, generator=g),
             "v": torch.randn(1, 2, 64, 2, 8, generator=g),
             "pos": torch.arange(64, dtype=torch.int32).expand(2, 64).clone()}
    cache["pos"][:, 40:] = -1
    x = torch.randn(1, 2, 1, 32, generator=g)
    ps = torch.tensor([[40], [41]], dtype=torch.int32)

    def run(n):
        c = {k: v.clone() for k, v in cache.items()}
        return TA.attn_decode(params, x, c, positions=ps, cfg=cfg, lay=lay,
                              theta=1e4, seq_shards=n)[0]
    want = TA.attn_decode(params, x, {k: v.clone() for k, v in
                                      cache.items()}, positions=ps, cfg=cfg,
                          lay=lay, theta=1e4)[0]
    for n in (1, 2, 8):
        _close(run(n), want, CP_TOL)


# --------------------------------------------------------------------------
# the reduced ep2d model with the batch over data
# --------------------------------------------------------------------------

def _port_pcfg(**kw):
    return tbase.ParallelConfig(**{**PCFG, **kw, "use_pallas_norm": True},
                                attn_impl="pallas")


def _kv_leaf(got, want):
    close_state(global_heads(got), want, KV_TOL)


@pytest.mark.slow
@pytest.mark.parametrize("weave", [True, False], ids=["weave", "unsplit"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_ep2d_model_batch_over_data_matches(jax_side, phase, weave,
                                            monkeypatch):
    """Prefill (the weave cutting the sequence) and decode (the batch
    split taking rows [lo, hi) of each data shard) at D = 2 x R = 2:
    logits, KV, and each forward's weave decision made on one data
    shard's rows, equal to the reference's."""
    mode, b, _ = MODEL_CASES[phase, weave]
    pre = f"model/{phase}/{int(weave)}/"
    cfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(EP2D).reduced()))
    pcfg = _port_pcfg(comm_mode=mode)
    api = t_build_model(cfg, pcfg, tp=2, ep=2)
    assert api.ep == 2
    params = from_jax_params(_nest(jax_side, pre + "params/"), cfg, pcfg,
                             device="cpu")
    assert params["layers"][0]["moe"]["w_gate"].shape[:2] == (2, 2)
    inp = _nest(jax_side, pre + "in/")
    cache = port_caches(inp["cache"], 2)
    infos = []
    orig = TT.weave_decision_info

    def record(b_, s_, **kw):
        info = orig(b_, s_, **kw)
        infos.append([b_, s_, bool(kw.get("decode")), info.weave,
                      list(info.split or []), info.reason])
        return info
    monkeypatch.setattr(TT, "weave_decision_info", record)
    with torch.no_grad():
        if phase == "prefill":
            logits, kv = api.prefill(params, _t(inp["tokens"]), cache,
                                     _t(inp["positions"]),
                                     last_idx=_t(inp["last"]))
        else:
            logits, kv = api.decode_step(params, _t(inp["tokens"]), cache,
                                         _t(inp["positions"]))
    want = json.loads(str(jax_side[pre + "decisions"]))
    assert infos == want and infos[0][0] == b // 2
    assert infos[0][3] == weave
    _close(local_logits(logits), jax_side[pre + "logits"], LOGIT_TOL)
    jkv = _nest(jax_side, pre + "kv/")
    for i, layer in enumerate(kv):
        jl = jkv[f"layer_{i}"]
        if phase == "prefill":
            _kv_leaf(layer[0], jl["0"])
            _kv_leaf(layer[1], jl["1"])
            np.testing.assert_array_equal(layer[2].numpy(), jl["2"])
        else:
            _kv_leaf(layer["k"], jl["k"])
            _kv_leaf(layer["v"], jl["v"])
            np.testing.assert_array_equal(layer["pos"].numpy(), jl["pos"])


# --------------------------------------------------------------------------
# context-parallel decode through the models
# --------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(CP_MODELS))
def test_context_parallel_model_decode_matches(jax_side, name):
    """Two decode steps of one row under seq_shard_kv at D = 4 (the ep2d
    model: D = 2, every shard dispatching its copy of the row) from a
    seeded cache (50 positions; the second step at 70 overwrites slot 6
    on shard 0): logits, the global layers' (or shared block's) caches
    and, hybrid, the Mamba-2 state.  Gemma's sliding layers keep their
    whole ring buffers."""
    pre = f"cp_model/{name}/"
    cfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(name).reduced()))
    pcfg = _port_pcfg(comm_mode="fused", seq_shard_kv=True)
    api = t_build_model(cfg, pcfg, tp=1, ep=CP_MODELS[name])
    params = from_jax_params(_nest(jax_side, pre + "params/"), cfg, pcfg,
                             device="cpu")
    jc = _nest(jax_side, pre + "cache/")
    hybrid = cfg.family == "hybrid"
    if hybrid:
        cache = {"mamba": to_port(_tuples(jc["mamba"]), "hybrid", 1),
                 "shared": port_shared(jc["shared"], 1)}
    else:
        cache = port_caches(jc, 1)
    global_layers = [i for i, k in enumerate(TT.layer_kinds(cfg))
                     if k.window == 0]
    assert hybrid or cfg.is_moe or 0 < len(global_layers) < cfg.num_layers
    for i in range(2):
        with torch.no_grad():
            logits, cache = api.decode_step(
                params, _t(jax_side[pre + f"{i}/tokens"]), cache,
                _t(jax_side[pre + f"{i}/positions"]))
        _close(local_logits(logits), jax_side[pre + f"{i}/logits"],
               LOGIT_TOL)
        want = _nest(jax_side, pre + f"{i}/cache/")
        if hybrid:
            from test_torch_hybrid import check_shared_cache
            from test_torch_ssm import check_state
            check_shared_cache(cache["shared"], want["shared"])
            check_state(cache["mamba"], _tuples(want["mamba"]), "hybrid")
        else:
            for j, layer in enumerate(cache):
                wl = want[f"layer_{j}"]
                _kv_leaf(layer["k"], wl["k"])
                _kv_leaf(layer["v"], wl["v"])
                np.testing.assert_array_equal(layer["pos"].numpy(),
                                              wl["pos"])


def test_kernel_inputs_on_the_data_axis_pass_the_kernels_checks(
        monkeypatch):
    """What the data axis hands K1, K2 and K3 passes each kernel's own
    input checks (the CUDA wrappers' first step; on the CPU the plain
    versions check nothing): ep2d at D = 2 x R = 2 (a woven prefill, a
    decode whose batch split takes rows of both shards) in ``ring``, K1
    once per data shard on views of the shard's rows, and in ``fused``,
    K2 on the shards' scattered rows; K3 with D folded into its batch;
    K2 in a context-parallel decode at D = 4."""
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    from repro_torch.kernels import ops
    calls = {"k1": 0, "k2": 0, "k3": 0}

    def k1(x, r, w, eps=1e-6, ctas=8):
        K1.check_inputs(x, r, w)
        calls["k1"] += 1
        return K1.ar_rmsnorm_plain(x, r, w, eps)

    def k2(x, r, w, eps=1e-6):
        K2.check_inputs(x, r, w)
        calls["k2"] += 1
        return K2.fused_residual_rmsnorm_plain(x, r, w, eps)

    def k3(q, k, v, qpos, kpos, **kw):
        K3.check_inputs(q, k, v, qpos, kpos)
        calls["k3"] += 1
        return K3.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    monkeypatch.setattr(ops, "_k1", k1)
    monkeypatch.setattr(ops, "_k2", k2)
    monkeypatch.setattr(TA, "flash_attention", k3)
    rng = np.random.RandomState(3)
    cfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(EP2D).reduced()))
    for mode, kernel in (("ring", "k1"), ("fused", "k2")):
        api = t_build_model(cfg, _port_pcfg(comm_mode=mode), tp=2, ep=2)
        params = api.init(0, device="cpu")
        with torch.no_grad():
            cache = api.init_cache(32, 64, device="cpu")
            api.prefill(params, _t(rng.randint(0, 512, (4, 48))), None,
                        None)
            api.decode_step(params, _t(rng.randint(0, 512, (32, 1))), cache,
                            _t(np.full((32, 1), 5, np.int32)))
        assert calls[kernel] and calls["k3"]
        calls.update(k2=0)
    gcfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config("gemma3-1b").reduced()))
    gapi = t_build_model(gcfg, _port_pcfg(comm_mode="fused",
                                          seq_shard_kv=True), ep=4)
    with torch.no_grad():
        gapi.decode_step(gapi.init(0, device="cpu"), _t([[1]]),
                         gapi.init_cache(1, 64, device="cpu"),
                         _t(np.array([[9]], np.int32)))
    assert calls["k2"]


# --------------------------------------------------------------------------
# the engine: the ep2d model at data size 1
# --------------------------------------------------------------------------

def _engine_run(api, params, column, prompts, outs, cancels):
    eng = TEngine(api, params, TSched(**SCHED, **COLUMNS[column]),
                  device="cpu")
    with torch.no_grad():
        got = _drive(eng, TRequest, TState.DONE, prompts, outs, cancels)
    if eng.block_mgr is not None:
        _drained(eng)
    return got, eng


@pytest.mark.slow
@pytest.mark.parametrize("column", TP2_COLUMNS)
def test_ep2d_engine_tp2_matches_reference(jax_side, column):
    cfg = tbase.ModelConfig(**dataclasses.asdict(dataclasses.replace(
        jconfigs.get_config(EP2D).reduced(), capacity_factor=1.25)))
    pcfg = _port_pcfg(comm_mode="ring")
    params = from_jax_params(_nest(jax_side, "engine/params/"), cfg, pcfg,
                             device="cpu")
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1100))
    got, eng = _engine_run(t_build_model(cfg, pcfg, tp=2), params, column,
                           prompts, outs, cancels)
    want = json.loads(str(jax_side[f"engine/{column}"]))
    assert {str(k): v for k, v in got.items()} == want["tokens"]
    assert (eng.stats.forwards, eng.stats.weave_forwards) == \
        (want["forwards"], want["weave_forwards"])


@pytest.fixture(scope="module")
def ep2d_pair(mesh11):
    from test_torch_configs import model_pair
    cfg = dataclasses.replace(jconfigs.get_config(EP2D).reduced(),
                              capacity_factor=1.25)
    _, jparams, jpcfg, tparams, tcfg, tpcfg = model_pair(cfg, seed=15)
    return (j_build_model(cfg, jpcfg, tp=1), jparams,
            t_build_model(tcfg, tpcfg), tparams, {})


@pytest.mark.parametrize("column", list(COLUMNS))
def test_ep2d_engine_tp1_matches_reference(ep2d_pair, mesh11, column):
    """The registry's last unserved name, reduced, through both engines at
    capacity 1.25: tokens and forward counts equal, assignments dropped."""
    japi, jparams, tapi, tparams, jit_caches = ep2d_pair
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1200))
    jeng = JEngine(japi, mesh11, jparams,
                   JSched(**SCHED, **COLUMNS[column]),
                   jit_cache=jit_caches.setdefault(column, {}))
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    dropped = []
    orig = TM._ep2d_dispatch

    def count(*a, **kw):
        got = orig(*a, **kw)
        dropped.append(got[1].numel() - int((got[2] >= 0).sum()))
        return got
    TM._ep2d_dispatch = count
    try:
        got, teng = _engine_run(tapi, tparams, column, prompts, outs,
                                cancels)
    finally:
        TM._ep2d_dispatch = orig
    assert got == want, (column, got, want)
    assert (teng.stats.forwards, teng.stats.weave_forwards) == \
        (jeng.stats.forwards, jeng.stats.weave_forwards)
    assert sum(dropped) > 0, "capacity dropped nothing"


def test_engine_refuses_a_data_axis(ep2d_pair):
    """The reference's engine passes each step's tokens replicated against
    a cache sharded over ``data``, so it serves at data size 1; the
    port's refuses ep > 1 by name."""
    tapi, tparams = ep2d_pair[2], ep2d_pair[3]
    api = dataclasses.replace(tapi, ep=2)
    with pytest.raises(NotImplementedError, match="data size 1, not ep=2"):
        TEngine(api, tparams, TSched(**SCHED), device="cpu")


# --------------------------------------------------------------------------
# the ssm, encdec and hybrid families with the batch over data
# --------------------------------------------------------------------------

def _family_cfg(name):
    return tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(name).reduced()))


def _check_family_cache(got, want, family):
    """A served cache against the reference's (``_nest``'s tree)."""
    if family == "ssm":
        check_state(got, _tuples(want), "ssm")
    elif family == "hybrid":
        check_state(got["mamba"], _tuples(want["mamba"]), "hybrid")
        check_shared_cache(got["shared"], want["shared"])
    else:
        check_kv(got["self"], want["self"])
        check_kv(got["cross"], want["cross"])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["ring", "fused"])
@pytest.mark.parametrize("name", SERVE_FAMILIES)
def test_families_batch_over_data_match_reference(jax_side, name, mode):
    """The reduced falcon-mamba-7b, whisper-base and zamba2-7b at D = 2 x
    R = 2, in ``ring`` (K1's plain version) and ``fused``, against the
    reference's ``shard_map`` at (data 2, model 2) in ``fused`` (its
    ``ring`` without Pallas kernels) with the batch over ``data`` (its
    ``cache_specs``): a prefill of 2 rows a
    shard that the weave cuts (whisper's encoder splitting each shard's
    rows, its prompt's KV and cross caches written into the cache), then
    two decode steps: logits within 1e-4, states and caches within 1e-5 of
    max(1, the leaf's largest magnitude)."""
    pre = f"fam/{name}/"
    cfg = _family_cfg(name)
    pcfg = _port_pcfg(comm_mode=mode)
    api = t_build_model(cfg, pcfg, tp=2, ep=2)
    assert TT.weave_decision_info(SERVE_ROWS // 2, SERVE_LEN, tp=2,
                                  pcfg=pcfg).weave
    params = from_jax_params(_nest(jax_side, pre + "params/"), cfg, pcfg,
                             device="cpu")
    logits, _, cache = family_serve_steps(api, params,
                                          family_serve_inputs(cfg),
                                          batch=SERVE_ROWS, greedy=False)
    for i, lg in enumerate(logits):
        _close(local_logits(lg), jax_side[f"{pre}logits{i}"], LOGIT_TOL)
    _check_family_cache(cache, _nest(jax_side, pre + "cache/"), cfg.family)


@pytest.mark.parametrize("name", SERVE_FAMILIES)
def test_each_data_shard_serves_as_a_one_shard_run(name):
    """In process, ``ring`` at D = 2 x R = 2 with 16 rows a shard: the
    weave cuts each shard's 16 x 8 prompt tokens, the decode batch split
    takes rows of both shards and whisper's encoder split each shard's
    rows; each shard's logits (within 1e-5), greedy
    tokens (equal) and cache rows (within 1e-5 of max(1, |leaf|)) are a
    D = 1 run's on that shard's rows alone."""
    from test_torch_pg_families import _leaves, _map
    cfg = _family_cfg(name)
    pcfg = _port_pcfg(comm_mode="ring")
    assert TT.weave_decision_info(16, 1, tp=2, pcfg=pcfg, decode=True).weave
    assert TT.weave_decision_info(16, 8, tp=2, pcfg=pcfg).weave
    if cfg.family == "encdec":
        assert TE.encoder_split(16, SERVE_FRAMES, tp=2, pcfg=pcfg)
    api = t_build_model(cfg, pcfg, tp=2, ep=2)
    one = t_build_model(cfg, pcfg, tp=2)
    params = api.init(0, device="cpu")
    inp = family_serve_inputs(cfg, rows=32, seed=98, length=8)
    logits, fed, cache = family_serve_steps(api, params, inp, batch=32)
    for d in range(2):
        rows = slice(16 * d, 16 * (d + 1))
        l1, f1, c1 = family_serve_steps(one, params, inp, batch=16,
                                        rows=rows)
        for a, b in zip(logits, l1):
            _close(a[:, rows], b, LAYER_TOL)
        for a, b in zip(fed, f1):
            assert torch.equal(a[rows], b)
        groups = TC.Groups(model=None, data=None, model_rank=0,
                           data_rank=d, model_size=1, data_size=2)
        mine = dict(_leaves(_cut(cache, c1, groups)))
        for p, t in _leaves(c1):
            close_state(mine[p].numpy(), t.numpy(), KV_TOL)


@pytest.mark.parametrize("entry", ["init", "init_cache", "init_rank"])
def test_data_axis_entry_points_default_to_cuda(entry, monkeypatch):
    """``ep`` and ``dp`` change no device: without one the weights and
    the caches go to CUDA and raise where there is none, one (data,
    model) rank's weights under groups (``init(rank=, data_rank=)``)
    too."""
    from repro_torch.distributed.context import Groups
    cfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(EP2D).reduced()))
    api = t_build_model(cfg, tbase.ParallelConfig(), tp=2, ep=2)
    one = t_build_model(cfg, tbase.ParallelConfig(), tp=2, ep=2,
                        groups=Groups(model=None, data=None, model_rank=1,
                                      data_rank=1, model_size=2,
                                      data_size=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"init": lambda: api.init(0),
             "init_cache": lambda: api.init_cache(4, 16),
             "init_rank": lambda: one.init(0)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    params = api.init(0, device="cpu")
    assert params["layers"][0]["moe"]["w_up"].shape[:2] == (2, 2)
    with pytest.raises(ValueError, match="batch=3 does not split"):
        api.init_cache(3, 16, device="cpu")
