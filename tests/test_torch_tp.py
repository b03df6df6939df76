"""The PyTorch port's tensor-parallel path (tp ranks on one device's rank
axis) against the JAX reference on tp host devices, in float32 on the CPU.

The JAX side runs in a subprocess with tp XLA host devices
(``conftest.run_distributed``), under ``shard_map`` as the reference's own
multidevice tests run it: it makes the tiny model's weights, seeded
inputs, and the reference's outputs, and writes them all to an ``.npz``
that the port's side reads.  The reference runs ``comm_mode="ring"`` with
``use_pallas_norm=False``, which its fallback ladder takes to the ``fused``
composition (the same function; its interpreted Pallas ring kernel is not
the oracle, ROADMAP.md C); the port runs ``ring`` with its K1 wrapper on
the path, which takes the plain version on CPU tensors.

In-process: K1's plain version against ``kernels/ref.ring_ar_rmsnorm_ref``,
a planted wrong chunk ownership that the comparison must catch, the budget
to CTA mapping and the ragged fallback.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_distributed
from repro.core.splitting import MAX_RING_CHANNELS as J_MAX_CHANNELS
from repro.core.splitting import ring_channels as j_ring_channels
from repro.kernels.ref import ring_ar_rmsnorm_ref

from repro_torch.configs import base as tbase
from repro_torch.core import fused_collectives as tfc
from repro_torch.core import splitting as tsplit
from repro_torch.distributed.context import CommCtx as TCtx
from repro_torch.kernels import ar_rmsnorm as K1
from repro_torch.layers.embedding import sharded_argmax as t_argmax
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.weights import from_jax_params

TOL = 1e-4
MODES = ("vanilla", "reordered", "fused", "ring", "nocomm")
CFG = dict(name="tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
           vocab_size=125, dtype="float32")   # 125: the vocab is padded
PCFG = dict(tokenweave=True, remat=False, split_unit=16,
            tokenweave_min_tokens=32)
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16)
PREFILL = {"weave": 48, "unsplit": 8}          # chunk per row, 2 rows
DECODE = {"weave": 16, "unsplit": 4, "ragged": 5}   # batch rows
N_TRACES = 4
# at tp=4, 2 query heads on 1 KV head: head shards replicated twice
REPLICATED = dict(CFG, num_heads=2, num_kv_heads=1, head_dim=32)

# --------------------------------------------------------------------------
# the reference's side, run on tp host devices
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import ModelConfig, ParallelConfig
from repro.core import fused_collectives as fc
from repro.distributed.context import CommCtx
from repro.layers.embedding import sharded_argmax
from repro.models import transformer as T
from repro.models.build import build_model
from repro.runtime.engine import Engine
from repro.runtime.requests import Request
from repro.runtime.scheduler import SchedulerConfig

tp, path = TP, PATH
CFG, PCFG, SCHED, REPLICATED = CFG_, PCFG_, SCHED_, REPLICATED_
PREFILL, DECODE, MODES, N_TRACES = PREFILL_, DECODE_, MODES_, N_TRACES_
mesh = jax.make_mesh((1, tp), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
rng = np.random.RandomState(100 + tp)


def sm(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


# comm_norm: x (tp, T, d) partials; every rank's output and residual
t_, d = 24, 64
x = rng.randn(tp, t_, d).astype(np.float32)
res = rng.randn(t_, d).astype(np.float32)
w = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
wp = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
out['cn/x'], out['cn/res'], out['cn/w'], out['cn/wp'] = x, res, w, wp
for mode in MODES:
    sharded = mode in ('fused', 'reordered', 'ring')
    res_in = (res.reshape(tp, t_ // tp, d) if sharded
              else np.broadcast_to(res[None], (tp, t_, d)).copy())
    for post in (False, True):
        ctx = CommCtx(mode=mode, use_pallas=False, comm_budget=0.5)
        def f(xs, r, w_, wp_, ctx=ctx, post=post):
            o, nr = fc.comm_norm(xs[0], r[0], w_, ctx=ctx,
                                 weight_post=wp_ if post else None)
            return o[None], nr[None]
        o, nr = sm(f, (P('model'), P('model'), P(), P()),
                   (P('model'), P('model')))(x, res_in, w, wp)
        out[f'cn/{mode}/{int(post)}/out'] = np.asarray(o)
        out[f'cn/{mode}/{int(post)}/res'] = np.asarray(nr)

# greedy argmax over vocab-sharded logits, ties across ranks, max in the pad
v_loc = 10
lg = rng.randint(0, 4, size=(tp, 3, 2, v_loc)).astype(np.float32)
lg[-1, 0, 0, -3:] = 9.0
out['am/logits'] = lg
out['am/ids'] = np.asarray(sm(
    lambda l: sharded_argmax(l[0], vocab_size=tp * v_loc - 3),
    (P('model'),), P())(lg))

# the model: weights, then prefill and decode logits and KV
cfg = ModelConfig(**CFG)
pcfgs = {m: ParallelConfig(comm_mode=m, use_pallas_norm=False, **PCFG)
         for m in ('ring', 'vanilla')}
api = build_model(cfg, pcfgs['ring'], tp=tp)
params = api.init(jax.random.PRNGKey(tp))
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out['params/' + '/'.join(p.key for p in k)] = np.asarray(v)
pspec, cspec = api.specs(), api.cache_specs()
kv_spec = P(None, None, None, 'model', None)


def rand_cache(b, c, lengths):
    shape = (cfg.num_layers, b, c, api.init_cache(1, 1)['k'].shape[3],
             cfg.head_dim)
    pos = np.full((cfg.num_layers, b, c), -1, np.int32)
    for i, n in enumerate(lengths):
        pos[:, i, :n] = np.arange(n)
    return {'k': rng.randn(*shape).astype(np.float32),
            'v': rng.randn(*shape).astype(np.float32), 'pos': pos}


b, c = 2, 64
for case, chunk in PREFILL.items():
    cache = rand_cache(b, c, [10, 3])
    tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
    positions = np.full((b, chunk), -1, np.int32)
    take = [chunk, chunk - 5]
    for i in range(b):
        positions[i, :take[i]] = np.arange([10, 3][i], [10, 3][i] + take[i])
    last = np.array([t - 1 for t in take], np.int32)
    pre = f'pf/{case}/'
    for name, a in (('cache/k', cache['k']), ('cache/v', cache['v']),
                    ('cache/pos', cache['pos']), ('tokens', tokens),
                    ('positions', positions), ('last', last)):
        out[pre + name] = a
    for mode, pcfg in pcfgs.items():
        def f(p, tok, cch, pos, li, pcfg=pcfg):
            return T.prefill(p, tok, cch, cfg=cfg, pcfg=pcfg, positions=pos,
                             last_idx=li)[:2]
        lgt, (k, v, kp) = sm(f, (pspec, P(), cspec, P(), P()),
                             (P(None, None, 'model'),
                              (kv_spec, kv_spec, P())))(
            params, tokens, cache, positions, last)
        winfo = T.weave_decision_info(b, chunk, tp=tp, pcfg=pcfg)
        out[pre + f'{mode}/weave'] = np.asarray(winfo.weave)
        out[pre + f'{mode}/logits'] = np.asarray(lgt)
        out[pre + f'{mode}/k'] = np.asarray(k)
        out[pre + f'{mode}/v'] = np.asarray(v)
        out[pre + f'{mode}/kpos'] = np.asarray(kp)

c = 32
for case, batch in DECODE.items():
    lengths = rng.randint(1, c, size=batch)
    cache = rand_cache(batch, c, lengths)
    tokens = rng.randint(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    positions = lengths[:, None].astype(np.int32)
    positions[1, 0] = -1                # an inactive slot
    positions[2, 0] = c + 3             # a write that wraps the row
    pre = f'dc/{case}/'
    for name, a in (('cache/k', cache['k']), ('cache/v', cache['v']),
                    ('cache/pos', cache['pos']), ('tokens', tokens),
                    ('positions', positions)):
        out[pre + name] = a
    for mode, pcfg in pcfgs.items():
        def f(p, tok, cch, pos, pcfg=pcfg):
            return T.decode_step(p, tok, cch, cfg=cfg, pcfg=pcfg,
                                 positions=pos)
        lgt, cch = sm(f, (pspec, P(), cspec, P()),
                      (P(None, None, 'model'), cspec))(
            params, tokens, cache, positions)
        winfo = T.weave_decision_info(batch, 1, tp=tp, pcfg=pcfg,
                                      decode=True)
        out[pre + f'{mode}/weave'] = np.asarray(winfo.weave)
        out[pre + f'{mode}/logits'] = np.asarray(lgt)
        for name in ('k', 'v', 'pos'):
            out[pre + f'{mode}/cache/{name}'] = np.asarray(cch[name])

# a layout whose head shards are replicated (o_scale), prefill only
if tp == 4:
    cfg2 = ModelConfig(**REPLICATED)
    api2 = build_model(cfg2, pcfgs['ring'], tp=tp)
    assert T.A.attention_layout(tp, cfg2.num_heads, cfg2.num_kv_heads,
                                cfg2.head_dim).replicas == 2
    params2 = api2.init(jax.random.PRNGKey(7))
    for k, v in jax.tree_util.tree_flatten_with_path(params2)[0]:
        out['rparams/' + '/'.join(p.key for p in k)] = np.asarray(v)
    chunk = PREFILL['weave']
    tokens = rng.randint(0, cfg2.vocab_size, (2, chunk)).astype(np.int32)
    positions = np.broadcast_to(np.arange(chunk, dtype=np.int32)[None],
                                (2, chunk)).copy()
    cache2 = api2.init_cache(2, 64)
    def f(p, tok, cch, pos):
        return T.prefill(p, tok, cch, cfg=cfg2, pcfg=pcfgs['ring'],
                         positions=pos)[:2]
    lgt, (k, v, kp) = sm(f, (api2.specs(), P(), api2.cache_specs(), P()),
                         (P(None, None, 'model'),
                          (kv_spec, kv_spec, P())))(
        params2, tokens, cache2, positions)
    out['rep/tokens'], out['rep/positions'] = tokens, positions
    out['rep/logits'], out['rep/k'] = np.asarray(lgt), np.asarray(k)

# the engine: seeded traces, greedy tokens
traces = []
if tp == 2:
    jit_cache = {}
    for trial in range(N_TRACES):
        trng = np.random.RandomState(7000 + trial)
        prompts = [[int(t) for t in trng.randint(0, cfg.vocab_size,
                                                 int(trng.randint(3, 60)))]
                   for _ in range(int(trng.randint(2, 6)))]
        outs = [int(trng.randint(2, 7)) for _ in prompts]
        eng = Engine(api, mesh, params, SchedulerConfig(**SCHED),
                     jit_cache=jit_cache)
        for i, (p, n) in enumerate(zip(prompts, outs)):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
        got = {r.rid: r.output for r in eng.run()}
        traces.append({'prompts': prompts, 'outs': outs,
                       'tokens': [got[i] for i in range(len(prompts))],
                       'forwards': eng.stats.forwards,
                       'weave_forwards': eng.stats.weave_forwards})
out['engine'] = np.asarray(json.dumps(traces))
np.savez(path, **out)
print('PASS')
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """tp -> the reference's npz (built once per tp, on first use)."""
    made = {}

    def get(tp):
        if tp not in made:
            path = tmp_path_factory.mktemp(f"tp{tp}") / "ref.npz"
            code = _JAX_SIDE
            for key, val in (("TP", tp), ("PATH", repr(str(path))),
                             ("CFG_", repr(CFG)), ("PCFG_", repr(PCFG)),
                             ("SCHED_", repr(SCHED)),
                             ("REPLICATED_", repr(REPLICATED)),
                             ("PREFILL_", repr(PREFILL)),
                             ("DECODE_", repr(DECODE)),
                             ("MODES_", repr(MODES)),
                             ("N_TRACES_", repr(N_TRACES))):
                code = code.replace(key, str(val), 1)
            run_distributed(code, n_devices=tp, timeout=600)
            made[tp] = dict(np.load(path))
        return made[tp]

    return get


def _nest(flat, prefix):
    """'params/a/b' keys -> nested dict of numpy arrays."""
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _port(ref, tp, mode, cfg=CFG, prefix="params/"):
    cfg = tbase.ModelConfig(**cfg)
    pcfg = tbase.ParallelConfig(comm_mode=mode, attn_impl="pallas",
                                use_pallas_norm=True, **PCFG)
    params = from_jax_params(_nest(ref, prefix), cfg, pcfg, device="cpu")
    return cfg, pcfg, params


def _rank_cache(ref, pre, tp):
    """The reference's global-head cache (L, B, C, tp·kv, dh) -> the
    port's per-layer {"k": (tp, B, C, kv, dh), ..., "pos": (B, C)}."""
    k, v, pos = (ref[pre + n] for n in ("cache/k", "cache/v", "cache/pos"))

    def split(a):
        nl, b, c, h, dh = a.shape
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(nl, b, c, tp, h // tp, dh).transpose(0, 3, 1, 2, 4, 5)))
    tk, tv = split(k), split(v)
    return [{"k": tk[i], "v": tv[i], "pos": torch.from_numpy(pos[i].copy())}
            for i in range(k.shape[0])]


def _global_heads(t):
    """(tp, ..., kv, dh) on the rank axis -> the reference's
    (..., tp·kv, dh)."""
    a = t.numpy()
    return np.moveaxis(a, 0, -3).reshape(*a.shape[1:-2], -1, a.shape[-1])


def _local_logits(t):
    """(tp, B, S, V_loc) -> the reference's gathered (B, S, tp·V_loc)."""
    return np.concatenate(list(t.numpy()), axis=-1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------
# K1's plain version against the reference's oracle (in-process)
# --------------------------------------------------------------------------

def _k1_inputs(n, dtype, t=16, d=96, seed=0):
    rng = np.random.RandomState(seed + n)
    xs = rng.randn(n, t, d).astype(np.float32)
    res = rng.randn(n, t // n, d).astype(np.float32)
    w = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (xs, res, w)]
    tt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx = [torch.from_numpy(np.array(a, np.float32)).to(tt) for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_k1_plain_matches_ring_ar_rmsnorm_ref(n, dtype, tol):
    (jx, jres, jw), (tx, tres, tw) = _k1_inputs(n, dtype)
    ref_outs, ref_res = ring_ar_rmsnorm_ref(list(jx), list(jres), jw)
    before = K1.ar_rmsnorm.launches
    out, new_res = K1.ar_rmsnorm(tx, tres, tw, ctas=3)
    assert K1.ar_rmsnorm.launches == before      # CPU: the plain version
    assert out.shape == tx.shape and new_res.shape == tres.shape
    assert out.dtype == tx.dtype and new_res.dtype == tres.dtype
    for r in range(n):
        _close(out[r].float(), ref_outs[r], tol)
        _close(new_res[r].float(), ref_res[r], tol)


def test_k1_numerics_pin_catches_wrong_chunk_ownership(monkeypatch):
    """Planted fault: every rank norms the next rank's chunk.  Shapes stay
    right, so only the comparison with the oracle can catch it."""
    (jx, jres, jw), (tx, tres, tw) = _k1_inputs(4, "float32", t=32, d=64)
    ref_outs, ref_res = ring_ar_rmsnorm_ref(list(jx), list(jres), jw)
    monkeypatch.setattr(K1, "_chunk_owner", lambda r, n: (r + 1) % n)
    bad_out, bad_res = K1.ar_rmsnorm_plain(tx, tres, tw)
    assert bad_out.shape == tx.shape
    assert not np.allclose(bad_out[0].numpy(), np.asarray(ref_outs[0]),
                           rtol=1e-3, atol=1e-3)
    assert not all(np.allclose(bad_res[r].numpy(), np.asarray(ref_res[r]),
                               rtol=1e-3, atol=1e-3) for r in range(4))


def test_budget_to_k1_ctas_matches_ring_channels():
    """The budget -> channel contract is the reference's; K1's grid is
    those channels clamped to [1, 8] SMs."""
    assert tsplit.MAX_RING_CHANNELS == J_MAX_CHANNELS == K1.MAX_CTAS
    for budget in (0.0, 0.05, 0.0625, 0.125, 0.25, 0.3, 0.5, 0.625, 0.75,
                   0.9, 1.0):
        ch = tsplit.ring_channels(budget)
        assert ch == j_ring_channels(budget), budget
        assert tsplit.ring_ctas(budget) == min(8, max(1, ch))
    assert tsplit.ring_ctas(0.05) == 1 and tsplit.ring_ctas(1.0) == 8


def test_comm_ctx_ragged_falls_back_to_vanilla():
    cfg = tbase.ModelConfig(**CFG)
    pcfg = tbase.ParallelConfig()
    ctx = TT._comm_ctx(pcfg, cfg, 32, 4, mode="ring", budget=0.5)
    assert ctx.mode == "ring" and ctx.comm_budget == 0.5 and ctx.tp == 4
    assert TT._comm_ctx(pcfg, cfg, 33, 4, mode="ring").mode == "vanilla"
    assert TT._comm_ctx(pcfg, cfg, 3, 4, mode="ring").mode == "vanilla"
    assert TT._comm_ctx(pcfg, cfg, 32, 4).mode == pcfg.comm_mode
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TCtx(tp=2, backend="process_group")


def test_k1_input_checks_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(4, 16, 64)
    K1.check_inputs(x, torch.zeros(4, 4, 64), torch.zeros(64))
    with pytest.raises(ValueError):        # T not a multiple of N
        K1.check_inputs(torch.zeros(4, 18, 64), torch.zeros(4, 4, 64),
                        torch.zeros(64))
    with pytest.raises(ValueError):        # more ranks than the table
        K1.check_inputs(torch.zeros(9, 18, 64), torch.zeros(9, 2, 64),
                        torch.zeros(64))
    with pytest.raises(ValueError):        # residual not (N, T/N, d)
        K1.check_inputs(x, torch.zeros(4, 16, 64), torch.zeros(64))
    with pytest.raises(TypeError):
        K1.check_inputs(x, torch.zeros(4, 4, 64),
                        torch.zeros(64, dtype=torch.bfloat16))
    # the pipelined body holds at most 1024 16-byte vectors of a row (bf16
    # d <= 8192); wider or ragged rows take the scalar body, whose row of t
    # in shared memory must fit
    bf = dict(dtype=torch.bfloat16)
    assert K1.pipelined(torch.zeros(8, 8, 8192, **bf))
    assert not K1.pipelined(torch.zeros(8, 8, 8190, **bf))
    assert not K1.pipelined(torch.zeros(2, 8, 8192))        # fp32: 2048
    K1.check_inputs(torch.zeros(2, 8, 8192), torch.zeros(2, 4, 8192),
                    torch.zeros(8192))
    with pytest.raises(ValueError, match="row buffer"):
        K1.check_inputs(torch.zeros(1, 1, 60000), torch.zeros(1, 1, 60000),
                        torch.zeros(60000))


# --------------------------------------------------------------------------
# against the reference on tp host devices
# --------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [2, 4])
def test_comm_norm_modes_match_shard_map(jax_side, tp, mode, post):
    ref = jax_side(tp)
    x, res, w, wp = (torch.from_numpy(ref["cn/" + n])
                     for n in ("x", "res", "w", "wp"))
    ctx = TCtx(mode=mode, use_pallas=True, tp=tp, comm_budget=0.5)
    t, d = res.shape
    res_in = (res.reshape(tp, t // tp, d) if ctx.sharded_residual
              else res.expand(tp, t, d).contiguous())
    before = K1.ar_rmsnorm.launches
    out, new_res = tfc.comm_norm(x, res_in, w, ctx=ctx,
                                 weight_post=wp if post else None)
    assert K1.ar_rmsnorm.launches == before
    _close(out, ref[f"cn/{mode}/{int(post)}/out"], 2e-5)
    _close(new_res, ref[f"cn/{mode}/{int(post)}/res"], 2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_argmax_ties_across_ranks(jax_side, tp):
    ref = jax_side(tp)
    lg = torch.from_numpy(ref["am/logits"])
    got = t_argmax(lg, vocab_size=tp * lg.shape[-1] - 3)
    np.testing.assert_array_equal(got.numpy(), ref["am/ids"])
    assert int(got[0, 0]) < tp * lg.shape[-1] - 3    # the pad never wins


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["ring", "vanilla"])
@pytest.mark.parametrize("case", list(PREFILL))
@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_logits_and_kv_match(jax_side, tp, case, mode):
    ref = jax_side(tp)
    cfg, pcfg, params = _port(ref, tp, mode)
    pre = f"pf/{case}/"
    tokens, positions, last = (torch.from_numpy(ref[pre + n])
                               for n in ("tokens", "positions", "last"))
    b, s = tokens.shape
    weave = TT.weave_decision_info(b, s, tp=tp, pcfg=pcfg).weave
    assert weave == bool(ref[pre + f"{mode}/weave"]) == (case == "weave")
    logits, kv = TT.prefill(params, tokens, _rank_cache(ref, pre, tp),
                            cfg=cfg, pcfg=pcfg, positions=positions,
                            last_idx=last)
    assert logits.shape[0] == tp
    _close(_local_logits(logits), ref[pre + f"{mode}/logits"])
    for layer, (k, v, kpos) in enumerate(kv):
        _close(_global_heads(k), ref[pre + f"{mode}/k"][layer])
        _close(_global_heads(v), ref[pre + f"{mode}/v"][layer])
        np.testing.assert_array_equal(kpos.numpy(),
                                      ref[pre + f"{mode}/kpos"][layer])


@pytest.mark.slow
def test_prefill_with_replicated_head_shards_matches(jax_side):
    """tp=4 ranks over 2 query heads: each head shard sits on 2 ranks and
    the output projection is scaled by o_scale = 1/2 before the psum."""
    ref = jax_side(4)
    cfg, pcfg, params = _port(ref, 4, "ring", REPLICATED, "rparams/")
    tokens, positions = (torch.from_numpy(ref["rep/" + n])
                         for n in ("tokens", "positions"))
    cache = TT.init_cache(2, 64, cfg, 4, device="cpu")
    logits, kv = TT.prefill(params, tokens, cache, cfg=cfg, pcfg=pcfg,
                            positions=positions)
    _close(_local_logits(logits), ref["rep/logits"])
    for layer, (k, _, _) in enumerate(kv):
        _close(_global_heads(k), ref["rep/k"][layer])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["ring", "vanilla"])
@pytest.mark.parametrize("case", list(DECODE))
@pytest.mark.parametrize("tp", [2, 4])
def test_decode_logits_and_cache_match(jax_side, tp, case, mode):
    """The weave case splits the batch, so each split writes its rows of
    the cache through a strided view of the (tp, B, C, ...) tensors."""
    ref = jax_side(tp)
    cfg, pcfg, params = _port(ref, tp, mode)
    pre = f"dc/{case}/"
    tokens, positions = (torch.from_numpy(ref[pre + n])
                         for n in ("tokens", "positions"))
    weave = TT.weave_decision_info(tokens.shape[0], 1, tp=tp, pcfg=pcfg,
                                   decode=True).weave
    assert weave == bool(ref[pre + f"{mode}/weave"]) == (case == "weave")
    cache = _rank_cache(ref, pre, tp)
    logits, cache = TT.decode_step(params, tokens, cache, cfg=cfg, pcfg=pcfg,
                                   positions=positions)
    _close(_local_logits(logits), ref[pre + f"{mode}/logits"])
    for layer, lc in enumerate(cache):
        _close(_global_heads(lc["k"]), ref[pre + f"{mode}/cache/k"][layer])
        _close(_global_heads(lc["v"]), ref[pre + f"{mode}/cache/v"][layer])
        np.testing.assert_array_equal(lc["pos"].numpy(),
                                      ref[pre + f"{mode}/cache/pos"][layer])


@pytest.mark.slow
@pytest.mark.parametrize("trial", range(N_TRACES))
def test_engine_token_identical_to_reference_tp2(jax_side, trial):
    """Greedy tokens through the port's Engine at tp=2 in ring mode equal
    the reference engine's on 2 host devices.  max_batch=3 makes every
    decode forward ragged (3 % 2), so those fall back to vanilla."""
    ref = jax_side(2)
    tr = json.loads(str(ref["engine"]))[trial]
    cfg, pcfg, params = _port(ref, 2, "ring")
    api = t_build_model(cfg, pcfg, tp=2)
    eng = TEngine(api, params, TSched(**SCHED), device="cpu")
    for i, (p, n) in enumerate(zip(tr["prompts"], tr["outs"])):
        eng.add_request(TRequest(rid=i, prompt=list(p), max_new_tokens=n))
    got = {r.rid: r.output for r in eng.run()}
    assert [got[i] for i in range(len(tr["prompts"]))] == tr["tokens"]
    assert eng.stats.forwards == tr["forwards"]
    assert eng.stats.weave_forwards == tr["weave_forwards"]


@pytest.mark.slow
def test_engine_traces_weave(jax_side):
    """The traces above are not vacuous: prefill forwards take the weave
    split in some of them."""
    traces = json.loads(str(jax_side(2)["engine"]))
    assert sum(t["weave_forwards"] for t in traces) > 0


def test_port_params_keep_the_rank_axis():
    """init_params at tp gives the reference's shapes: sharded weights
    (tp, ...), vocab padded to a multiple of tp, norms (d,)."""
    cfg = tbase.ModelConfig(**CFG)
    api = t_build_model(cfg, dataclasses.replace(
        tbase.ParallelConfig(**PCFG), comm_mode="ring"), tp=4)
    p = api.init(0, device="cpu")
    assert p["embedding"]["embed"].shape == (4, 32, 64)
    assert p["embedding"]["lm_head"].shape == (4, 64, 32)
    lp = p["layers"][0]
    assert lp["attn"]["wq"].shape == (4, 64, 16)     # one query head each
    assert lp["attn"]["wk"].shape == (4, 64, 16)     # KV heads duplicated
    assert lp["mlp"]["w_down"].shape == (4, 32, 64)
    assert lp["norm_attn"].shape == p["norm_first"].shape == (64,)
    cache = api.init_cache(3, 16, device="cpu")
    assert cache[0]["k"].shape == (4, 3, 16, 1, 16)
    assert cache[0]["pos"].shape == (3, 16)
