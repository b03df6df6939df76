"""The port's encdec family (``models/encdec.py``: Whisper's encoder,
cross-attention decoder and their weave) against the JAX reference, in
float32 on the CPU, on the same numpy-seeded inputs and weights
(``from_jax_params``).

The reduced whisper-base (2 encoder and 2 decoder layers, 64 source
positions) with every leaf perturbed by 0.05·N(0, 1): ``encode`` with
and without its batch split, ``project_cross_caches``, a decoder prompt
through a non-empty self cache (the weave splitting it or not) and a
decode step over random self and cross caches (its batch split slicing
the cross caches' rows or not): logits within 1e-4, encoder output and
caches within 1e-5 (of max(1, a leaf's largest magnitude)).  tp=2 in
``fused`` and ``ring`` against the reference on two host devices (one
subprocess), with an encoder batch whose cut the shrink rule moves.
K3's plain version, non-causal, against the reference's ``_attn_ref``
with ragged, padded keys, and the non-causal mask's shape.  The engine
refuses the family by name; its entry points default to CUDA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_distributed
from repro.layers.attention import _attn_ref as j_attn_ref
from repro.models import encdec as JE
from repro.models import transformer as JT

from repro_torch.kernels import flash_attention as K3
from repro_torch.layers import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import kv_cache as TKC
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.weights import from_jax_params
from test_torch_ssm import (LOGIT_TOL, PCFG, STATE_TOL, P, close,
                            close_state, local_logits, model_pair, nest,
                            shard_call, tp2_port)
from test_torch_vlm import check_kv, port_cache, random_cache

NAME = "whisper-base"
ENCODE = {True: (4, 16), False: (2, 8)}      # (rows, frames): split or not
PROMPT = {True: 48, False: 8}                # decoder tokens per row of 2
DECODE = {True: 16, False: 4}                # batch rows
ENC_LEN = 24                                 # frames under the caches


def frames_of(rng, b: int, s: int, d: int):
    return rng.randn(b, s, d).astype(np.float32)


@pytest.fixture(scope="module")
def encdec_pair():
    return model_pair(NAME, seed=8)


def k3_batches(monkeypatch):
    """Record the batch of every K3 call the model path makes."""
    seen = []
    wrapper = TA.flash_attention

    def spy(q, *args, **kw):
        seen.append((q.shape[0], kw["causal"]))
        return wrapper(q, *args, **kw)
    monkeypatch.setattr(TA, "flash_attention", spy)
    return seen


# --------------------------------------------------------------------------
# K3's plain version, bidirectional
# --------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 7])
def test_k3_plain_non_causal_matches_attn_ref(g):
    """The encoder's bidirectional attention (G 1) and a G of 7, ragged
    Sq != Sk, keys padded (kpos -1) at the end and in the middle."""
    rng = np.random.RandomState(30 + g)
    b, sq, sk, kvh, dh = 2, 37, 53, 2, 64
    q = rng.randn(b, sq, kvh, g, dh).astype(np.float32)
    k = rng.randn(b, sk, kvh, dh).astype(np.float32)
    v = rng.randn(b, sk, kvh, dh).astype(np.float32)
    qpos = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    kpos[:, -9:] = -1
    kpos[1, 10:14] = -1
    kw = dict(causal=False, window=0, sm_scale=dh ** -0.5)
    want = j_attn_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), **kw)
    got = K3.flash_attention(*(torch.from_numpy(a) for a in
                               (q, k, v, qpos, kpos)), **kw)
    close(got, want, STATE_TOL)


def test_attention_mask_non_causal_has_every_query_row():
    """The mask is (B, Sq, Sk) without the causal and window terms too
    (a visible-pair count, as behind a kernel case's bound, sums it), and
    only padded keys are hidden."""
    kpos = torch.tensor([[0, 1, -1, 3, -1]], dtype=torch.int32)
    qpos = torch.tensor([[-1, 7, 2]], dtype=torch.int32)
    m = K3.attention_mask(qpos, kpos, False, 0)
    assert m.shape == (1, 3, 5)
    assert int(m.sum()) == 3 * 3
    assert torch.equal(m[0, 1], kpos[0] >= 0)


# --------------------------------------------------------------------------
# the reduced whisper-base
# --------------------------------------------------------------------------

@pytest.mark.parametrize("split", [True, False])
def test_reduced_whisper_encode_and_cross_caches_match(split, encdec_pair,
                                                       mesh11, monkeypatch):
    """The encoder's output and each decoder layer's cross K/V; with the
    split the encoder's K3 calls take half the rows each."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = encdec_pair
    b, s = ENCODE[split]
    assert (TE.encoder_split(b, s, tp=1, pcfg=tpcfg) is not None) == split
    frames = frames_of(np.random.RandomState(80 + split), b, s, cfg.d_model)

    def f(p, x):
        out = JE.encode(p, x, cfg=cfg, pcfg=jpcfg)
        return out, JE.project_cross_caches(p, out, cfg=cfg, pcfg=jpcfg)
    j_out, j_cross = shard_call(mesh11, f, jp, jnp.asarray(frames),
                                out_specs=(P(), P()))
    seen = k3_batches(monkeypatch)
    with torch.no_grad():
        t_out = TE.encode(tparams, torch.from_numpy(frames), cfg=tcfg,
                          pcfg=tpcfg)
        t_cross = TE.project_cross_caches(tparams, t_out, cfg=tcfg,
                                          pcfg=tpcfg)
    close_state(t_out[0], j_out)
    check_kv(t_cross, j_cross)
    half = b // 2 if split else b
    assert seen == [(half, False)] * (cfg.encoder_layers * (1 + split))


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_whisper_prefill_through_self_cache_matches(weave,
                                                            encdec_pair,
                                                            mesh11):
    """Frames encoded, cross caches projected, then a decoder prompt
    that attends earlier tokens of a random self cache (rows of different
    lengths); the weave splits the prompt (the suffix takes the prefix's
    KV) or not.  Logits, the prompt's self KV and the cross caches; the
    port writes both into its cache (``insert_chunk``, ``write_rows``)."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = encdec_pair
    b, s, c = 2, PROMPT[weave], 96
    assert JT.weave_decision_info(b, s, tp=1, pcfg=jpcfg).weave == weave
    rng = np.random.RandomState(90 + weave)
    frames = frames_of(rng, b, ENC_LEN, cfg.d_model)
    prior = np.array([5, 12])
    self_np = random_cache(rng, cfg, b, c, prior)
    tokens = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = (prior[:, None] + np.arange(s)).astype(np.int32)
    jcache = api.init_cache(b, c, enc_len=ENC_LEN)
    jcache = {"self": self_np, "cross": jax.tree.map(np.asarray,
                                                     jcache["cross"])}

    def f(p, x, t, cch, ps):
        return JE.prefill(p, {"frames": x, "tokens": t}, cch, cfg=cfg,
                          pcfg=jpcfg, positions=ps)[:2]
    j_logits, j_out = shard_call(
        mesh11, f, jp, jnp.asarray(frames), jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, jcache), jnp.asarray(pos),
        out_specs=(P(), P()))
    tcache = TE.init_cache(b, c, tcfg, enc_len=ENC_LEN, device="cpu")
    tcache["self"] = port_cache(self_np["k"], self_np["v"], self_np["pos"],
                                1)
    with torch.no_grad():
        t_logits, t_out = TE.prefill(
            tparams, torch.from_numpy(tokens), tcache, cfg=tcfg, pcfg=tpcfg,
            frames=torch.from_numpy(frames), positions=torch.from_numpy(pos))
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_kv(t_out["self"], j_out["self"])
    check_kv(t_out["cross"], j_out["cross"])
    rows = torch.arange(b)
    TKC.insert_chunk(tcache["self"], t_out["self"], torch.from_numpy(prior),
                     rows)
    TKC.write_rows(tcache["cross"], t_out["cross"], rows)
    check_kv(tcache["cross"], j_out["cross"])
    for li, layer in enumerate(tcache["self"]):
        for i, n in enumerate(prior):
            close_state(global_heads_row(layer["k"], i, n, s),
                        np.asarray(j_out["self"][0][li][i]))
            np.testing.assert_array_equal(layer["pos"][i, n:n + s].numpy(),
                                          pos[i])


def global_heads_row(k, row: int, start: int, n: int):
    """Tokens [start, start + n) of one row of a port cache layer (R, B,
    C, kv, dh) in the reference's (n, R·kv, dh)."""
    a = k[:, row, start:start + n].numpy()
    return np.moveaxis(a, 0, -3).reshape(n, -1, a.shape[-1])


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_whisper_decode_step_matches(weave, encdec_pair, mesh11):
    """One token per row over random self and cross caches; with 16 rows
    the batch split gives each split its rows of the cross caches.
    Logits and the self cache."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = encdec_pair
    b, c = DECODE[weave], 32
    assert JT.weave_decision_info(b, 1, tp=1, pcfg=jpcfg,
                                  decode=True).weave == weave
    rng = np.random.RandomState(100 + weave)
    lengths = rng.randint(1, c, size=b)
    self_np = random_cache(rng, cfg, b, c, lengths)
    cross_np = random_cache(rng, cfg, b, ENC_LEN, [ENC_LEN] * b)
    tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = lengths[:, None].astype(np.int32)

    def f(p, t, cch, ps):
        return JE.decode_step(p, t, cch, cfg=cfg, pcfg=jpcfg, positions=ps)
    j_logits, j_cache = shard_call(
        mesh11, f, jp, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, {"self": self_np, "cross": cross_np}),
        jnp.asarray(pos), out_specs=(P(), P()))
    tcache = {"self": port_cache(self_np["k"], self_np["v"],
                                 self_np["pos"], 1),
              "cross": port_cache(cross_np["k"], cross_np["v"],
                                  cross_np["pos"], 1)}
    with torch.no_grad():
        t_logits, t_cache = TE.decode_step(
            tparams, torch.from_numpy(tokens), tcache, cfg=tcfg, pcfg=tpcfg,
            positions=torch.from_numpy(pos))
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_kv(t_cache["self"], j_cache["self"])
    check_kv(t_cache["cross"], j_cache["cross"])


# --------------------------------------------------------------------------
# the engine's refusal and the entry points' device
# --------------------------------------------------------------------------

def test_engine_refuses_encdec(encdec_pair):
    tcfg, tparams, tpcfg = encdec_pair[4], encdec_pair[5], encdec_pair[6]
    with pytest.raises(NotImplementedError,
                       match="encdec family is served by direct ModelApi"):
        TEngine(t_build_model(tcfg, tpcfg), tparams,
                tsched.SchedulerConfig(max_batch=2, max_len=64),
                device="cpu")


@pytest.mark.parametrize("entry", ["init", "init_cache", "from_jax_params"])
def test_encdec_entry_points_default_to_cuda(entry, encdec_pair,
                                             monkeypatch):
    jp, tcfg, tpcfg = encdec_pair[2], encdec_pair[4], encdec_pair[6]
    tapi = t_build_model(tcfg, tpcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"init": lambda: tapi.init(0),
             "init_cache": lambda: tapi.init_cache(2, 16, enc_len=8),
             "from_jax_params": lambda: from_jax_params(
                 jax.tree.map(np.asarray, jp), tcfg)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_init_matches_reference_shapes(encdec_pair):
    """The port's random init has the bridged weights' shapes and dtypes
    at tp=2 (the cross attention without biases, the replicated norms and
    tables)."""
    cfg, tcfg = encdec_pair[0], encdec_pair[4]
    from repro.configs.base import ParallelConfig as JParallel
    from repro.models.build import build_model as j_build_model
    jp = j_build_model(cfg, JParallel(), tp=2).init(jax.random.PRNGKey(0))
    want = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    got = TE.init_params(tcfg, device="cpu", tp=2)
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat.keys() == got_flat.keys()
    for k, w in flat.items():
        assert (tuple(got_flat[k].shape), got_flat[k].dtype) == \
            (tuple(w.shape), w.dtype), k


# --------------------------------------------------------------------------
# tp=2: the reference on two host devices
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.configs.base import ParallelConfig
from repro.models import encdec as E
from repro.models.build import build_model

name, path, PCFG, ENC_LEN = NAME_, PATH_, PCFG_, ENC_LEN_
tp = 2
mesh = jax.make_mesh((1, tp), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = configs.get_config(name).reduced()
rng = np.random.RandomState(220)
out = {}
pcfgs = {m: ParallelConfig(comm_mode=m, use_pallas_norm=False, **PCFG)
         for m in ('fused', 'ring')}
api = build_model(cfg, pcfgs['ring'], tp=tp)
params = jax.tree.map(
    lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
        np.asarray(a).dtype)), api.init(jax.random.PRNGKey(9)))
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out['params/' + '/'.join(p.key for p in k)] = np.asarray(v)
pspec, cspec = api.specs(), api.cache_specs()
kv = P(None, None, None, 'model', None)
cross_spec = {'k': kv, 'v': kv, 'pos': P()}
logit_spec = P(None, None, 'model')


def sm(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def save(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + '/'.join(str(getattr(p, 'key', getattr(p, 'idx', p)))
                              for p in k)] = np.asarray(v)


# encode: 6 rows of 33 frames, the shrink rule moving the cut to 2 rows
frames = rng.randn(6, 33, cfg.d_model).astype(np.float32)
out['enc/frames'] = frames
for mode, pcfg in pcfgs.items():
    def e(p, x, pcfg=pcfg):
        return E.encode(p, x, cfg=cfg, pcfg=pcfg)
    out[f'enc/{mode}/out'] = np.asarray(sm(e, (pspec, P()), P())(params,
                                                                 frames))

# prefill: 2 rows, ENC_LEN frames, a 48-token prompt the weave splits
frames = rng.randn(2, ENC_LEN, cfg.d_model).astype(np.float32)
tokens = rng.randint(0, cfg.vocab_size, (2, 48)).astype(np.int32)
out['pf/frames'], out['pf/tokens'] = frames, tokens
for mode, pcfg in pcfgs.items():
    def f(p, x, t, pcfg=pcfg):
        return E.prefill(p, {'frames': x, 'tokens': t}, None, cfg=cfg,
                         pcfg=pcfg)[:2]
    lg, st = sm(f, (pspec, P(), P()),
                (logit_spec, {'self': (kv, kv, P()), 'cross': cross_spec}))(
        params, frames, tokens)
    out[f'pf/{mode}/logits'] = np.asarray(lg)
    save(f'pf/{mode}/out/', st)

# decode: 16 rows over random self and cross caches, the batch splitting
b, c = 16, 32
cache = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype)
                     if a.dtype != jnp.int32 else np.asarray(a),
                     api.init_cache(b, c, enc_len=ENC_LEN))
lengths = rng.randint(1, c, size=b)
pos = np.full(cache['self']['pos'].shape, -1, np.int32)
for i, n in enumerate(lengths):
    pos[:, i, :n] = np.arange(n)
cache['self']['pos'] = pos
cache['cross']['pos'] = np.broadcast_to(
    np.arange(ENC_LEN, dtype=np.int32), cache['cross']['pos'].shape).copy()
save('dc/cache/', cache)
tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
positions = lengths[:, None].astype(np.int32)
out['dc/tokens'], out['dc/positions'] = tokens, positions
for mode, pcfg in pcfgs.items():
    def g(p, t, cc, ps, pcfg=pcfg):
        return E.decode_step(p, t, cc, cfg=cfg, pcfg=pcfg, positions=ps)
    lg, st = sm(g, (pspec, P(), cspec, P()), (logit_spec, cspec))(
        params, tokens, cache, positions)
    out[f'dc/{mode}/logits'] = np.asarray(lg)
    save(f'dc/{mode}/cache/', st)
np.savez(path, **out)
print('PASS')
"""


@pytest.fixture(scope="module")
def encdec_tp2(tmp_path_factory):
    path = tmp_path_factory.mktemp("encdec_tp2") / "ref.npz"
    code = _JAX_SIDE
    for key, val in (("NAME_", repr(NAME)), ("PATH_", repr(str(path))),
                     ("PCFG_", repr({k: v for k, v in PCFG.items()
                                     if k != "comm_mode"})),
                     ("ENC_LEN_", repr(ENC_LEN))):
        code = code.replace(key, val, 1)
    run_distributed(code, n_devices=2, timeout=600)
    return dict(np.load(path))


def _kv3(tree):
    return tuple(tree[str(i)] for i in range(3))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fused", "ring"])
@pytest.mark.parametrize("phase", ["encode", "prefill", "decode"])
def test_tp2_whisper_matches(encdec_tp2, mode, phase, monkeypatch):
    """tp=2 (one KV head a rank), the weaves firing: the encoder over 6
    rows of 33 frames (cut at 2 rows, not 3: 3·33 tokens do not divide
    over 2 ranks), a 2 x 48 prompt over 24 frames, a 16-row decode over
    random caches: logits within 1e-4, encoder output and caches within
    1e-5."""
    ref = encdec_tp2
    api, params = tp2_port(ref, NAME, mode)
    pre = {"encode": "enc/", "prefill": "pf/", "decode": "dc/"}[phase]
    seen = k3_batches(monkeypatch)
    with torch.no_grad():
        if phase == "encode":
            frames = torch.from_numpy(ref["enc/frames"])
            assert TE.encoder_split(6, 33, tp=2, pcfg=api.pcfg) == 2
            out = TE.encode(params, frames, cfg=api.cfg, pcfg=api.pcfg)
            assert torch.equal(out[0], out[1])
            close_state(out[0], ref[f"enc/{mode}/out"])
            # ranks folded into K3's batch: 2·2 rows, then 2·4
            assert seen == [(4, False), (8, False)] * api.cfg.encoder_layers
            return
        if phase == "prefill":
            assert TT.weave_decision_info(2, 48, tp=2, pcfg=api.pcfg).weave
            logits, out = api.prefill(
                params, torch.from_numpy(ref["pf/tokens"]), None, None,
                frames=torch.from_numpy(ref["pf/frames"]))
            want = nest(ref, f"pf/{mode}/out/")
            check_kv(out["self"], _kv3(want["self"]))
            check_kv(out["cross"], want["cross"])
        else:
            assert TT.weave_decision_info(16, 1, tp=2, pcfg=api.pcfg,
                                          decode=True).weave
            c = nest(ref, "dc/cache/")
            cache = {n: port_cache(c[n]["k"], c[n]["v"], c[n]["pos"], 2)
                     for n in ("self", "cross")}
            logits, out = api.decode_step(
                params, torch.from_numpy(ref["dc/tokens"]), cache,
                torch.from_numpy(ref["dc/positions"]))
            want = nest(ref, f"dc/{mode}/cache/")
            check_kv(out["self"], want["self"])
    close(local_logits(logits), ref[pre + f"{mode}/logits"], LOGIT_TOL)
