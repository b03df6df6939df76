"""The port's vlm family (Qwen2-VL: the dense stack, patch embeddings in
front of the text rows, M-RoPE) against the JAX reference, in float32 on
the CPU, on the same numpy-seeded inputs and weights
(``from_jax_params``).

``apply_mrope`` on an image-then-text id pattern, and equal to
``apply_rope`` where the t/h/w rows agree.  The reduced qwen2-vl-7b with
every leaf perturbed by 0.05·N(0, 1): a prefill of patch embeddings and
text with M-RoPE ids (weave on and off), a decode step and a verify
window whose M-RoPE ids differ from their 1-D positions (the batch split
on and off): logits within 1e-4, KV within 1e-5 (of max(1, a leaf's
largest magnitude)).  Two traces of tests/test_differential.py through
both packages' engines, which serve the family text-only (plain RoPE).
tp=2 in ``fused`` and ``ring`` against the reference on two host devices
(one subprocess).  The entry points default to CUDA.  Helpers come from
``test_torch_ssm.py``; ``test_torch_encdec.py`` takes the cache helpers
from here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_distributed
from repro.layers import rotary as JR
from repro.layers.attention import attention_layout
from repro.models import transformer as JT
from repro.runtime.engine import Engine as JEngine
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.layers import rotary as TR
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.weights import from_jax_params
from test_torch_engine_paged import _drive, _gen_trace
from test_torch_hybrid import global_heads
from test_torch_ssm import (LOGIT_TOL, PCFG, SCHED, P, close,
                            close_state, local_logits, model_pair, nest,
                            shard_call, tp2_port)

NAME = "qwen2-vl-7b"
# (patch grid side, text tokens) per row: the weave splits 2 x 48 tokens
# and not 2 x 8
PREFILL = {True: (4, 32), False: (2, 4)}
DECODE = {True: 16, False: 4}        # batch rows
GAMMA = 2                            # verify window: gamma + 1 tokens


def mrope_ids(b: int, grid: int, n_text: int, start: int = 0):
    """(B, 3, grid² + n_text) int32: patch (i, j) gets (t, h, w) = (0, i,
    j), text token k gets t = h = w = grid + k, each row shifted by
    ``start`` + its index."""
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid), i.ravel(), j.ravel()])
    text = np.tile(grid + np.arange(n_text), (3, 1))
    ids = np.concatenate([img, text], axis=1)[None]
    return (ids + start + np.arange(b)[:, None, None]).astype(np.int32)


def port_cache(k, v, pos, tp: int):
    """The reference's stacked global cache, k/v (L, B, C, tp·kv, dh) and
    pos (L, B, C) -> the port's per-layer dicts, copied."""
    def ranks(a):
        nl, b, c, h, dh = a.shape
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(nl, b, c, tp, h // tp, dh).transpose(0, 3, 1, 2, 4, 5)))
    tk, tv = ranks(np.asarray(k)), ranks(np.asarray(v))
    return [{"k": tk[i], "v": tv[i], "pos": torch.from_numpy(np.array(
        pos[i]))} for i in range(tk.shape[0])]


def check_kv(got, want):
    """The port's per-layer (k, v, pos) chunks or cache dicts against the
    reference's stacked (k, v, pos) or {"k", "v", "pos"}."""
    if isinstance(want, dict):
        want = (want["k"], want["v"], want["pos"])
    for li, layer in enumerate(got):
        k, v, pos = ((layer["k"], layer["v"], layer["pos"])
                     if isinstance(layer, dict) else layer)
        close_state(global_heads(k), want[0][li])
        close_state(global_heads(v), want[1][li])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want[2][li]))


def random_cache(rng, cfg, b: int, c: int, lengths, tp: int = 1):
    """A stacked reference cache (numpy) with rows filled to ``lengths``
    (pos -1 beyond)."""
    lay = attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim)
    shape = (cfg.num_layers, b, c, lay.kv_store * tp, cfg.head_dim)
    pos = np.full(shape[:3], -1, np.int32)
    for i, n in enumerate(lengths):
        pos[:, i, :n] = np.arange(n)
    return {"k": rng.randn(*shape).astype(np.float32),
            "v": rng.randn(*shape).astype(np.float32), "pos": pos}


# --------------------------------------------------------------------------
# apply_mrope
# --------------------------------------------------------------------------

def test_apply_mrope_matches_reference():
    """Image-then-text ids on 2 rows (the sections 16/24/24 of the full
    config over dh 128), and rows that differ in t, h and w."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20, 3, 128).astype(np.float32)
    ids = mrope_ids(2, 4, 4, start=3)
    ids[1, 0] += 7                              # a later frame
    for sections, theta in (((16, 24, 24), 1e6), ((8, 24, 32), 1e4)):
        want = JR.apply_mrope(jnp.asarray(x), jnp.asarray(ids), sections,
                              theta)
        got = TR.apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                             sections, theta)
        close(got, want, 1e-6)
    with pytest.raises(ValueError, match="head_dim/2"):
        TR.apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                       (8, 4, 4), 1e6)


def test_apply_mrope_with_equal_rows_is_rope():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 9, 2, 32).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 5000, (2, 9)).astype(np.int32))
    got = TR.apply_mrope(x, pos[:, None].expand(2, 3, 9), (8, 4, 4), 1e6)
    assert torch.equal(got, TR.apply_rope(x, pos, 1e6))
    close(TR.apply_rope(x, pos, 1e6),
          JR.apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()),
                        1e6), 1e-6)


# --------------------------------------------------------------------------
# the reduced qwen2-vl-7b
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm_pair():
    return model_pair(NAME, seed=6)


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_qwen2vl_prefill_with_image_matches(weave, vlm_pair, mesh11):
    """Patch embeddings (0.02 scale) in front of the text, M-RoPE ids
    from the patch grid, the default 1-D positions: logits and chunk
    KV."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = vlm_pair
    grid, n_text = PREFILL[weave]
    b, s = 2, grid * grid + n_text
    assert JT.weave_decision_info(b, s, tp=1, pcfg=jpcfg).weave == weave
    rng = np.random.RandomState(60 + weave)
    tokens = rng.randint(0, cfg.vocab_size, (b, n_text)).astype(np.int32)
    img = (0.02 * rng.randn(b, grid * grid, cfg.d_model)).astype(np.float32)
    ids = mrope_ids(b, grid, n_text)

    def f(p, t, m, e):
        return JT.prefill(p, t, None, cfg=cfg, pcfg=jpcfg, positions=None,
                          mrope_positions=m, extra_embeds=e)[:2]
    j_logits, j_kv = shard_call(mesh11, f, jp, *map(jnp.asarray,
                                                    (tokens, ids, img)))
    with torch.no_grad():
        t_logits, t_kv = TT.prefill(
            tparams, torch.from_numpy(tokens), None, cfg=tcfg, pcfg=tpcfg,
            positions=None, mrope_positions=torch.from_numpy(ids),
            extra_embeds=torch.from_numpy(img))
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_kv(t_kv, j_kv)
    assert t_kv[0][2].shape == (b, s)


@pytest.mark.parametrize("step", ["decode", "verify"])
@pytest.mark.parametrize("weave", [True, False])
def test_reduced_qwen2vl_decode_and_verify_with_mrope_match(step, weave,
                                                            vlm_pair,
                                                            mesh11):
    """One decode token or a verify window (gamma 2, one row without a
    draft) over a random cache, each token's M-RoPE ids 40 below its 1-D
    position (a 6x6 image took 36 positions and 6 ids).  Logits and the
    updated cache."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = vlm_pair
    b, c = DECODE[weave], 64
    s = 1 if step == "decode" else GAMMA + 1
    rng = np.random.RandomState(70 + 2 * weave + (step == "verify"))
    lengths = rng.randint(40, c - s, size=b)
    cache = random_cache(rng, cfg, b, c, lengths)
    tokens = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = (lengths[:, None] + np.arange(s)).astype(np.int32)
    ids = np.repeat((pos - 40)[:, None], 3, axis=1).astype(np.int32)
    if step == "verify":
        pos[1, 1:] = -1
    assert JT.weave_decision_info(b, s, tp=1, pcfg=jpcfg,
                                  decode=True).weave == weave
    jfn = JT.decode_step if step == "decode" else JT.verify_step
    tfn = TT.decode_step if step == "decode" else TT.verify_step

    def f(p, t, cch, ps, m):
        return jfn(p, t, cch, cfg=cfg, pcfg=jpcfg, positions=ps,
                   mrope_positions=m)
    j_logits, j_cache = shard_call(
        mesh11, f, jp, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos),
        jnp.asarray(ids), out_specs=(P(), P()))
    with torch.no_grad():
        t_logits, t_cache = tfn(
            tparams, torch.from_numpy(tokens),
            port_cache(cache["k"], cache["v"], cache["pos"], 1), cfg=tcfg,
            pcfg=tpcfg, positions=torch.from_numpy(pos),
            mrope_positions=torch.from_numpy(ids))
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_kv(t_cache, j_cache)


@pytest.fixture(scope="module")
def vlm_engines(vlm_pair):
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = vlm_pair
    return api, jp, t_build_model(tcfg, tpcfg), tparams


@pytest.mark.parametrize("trial", range(2))
def test_differential_traces_vlm_text_only(trial, vlm_engines, mesh11):
    """Seeded traces of tests/test_differential.py's generator (gamma
    forced to 0, cancellations included) through both packages' engines
    with the vlm config, which pass no M-RoPE ids: tokens, forwards and
    weave forwards equal."""
    api, jp, tapi, tparams = vlm_engines
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(2000
                                                                 + trial))
    jeng = JEngine(api, mesh11, jp, JSched(**SCHED))
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    teng = TEngine(tapi, tparams, tsched.SchedulerConfig(**SCHED),
                   device="cpu")
    got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
    assert got == want
    assert (teng.stats.forwards, teng.stats.weave_forwards) == \
        (jeng.stats.forwards, jeng.stats.weave_forwards)


@pytest.mark.parametrize("entry", ["init", "init_cache", "from_jax_params"])
def test_vlm_entry_points_default_to_cuda(entry, vlm_pair, monkeypatch):
    jp, tcfg, tpcfg = vlm_pair[2], vlm_pair[4], vlm_pair[6]
    tapi = t_build_model(tcfg, tpcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"init": lambda: tapi.init(0),
             "init_cache": lambda: tapi.init_cache(2, 16),
             "from_jax_params": lambda: from_jax_params(
                 jax.tree.map(np.asarray, jp), tcfg)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# --------------------------------------------------------------------------
# tp=2: the reference on two host devices
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.configs.base import ParallelConfig
from repro.models.build import build_model

name, path, PCFG, GRID, NTEXT = NAME_, PATH_, PCFG_, GRID_, NTEXT_
tp = 2
mesh = jax.make_mesh((1, tp), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = configs.get_config(name).reduced()
rng = np.random.RandomState(210)
out = {}
pcfgs = {m: ParallelConfig(comm_mode=m, use_pallas_norm=False, **PCFG)
         for m in ('fused', 'ring')}
api = build_model(cfg, pcfgs['ring'], tp=tp)
params = jax.tree.map(
    lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
        np.asarray(a).dtype)), api.init(jax.random.PRNGKey(7)))
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out['params/' + '/'.join(p.key for p in k)] = np.asarray(v)
pspec, cspec = api.specs(), api.cache_specs()
kv = P(None, None, None, 'model', None)
logit_spec = P(None, None, 'model')


def sm(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def save(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + '/'.join(str(getattr(p, 'key', getattr(p, 'idx', p)))
                              for p in k)] = np.asarray(v)


# prefill: 2 rows of GRID^2 patches and NTEXT tokens, the weave splitting
b = 2
tokens = rng.randint(0, cfg.vocab_size, (b, NTEXT)).astype(np.int32)
img = (0.02 * rng.randn(b, GRID * GRID, cfg.d_model)).astype(np.float32)
i, j = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing='ij')
ids = np.concatenate([np.stack([0 * i.ravel(), i.ravel(), j.ravel()]),
                      np.tile(GRID + np.arange(NTEXT), (3, 1))], axis=1)
ids = np.tile(ids[None], (b, 1, 1)).astype(np.int32)
out['pf/tokens'], out['pf/img'], out['pf/ids'] = tokens, img, ids
for mode, pcfg in pcfgs.items():
    def f(p, t, m, e, pcfg=pcfg):
        return api.mod.prefill(p, t, None, cfg=cfg, pcfg=pcfg, positions=None,
                               mrope_positions=m, extra_embeds=e)[:2]
    lg, st = sm(f, (pspec, P(), P(), P()), (logit_spec, (kv, kv, P())))(
        params, tokens, ids, img)
    out[f'pf/{mode}/logits'] = np.asarray(lg)
    save(f'pf/{mode}/kv/', st)

# decode: 16 rows over a random cache, M-RoPE ids 40 below the positions
b, c = 16, 64
lengths = rng.randint(40, c - 1, size=b)
cache = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype)
                     if a.dtype != jnp.int32 else np.asarray(a),
                     api.init_cache(b, c))
pos = np.full(cache['pos'].shape, -1, np.int32)
for i, n in enumerate(lengths):
    pos[:, i, :n] = np.arange(n)
cache['pos'] = pos
save('dc/cache/', cache)
tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
positions = lengths[:, None].astype(np.int32)
ids = np.repeat((positions - 40)[:, None], 3, axis=1).astype(np.int32)
out['dc/tokens'], out['dc/positions'], out['dc/ids'] = tokens, positions, ids
for mode, pcfg in pcfgs.items():
    def g(p, t, cc, ps, m, pcfg=pcfg):
        return api.mod.decode_step(p, t, cc, cfg=cfg, pcfg=pcfg, positions=ps,
                                   mrope_positions=m)
    lg, st = sm(g, (pspec, P(), cspec, P(), P()), (logit_spec, cspec))(
        params, tokens, cache, positions, ids)
    out[f'dc/{mode}/logits'] = np.asarray(lg)
    save(f'dc/{mode}/cache/', st)
np.savez(path, **out)
print('PASS')
"""


@pytest.fixture(scope="module")
def vlm_tp2(tmp_path_factory):
    path = tmp_path_factory.mktemp("vlm_tp2") / "ref.npz"
    grid, n_text = PREFILL[True]
    code = _JAX_SIDE
    for key, val in (("NAME_", repr(NAME)), ("PATH_", repr(str(path))),
                     ("PCFG_", repr({k: v for k, v in PCFG.items()
                                     if k != "comm_mode"})),
                     ("GRID_", repr(grid)), ("NTEXT_", repr(n_text))):
        code = code.replace(key, val, 1)
    run_distributed(code, n_devices=2, timeout=600)
    return dict(np.load(path))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fused", "ring"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tp2_qwen2vl_matches(vlm_tp2, mode, phase):
    """tp=2 (one KV head a rank), the weave firing: the image prefill
    (2 x 48 tokens) and a 16-row decode with M-RoPE ids: logits within
    1e-4, KV within 1e-5."""
    ref = vlm_tp2
    api, params = tp2_port(ref, NAME, mode)
    b, s = ref["pf/ids"].shape[::2] if phase == "prefill" else (16, 1)
    assert TT.weave_decision_info(b, s, tp=2, pcfg=api.pcfg,
                                  decode=phase == "decode").weave
    with torch.no_grad():
        if phase == "prefill":
            logits, out = api.prefill(
                params, torch.from_numpy(ref["pf/tokens"]), None, None,
                mrope_positions=torch.from_numpy(ref["pf/ids"]),
                extra_embeds=torch.from_numpy(ref["pf/img"]))
            want = nest(ref, f"pf/{mode}/kv/")
            want = tuple(want[str(i)] for i in range(3))
        else:
            c = nest(ref, "dc/cache/")
            logits, out = api.decode_step(
                params, torch.from_numpy(ref["dc/tokens"]),
                port_cache(c["k"], c["v"], c["pos"], 2),
                torch.from_numpy(ref["dc/positions"]),
                mrope_positions=torch.from_numpy(ref["dc/ids"]))
            want = nest(ref, f"dc/{mode}/cache/")
    pre = ("pf/" if phase == "prefill" else "dc/") + f"{mode}/"
    close(local_logits(logits), ref[pre + "logits"], LOGIT_TOL)
    check_kv(out, want)
