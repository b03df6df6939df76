"""The port's ssm family (``layers/ssm.py``, ``models/mamba_model.py`` and
the engine's ssm branches) against the JAX reference, in float32 on the
CPU, on the same numpy-seeded inputs and weights (``from_jax_params``).

Layers within 1e-5: ``causal_conv1d`` with and without a carry-in,
``_ssm_scan_chunked`` with chunks that do and do not divide S, Mamba-1 and
Mamba-2 forward and decode, and the prefix-state handoff of the weave's
suffix split.  The reduced falcon-mamba-7b with every leaf perturbed by
0.05·N(0, 1): prefill, a second prefill chunk resuming the first's state
and decode (the batch split when the weave fires), weave on and off,
logits within 1e-4 and states within 1e-5 (of max(1, a leaf's largest
magnitude), ``close_state``).  The engine: the ssm case of
``tests/test_serving.py::test_engine_matches_full_context`` and seeded
``tests/test_differential.py`` traces (legacy slots, gamma 0, with
cancellations) through both packages' ``Engine``, tokens equal; the three
ssm refusals with the reference's messages; entry points that default to
CUDA.  tp=2: the reference on two host devices in one subprocess
(``conftest.run_distributed``), ``fused`` and ``ring``, logits and states.

The reference runs under ``shard_map`` (its layers psum over the
``model`` axis); the port runs ``use_pallas_norm=True`` (the K2/K1
wrappers, their plain versions on the CPU).  State layouts: the
reference's are global ((L, B, ..., d_inner or heads, ...), sharded
over ``model``), the port's stacked (L, R, B, ...) with the rank axis
second (``to_port`` / ``to_ref``).  The helpers here also serve
``tests/test_torch_hybrid.py``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import run_distributed
from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParallelConfig as JParallel
from repro.layers import ssm as JS
from repro.models import mamba_model as JMM
from repro.models import transformer as JT
from repro.models.build import build_model as j_build_model
from repro.runtime.engine import Engine as JEngine
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.configs import base as tbase
from repro_torch.layers import ssm as TS
from repro_torch.layers.embedding import sharded_argmax as t_argmax
from repro_torch.models import mamba_model as TMM
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.weights import from_jax_params
from test_torch_engine_paged import _drive, _gen_trace

LAYER_TOL, LOGIT_TOL, STATE_TOL = 1e-5, 1e-4, 1e-5
PCFG = dict(tokenweave=True, comm_mode="fused", remat=False, split_unit=16,
            tokenweave_min_tokens=32)
PREFILL = {True: 48, False: 8}       # chunk per row of 2: weave fires or not
DECODE = {True: 16, False: 4}        # batch rows
PERTURB = 0.05
# test_serving's small ssm model (vocab 128: test_differential's prompts)
SMALL = dict(name="t", family="ssm", num_layers=2, d_model=64, num_heads=0,
             num_kv_heads=0, d_ff=0, vocab_size=128, ssm_state=8,
             ssm_dt_rank=8, dtype="float32")
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16)
N_TRACES = 4
# the sharded axis of each state leaf in the reference's global layout
# (None: replicated), nested as the state
AXES = {"ssm": (3, 2), "hybrid": ((3, None), 2)}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def perturb(params, seed: int):
    """Every leaf plus PERTURB·N(0, 1), seeded with numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + PERTURB * rng.randn(
            *a.shape).astype(np.asarray(a).dtype)), params)


def tree_zip(fn, a, b):
    """fn over the leaves of two nested tuples of the same structure."""
    if isinstance(a, (tuple, list)):
        return tuple(tree_zip(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def to_port(state, family: str, tp: int):
    """The reference's global state (numpy, batch on dim 1) -> the port's
    stacked (L, R, B, ...) tensors (R = 1 for a replicated leaf), copied:
    the port writes its state in place, and a numpy view of a jax array
    is jax's own buffer."""
    def one(a, ax):
        a = np.asarray(a)
        if ax is None:
            return torch.from_numpy(np.array(a[:, None]))
        a = a.reshape(a.shape[:ax] + (tp, a.shape[ax] // tp)
                      + a.shape[ax + 1:])
        return torch.from_numpy(np.array(np.moveaxis(a, ax, 1)))
    return tree_zip(one, state, AXES[family])


def to_ref(state, family: str):
    """The port's stacked state -> the reference's global layout."""
    def one(t, ax):
        a = t.numpy()
        if ax is None:
            return a[:, 0]
        a = np.moveaxis(a, 1, ax)
        return a.reshape(a.shape[:ax] + (-1,) + a.shape[ax + 2:])
    return tree_zip(one, state, AXES[family])


def close_state(got, want, tol=STATE_TOL):
    """A state or KV leaf within ``tol`` of max(1, its largest magnitude)
    (and rtol ``tol``): the conv states are raw projections of the hidden
    rows, |x| up to ~5 in the reduced models, whose float32 GEMMs round
    apart by a few ulps per layer in the two packages."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def check_state(got, want, family: str):
    """The port's stacked state against the reference's (nested tuples)."""
    tree_zip(close_state, to_ref(got, family), want)


def local_logits(t):
    """(tp, B, S, V_loc) -> the reference's gathered (B, S, tp·V_loc)."""
    return np.concatenate(list(t.numpy()), axis=-1)


def torch_pcfg(**kw):
    return tbase.ParallelConfig(**{**PCFG, **kw}, attn_impl="pallas",
                                use_pallas_norm=True)


def model_pair(name: str, *, seed: int, **pcfg_kw):
    """The reduced registry config, the reference's perturbed weights and
    parallel config, the port's bridged weights, config and parallel
    config."""
    cfg = jconfigs.get_config(name).reduced()
    jpcfg = JParallel(**{**PCFG, **pcfg_kw})
    api = j_build_model(cfg, jpcfg, tp=1)
    jparams = perturb(api.init(jax.random.PRNGKey(seed)), seed + 1)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, api, jparams, jpcfg, tcfg, tparams, torch_pcfg(**pcfg_kw)


def shard_call(mesh, fn, *args, out_specs=P()):
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=tuple(P() for _ in args),
                                 out_specs=out_specs, check_vma=False))(*args)


def random_ssm_state(rng, cfg, batch: int):
    """Random decode state in the reference's global layout (numpy)."""
    shapes = JS.init_mamba1_state(batch, cfg, 1, cfg.num_layers)
    return tuple((0.5 * rng.randn(*s.shape)).astype(np.float32)
                 for s in shapes)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _layer_cfg(version: int):
    return JModelConfig(name="t", family="ssm", num_layers=1, d_model=32,
                        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=64,
                        ssm_state=8, ssm_dt_rank=8, ssm_expand=2,
                        ssm_version=version,
                        ssm_heads=4 if version == 2 else 0, dtype="float32")


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv1d_matches(state):
    rng = np.random.RandomState(1)
    x, w, b = (rng.randn(2, 13, 6), rng.randn(4, 6), rng.randn(6))
    st = rng.randn(2, 3, 6) if state else None
    want = JS.causal_conv1d(*(jnp.asarray(a, jnp.float32) for a in (x, w, b)),
                            state=None if st is None else jnp.asarray(
                                st, jnp.float32))
    f = [torch.from_numpy(a.astype(np.float32)) for a in (x, w, b)]
    got = TS.causal_conv1d(*f, state=None if st is None else
                           torch.from_numpy(st.astype(np.float32)))
    for g, w_ in zip(got, want):
        close(g, w_, LAYER_TOL)


@pytest.mark.parametrize("chunk", [8, 12, 64])
def test_ssm_scan_chunked_matches(chunk):
    """Chunks that divide S = 40 (8), do not (12), and exceed it (64)."""
    rng = np.random.RandomState(chunk)
    a = rng.uniform(0.5, 1.0, (2, 40, 3, 4)).astype(np.float32)
    b = rng.randn(2, 40, 3, 4).astype(np.float32)
    h0 = rng.randn(2, 3, 4).astype(np.float32)
    want = JS._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(h0), chunk)
    got = TS._ssm_scan_chunked(*(torch.from_numpy(t) for t in (a, b, h0)),
                               chunk)
    for g, w in zip(got, want):
        close(g, w, LAYER_TOL)


def _layer_pair(version: int, seed: int):
    cfg = _layer_cfg(version)
    init = JS.init_mamba1_params if version == 1 else JS.init_mamba2_params
    jp = perturb(init(jax.random.PRNGKey(seed), cfg, 1), seed)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    one = {"layers": {"layer_0": jax.tree.map(np.asarray, jp)}}
    tp = from_jax_params(one, dataclasses.replace(tcfg, num_layers=1),
                         device="cpu")["layers"][0]
    return cfg, jp, tcfg, tp


def _layer_state(version, st):
    """A reference layer state (batch first) -> the port's (rank axis
    first, size 1)."""
    if version == 1:
        return tuple(torch.from_numpy(np.asarray(a))[None] for a in st)
    (cx, cbc), h = st
    return ((torch.from_numpy(np.asarray(cx))[None],
             torch.from_numpy(np.asarray(cbc))[None]),
            torch.from_numpy(np.asarray(h))[None])


def _flat(st):
    return jax.tree.leaves(st) if not isinstance(st, torch.Tensor) else [st]


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_forward_and_decode_match(version, mesh11):
    """Forward over 24 tokens in chunks of 5 (the last one short), then 3
    decode steps from its state: outputs and states within 1e-5."""
    cfg, jp, tcfg, tp = _layer_pair(version, 5 + version)
    fwd = JS.mamba1_forward if version == 1 else JS.mamba2_forward
    dec = JS.mamba1_decode if version == 1 else JS.mamba2_decode
    tfwd = TS.mamba1_forward if version == 1 else TS.mamba2_forward
    tdec = TS.mamba1_decode if version == 1 else TS.mamba2_decode
    rng = np.random.RandomState(version)
    x = rng.randn(2, 24, 32).astype(np.float32)
    xs = rng.randn(3, 2, 1, 32).astype(np.float32)

    def f(x, xs):
        out, st = fwd(jp, x, cfg=cfg, chunk=5)
        outs = []
        for t in range(3):
            o, st = dec(jp, xs[t], st, cfg=cfg)
            outs.append(o)
        return out, jnp.stack(outs), st
    j_out, j_dec, j_st = shard_call(mesh11, f, jnp.asarray(x),
                                    jnp.asarray(xs))
    with torch.no_grad():
        t_out, st = tfwd(tp, torch.from_numpy(x)[None], cfg=tcfg, chunk=5)
        t_dec = []
        for t in range(3):
            o, st = tdec(tp, torch.from_numpy(xs[t])[None], st, cfg=tcfg)
            t_dec.append(o[0])
    close(t_out[0], j_out, LAYER_TOL)
    close(torch.stack(t_dec), j_dec, LAYER_TOL)
    for g, w in zip(_flat(st), jax.tree.leaves(j_st)):
        close(g[0], w, LAYER_TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_prefix_state_handoff_matches(version, mesh11):
    """The weave's suffix split resuming from the prefix's final state
    (as tests/test_layers.py's handoff test): the split forward equals
    the unsplit one in the port, and the reference's split forward."""
    cfg, jp, tcfg, tp = _layer_pair(version, 11 + version)
    fwd = JS.mamba1_forward if version == 1 else JS.mamba2_forward
    tfwd = TS.mamba1_forward if version == 1 else TS.mamba2_forward
    x = np.random.RandomState(4).randn(2, 32, 32).astype(np.float32)

    def f(x):
        o0, st0 = fwd(jp, x[:, :20], cfg=cfg, chunk=8)
        o1, st1 = fwd(jp, x[:, 20:], cfg=cfg, init_state=st0, chunk=8)
        return jnp.concatenate([o0, o1], axis=1), st1
    j_out, j_st = shard_call(mesh11, f, jnp.asarray(x))
    xt = torch.from_numpy(x)[None]
    with torch.no_grad():
        full, st_full = tfwd(tp, xt, cfg=tcfg, chunk=8)
        o0, st0 = tfwd(tp, xt[:, :, :20], cfg=tcfg, chunk=8)
        o1, st1 = tfwd(tp, xt[:, :, 20:], cfg=tcfg, init_state=st0, chunk=8)
    split = torch.cat([o0, o1], dim=2)
    close(split, full, LAYER_TOL)
    close(split[0], j_out, LAYER_TOL)
    for g, f_, w in zip(_flat(st1), _flat(st_full), jax.tree.leaves(j_st)):
        close(g, f_, LAYER_TOL)
        close(g[0], w, LAYER_TOL)


# --------------------------------------------------------------------------
# the reduced falcon-mamba-7b
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_pair():
    return model_pair("falcon-mamba-7b", seed=3)


def _ssm_prefill(mesh, pair, tokens, state, last=None):
    """Both packages' prefill from the same state (reference layout):
    ((reference logits, state), (port logits, state))."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = pair

    def f(p, t, c, li):
        return JMM.prefill(p, t, c, cfg=cfg, pcfg=jpcfg, last_idx=li)[:2]
    b = tokens.shape[0]
    li = np.full(b, tokens.shape[1] - 1, np.int32) if last is None else last
    want = shard_call(mesh, f, jp, jnp.asarray(tokens), state,
                      jnp.asarray(li), out_specs=(P(), P()))
    with torch.no_grad():
        got = TMM.prefill(tparams, torch.from_numpy(tokens).long(),
                          to_port(state, "ssm", 1), cfg=tcfg, pcfg=tpcfg,
                          last_idx=torch.from_numpy(li))
    return want, got


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_falcon_mamba_prefill_chunks_match(weave, ssm_pair, mesh11):
    """Two prefill chunks per row through the state cache (the second
    resumes the first's state), the weave's sequence split firing or
    not; logits at a row's last token within 1e-4, states within 1e-5."""
    cfg, api, _, jpcfg = ssm_pair[:4]
    rng = np.random.RandomState(20 + weave)
    chunk = PREFILL[weave]
    assert JT.weave_decision_info(2, chunk, tp=1, pcfg=jpcfg).weave == weave
    state = jax.tree.map(np.asarray, api.init_cache(2, 1))
    for step in range(2):
        tokens = rng.randint(0, cfg.vocab_size, (2, chunk)).astype(np.int32)
        last = np.array([chunk - 1, chunk - 3], np.int32)
        (j_logits, j_state), (t_logits, t_state) = _ssm_prefill(
            mesh11, ssm_pair, tokens, state, last)
        close(local_logits(t_logits), j_logits, LOGIT_TOL)
        check_state(t_state, j_state, "ssm")
        state = jax.tree.map(np.asarray, j_state)


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_falcon_mamba_decode_matches(weave, ssm_pair, mesh11):
    """One decode step over random states, the batch split firing (16
    rows) or not (4); logits and states."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = ssm_pair
    rng = np.random.RandomState(30 + weave)
    b = DECODE[weave]
    assert JT.weave_decision_info(b, 1, tp=1, pcfg=jpcfg,
                                  decode=True).weave == weave
    state = random_ssm_state(rng, cfg, b)
    tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)

    def f(p, t, c):
        return JMM.decode_step(p, t, c, cfg=cfg, pcfg=jpcfg)
    j_logits, j_state = shard_call(mesh11, f, jp, jnp.asarray(tokens), state,
                                   out_specs=(P(), P()))
    with torch.no_grad():
        t_logits, t_state = TMM.decode_step(
            tparams, torch.from_numpy(tokens).long(),
            to_port(state, "ssm", 1), cfg=tcfg, pcfg=tpcfg)
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_state(t_state, j_state, "ssm")


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_ssm():
    """test_serving's small float32 ssm model in both packages:
    (reference api, params, port api, params)."""
    cfg = JModelConfig(**SMALL)
    jpcfg = JParallel(**PCFG)
    api = j_build_model(cfg, jpcfg, tp=1)
    params = api.init(jax.random.PRNGKey(0))
    tcfg = tbase.ModelConfig(**SMALL)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return api, params, t_build_model(tcfg, torch_pcfg()), tparams


def _port_full_greedy(tapi, tparams, prompt, n_new):
    """Greedy tokens from full-context forwards (no cache, no engine)."""
    toks = list(prompt)
    for _ in range(n_new):
        with torch.no_grad():
            h, _ = TMM.forward(tparams, torch.tensor([toks]), cfg=tapi.cfg,
                               pcfg=tapi.pcfg)
            lg = TMM.lm_logits_at(tparams, h)
        toks.append(int(t_argmax(lg, vocab_size=tapi.cfg.vocab_size)[0, 0]))
    return toks[len(prompt):]


def test_engine_matches_full_context_ssm(small_ssm, mesh11):
    """test_serving's ssm case through both engines: the port's tokens
    equal the reference engine's and the port's full-context greedy."""
    api, params, tapi, tparams = small_ssm
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, 128, size=n)) for n in (23, 57, 40)]
    scfg = dict(max_batch=4, chunk_tokens=32, max_len=128, prefill_bucket=16)
    jeng = JEngine(api, mesh11, params, JSched(**scfg))
    teng = TEngine(tapi, tparams, tsched.SchedulerConfig(**scfg),
                   device="cpu")
    for eng, req in ((jeng, JRequest), (teng, TRequest)):
        for i, p in enumerate(prompts):
            eng.add_request(req(rid=i, prompt=[int(t) for t in p],
                                max_new_tokens=6))
    want = {r.rid: r.output for r in jeng.run()}
    got = {r.rid: r.output for r in teng.run()}
    assert got == want
    for i, p in enumerate(prompts):
        assert got[i] == _port_full_greedy(tapi, tparams, p, 6)
    assert teng.stats.forwards == jeng.stats.forwards
    assert teng.stats.weave_forwards == jeng.stats.weave_forwards


@pytest.fixture(scope="module")
def jit_cache():
    return {}


@pytest.mark.parametrize("trial", range(N_TRACES))
def test_differential_traces_ssm(trial, small_ssm, mesh11, jit_cache):
    """Seeded traces of tests/test_differential.py's generator (gamma
    forced to 0) over legacy slots, cancellations included: tokens,
    forwards and weave forwards equal."""
    api, params, tapi, tparams = small_ssm
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1000
                                                                 + trial))
    jeng = JEngine(api, mesh11, params, JSched(**SCHED),
                   jit_cache=jit_cache)
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    teng = TEngine(tapi, tparams, tsched.SchedulerConfig(**SCHED),
                   device="cpu")
    got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
    assert got == want
    assert (teng.stats.forwards, teng.stats.weave_forwards) == \
        (jeng.stats.forwards, jeng.stats.weave_forwards)


@pytest.mark.parametrize("mode", ["packed", "spec", "paged"])
def test_engine_refuses_ssm_modes_as_reference(mode, small_ssm, mesh11):
    """Packed, speculative and paged runs are refused with the
    reference's messages: ssm state has no token axis."""
    api, params, tapi, tparams = small_ssm
    kw = {"packed": dict(packed=True), "spec": dict(spec_gamma=2),
          "paged": dict(paged=True)}[mode]
    with pytest.raises(ValueError) as jerr:
        JEngine(api, mesh11, params, JSched(**SCHED, **kw))
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        TEngine(tapi, tparams, tsched.SchedulerConfig(**SCHED, **kw),
                device="cpu")


@pytest.mark.parametrize("entry", ["engine", "init", "init_cache",
                                   "from_jax_params"])
def test_ssm_entry_points_default_to_cuda(entry, small_ssm, monkeypatch):
    """With no device, the engine, params, state caches and bridged
    weights go to CUDA, and raise where there is none."""
    api, params, tapi, tparams = small_ssm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"engine": lambda: TEngine(tapi, tparams,
                                       tsched.SchedulerConfig(**SCHED)),
             "init": lambda: tapi.init(0),
             "init_cache": lambda: tapi.init_cache(2, 16),
             "from_jax_params": lambda: from_jax_params(
                 jax.tree.map(np.asarray, params), tapi.cfg)}
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

family, name, path, PCFG = FAMILY_, NAME_, PATH_, PCFG_
tp = 2
mesh = jax.make_mesh((1, tp), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = configs.get_config(name).reduced()
rng = np.random.RandomState(200)
out = {}
pcfgs = {m: ParallelConfig(comm_mode=m, use_pallas_norm=False, **PCFG)
         for m in ('fused', 'ring')}
api = build_model(cfg, pcfgs['ring'], tp=tp)
params = jax.tree.map(
    lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
        np.asarray(a).dtype)), api.init(jax.random.PRNGKey(5)))
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


# prefill: 2 rows of 48 tokens from an empty cache, the weave splitting
tokens = rng.randint(0, cfg.vocab_size, (2, 48)).astype(np.int32)
out['pf/tokens'] = tokens
pf_spec = (cspec if family == 'ssm' else
           {'mamba': cspec['mamba'], 'shared': (kv, kv, P())})
for mode, pcfg in pcfgs.items():
    def f(p, t, c, pcfg=pcfg):
        return api.mod.prefill(p, t, c, cfg=cfg, pcfg=pcfg)[:2]
    lg, st = sm(f, (pspec, P(), cspec), (logit_spec, pf_spec))(
        params, tokens, api.init_cache(2, 64))
    out[f'pf/{mode}/logits'] = np.asarray(lg)
    save(f'pf/{mode}/state/', st)

# decode: 16 rows from random state (and shared KV), the batch splitting
b, c = 16, 32
cache = jax.tree.map(lambda a: (0.5 * rng.randn(*a.shape)).astype(a.dtype)
                     if a.dtype != jnp.int32 else np.asarray(a),
                     api.init_cache(b, c))
lengths = rng.randint(1, c, size=b)
if family == 'hybrid':
    pos = np.full(cache['shared']['pos'].shape, -1, np.int32)
    for i, n in enumerate(lengths):
        pos[:, i, :n] = np.arange(n)
    cache['shared']['pos'] = pos
save('dc/cache/', cache)
tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
positions = lengths[:, None].astype(np.int32)
out['dc/tokens'], out['dc/positions'] = tokens, positions
for mode, pcfg in pcfgs.items():
    def g(p, t, c, ps, pcfg=pcfg):
        return api.mod.decode_step(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps)
    lg, st = sm(g, (pspec, P(), cspec, P()), (logit_spec, cspec))(
        params, tokens, cache, positions)
    out[f'dc/{mode}/logits'] = np.asarray(lg)
    save(f'dc/{mode}/state/', st)
np.savez(path, **out)
print('PASS')
"""


def nest(flat, prefix):
    """'prefix/a/b' keys -> nested dict of numpy arrays (integer keys of
    tuples stay strings)."""
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


def as_tuple(tree):
    """A nested dict with keys '0', '1', .. -> nested tuples."""
    if isinstance(tree, dict) and tree and all(k.isdigit() for k in tree):
        return tuple(as_tuple(tree[str(i)]) for i in range(len(tree)))
    if isinstance(tree, dict):
        return {k: as_tuple(v) for k, v in tree.items()}
    return tree


def tp2_reference(tmp_path_factory, family: str, name: str):
    """The reference's tp=2 weights, inputs and outputs (an npz written
    by a subprocess on two host devices)."""
    path = tmp_path_factory.mktemp(f"{family}_tp2") / "ref.npz"
    code = _JAX_SIDE
    for key, val in (("FAMILY_", repr(family)), ("NAME_", repr(name)),
                     ("PATH_", repr(str(path))),
                     ("PCFG_", repr({k: v for k, v in PCFG.items()
                                     if k != "comm_mode"}))):
        code = code.replace(key, val, 1)
    run_distributed(code, n_devices=2, timeout=600)
    return dict(np.load(path))


def tp2_port(ref, name: str, mode: str):
    """The port's model at tp=2 on the reference's weights."""
    cfg = tbase.ModelConfig(**dataclasses.asdict(
        jconfigs.get_config(name).reduced()))
    pcfg = torch_pcfg(comm_mode=mode)
    params = from_jax_params(nest(ref, "params/"), cfg, device="cpu")
    return t_build_model(cfg, pcfg, tp=2), params


@pytest.fixture(scope="module")
def ssm_tp2(tmp_path_factory):
    return tp2_reference(tmp_path_factory, "ssm", "falcon-mamba-7b")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fused", "ring"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tp2_falcon_mamba_matches(ssm_tp2, mode, phase):
    """tp=2, the weave firing (2x48 prefill, 16-row decode): logits
    within 1e-4, states within 1e-5."""
    ref = ssm_tp2
    api, params = tp2_port(ref, "falcon-mamba-7b", mode)
    b, s = ref["pf/tokens"].shape if phase == "prefill" else (16, 1)
    assert TT.weave_decision_info(b, s, tp=2, pcfg=api.pcfg,
                                  decode=phase == "decode").weave
    with torch.no_grad():
        if phase == "prefill":
            logits, st = api.prefill(
                params, torch.from_numpy(ref["pf/tokens"]).long(),
                api.init_cache(2, 64, device="cpu"), None)
            pre = f"pf/{mode}/"
        else:
            cache = to_port(as_tuple(nest(ref, "dc/cache/")), "ssm", 2)
            logits, st = api.decode_step(
                params, torch.from_numpy(ref["dc/tokens"]).long(), cache,
                torch.from_numpy(ref["dc/positions"]))
            pre = f"dc/{mode}/"
    close(local_logits(logits), ref[pre + "logits"], LOGIT_TOL)
    check_state(st, as_tuple(nest(ref, pre + "state/")), "ssm")
