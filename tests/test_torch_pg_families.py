"""The MoE (``expert``, ``ffn``), ssm, hybrid, encdec and vlm families on
the port's ``process_group`` backend (one model rank per process,
``launch.mesh.init_groups``) in CPU processes over gloo, held to the
rank axis at tp=2 on the same weights and inputs and, for prefill, to
the JAX reference at tp=2.

One world of 2 processes (mesh data 1 x model 2, a ``file://`` store) is
spawned once for the module.  Every rank builds each reduced model
(float32) on the weights the port draws at tp=2, each leaf perturbed by
0.05·N(0, 1) from numpy (so the LoRA B, the biases and the norms are not
their constants), keeps its rank's slice (``weights.take_rank``), and in
comm modes ``fused`` and ``ring`` (K1's cross-rank wrapper, its plain
version over the group on the CPU) runs a prefill (2 rows, the weave
splitting) and a decode step (16 rows over a random cache, the batch
splitting), and for OLMoE and Falcon-Mamba an engine trace; it writes
its logits, caches and tokens to an ``.npz``.  The tests compute the rank
axis here and compare each rank with its slice: logits within 1e-5,
caches within 1e-5 of max(1, the leaf's largest magnitude), tokens
equal.  Meanwhile one subprocess (``conftest.run_distributed``) runs the
reference's tp=2 prefill and decode step of the six models on the same
weights (``weights.to_jax_layout``) and the same decode cache (moved to
the reference's layout, ``_ref_cache``), held to each rank's logits in
both modes within 1e-4.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_distributed

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.distributed.context import Groups
from repro_torch.launch.mesh import init_groups, make_mesh
from repro_torch.layers import moe as TM
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.weights import from_jax_params, take_rank, to_jax_layout

TP = 2
TOL, TOL_REF = 1e-5, 1e-4
MODELS = ("mixtral-8x22b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b",
          "whisper-base", "qwen2-vl-7b")
ENGINE_MODELS = ("olmoe-1b-7b", "falcon-mamba-7b")
SPEC_MODELS = ("olmoe-1b-7b",)    # engine traces with speculative decoding
VERIFY_MODELS = ("mixtral-8x22b", "qwen2-vl-7b")   # verify_step logits
GAMMA = 3
MODES = ("fused", "ring")
PCFG = dict(tokenweave=True, remat=False, split_unit=16,
            tokenweave_min_tokens=32)
PREFILL_B, PREFILL_S = 2, 48      # the weave splits the sequence
DECODE_B, CACHE_LEN = 16, 64      # the weave splits the batch
ENC_LEN = 24                      # whisper's frames per row
GRID = 4                          # qwen2-vl: a 4 x 4 patch image
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16)
SEED = 5


def _cfg(name):
    return get_config(name).reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    """The rank axis's side runs here in many tiny ops: one intra-op
    thread, as the spawned ranks run, keeps them from spinning against
    the other test workers' threads on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg(mode):
    return tbase.ParallelConfig(comm_mode=mode, attn_impl="pallas",
                                use_pallas_norm=True, **PCFG)


def _fake_groups(rank=0):
    return Groups(model=None, data=None, model_rank=rank, data_rank=0,
                  model_size=TP, data_size=1)


# --------------------------------------------------------------------------
# trees, weights and inputs, made from seeds on every side
# --------------------------------------------------------------------------

def _leaves(tree, path=""):
    """(path, tensor) of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}{i}/")
    else:
        yield path[:-1], tree


def _map(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, f"{path}{i}/") for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path[:-1], tree)


def _params(name):
    """The reduced model's weights at tp=2, drawn by the port, every leaf
    plus 0.05·N(0, 1) (numpy, in the tree's order)."""
    cfg = _cfg(name)
    full = build_model(cfg, _pcfg("fused"), tp=TP).init(SEED, device="cpu")
    rng = np.random.RandomState(SEED)
    return _map(lambda p, t: t + torch.from_numpy(
        0.05 * rng.randn(*t.shape)).to(t.dtype), full)


def _rank_cut(full, local_like, rank):
    """Rank ``rank``'s slice of a rank-axis tree: each leaf cut on the
    axis where the tree of one process (``local_like``) holds 1 of 2."""
    def cut(path, t):
        like = dict(_leaves(local_like))[path]
        diff = [a for a, (m, n) in enumerate(zip(t.shape, like.shape))
                if m != n]
        if not diff:
            return t
        assert len(diff) == 1 and like.shape[diff[0]] == 1, (path, t.shape)
        return t.narrow(diff[0], rank, 1).contiguous()
    return _map(cut, full)


def _prefill_inputs(cfg):
    """(tokens (B, S), keywords of ``ModelApi.prefill``), seeded."""
    rng = np.random.RandomState(11)
    b, s = PREFILL_B, PREFILL_S
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.from_numpy(
            rng.randn(b, ENC_LEN, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        n_img = GRID * GRID
        s -= n_img
        kw["extra_embeds"] = torch.from_numpy(
            (0.02 * rng.randn(b, n_img, cfg.d_model)).astype(np.float32))
        i, j = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
        ids = np.concatenate([np.stack([0 * i.ravel(), i.ravel(), j.ravel()]),
                              np.tile(GRID + np.arange(s), (3, 1))], axis=1)
        kw["mrope_positions"] = torch.from_numpy(
            np.tile(ids[None], (b, 1, 1)).astype(np.int32))
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
    return tokens, kw


def _empty_cache(api, b, device="cpu"):
    """What ``ModelApi.prefill`` takes as the cache of a first chunk."""
    if api.cfg.family in ("encdec", "vlm"):
        return None
    return api.init_cache(b, CACHE_LEN, device=device)


def _decode_inputs(api):
    """A random cache at tp=2 on the rank axis (k/v and states 0.5·N(0,
    1), row i holding ``lengths[i]`` positions; whisper's cross caches
    every encoder position), one step's tokens, positions and keywords."""
    cfg = api.cfg
    rng = np.random.RandomState(12)
    b = DECODE_B
    lengths = rng.randint(41, CACHE_LEN - 1, size=b)
    kw = {} if cfg.family != "encdec" else {"enc_len": ENC_LEN}
    cache = api.init_cache(b, CACHE_LEN, device="cpu", **kw)

    def fill(path, t):
        if t.dtype.is_floating_point:
            return torch.from_numpy(
                (0.5 * rng.randn(*t.shape)).astype(np.float32))
        pos = np.full(t.shape, -1, np.int32)
        for i in range(b):
            n = t.shape[1] if path.startswith("cross") else lengths[i]
            pos[i, :n] = np.arange(n)
        return torch.from_numpy(pos)
    cache = _map(fill, cache)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, 1)))
    positions = torch.from_numpy(lengths[:, None].astype(np.int32))
    step = {}
    if cfg.family == "vlm":                       # M-RoPE ids 40 below
        step["mrope_positions"] = (positions - 40)[:, None].repeat(1, 3, 1)
    return cache, tokens, positions, step


# the model axis of each recurrent state leaf in the reference's (L, B,
# ...) layout (None: replicated), as its cache_specs give it
_STATE_AXES = {"ssm": (3, 2), "hybrid": ((3, None), 2)}


def _ref_cache(cache, family):
    """The rank axis's decode cache at tp=2 -> the reference's global
    layout, as numpy leaves by the reference's path ('a.0.k'): per-layer
    KV dicts stacked on a layer axis with the ranks' heads joined (global
    head rank·h + j), a state's rank axis (axis 1) merged into its model
    axis."""
    def kv(layers):
        def heads(t):
            a = np.moveaxis(t.numpy(), 0, 2)
            return a.reshape(a.shape[:2] + (-1,) + a.shape[4:])
        return {"k": np.stack([heads(lc["k"]) for lc in layers]),
                "v": np.stack([heads(lc["v"]) for lc in layers]),
                "pos": np.stack([lc["pos"].numpy() for lc in layers])}

    def state(t, ax):
        if isinstance(t, (tuple, list)):
            return tuple(state(x, a) for x, a in zip(t, ax))
        a = t.numpy()
        if ax is None:
            return a[:, 0]
        a = np.moveaxis(a, 1, ax)
        return a.reshape(a.shape[:ax] + (-1,) + a.shape[ax + 2:])
    if family == "ssm":
        ref = state(cache, _STATE_AXES["ssm"])
    elif family == "hybrid":
        ref = {"mamba": state(cache["mamba"], _STATE_AXES["hybrid"]),
               "shared": kv(cache["shared"])}
    elif family == "encdec":
        ref = {k: kv(cache[k]) for k in ("self", "cross")}
    else:
        ref = kv(cache)
    return {path.replace("/", "."): a for path, a in _leaves(ref)}


def _flat_out(prefix, tree, out):
    for path, t in _leaves(tree):
        out[f"{prefix}/{path}"] = t.numpy()


def _run_model(api, params, cache_cut=None, between=None):
    """(prefill logits, prefill caches, decode logits, decode cache) of one
    model: ``cache_cut`` cuts the rank axis's random decode cache to this
    process's rank; ``between()`` runs after the prefill."""
    tokens, kw = _prefill_inputs(api.cfg)
    with torch.no_grad():
        pf, pf_cache = api.prefill(params, tokens,
                                   _empty_cache(api, PREFILL_B), None, **kw)
        if between is not None:
            between()
        full = build_model(api.cfg, api.pcfg, tp=TP)
        cache, tok, pos, step = _decode_inputs(full)
        if cache_cut is not None:
            cache = cache_cut(cache)
        dc, dc_cache = api.decode_step(params, tok, cache, pos, **step)
    return pf, pf_cache, dc, dc_cache


def _prompts(cfg, seed):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, cfg.vocab_size, n).tolist() for n in (21, 7, 34)],
            [4, 6, 3])


def _serve(api, params, prompts, outs, **sched):
    """Serve ``prompts`` with ``sched`` over SCHED: (tokens, the
    ``spec/*`` counters)."""
    eng = Engine(api, params, SchedulerConfig(**dict(SCHED, **sched)),
                 device="cpu")
    for i, (p, n) in enumerate(zip(prompts, outs)):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
    got = {r.rid: r.output for r in eng.run()}
    sp = eng.stats.spec
    return ([got[i] for i in range(len(prompts))],
            [sp.verify_steps, sp.draft_proposed, sp.draft_accepted,
             sp.emitted])


def _lookup_prompts(cfg, seed):
    """Prompts repeating one seeded 6-token block, and new tokens."""
    block = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                6).tolist()
    return [(block * 8)[:n] for n in (29, 13, 40)], [8, 10, 7]


def _verify(api, params, cache_cut=None):
    """One ``verify_step`` of DECODE_B windows of GAMMA + 1 tokens over
    the random decode cache, each window rewriting its row's last GAMMA
    + 1 cells (row 1 with a one-token draft, the rest padding): the
    logits."""
    full = build_model(api.cfg, api.pcfg, tp=TP)
    cache, _, pos, step = _decode_inputs(full)
    if cache_cut is not None:
        cache = cache_cut(cache)
    rng = np.random.RandomState(13)
    tokens = torch.from_numpy(rng.randint(0, api.cfg.vocab_size,
                                          (DECODE_B, GAMMA + 1)))
    positions = pos - GAMMA - 1 + torch.arange(GAMMA + 1, dtype=torch.int32)
    positions[1, 2:] = -1
    kw = {}
    if "mrope_positions" in step:                 # M-RoPE ids 40 below
        kw["mrope_positions"] = (positions - 40)[:, None].repeat(1, 3, 1)
    with torch.no_grad():
        logits, _ = api.verify_step(params, tokens, cache, positions, **kw)
    return logits


# --------------------------------------------------------------------------
# the world: every rank runs every model
# --------------------------------------------------------------------------

def _worker(rank, tmp):
    from repro_torch.kernels import ar_rmsnorm_peer as K1P

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    groups = init_groups(make_mesh((1, TP), ("data", "model")),
                         backend="gloo", init_method=f"file://{tmp}/store",
                         rank=rank, world_size=TP)
    out = {"backend": np.asarray(dist.get_backend())}
    real, calls = K1P.ar_rmsnorm_peer, []

    def counted(x, *args, **kw):              # comm_norm's ring slots
        calls.append(x.shape[1])
        return real(x, *args, **kw)
    K1P.ar_rmsnorm_peer = counted
    try:
        for name in MODELS:
            cfg = _cfg(name)
            params = take_rank(_params(name), rank, cfg)
            for mode in MODES:
                api = build_model(cfg, _pcfg(mode), tp=TP, groups=groups)
                like = api.init_cache(DECODE_B, CACHE_LEN, device="cpu",
                                      **({"enc_len": ENC_LEN}
                                         if cfg.family == "encdec" else {}))
                calls.clear()
                n_pf = []
                pf, pf_cache, dc, dc_cache = _run_model(
                    api, params, lambda c: _rank_cut(c, like, rank),
                    between=lambda: n_pf.append(len(calls)))
                key = f"{name}/{mode}"
                out[f"{key}/k1p"] = np.asarray([n_pf[0],
                                                len(calls) - n_pf[0]])
                out[f"{key}/pf/logits"] = pf.numpy()
                out[f"{key}/dc/logits"] = dc.numpy()
                _flat_out(f"{key}/pf/cache", pf_cache, out)
                _flat_out(f"{key}/dc/cache", dc_cache, out)
                if name in ENGINE_MODELS:
                    out[f"{key}/engine"] = np.asarray(json.dumps(
                        _serve(api, params, *_prompts(cfg, 3))[0]))
                if name in SPEC_MODELS:
                    out[f"{key}/engine_spec"] = np.asarray(json.dumps(
                        _serve(api, params, *_lookup_prompts(cfg, 4),
                               spec_gamma=GAMMA)))
                if name in VERIFY_MODELS:
                    out[f"{key}/verify"] = _verify(
                        api, params, lambda c: _rank_cut(c, like, rank)
                    ).numpy()
    finally:
        K1P.ar_rmsnorm_peer = real
        dist.destroy_process_group()
    np.savez(f"{tmp}/r{rank}.npz", **out)


# --------------------------------------------------------------------------
# the reference at tp=2, in a subprocess
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.configs.base import ParallelConfig
from repro.models.build import build_model

MODELS, PCFG, PATH, OUT = MODELS_, PCFG_, PATH_, OUT_
mesh = jax.make_mesh((1, 2), ('data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
flat = dict(np.load(PATH))
out = {}
for name in MODELS:
    cfg = configs.get_config(name).reduced()
    pcfg = ParallelConfig(comm_mode='fused', use_pallas_norm=False, **PCFG)
    api = build_model(cfg, pcfg, tp=2)
    params, inp = {}, {}
    for key, a in flat.items():
        head, *path, leaf = key.split('/')
        if head != name:
            continue
        if leaf.startswith('@'):
            inp[leaf[1:]] = a
            continue
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    tokens = inp['tokens']
    if cfg.family == 'encdec':
        def f(p, t, x):
            return api.mod.prefill(p, {'frames': x, 'tokens': t}, None,
                                   cfg=cfg, pcfg=pcfg)[0]
        args, specs = (tokens, inp['frames']), (P(), P())
    elif cfg.family == 'vlm':
        def f(p, t, m, e):
            return api.mod.prefill(p, t, None, cfg=cfg, pcfg=pcfg,
                                   positions=None, mrope_positions=m,
                                   extra_embeds=e)[0]
        args = (tokens, inp['mrope_positions'], inp['extra_embeds'])
        specs = (P(), P(), P())
    elif cfg.family == 'moe':
        def f(p, t):
            return api.mod.prefill(p, t, None, cfg=cfg, pcfg=pcfg,
                                   positions=None)[0]
        args, specs = (tokens,), (P(),)
    else:
        def f(p, t, c):
            return api.mod.prefill(p, t, c, cfg=cfg, pcfg=pcfg)[0]
        args = (tokens, api.init_cache(tokens.shape[0], 64))
        specs = (P(), api.cache_specs())
    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(api.specs(),) + specs,
                              out_specs=P(None, None, 'model'),
                              check_vma=False))
    out[name + '/pf'] = np.asarray(g(params, *args))
    # one decode step on the port's random cache, in the reference's layout
    kw = {'enc_len': inp['frames'].shape[1]} if cfg.family == 'encdec' else {}
    cache = jax.tree_util.tree_map_with_path(
        lambda pth, a: jnp.asarray(inp['cache:' + '.'.join(
            str(getattr(q, 'key', getattr(q, 'idx', q))) for q in pth)]),
        api.init_cache(1, 1, **kw))
    vlm = cfg.family == 'vlm'

    def d(p, t, c, ps, *m):
        return api.mod.decode_step(p, t, c, cfg=cfg, pcfg=pcfg, positions=ps,
                                   **({'mrope_positions': m[0]} if m else {}))[0]
    args = (inp['dc_tokens'], cache, inp['dc_positions'])
    args += (inp['dc_mrope'],) if vlm else ()
    specs = (P(), api.cache_specs(), P()) + ((P(),) if vlm else ())
    g = jax.jit(jax.shard_map(d, mesh=mesh, in_specs=(api.specs(),) + specs,
                              out_specs=P(None, None, 'model'),
                              check_vma=False))
    out[name + '/dc'] = np.asarray(g(params, *args))
np.savez(OUT, **out)
print('PASS')
"""


def _reference_inputs(npz):
    """Every model's tp=2 weights in the reference's layout, its prefill
    inputs and its decode step's (the cache in the reference's layout), in
    one npz ('<name>/<leaf path>', '<name>/@<input>', '<name>/@cache:<leaf
    path>')."""
    flat = {}
    for name in MODELS:
        cfg = _cfg(name)
        ref = to_jax_layout(_params(name), cfg, _pcfg("fused"))
        for path, t in _leaves(ref):
            flat[f"{name}/{path}"] = t.numpy()
        tokens, kw = _prefill_inputs(cfg)
        flat[f"{name}/@tokens"] = tokens.numpy().astype(np.int32)
        for k, v in kw.items():
            flat[f"{name}/@{k}"] = v.numpy()
        cache, tok, pos, step = _decode_inputs(
            build_model(cfg, _pcfg("fused"), tp=TP))
        for path, a in _ref_cache(cache, cfg.family).items():
            flat[f"{name}/@cache:{path}"] = a
        flat[f"{name}/@dc_tokens"] = tok.numpy().astype(np.int32)
        flat[f"{name}/@dc_positions"] = pos.numpy()
        if "mrope_positions" in step:
            flat[f"{name}/@dc_mrope"] = step["mrope_positions"].numpy()
    np.savez(npz, **flat)


def _reference_code(params_path, out_path):
    code = _JAX_SIDE
    for key, val in (("MODELS_", repr(MODELS)), ("PCFG_", repr(PCFG)),
                     ("PATH_", repr(str(params_path))),
                     ("OUT_", repr(str(out_path)))):
        code = code.replace(key, val, 1)
    return code


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world (and run the reference subprocess meanwhile) once;
    -> {"ranks": [rank 0's results, rank 1's], "ref": the reference's
    logits by '<model>/pf' and '<model>/dc'}."""
    tmp = tmp_path_factory.mktemp("pg_families")
    _reference_inputs(tmp / "ref_in.npz")
    ref_error = []

    def reference():
        try:
            run_distributed(_reference_code(tmp / "ref_in.npz",
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
        ctx = mp.spawn(_worker, args=(str(tmp),), nprocs=TP, join=False)
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    try:
        while not ctx.join():
            pass
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    finally:
        ref.join()
    if ref_error:
        raise ref_error[0]
    return {"ranks": [dict(np.load(tmp / f"r{w}.npz")) for w in range(TP)],
            "ref": dict(np.load(tmp / "ref.npz"))}


# --------------------------------------------------------------------------
# against the rank axis
# --------------------------------------------------------------------------

def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_state(got, want, tol=TOL):
    """Within ``tol`` of max(1, the leaf's largest magnitude)."""
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


_AXIS = {}


def _axis_results(name, mode):
    """The rank axis at tp=2 on the same weights and inputs (memoized)."""
    if (name, mode) not in _AXIS:
        cfg = _cfg(name)
        api = build_model(cfg, _pcfg(mode), tp=TP)
        _AXIS[(name, mode)] = _run_model(api, _params(name))
    return _AXIS[(name, mode)]


@pytest.mark.parametrize("phase", ["pf", "dc"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_family_matches_rank_axis(world, name, mode, phase):
    """Prefill (2 x 48, the weave splitting the sequence) and one decode
    step (16 rows, the batch splitting): each rank's local logits and
    caches are its slice of the rank axis's at tp=2 (a leaf whose rank
    axis the process holds one entry of is cut there; a replicated one,
    the same shape on both sides, is held whole)."""
    pf, pf_cache, dc, dc_cache = _axis_results(name, mode)
    logits, cache = (pf, pf_cache) if phase == "pf" else (dc, dc_cache)
    key = f"{name}/{mode}/{phase}"
    leaves = dict(_leaves(cache))
    for r, got in enumerate(world["ranks"]):
        _close(got[f"{key}/logits"], logits[r:r + 1].numpy())
        assert {k for k in got if k.startswith(f"{key}/cache/")} == {
            f"{key}/cache/{p}" for p in leaves}
        for path, t in leaves.items():
            g = got[f"{key}/cache/{path}"]
            diff = [a for a, (m, n) in enumerate(zip(t.shape, g.shape))
                    if m != n]
            assert g.ndim == t.dim() and len(diff) <= 1, path
            if diff:
                assert (t.shape[diff[0]], g.shape[diff[0]]) == (TP, 1), path
                t = t.narrow(diff[0], r, 1)
            _close_state(g, t.numpy())


def _ring_slots(cfg):
    """K1-peer calls of one forward per weave split: the entry norm and
    each block's slot.  (prefill, decode) for this file's inputs, where
    the weave splits both in two: dense/MoE/vlm 1 + 2L, ssm 1 + L,
    hybrid 1 + L + n_inv (the shared block's invocations), encdec's
    decoder 1 + 3L (and its encoder 1 + 2·L_enc, prefill only)."""
    n = cfg.num_layers
    per = {"moe": 1 + 2 * n, "vlm": 1 + 2 * n, "ssm": 1 + n,
           "hybrid": 1 + n + n // max(cfg.shared_attn_period, 1),
           "encdec": 1 + 3 * n}[cfg.family]
    enc = 1 + 2 * cfg.encoder_layers if cfg.family == "encdec" else 0
    return 2 * (per + enc), 2 * per


@pytest.mark.parametrize("name", MODELS)
def test_ring_takes_k1_peer_at_every_slot(world, name):
    """Comm mode ``ring``: every add+norm slot of the prefill and the
    decode step went through K1's cross-rank wrapper (``fused`` never)."""
    cfg = _cfg(name)
    for mode in MODES:
        assert TT.weave_decision_info(PREFILL_B, PREFILL_S, tp=TP,
                                      pcfg=_pcfg(mode)).weave
        assert TT.weave_decision_info(DECODE_B, 1, tp=TP, pcfg=_pcfg(mode),
                                      decode=True).weave
    if cfg.family == "encdec":
        assert TE.encoder_split(PREFILL_B, ENC_LEN, tp=TP,
                                pcfg=_pcfg("ring")) == 1
    for got in world["ranks"]:
        assert tuple(got[f"{name}/ring/k1p"]) == _ring_slots(cfg)
        assert tuple(got[f"{name}/fused/k1p"]) == (0, 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ENGINE_MODELS)
def test_engine_tokens_equal_rank_axis(world, name, mode):
    cfg = _cfg(name)
    api = build_model(cfg, _pcfg(mode), tp=TP)
    want, _ = _serve(api, _params(name), *_prompts(cfg, 3))
    assert sum(len(t) for t in want) == 13
    for got in world["ranks"]:
        assert json.loads(str(got[f"{name}/{mode}/engine"])) == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SPEC_MODELS)
def test_engine_spec_equals_rank_axis(world, name, mode):
    """OLMoE (``expert``) with speculative decoding over slots (n-gram
    draft, gamma 3) on prompt-lookup prompts: each rank's tokens and
    ``spec/*`` counters equal the rank axis's with the same scheduler
    (MoE tokens depend on the batch: the reference is the same
    speculative engine), windows verified and drafts proposed."""
    cfg = _cfg(name)
    api = build_model(cfg, _pcfg(mode), tp=TP)
    want = _serve(api, _params(name), *_lookup_prompts(cfg, 4),
                  spec_gamma=GAMMA)
    assert want[1][0] > 0 and want[1][1] > 0
    for got in world["ranks"]:
        assert json.loads(str(got[f"{name}/{mode}/engine_spec"])) == \
            list(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", VERIFY_MODELS)
def test_verify_step_matches_rank_axis(world, name, mode):
    """``ModelApi.verify_step`` over the groups (Mixtral's ``ffn`` MoE
    routing a process's own window rows; Qwen2-VL as text, M-RoPE ids 40
    below the 1-D positions): each rank's logits within 1e-5 of its slice
    of the rank axis's."""
    api = build_model(_cfg(name), _pcfg(mode), tp=TP)
    want = _verify(api, _params(name))
    assert want.shape[2] == GAMMA + 1
    for r, got in enumerate(world["ranks"]):
        _close(got[f"{name}/{mode}/verify"], want[r:r + 1].numpy())


@pytest.mark.parametrize("phase", ["pf", "dc"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_logits_match_reference_tp2(world, name, mode, phase):
    """Each rank's prefill and decode-step logits in either comm mode are
    its vocabulary slice of the reference's at tp=2 (comm mode fused) on
    the same weights, inputs and decode cache."""
    want = world["ref"][f"{name}/{phase}"]           # (B, 1, tp·V_loc)
    for r, got in enumerate(world["ranks"]):
        lg = got[f"{name}/{mode}/{phase}/logits"][0]
        v_loc = lg.shape[-1]
        _close(lg, want[..., r * v_loc:(r + 1) * v_loc], TOL_REF)


def test_world_ran_over_gloo(world):
    assert [str(r["backend"]) for r in world["ranks"]] == ["gloo"] * TP


# --------------------------------------------------------------------------
# weights and the MoE experts of a rank (in process)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_take_rank_equals_from_jax_params_rank(name):
    """Every family's tree: ``from_jax_params(rank=r)`` of the reference's
    layout equals ``take_rank`` of the port's tree, leaf for leaf (the
    hybrid's ``shared.lora_b`` cut on axis 1, its per-invocation
    ``norm_out`` and ``lora_a`` whole), each leaf in a storage of its
    own."""
    cfg = _cfg(name)
    full = _params(name)
    ref = _map(lambda p, t: t.numpy(), to_jax_layout(full, cfg,
                                                     _pcfg("fused")))
    for r in range(TP):
        want = dict(_leaves(take_rank(full, r, cfg)))
        got = dict(_leaves(from_jax_params(ref, cfg, _pcfg("fused"),
                                           device="cpu", rank=r)))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
        for k, t in want.items():
            if t.data_ptr() != dict(_leaves(full))[k].data_ptr():
                assert t.untyped_storage().nbytes() == t.nbytes, k
    if cfg.family == "hybrid":
        sh = full["shared"]
        one = take_rank(full, 1, cfg)["shared"]
        assert torch.equal(one["lora_b"], sh["lora_b"][:, 1:2])
        assert one["norm_out"] is sh["norm_out"]
        assert one["lora_a"] is sh["lora_a"]


@pytest.mark.parametrize("name", MODELS)
def test_init_one_rank_equals_take_rank(name):
    """``ModelApi.init`` under groups gives the rank's slice of the
    tp-rank draw for every family, each leaf in a storage of its own."""
    cfg = _cfg(name)
    full = build_model(cfg, _pcfg("fused"), tp=TP).init(SEED, device="cpu")
    for r in range(TP):
        api = build_model(cfg, _pcfg("fused"), tp=TP,
                          groups=_fake_groups(r))
        got = dict(_leaves(api.init(SEED, device="cpu")))
        want = dict(_leaves(take_rank(full, r, cfg)))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
            assert got[k].untyped_storage().nbytes() == got[k].nbytes, k


def test_expert_offsets_of_a_process_rank():
    """OLMoE (``expert``): rank 1 of 2 holds experts [E/2, E); Mixtral
    (``ffn``): every rank holds every expert from 0."""
    cfg = get_config("olmoe-1b-7b")
    e = cfg.num_experts
    assert TM.local_sizes(cfg, TP) == (e // 2, cfg.moe_d_ff)
    assert TM.expert_offsets(cfg, TP, "cpu", range(1, 2)).tolist() == [e // 2]
    assert TM.expert_offsets(cfg, TP, "cpu").tolist() == [0, e // 2]
    mix = get_config("mixtral-8x22b")
    assert TM.expert_offsets(mix, TP, "cpu", range(1, 2)).tolist() == [0]


def test_moe_forward_on_one_rank_is_its_slice_of_the_rank_axis():
    """``moe_forward`` with a process's ``CommCtx`` (rank 1 of 2) on rank
    1's experts gives rank 1's slice of the rank axis's partial output:
    it routes to experts [E/2, E) only."""
    from repro_torch.distributed.context import CommCtx
    cfg = dataclasses.replace(_cfg("olmoe-1b-7b"), num_experts=8)
    gen = torch.Generator().manual_seed(2)
    full = TM.init_moe_params(gen, cfg, TP, device="cpu",
                              dtype=torch.float32)
    x = torch.randn(1, 3, 8, cfg.d_model, generator=gen)
    want, aux = TM.moe_forward(full, x.expand(TP, -1, -1, -1), cfg)
    one = {k: v if k == "router" else v[1:2] for k, v in full.items()}
    ctx = CommCtx(tp=TP, backend="process_group", groups=_fake_groups(1))
    got, aux1 = TM.moe_forward(one, x, cfg, ctx=ctx)
    _close(got.numpy(), want[1:2].numpy())
    _close(aux1.numpy(), aux[1:2].numpy())
    # on rank 0's offsets the same weights give another output
    wrong, _ = TM.moe_forward(one, x, cfg, ctx=CommCtx(
        tp=TP, backend="process_group", groups=_fake_groups(0)))
    assert not torch.allclose(wrong, got)
