"""The port's config registry and every transformer-family config it
serves, against the JAX reference, in float32 on the CPU.

Each of the 13 registry names gives a config equal to the reference's
field by field.  The six dense configs and the three MoE ones (``ffn``,
``expert`` and ``ep2d``, the last at data size 1), ``reduced()``
and with every weight perturbed by 0.05·N(0, 1) (so that norms, biases and
routers are not trivial), run one prefill and one decode step through
both packages with the same weights: logits and KV agree within 1e-4, and
for the MoE configs so does the hidden state entering each MoE layer at
every row, padding rows and free slots included (a padding row that
routes differently could take a real token's place in an expert).  This
covers local/global layers with two rope thetas, QKV bias, q/k norms,
sandwich norms, GEGLU and tied, scaled embeddings.  The ssm and hybrid
configs (falcon-mamba-7b, zamba2-7b) run the same way through their own
model modules, a prefill then a decode step of its rows, with logits
within 1e-4 and states and KV within 1e-5 (``test_torch_ssm.py``'s
``close_state``); ``test_torch_ssm.py`` and ``test_torch_hybrid.py``
add chunked prefill, the weave off and tp=2.

The reference runs under ``shard_map`` on the 1x1 mesh with its layers
unrolled (``scan_layers=False``), so that a host callback labelled at
trace time records each MoE call's input; the port runs
``attn_impl="pallas"`` and ``use_pallas_norm=True`` (the K2/K3 wrappers,
their plain versions on the CPU).  ``tests/test_torch_moe.py`` adds the
weave-off cases and tp=2.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import ParallelConfig as JParallel
from repro.layers import moe as JM
from repro.models import transformer as JT
from repro.models.build import build_model as j_build_model

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.layers import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

TOL = 1e-4
PCFG = dict(tokenweave=True, comm_mode="fused", remat=False, split_unit=16,
            tokenweave_min_tokens=32, scan_layers=False)
DENSE = ("gemma3-1b", "qwen1.5-4b", "deepseek-67b", "qwen3-14b",
         "llama3.3-70b", "qwen2.5-72b")
MOE = ("mixtral-8x22b", "olmoe-1b-7b")
EP2D = ("qwen3-moe-235b-a22b",)      # data size > 1: test_torch_dp.py
PREFILL = {True: 48, False: 8}       # weave fires -> chunk per row (2 rows)
DECODE = {True: 16, False: 4}        # weave fires -> batch rows
PERTURB = 0.05


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def perturb(params, seed: int):
    """Every leaf plus PERTURB·N(0, 1), seeded with numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + PERTURB * rng.randn(
            *a.shape).astype(np.asarray(a).dtype)), params)


def torch_pcfg(jpcfg, **kw):
    return dataclasses.replace(
        tbase.ParallelConfig(**{f.name: getattr(jpcfg, f.name)
                                for f in dataclasses.fields(jpcfg)}),
        attn_impl="pallas", use_pallas_norm=True, **kw)


def model_pair(cfg, *, seed: int = 0, tp: int = 1, **pcfg_kw):
    """(cfg, the reference's perturbed weights and parallel config, the
    port's bridged weights, config and parallel config)."""
    jpcfg = JParallel(**{**PCFG, **pcfg_kw})
    api = j_build_model(cfg, jpcfg, tp=tp)
    jparams = perturb(api.init(jax.random.PRNGKey(seed)), seed + 1)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    tpcfg = torch_pcfg(jpcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, tpcfg,
                              device="cpu")
    return cfg, jparams, jpcfg, tparams, tcfg, tpcfg


def capture_moe_inputs(monkeypatch):
    """Make both packages' ``moe_forward`` record each call's input.  The
    reference's label is fixed at trace time, in the order both forwards
    call it (layer by layer, split by split), and its host callback keys
    the value by (label, rank); the port's calls append in that order.
    Returns (reference dict, port list)."""
    jstore, tstore = {}, []
    jorig, torig = JM.moe_forward, TM.moe_forward
    count = itertools.count()

    def jwrap(params, x, cfg, **kw):
        label = next(count)
        jax.debug.callback(
            lambda a, r, label=label: jstore.__setitem__(
                (label, int(r)), np.asarray(a)),
            x, lax.axis_index(kw.get("tp_axis", "model")))
        return jorig(params, x, cfg, **kw)

    def twrap(params, x, cfg, **kw):
        tstore.append(x.detach().clone())
        return torig(params, x, cfg, **kw)

    monkeypatch.setattr(JM, "moe_forward", jwrap)
    monkeypatch.setattr(TM, "moe_forward", twrap)
    return jstore, tstore


def check_moe_inputs(jstore, tstore, n_calls: int, tol=TOL):
    """Every MoE call's input equal at every row, on every rank."""
    assert len(tstore) == n_calls, (len(tstore), n_calls)
    assert {label for label, _ in jstore} == set(range(n_calls))
    for (label, rank), want in jstore.items():
        got = tstore[label][rank]
        assert got.shape == want.shape, (label, got.shape, want.shape)
        _close(got, want, tol)


def random_caches(rng, cfg, b: int, max_len: int, lengths):
    """Per-layer random KV caches in the reference's layout, {"layer_i":
    {"k", "v" (B, C, kv heads, dh), "pos" (B, C)}}: row r holds the last
    C of its ``lengths[r]`` positions at index pos % C (C the layer's
    window, or max_len), -1 elsewhere."""
    caches = {}
    for i, kind in enumerate(JT.layer_kinds(cfg)):
        c = min(max_len, kind.window) if kind.window else max_len
        shape = (b, c, cfg.num_kv_heads, cfg.head_dim)
        k = rng.randn(*shape).astype(np.float32)
        v = rng.randn(*shape).astype(np.float32)
        pos = np.full((b, c), -1, np.int32)
        for r, n in enumerate(lengths):
            for p in range(max(0, n - c), n):
                pos[r, p % c] = p
        caches[f"layer_{i}"] = {"k": k, "v": v, "pos": pos}
    return caches


def port_caches(caches, tp: int):
    """The reference's caches (kv heads global, split over tp shards) ->
    the port's per-layer list, k/v (tp, B, C, kv heads / tp, dh)."""
    def ranks(a):
        b, c, h, dh = a.shape
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(b, c, tp, h // tp, dh).transpose(2, 0, 1, 3, 4)))
    return [{"k": ranks(lc["k"]), "v": ranks(lc["v"]),
             "pos": torch.from_numpy(lc["pos"].copy())}
            for _, lc in sorted(caches.items(),
                                key=lambda kv: int(kv[0][6:]))]


def global_heads(t):
    """(tp, ..., kv, dh) on the rank axis -> (..., tp·kv, dh)."""
    a = t.numpy()
    return np.moveaxis(a, 0, -3).reshape(*a.shape[1:-2], -1, a.shape[-1])


def local_logits(t):
    """(tp, B, S, V_loc) -> the reference's gathered (B, S, tp·V_loc)."""
    return np.concatenate(list(t.numpy()), axis=-1)


def prefill_inputs(cfg, *, weave: bool, seed: int):
    """One chunk of 2 rows behind cached prefixes of 10 and 3 tokens, row
    1 ending in 5 padding tokens (numpy)."""
    rng = np.random.RandomState(seed)
    chunk, prior = PREFILL[weave], [10, 3]
    caches = random_caches(rng, cfg, 2, 64, prior)
    tokens = rng.randint(0, cfg.vocab_size, (2, chunk)).astype(np.int32)
    positions = np.full((2, chunk), -1, np.int32)
    take = [chunk, chunk - 5]
    for i in range(2):
        positions[i, :take[i]] = np.arange(prior[i], prior[i] + take[i])
    last = np.array([t - 1 for t in take], np.int32)
    return dict(cache=caches, tokens=tokens, positions=positions, last=last)


def decode_inputs(cfg, *, weave: bool, seed: int):
    """One decode step over a slot cache of 32 cells, slot 1 free
    (position -1, its row still goes through the MoE) and slot 2 writing
    past the row's end (numpy)."""
    rng = np.random.RandomState(seed)
    batch, c = DECODE[weave], 32
    lengths = rng.randint(1, c, size=batch)
    caches = random_caches(rng, cfg, batch, c, lengths)
    tokens = rng.randint(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    positions = lengths[:, None].astype(np.int32)
    positions[1, 0] = -1
    positions[2, 0] = c + 3
    return dict(cache=caches, tokens=tokens, positions=positions)


def ref_step(mesh, cfg, jpcfg, jparams, inp, *, phase: str, specs=None):
    """The reference's prefill or decode step under shard_map: (gathered
    logits, chunk kv or the cache, per layer).  ``specs``: (params,
    cache) PartitionSpecs at tp > 1; everything replicated otherwise."""
    kv = P(None, None, "model", None)
    pspec, cspec = specs or (P(), P())
    if phase == "prefill":
        def fn(params, tok, cache, pos, li):
            return JT.prefill(params, tok, cache, cfg=cfg, pcfg=jpcfg,
                              positions=pos, last_idx=li)[:2]
        args = ("tokens", "cache", "positions", "last")
        out_kv = {f"layer_{i}": (kv, kv, P()) for i in range(cfg.num_layers)}
    else:
        def fn(params, tok, cache, pos):
            return JT.decode_step(params, tok, cache, cfg=cfg, pcfg=jpcfg,
                                  positions=pos)
        args = ("tokens", "cache", "positions")
        out_kv = cspec
    in_specs = (pspec,) + tuple(cspec if a == "cache" else P() for a in args)
    out_specs = (P(None, None, "model"), out_kv if specs else P())
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(
        jparams, *(jax.tree.map(jnp.asarray, inp[a]) for a in args))


def port_step(tparams, tcfg, tpcfg, inp, *, phase: str, tp: int = 1):
    """The port's prefill or decode step on the same inputs."""
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "cache"}
    with torch.no_grad():
        if phase == "prefill":
            return TT.prefill(tparams, t["tokens"],
                              port_caches(inp["cache"], tp), cfg=tcfg,
                              pcfg=tpcfg, positions=t["positions"],
                              last_idx=t["last"])
        return TT.decode_step(tparams, t["tokens"],
                              port_caches(inp["cache"], tp), cfg=tcfg,
                              pcfg=tpcfg, positions=t["positions"])


def check_step(got, want, *, phase: str):
    """Logits and KV (chunk kv at prefill, the cache at decode) equal."""
    (t_logits, t_kv), (j_logits, j_kv) = got, want
    _close(local_logits(t_logits), j_logits)
    for i, tl in enumerate(t_kv):
        jl = j_kv[f"layer_{i}"]
        if phase == "decode":
            tl, jl = ((c["k"], c["v"], c["pos"]) for c in (tl, jl))
        _close(global_heads(tl[0]), jl[0])
        _close(global_heads(tl[1]), jl[1])
        np.testing.assert_array_equal(tl[2].numpy(), np.asarray(jl[2]))


def check_model_step(mesh, pair, *, phase: str, weave: bool, seed: int,
                     monkeypatch):
    """One prefill or decode step at tp=1 through both packages: logits,
    KV and (MoE) every MoE layer's input at every row equal."""
    cfg, jparams, jpcfg, tparams, tcfg, tpcfg = pair
    make = prefill_inputs if phase == "prefill" else decode_inputs
    inp = make(cfg, weave=weave, seed=seed)
    b, s = inp["tokens"].shape
    for mod, pcfg in ((JT, jpcfg), (TT, tpcfg)):
        assert mod.weave_decision_info(b, s, tp=1, pcfg=pcfg,
                                       decode=phase == "decode").weave == weave
    jstore, tstore = capture_moe_inputs(monkeypatch)
    want = ref_step(mesh, cfg, jpcfg, jparams, inp, phase=phase)
    check_step(port_step(tparams, tcfg, tpcfg, inp, phase=phase), want,
               phase=phase)
    if cfg.is_moe:
        check_moe_inputs(jstore, tstore, cfg.num_layers * (1 + weave))


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.list_configs())
def test_registry_config_equals_reference(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())


def test_registry_lists_equal_reference():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert tconfigs.PAPER_MODELS == jconfigs.PAPER_MODELS
    assert len(tconfigs.list_configs()) == 13
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


# --------------------------------------------------------------------------
# every transformer-family config, reduced and perturbed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE + MOE + EP2D)
def test_reduced_config_prefill_and_decode_match(name, mesh11, monkeypatch):
    cfg = jconfigs.get_config(name).reduced()
    pair = model_pair(cfg, seed=3)
    for phase, seed in (("prefill", 11), ("decode", 12)):
        check_model_step(mesh11, pair, phase=phase, weave=True, seed=seed,
                         monkeypatch=monkeypatch)


# --------------------------------------------------------------------------
# the ssm and hybrid configs, reduced and perturbed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("falcon-mamba-7b", "zamba2-7b"))
def test_reduced_recurrent_config_prefill_and_decode_match(name, mesh11):
    """A 2x48 prefill from an empty cache (the weave splitting the
    sequence), then one decode step of its two rows from the prefill's
    state (and, hybrid, its shared KV inserted by each package's own cache
    code): logits, states and KV."""
    from repro_torch.models.build import build_model as t_build_model
    from repro_torch.runtime import kv_cache as TKC
    from test_torch_hybrid import check_chunk_kv, check_shared_cache
    from test_torch_ssm import (check_state, local_logits, shard_call)
    from test_torch_ssm import model_pair as ssm_model_pair

    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = ssm_model_pair(name, seed=3)
    tapi = t_build_model(tcfg, tpcfg)
    hybrid = cfg.family == "hybrid"
    rng = np.random.RandomState(13)
    b, s, c = 2, PREFILL[True], 64
    tokens = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    j_logits, j_out = shard_call(
        mesh11, lambda p, t, cc: api.mod.prefill(p, t, cc, cfg=cfg,
                                                 pcfg=jpcfg)[:2],
        jp, jnp.asarray(tokens), api.init_cache(b, c), out_specs=(P(), P()))
    with torch.no_grad():
        tcache = tapi.init_cache(b, c, device="cpu")
        t_logits, t_out = tapi.prefill(tparams, torch.from_numpy(tokens),
                                       tcache, None)
    _close(local_logits(t_logits), j_logits)
    family = cfg.family
    check_state(t_out["mamba"] if hybrid else t_out,
                j_out["mamba"] if hybrid else j_out, family)
    jcache = jax.tree.map(np.asarray, j_out)
    if hybrid:
        check_chunk_kv(t_out["shared"], j_out["shared"])
        shared = jax.tree.map(np.array, api.init_cache(b, c)["shared"])
        for n, a in zip(("k", "v", "pos"), jcache["shared"]):
            shared[n][:, :, :s] = a
        jcache = {"mamba": jcache["mamba"], "shared": shared}
        TKC.insert_chunk(tcache["shared"], t_out["shared"],
                         torch.zeros(b, dtype=torch.long), torch.arange(b))
    dtok = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    dpos = np.full((b, 1), s, np.int32)
    j_logits, j_out = shard_call(
        mesh11, lambda p, t, cc, ps: api.mod.decode_step(
            p, t, cc, cfg=cfg, pcfg=jpcfg, positions=ps),
        jp, jnp.asarray(dtok), jcache, jnp.asarray(dpos),
        out_specs=(P(), P()))
    with torch.no_grad():
        t_logits, t_out = tapi.decode_step(
            tparams, torch.from_numpy(dtok), tcache,
            torch.from_numpy(dpos))
    _close(local_logits(t_logits), j_logits)
    check_state(t_out["mamba"] if hybrid else t_out,
                j_out["mamba"] if hybrid else j_out, family)
    if hybrid:
        check_shared_cache(t_out["shared"], j_out["shared"])
