"""The port's hybrid family (``models/hybrid.py``: Mamba-2 layers and the
shared 2d-wide attention block with its per-invocation LoRA) against the
JAX reference, in float32 on the CPU, on the same numpy-seeded inputs and
weights (``from_jax_params``), and K3's plain version at the head dims
above 128 that this family and gemma3 need.

The reduced zamba2-7b (6 layers, the shared block every 3) with every leaf
perturbed by 0.05·N(0, 1): two prefill chunks through the cache (the
second attends the first's shared KV and resumes its SSD state) and one
decode step over random state and KV (the batch split slicing each
invocation's cache rows when the weave fires), weave on and off: logits
within 1e-4, states and KV within 1e-5 (of max(1, a leaf's largest
magnitude)).  tp=2 in ``fused`` and ``ring``
against the reference on two host devices (one subprocess).  The engine
refuses the family (the reference serves it by direct calls), and its
entry points default to CUDA.  Helpers come from ``test_torch_ssm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.attention import _attn_ref as j_attn_ref
from repro.models import hybrid as JH
from repro.models import transformer as JT

from repro_torch.kernels import flash_attention as K3
from repro_torch.models import hybrid as THY
from repro_torch.models import transformer as TT
from repro_torch.runtime import kv_cache as TKC
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.weights import from_jax_params
from test_torch_ssm import (DECODE, LOGIT_TOL, PREFILL, STATE_TOL, P,
                            as_tuple, check_state, close, close_state,
                            local_logits, model_pair, nest, shard_call,
                            to_port, tp2_port, tp2_reference)

NAME = "zamba2-7b"


def global_heads(t):
    """(R, ..., kv, dh) on the rank axis -> the reference's (..., R·kv,
    dh)."""
    a = t.numpy()
    return np.moveaxis(a, 0, -3).reshape(*a.shape[1:-2], -1, a.shape[-1])


def port_shared(ref_shared, tp: int):
    """The reference's stacked shared cache (n_inv, B, C, R·kv, dh) -> the
    port's per-invocation dicts, k/v (R, B, C, kv, dh), copied."""
    def ranks(a):
        b, c, h, dh = a.shape
        return torch.from_numpy(np.array(
            a.reshape(b, c, tp, h // tp, dh).transpose(2, 0, 1, 3, 4)))
    k, v, pos = (np.asarray(ref_shared[n]) for n in ("k", "v", "pos"))
    return [{"k": ranks(k[g]), "v": ranks(v[g]),
             "pos": torch.from_numpy(np.array(pos[g]))}
            for g in range(k.shape[0])]


def check_chunk_kv(got, want):
    """The port's per-invocation chunk (k, v, pos) against the
    reference's stacked one."""
    assert len(got) == want[0].shape[0]
    for g, (k, v, pos) in enumerate(got):
        close_state(global_heads(k), want[0][g])
        close_state(global_heads(v), want[1][g])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want[2][g]))


def check_shared_cache(got, want):
    for g, layer in enumerate(got):
        close_state(global_heads(layer["k"]), want["k"][g])
        close_state(global_heads(layer["v"]), want["v"][g])
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      np.asarray(want["pos"][g]))


# --------------------------------------------------------------------------
# K3's plain version at head dims 224 and 256
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [224, 256])
def test_k3_plain_at_wide_heads_matches_attn_ref(dh):
    """The shared block's 224 (2·3584/32) and gemma3's 256, GQA group 2,
    padded keys (kpos -1), fully masked query rows and a window."""
    rng = np.random.RandomState(dh)
    b, sq, sk, kvh, g = 2, 24, 40, 2, 2
    q = rng.randn(b, sq, kvh, g, dh).astype(np.float32)
    k = rng.randn(b, sk, kvh, dh).astype(np.float32)
    v = rng.randn(b, sk, kvh, dh).astype(np.float32)
    qpos = np.tile(np.arange(16, 16 + sq, dtype=np.int32), (b, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    kpos[:, 5:9] = -1
    qpos[1, -3:] = -1
    for window in (0, 12):
        kw = dict(causal=True, window=window, sm_scale=dh ** -0.5)
        want = j_attn_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                          **kw)
        got = K3.flash_attention(*(torch.from_numpy(a) for a in
                                   (q, k, v, qpos, kpos)), **kw)
        close(got, want, STATE_TOL)


def test_k3_takes_bf16_wide_heads_and_refuses_fp32_ones():
    qp = torch.zeros(1, 8, dtype=torch.int32)
    kp = torch.zeros(1, 16, dtype=torch.int32)
    for dh in (224, 256):
        for dtype in (torch.bfloat16, torch.float32):
            args = (torch.zeros(1, 8, 2, 1, dh, dtype=dtype),
                    torch.zeros(1, 16, 2, dh, dtype=dtype),
                    torch.zeros(1, 16, 2, dh, dtype=dtype), qp, kp)
            if dtype == torch.bfloat16:
                K3.check_inputs(*args)
            else:
                with pytest.raises(ValueError,
                                   match="no model runs float32 on the card"):
                    K3.check_inputs(*args)


# --------------------------------------------------------------------------
# the reduced zamba2-7b
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_pair():
    return model_pair(NAME, seed=4)


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_zamba2_prefill_chunks_match(weave, hybrid_pair, mesh11):
    """Two prefill chunks of 2 rows through the cache: the second attends
    the first's shared KV (inserted by each package's own cache code) and
    resumes its Mamba-2 state.  Logits, states and chunk KV."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = hybrid_pair
    chunk, b, c = PREFILL[weave], 2, 2 * PREFILL[weave]
    assert JT.weave_decision_info(b, chunk, tp=1, pcfg=jpcfg).weave == weave
    rng = np.random.RandomState(40 + weave)
    jcache = jax.tree.map(np.asarray, api.init_cache(b, c))
    tcache = THY.init_cache(b, c, tcfg, 1, device="cpu")

    def f(p, t, cch, ps):
        return JH.prefill(p, t, cch, cfg=cfg, pcfg=jpcfg, positions=ps)[:2]
    for step in range(2):
        tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        pos = np.tile(np.arange(step * chunk, (step + 1) * chunk,
                                dtype=np.int32), (b, 1))
        j_logits, j_out = shard_call(mesh11, f, jp, jnp.asarray(tokens),
                                     jcache, jnp.asarray(pos),
                                     out_specs=(P(), P()))
        with torch.no_grad():
            t_logits, t_out = THY.prefill(
                tparams, torch.from_numpy(tokens).long(), tcache, cfg=tcfg,
                pcfg=tpcfg, positions=torch.from_numpy(pos))
        close(local_logits(t_logits), j_logits, LOGIT_TOL)
        check_state(t_out["mamba"], j_out["mamba"], "hybrid")
        check_chunk_kv(t_out["shared"], j_out["shared"])
        # each package inserts the chunk's KV its own way
        k, v, kpos = (np.asarray(a) for a in j_out["shared"])
        sl = slice(step * chunk, (step + 1) * chunk)
        jcache = {"mamba": jax.tree.map(np.asarray, j_out["mamba"]),
                  "shared": {n: np.array(jcache["shared"][n])
                             for n in ("k", "v", "pos")}}
        jcache["shared"]["k"][:, :, sl] = k
        jcache["shared"]["v"][:, :, sl] = v
        jcache["shared"]["pos"][:, :, sl] = kpos
        TKC.insert_chunk(tcache["shared"], t_out["shared"],
                         torch.full((b,), step * chunk), torch.arange(b))


@pytest.mark.parametrize("weave", [True, False])
def test_reduced_zamba2_decode_matches(weave, hybrid_pair, mesh11):
    """One decode step over random Mamba-2 state and shared KV (rows of
    different lengths), the batch split firing (16 rows: each split reads
    and writes its own rows of every invocation's cache) or not (4).
    Logits, state and the updated KV."""
    cfg, api, jp, jpcfg, tcfg, tparams, tpcfg = hybrid_pair
    b, c = DECODE[weave], 32
    assert JT.weave_decision_info(b, 1, tp=1, pcfg=jpcfg,
                                  decode=True).weave == weave
    rng = np.random.RandomState(50 + weave)
    jcache = jax.tree.map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32)
        if a.dtype != jnp.int32 else np.array(a), api.init_cache(b, c))
    lengths = rng.randint(1, c, size=b)
    for i, n in enumerate(lengths):
        jcache["shared"]["pos"][:, i, :n] = np.arange(n)
    tokens = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = lengths[:, None].astype(np.int32)
    tcache = {"mamba": to_port(jcache["mamba"], "hybrid", 1),
              "shared": port_shared(jcache["shared"], 1)}

    def f(p, t, cch, ps):
        return JH.decode_step(p, t, cch, cfg=cfg, pcfg=jpcfg, positions=ps)
    j_logits, j_out = shard_call(mesh11, f, jp, jnp.asarray(tokens), jcache,
                                 jnp.asarray(pos), out_specs=(P(), P()))
    with torch.no_grad():
        t_logits, t_out = THY.decode_step(
            tparams, torch.from_numpy(tokens).long(), tcache, cfg=tcfg,
            pcfg=tpcfg, positions=torch.from_numpy(pos))
    close(local_logits(t_logits), j_logits, LOGIT_TOL)
    check_state(t_out["mamba"], j_out["mamba"], "hybrid")
    check_shared_cache(t_out["shared"], j_out["shared"])


# --------------------------------------------------------------------------
# the engine's refusal and the entry points' device
# --------------------------------------------------------------------------

def test_engine_refuses_hybrid(hybrid_pair):
    """The reference serves the hybrid family by direct prefill / decode
    calls; the port's engine says so."""
    tparams, tpcfg, tcfg = hybrid_pair[5], hybrid_pair[6], hybrid_pair[4]
    from repro_torch.models.build import build_model
    with pytest.raises(NotImplementedError, match="direct ModelApi"):
        TEngine(build_model(tcfg, tpcfg), tparams,
                tsched.SchedulerConfig(max_batch=2, max_len=64),
                device="cpu")


@pytest.mark.parametrize("entry", ["init", "init_cache", "from_jax_params"])
def test_hybrid_entry_points_default_to_cuda(entry, hybrid_pair,
                                             monkeypatch):
    jp, tcfg, tpcfg = hybrid_pair[2], hybrid_pair[4], hybrid_pair[6]
    from repro_torch.models.build import build_model
    api = build_model(tcfg, tpcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"init": lambda: api.init(0),
             "init_cache": lambda: api.init_cache(2, 16),
             "from_jax_params": lambda: from_jax_params(
                 jax.tree.map(np.asarray, jp), tcfg)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_init_matches_reference_shapes(hybrid_pair):
    """The port's random init has the bridged weights' shapes and dtypes
    at tp=2 (the per-invocation axes, the replicated B/C, LoRA B's rank
    axis)."""
    cfg = hybrid_pair[0]
    from repro.models.build import build_model as j_build_model
    from repro.configs.base import ParallelConfig as JParallel
    jp = j_build_model(cfg, JParallel(), tp=2).init(jax.random.PRNGKey(0))
    want = from_jax_params(jax.tree.map(np.asarray, jp), hybrid_pair[4],
                           device="cpu")
    got = THY.init_params(hybrid_pair[4], device="cpu", tp=2)
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat.keys() == got_flat.keys()
    for k, w in flat.items():
        assert (tuple(got_flat[k].shape), got_flat[k].dtype) == \
            (tuple(w.shape), w.dtype), k


# --------------------------------------------------------------------------
# tp=2: the reference on two host devices
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_tp2(tmp_path_factory):
    return tp2_reference(tmp_path_factory, "hybrid", NAME)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fused", "ring"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tp2_zamba2_matches(hybrid_tp2, mode, phase):
    """tp=2, the weave firing (2x48 prefill from an empty cache, 16-row
    decode over random state and KV): logits within 1e-4, state and KV
    within 1e-5."""
    ref = hybrid_tp2
    api, params = tp2_port(ref, NAME, mode)
    b, s = ref["pf/tokens"].shape if phase == "prefill" else (16, 1)
    assert TT.weave_decision_info(b, s, tp=2, pcfg=api.pcfg,
                                  decode=phase == "decode").weave
    with torch.no_grad():
        if phase == "prefill":
            logits, out = api.prefill(
                params, torch.from_numpy(ref["pf/tokens"]).long(),
                api.init_cache(2, 64, device="cpu"), None)
        else:
            cache = as_tuple(nest(ref, "dc/cache/"))
            logits, out = api.decode_step(
                params, torch.from_numpy(ref["dc/tokens"]).long(),
                {"mamba": to_port(cache["mamba"], "hybrid", 2),
                 "shared": port_shared(cache["shared"], 2)},
                torch.from_numpy(ref["dc/positions"]))
    pre = ("pf/" if phase == "prefill" else "dc/") + f"{mode}/"
    close(local_logits(logits), ref[pre + "logits"], LOGIT_TOL)
    want = as_tuple(nest(ref, pre + "state/"))
    check_state(out["mamba"], want["mamba"], "hybrid")
    if phase == "prefill":
        check_chunk_kv(out["shared"], want["shared"])
    else:
        check_shared_cache(out["shared"], want["shared"])
