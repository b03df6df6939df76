"""The PyTorch port's model path against the JAX reference, in float32 on
the CPU, with the tiny dense model and the same weights on both sides, at
tp=1 (the port's rank axis has size 1; tests/test_torch_tp.py covers
tp>1).

The reference runs ``tiny_pcfg`` as its own tests do (chunked attention,
jnp add+norm); the port runs it with ``attn_impl="pallas"`` and
``use_pallas_norm=True``, so its K2/K3 wrappers are on the path and take
their plain versions on CPU tensors.  Prefill and decode are checked with
the weave split both firing and not firing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import fused_collectives as jfc
from repro.distributed.context import CommCtx as JCtx
from repro.kernels.ref import ring_ar_rmsnorm_ref
from repro.layers import attention as JA
from repro.layers.embedding import sharded_argmax as j_argmax
from repro.models import transformer as JT
from repro.runtime import kv_cache as JKC

from repro_torch.configs import base as tbase
from repro_torch.core import fused_collectives as tfc
from repro_torch.distributed.context import CommCtx as TCtx
from repro_torch.layers import attention as TA
from repro_torch.layers.embedding import sharded_argmax as t_argmax
from repro_torch.models import transformer as TT
from repro_torch.runtime import kv_cache as TKC
from repro_torch.weights import from_jax_params

TOL = 1e-4


def _shard_run(mesh, fn, *args):
    """Run ``fn`` inside shard_map on the 1x1 mesh (every arg replicated)."""
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                 out_specs=P(), check_vma=False))(*args)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def both(tiny_model, tiny_cfg, tiny_pcfg):
    """(jax params, jax cfg, jax pcfg, torch params, torch cfg, torch pcfg)."""
    _, mesh, jparams = tiny_model
    tcfg = tbase.ModelConfig(**dataclasses.asdict(tiny_cfg))
    tpcfg = dataclasses.replace(
        tbase.ParallelConfig(**{f.name: getattr(tiny_pcfg, f.name)
                                for f in dataclasses.fields(tiny_pcfg)}),
        attn_impl="pallas", use_pallas_norm=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, tpcfg,
                              device="cpu")
    return mesh, jparams, tiny_cfg, tiny_pcfg, tparams, tcfg, tpcfg


def _random_cache(rng, cfg, b, c, lengths):
    """Stacked numpy cache (L, B, C, kvh, dh) with rows filled to
    ``lengths`` (pos -1 beyond)."""
    shape = (cfg.num_layers, b, c, cfg.num_kv_heads, cfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    pos = np.full((cfg.num_layers, b, c), -1, np.int32)
    for i, n in enumerate(lengths):
        pos[:, i, :n] = np.arange(n)
    return {"k": k, "v": v, "pos": pos}


def _torch_cache(np_cache):
    """Per-layer torch cache with a rank axis of size 1 on k and v."""
    return [{name: torch.from_numpy(np.ascontiguousarray(
                 a[i] if name == "pos" else a[i][None]))
             for name, a in np_cache.items()}
            for i in range(np_cache["k"].shape[0])]


def test_bridge_takes_stacked_and_per_layer_pytrees(both):
    _, _, cfg, pcfg, tparams, tcfg, tpcfg = both
    unrolled = JT.init_params(jax.random.PRNGKey(0), cfg,
                              dataclasses.replace(pcfg, scan_layers=False), 1)
    assert "layer_0" in unrolled["layers"]
    other = from_jax_params(jax.tree.map(np.asarray, unrolled), tcfg, tpcfg,
                            device="cpu")
    flat_a = jax.tree_util.tree_leaves_with_path(tparams)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(other))
    assert len(flat_a) == len(flat_b) > 0
    for path, t in flat_a:
        assert torch.equal(t, flat_b[path]), path


@pytest.mark.parametrize("chunk,weave", [(48, True), (16, False)])
def test_prefill_logits_and_kv_match(both, chunk, weave):
    mesh, jparams, cfg, pcfg, tparams, tcfg, tpcfg = both
    assert JT.weave_decision_info(1, chunk, tp=1, pcfg=pcfg).weave == weave
    assert TT.weave_decision_info(1, chunk, tp=1, pcfg=tpcfg).weave == weave
    rng = np.random.RandomState(chunk)
    b, c, prior = 2, 64, [10, 3]
    cache = _random_cache(rng, cfg, b, c, prior)
    tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
    positions = np.full((b, chunk), -1, np.int32)
    take = [chunk, chunk - 5]           # row 1 ends in padding tokens
    for i in range(b):
        positions[i, :take[i]] = np.arange(prior[i], prior[i] + take[i])
    last_idx = np.array([t - 1 for t in take], np.int32)

    def jfn(params, tok, cache, pos, last):
        return JT.prefill(params, tok, cache, cfg=cfg, pcfg=pcfg,
                          positions=pos, last_idx=last)[:2]

    j_logits, (jk, jv, jpos) = _shard_run(
        mesh, jfn, jparams, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(positions),
        jnp.asarray(last_idx))
    t_logits, t_kv = TT.prefill(
        tparams, torch.from_numpy(tokens), _torch_cache(cache), cfg=tcfg,
        pcfg=tpcfg, positions=torch.from_numpy(positions),
        last_idx=torch.from_numpy(last_idx))
    _close(t_logits[0], j_logits)
    for layer, (k, v, pos) in enumerate(t_kv):
        _close(k[0], jk[layer])
        _close(v[0], jv[layer])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos[layer]))


@pytest.mark.parametrize("batch,weave", [(16, True), (4, False)])
def test_decode_logits_and_cache_match(both, batch, weave):
    mesh, jparams, cfg, pcfg, tparams, tcfg, tpcfg = both
    assert JT.weave_decision_info(batch, 1, tp=1, pcfg=pcfg,
                                  decode=True).weave == weave
    rng = np.random.RandomState(batch)
    c = 32
    lengths = rng.randint(1, c, size=batch)
    cache = _random_cache(rng, cfg, batch, c, lengths)
    tokens = rng.randint(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    positions = lengths[:, None].astype(np.int32)
    positions[1, 0] = -1                # an inactive slot
    positions[2, 0] = c + 3             # a write that wraps the row

    def jfn(params, tok, cache, pos):
        return JT.decode_step(params, tok, cache, cfg=cfg, pcfg=pcfg,
                              positions=pos)

    j_logits, j_cache = _shard_run(
        mesh, jfn, jparams, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(positions))
    t_logits, t_cache = TT.decode_step(
        tparams, torch.from_numpy(tokens), _torch_cache(cache), cfg=tcfg,
        pcfg=tpcfg, positions=torch.from_numpy(positions))
    _close(t_logits[0], j_logits)
    for layer, lc in enumerate(t_cache):
        _close(lc["k"][0], j_cache["k"][layer])
        _close(lc["v"][0], j_cache["v"][layer])
        np.testing.assert_array_equal(lc["pos"].numpy(),
                                      np.asarray(j_cache["pos"][layer]))


def test_attn_prefill_with_kv_prefix_matches(both):
    _, jparams, cfg, _, tparams, tcfg, _ = both
    rng = np.random.RandomState(3)
    b, s, npre = 2, 12, 20
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(npre, npre + s)[None], (b, s))
    pos = pos.astype(np.int32).copy()
    pk = rng.randn(b, npre, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
    pv = rng.randn(b, npre, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
    ppos = np.broadcast_to(np.arange(npre)[None], (b, npre)).astype(np.int32)
    ppos = ppos.copy()
    ppos[1, -4:] = -1                   # empty cache slots in row 1
    lay = JA.attention_layout(1, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim)
    j_out, (jk, jv, jkp) = JA.attn_prefill(
        jl, jnp.asarray(x), positions=jnp.asarray(pos), cfg=cfg, lay=lay,
        theta=cfg.rope_theta, kv_prefix=tuple(map(jnp.asarray,
                                                  (pk, pv, ppos))))
    tlay = TA.attention_layout(1, tcfg.num_heads, tcfg.num_kv_heads,
                               tcfg.head_dim)
    t_out, (tk, tv, tkp) = TA.attn_prefill(
        tparams["layers"][0]["attn"], torch.from_numpy(x)[None],
        positions=torch.from_numpy(pos), cfg=tcfg, lay=tlay,
        theta=tcfg.rope_theta, impl="pallas",
        kv_prefix=(torch.from_numpy(pk)[None], torch.from_numpy(pv)[None],
                   torch.from_numpy(ppos)))
    _close(t_out[0], j_out)
    _close(tk[0], jk)
    _close(tv[0], jv)
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))


@pytest.mark.parametrize("mode", ["vanilla", "reordered", "fused", "nocomm"])
@pytest.mark.parametrize("post", [False, True])
def test_comm_norm_modes_match(both, mode, post):
    mesh = both[0]
    rng = np.random.RandomState(7)
    t, d = 24, 64
    x, res = (rng.randn(t, d).astype(np.float32) for _ in range(2))
    w, wp = ((np.abs(rng.randn(d)) + 0.5).astype(np.float32)
             for _ in range(2))

    def jfn(x, res, w, wp):
        return jfc.comm_norm(x, res, w, ctx=JCtx(mode=mode),
                             weight_post=wp if post else None)

    j_out, j_res = _shard_run(mesh, jfn, *map(jnp.asarray, (x, res, w, wp)))
    tx, tres, tw, twp = map(torch.from_numpy, (x, res, w, wp))
    t_out, t_res = tfc.comm_norm(tx[None], tres[None], tw,
                                 ctx=TCtx(mode=mode, use_pallas=True),
                                 weight_post=twp if post else None)
    _close(t_out[0], j_out, 1e-5)
    _close(t_res[0], j_res, 1e-5)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       ("bfloat16", 3e-2)])
def test_comm_norm_ring_mode_matches_fused_and_ref_tp1(both, dtype, tol):
    """ring at tp=1 runs K1's wrapper with one rank (its plain version on
    the CPU): it must equal the reference's fused mode and its oracle."""
    from repro_torch.kernels import ar_rmsnorm as K1
    mesh = both[0]
    rng = np.random.RandomState(13)
    t, d = 24, 64
    x, res = (jnp.asarray(rng.randn(t, d).astype(np.float32)).astype(dtype)
              for _ in range(2))
    w = jnp.asarray((np.abs(rng.randn(d)) + 0.5).astype(np.float32)
                    ).astype(dtype)
    j_out, j_res = _shard_run(
        mesh, lambda x, r, w: jfc.comm_norm(x, r, w, ctx=JCtx(mode="fused")),
        x, res, w)
    ref_outs, ref_res = ring_ar_rmsnorm_ref([x], [res], w)
    tt = {np.float32: torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def to_t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tt)

    before = K1.ar_rmsnorm.launches
    t_out, t_res = tfc.comm_norm(to_t(x)[None], to_t(res)[None], to_t(w),
                                 ctx=TCtx(mode="ring", use_pallas=True))
    assert K1.ar_rmsnorm.launches == before      # plain version on the CPU
    assert t_out.dtype == tt and t_out.shape == (1, t, d)
    for got, want in ((t_out[0], j_out), (t_out[0], ref_outs[0]),
                      (t_res[0], j_res), (t_res[0], ref_res[0])):
        _close(got.float(), want, tol)


def test_sharded_argmax_ties_and_vocab_pad_match(both):
    mesh = both[0]
    rng = np.random.RandomState(11)
    logits = rng.randint(0, 4, size=(6, 2, 40)).astype(np.float32)
    logits[0, 0, 37:] = 9.0             # max only in the padded tail
    vocab = 37
    want = _shard_run(mesh, lambda lg: j_argmax(lg, vocab_size=vocab),
                      jnp.asarray(logits))
    got = t_argmax(torch.from_numpy(logits)[None], vocab_size=vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) < vocab


@pytest.mark.parametrize("c", [64, 8])   # 8: a ring window shorter than s
def test_insert_chunk_with_padded_positions_matches(c):
    rng = np.random.RandomState(c)
    nl, bslots, s, h, dh = 2, 4, 20, 2, 4
    cache = {"k": rng.randn(nl, bslots, c, h, dh).astype(np.float32),
             "v": rng.randn(nl, bslots, c, h, dh).astype(np.float32),
             "pos": rng.randint(-1, 50, (nl, bslots, c)).astype(np.int32)}
    slot_ids = np.array([2, 0], np.int32)
    offsets = np.array([5, 30], np.int32)
    pos = np.full((nl, 2, s), -1, np.int32)
    pos[:, 0, :] = np.arange(5, 5 + s)
    pos[:, 1, :13] = np.arange(30, 43)    # the rest is padding
    k = rng.randn(nl, 2, s, h, dh).astype(np.float32)
    v = rng.randn(nl, 2, s, h, dh).astype(np.float32)
    want = JKC.insert_chunk(jax.tree.map(jnp.asarray, cache),
                            tuple(map(jnp.asarray, (k, v, pos))),
                            jnp.asarray(offsets), jnp.asarray(slot_ids))
    got = TKC.insert_chunk(
        _torch_cache(cache),
        [(torch.from_numpy(k[i])[None], torch.from_numpy(v[i])[None],
          torch.from_numpy(pos[i])) for i in range(nl)],
        torch.from_numpy(offsets), torch.from_numpy(slot_ids))
    for i, layer in enumerate(got):
        for name in ("k", "v", "pos"):
            t = layer[name] if name == "pos" else layer[name][0]
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(want[name][i]))


# --------------------------------------------------------------------------
# paged decode and packed steps
# --------------------------------------------------------------------------

NB, BS, MAXB = 32, 4, 10


def _paged_state(rng, cfg, contexts, grow=4):
    """A stacked numpy pool (L, NB, BS, kvh, dh) and block tables (B,
    MAXB) for requests whose first ``contexts[i]`` positions are written;
    each table holds blocks for ``grow`` more positions, then -1 entries.
    Cells nobody wrote hold random keys with pos -1 (or stale positions
    in blocks no table holds)."""
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    pool = {"k": rng.randn(*shape).astype(np.float32),
            "v": rng.randn(*shape).astype(np.float32),
            "pos": np.full(shape[:3], -1, np.int32)}
    free = list(rng.permutation(NB))
    tables = np.full((len(contexts), MAXB), -1, np.int32)
    for i, n in enumerate(contexts):
        for j in range(-(-(n + grow) // BS)):
            tables[i, j] = free.pop()
        for p in range(n):
            pool["pos"][:, tables[i, p // BS], p % BS] = p
    for b in free:                               # stale, unowned
        pool["pos"][:, b] = rng.randint(0, 30, BS)
    return pool, tables


def _torch_pool(np_pool):
    return [{name: torch.from_numpy(np.ascontiguousarray(
                 a[i] if name == "pos" else a[i][None]))
             for name, a in np_pool.items()}
            for i in range(np_pool["k"].shape[0])]


def _pools_close(tpool, jpool):
    for layer, lc in enumerate(tpool):
        _close(lc["k"][0], jpool["k"][layer])
        _close(lc["v"][0], jpool["v"][layer])
        np.testing.assert_array_equal(lc["pos"].numpy(),
                                      np.asarray(jpool["pos"][layer]))


def _layer0(both):
    _, jparams, cfg, _, tparams, tcfg, _ = both
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    lay = JA.attention_layout(1, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim)
    tlay = TA.attention_layout(1, tcfg.num_heads, tcfg.num_kv_heads,
                               tcfg.head_dim)
    return jl, lay, tparams["layers"][0]["attn"], tlay


@pytest.mark.parametrize("s_v", [1, 3])
def test_attn_decode_paged_matches(both, s_v):
    """Decode (S=1) and a verify window (S=3) through the block tables:
    an inactive row, a short window (pos -1 tail), a row whose write
    block is unallocated (dropped)."""
    _, _, cfg, _, _, tcfg, _ = both
    jl, lay, tl, tlay = _layer0(both)
    rng = np.random.RandomState(20 + s_v)
    pool, bt = _paged_state(rng, cfg, [5, 9, 2, 11])
    b = bt.shape[0]
    positions = np.array([[5 + j for j in range(s_v)],
                          [-1] * s_v,
                          [2] + [-1] * (s_v - 1),
                          [11 + j for j in range(s_v)]], np.int32)
    bt[3, 11 // BS] = -1                    # row 3 writes nowhere
    x = rng.randn(b, s_v, cfg.d_model).astype(np.float32)
    layer = {n: a[0] for n, a in pool.items()}
    jfn = JA.attn_verify_paged if s_v > 1 else JA.attn_decode_paged
    tfn = TA.attn_verify_paged if s_v > 1 else TA.attn_decode_paged
    j_out, j_pool = jfn(jl, jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
                        jnp.asarray(bt), positions=jnp.asarray(positions),
                        cfg=cfg, lay=lay, theta=cfg.rope_theta)
    t_pool = _torch_pool({n: a[:1] for n, a in pool.items()})[0]
    t_out, _ = tfn(tl, torch.from_numpy(x)[None], t_pool,
                   torch.from_numpy(bt), positions=torch.from_numpy(positions),
                   cfg=tcfg, lay=tlay, theta=tcfg.rope_theta)
    live = positions[:, 0] >= 0
    _close(t_out[0][live], np.asarray(j_out)[live])
    _pools_close([t_pool], {n: np.asarray(a)[None] for n, a in j_pool.items()})


def _packed_inputs(rng, cfg, t, weave):
    """A packed axis of T tokens: a decode token of row 1, a prefill
    segment of row 0 (straddling the weave's cut at 16 when ``weave``),
    a fresh prefill of row 2, then padding; row 3 idle."""
    n_a, n_c = (20, 10) if weave else (8, 5)
    ctx = [5, 9, 0, 0]
    tokens = np.zeros((1, t), np.int32)
    positions = np.full((1, t), -1, np.int32)
    seg = np.full(t, -1, np.int32)
    sample_idx = np.full((4, 1), -1, np.int32)
    cur = 0
    for row, n in ((1, 1), (0, n_a), (2, n_c)):
        tokens[0, cur:cur + n] = rng.randint(0, cfg.vocab_size, n)
        positions[0, cur:cur + n] = np.arange(ctx[row], ctx[row] + n)
        seg[cur:cur + n] = row
        sample_idx[row, 0] = cur + n - 1
        cur += n
    return ctx, tokens, positions, seg, sample_idx


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_attn_packed_matches(both, paged, impl):
    """The segment form (impl "pallas": K3 over per-segment views) and the
    plain form against the reference, with a segment straddling nothing
    here (one split): real tokens' outputs and the written cache."""
    _, _, cfg, _, _, tcfg, _ = both
    jl, lay, tl, tlay = _layer0(both)
    rng = np.random.RandomState(31)
    ctx, _, positions, seg, _ = _packed_inputs(rng, cfg, 48, True)
    t = positions.shape[1]
    x = rng.randn(1, t, cfg.d_model).astype(np.float32)
    geo = dict(cfg=cfg, lay=lay, theta=cfg.rope_theta)
    tgeo = dict(cfg=tcfg, lay=tlay, theta=tcfg.rope_theta, impl=impl)
    if paged:
        pool, bt = _paged_state(rng, cfg, ctx, grow=20)
        layer = {n: a[0] for n, a in pool.items()}
        j_out, j_cache = JA.attn_packed_paged(
            jl, jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
            jnp.asarray(bt), positions=jnp.asarray(positions),
            seg_slots=jnp.asarray(seg), **geo)
        t_cache = _torch_pool({n: a[:1] for n, a in pool.items()})[0]
        t_out, _ = TA.attn_packed_paged(
            tl, torch.from_numpy(x)[None], t_cache, torch.from_numpy(bt),
            positions=torch.from_numpy(positions),
            seg_slots=torch.from_numpy(seg), **tgeo)
    else:
        cache = _random_cache(rng, cfg, 4, 40, ctx)
        layer = {n: a[0] for n, a in cache.items()}
        j_out, j_cache = JA.attn_packed(
            jl, jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
            positions=jnp.asarray(positions), seg_slots=jnp.asarray(seg),
            **geo)
        t_cache = _torch_cache({n: a[:1] for n, a in cache.items()})[0]
        t_out, _ = TA.attn_packed(
            tl, torch.from_numpy(x)[None], t_cache,
            positions=torch.from_numpy(positions),
            seg_slots=torch.from_numpy(seg), **tgeo)
    # the segment form leaves padding tokens' outputs at zero; the plain
    # form follows the reference on every token
    rows = seg >= 0 if impl == "pallas" else slice(None)
    _close(t_out[0][0][rows], np.asarray(j_out)[0][rows])
    _pools_close([t_cache], {n: np.asarray(a)[None]
                             for n, a in j_cache.items()})


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
@pytest.mark.parametrize("t,weave", [(48, True), (16, False)])
def test_packed_step_logits_and_cache_match(both, t, weave, paged, impl):
    """A whole packed forward, weave on (split 16 + 32, row 0's segment
    straddling the cut, so the suffix split reads the prefix split's
    keys) and off: sampled logits and the cache after the step."""
    mesh, jparams, cfg, pcfg, tparams, tcfg, tpcfg = both
    tpcfg = dataclasses.replace(tpcfg, attn_impl=impl)
    info = JT.weave_decision_info(1, t, tp=1, pcfg=pcfg, packed=True)
    assert info.weave == weave
    assert dataclasses.asdict(TT.weave_decision_info(
        1, t, tp=1, pcfg=tpcfg, packed=True)) == dataclasses.asdict(info)
    rng = np.random.RandomState(t)
    ctx, tokens, positions, seg, sample_idx = _packed_inputs(rng, cfg, t,
                                                             weave)
    if weave:
        cut = info.split[0]
        assert seg[cut - 1] == seg[cut] == 0          # straddles the cut
    if paged:
        cache, bt = _paged_state(rng, cfg, ctx, grow=20)
        t_cache = _torch_pool(cache)
        kw, tkw = ({"block_tables": jnp.asarray(bt)},
                   {"block_tables": torch.from_numpy(bt)})
    else:
        cache, kw, tkw = _random_cache(rng, cfg, 4, 40, ctx), {}, {}
        t_cache = _torch_cache(cache)

    def jfn(params, tok, cache, pos, seg, idx, kw):
        return JT.packed_step(params, tok, cache, cfg=cfg, pcfg=pcfg,
                              positions=pos, seg_slots=seg, sample_idx=idx,
                              **kw)

    j_logits, j_cache = _shard_run(
        mesh, jfn, jparams, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(positions),
        jnp.asarray(seg), jnp.asarray(sample_idx), kw)
    t_logits, t_cache = TT.packed_step(
        tparams, torch.from_numpy(tokens), t_cache, cfg=tcfg, pcfg=tpcfg,
        positions=torch.from_numpy(positions),
        seg_slots=torch.from_numpy(seg),
        sample_idx=torch.from_numpy(sample_idx), **tkw)
    assert t_logits.shape == (1, 4, 1, cfg.vocab_size)
    _close(t_logits[0], j_logits)
    _pools_close(t_cache, j_cache)


def test_paged_decode_step_matches(both):
    mesh, jparams, cfg, pcfg, tparams, tcfg, tpcfg = both
    rng = np.random.RandomState(41)
    pool, bt = _paged_state(rng, cfg, [5, 9, 2, 11])
    tokens = rng.randint(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    positions = np.array([[5], [9], [-1], [11]], np.int32)

    def jfn(params, tok, cache, pos, bt):
        return JT.decode_step(params, tok, cache, cfg=cfg, pcfg=pcfg,
                              positions=pos, block_tables=bt)

    j_logits, j_pool = _shard_run(
        mesh, jfn, jparams, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(positions),
        jnp.asarray(bt))
    t_logits, t_pool = TT.decode_step(
        tparams, torch.from_numpy(tokens), _torch_pool(pool), cfg=tcfg,
        pcfg=tpcfg, positions=torch.from_numpy(positions),
        block_tables=torch.from_numpy(bt))
    live = positions[:, 0] >= 0
    _close(t_logits[0][live], np.asarray(j_logits)[live])
    _pools_close(t_pool, j_pool)
