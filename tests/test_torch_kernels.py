"""The PyTorch port's kernel modules against the JAX reference kernels.

The same seeded numpy inputs go through the Pallas kernels in interpret
mode (as tests/test_kernels.py runs them) and through the port's wrappers
on CPU tensors, which take the plain PyTorch versions.  The CUDA kernels
themselves are checked against these plain versions on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.layers.attention import _attn_ref as j_attn_ref
from repro.kernels.fused_rmsnorm import fused_residual_rmsnorm_pallas
from repro.kernels.ref import fused_residual_rmsnorm_ref

from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import fused_rmsnorm as K2

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _np(t) -> np.ndarray:
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


@pytest.mark.parametrize("t,d", [(8, 64), (64, 128), (128, 384), (56, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_matches_reference(t, d, dtype):
    rng = np.random.RandomState(t + d)
    x, tx = _pair(rng.randn(t, d).astype(np.float32), dtype)
    r, tr = _pair(rng.randn(t, d).astype(np.float32), dtype)
    w, tw = _pair((np.abs(rng.randn(d)) + 0.5).astype(np.float32), dtype)
    before = K2.fused_residual_rmsnorm.launches
    o_t, r_t = K2.fused_residual_rmsnorm(tx, tr, tw)
    assert K2.fused_residual_rmsnorm.launches == before
    assert o_t.dtype == tx.dtype and r_t.dtype == tr.dtype
    tol = 1e-6 if dtype == "float32" else 2e-2
    o_k, r_k = fused_residual_rmsnorm_pallas(x, r, w, interpret=True,
                                             block_tokens=32)
    o_ref, r_ref = fused_residual_rmsnorm_ref(x, r, w)
    for got, want in ((o_t, o_k), (r_t, r_k), (o_t, o_ref), (r_t, r_ref)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _positions(b, sq, sk, off, pad_keys=0, pad_queries=0):
    qpos = np.broadcast_to(np.arange(off, off + sq)[None], (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk)[None], (b, sk)).copy()
    if pad_keys:
        kpos[:, -pad_keys:] = -1            # empty cache slots
    if pad_queries:
        qpos[:, -pad_queries:] = -1         # padded prefill tokens
    return qpos.astype(np.int32), kpos.astype(np.int32)


@pytest.mark.parametrize(
    "b,sq,sk,kvh,g,dh,causal,window,off,pad_k,pad_q",
    [
        (2, 40, 72, 2, 3, 16, True, 0, 32, 0, 0),    # GQA + chunked offset
        (1, 64, 64, 1, 4, 32, True, 24, 0, 0, 0),    # sliding window
        (2, 33, 65, 2, 1, 16, False, 0, 0, 0, 0),    # bidirectional, ragged
        (1, 16, 128, 4, 2, 64, True, 0, 112, 0, 0),  # decode-ish long kv
        # padded keys (kpos -1) and fully masked query rows (qpos -1)
        (2, 24, 64, 2, 2, 16, True, 0, 40, 16, 5),
    ])
def test_flash_attention_matches_reference(b, sq, sk, kvh, g, dh, causal,
                                           window, off, pad_k, pad_q):
    rng = np.random.RandomState(sq + sk)
    q = rng.randn(b, sq, kvh, g, dh).astype(np.float32)
    k = rng.randn(b, sk, kvh, dh).astype(np.float32)
    v = rng.randn(b, sk, kvh, dh).astype(np.float32)
    qpos, kpos = _positions(b, sq, sk, off, pad_k, pad_q)
    # block_kv divides Sk in the padded case: the Pallas kernel's own
    # zero-padded keys would otherwise join a fully masked row's average
    block_kv = 32 if pad_q == 0 else sk
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(qpos), jnp.asarray(kpos), causal=causal,
                   window=window, block_q=16, block_kv=block_kv,
                   interpret=True)
    before = K3.flash_attention.launches
    got = K3.flash_attention(*(torch.from_numpy(a) for a in
                               (q, k, v, qpos, kpos)),
                             causal=causal, window=window)
    assert K3.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if pad_q:
        # a fully masked row is the uniform average of V over all keys
        mean_v = v.mean(axis=1)                       # (b, kvh, dh)
        np.testing.assert_allclose(
            got.numpy()[:, -1], np.broadcast_to(mean_v[:, :, None],
                                                (b, kvh, g, dh)),
            rtol=2e-5, atol=2e-5)


def _skipping_attention(q, k, v, qpos, kpos, live, *, causal, window,
                        queries_per_cta, keys_per_tile, scale):
    """What the bfloat16 kernel computes, in fp32: per q tile, an online
    softmax over the live key tiles of ``live`` only (masked logits at the
    finite NEG_INF inside a visited tile), then mean(V) over all Sk keys
    for each row whose running max stayed at NEG_INF."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    out = torch.empty(b, sq, kvh, g, dh)
    mean_v = v.mean(dim=1)                               # (b, kvh, dh)
    for bi in range(b):
        for qt in range(live.shape[1]):
            q0 = qt * queries_per_cta
            q1 = min(sq, q0 + queries_per_cta)
            qs = q[bi, q0:q1]                            # (n, kvh, g, dh)
            m = torch.full((q1 - q0, kvh, g), K3.NEG_INF)
            l = torch.zeros(q1 - q0, kvh, g)
            acc = torch.zeros(q1 - q0, kvh, g, dh)
            for kt in range(live.shape[2]):
                if not live[bi, qt, kt]:
                    continue
                k0, k1 = kt * keys_per_tile, min(sk, (kt + 1) * keys_per_tile)
                s = torch.einsum("qhgd,khd->qhgk", qs, k[bi, k0:k1]) * scale
                if live[bi, qt, kt] == 1:    # 2: every pair visible, no mask
                    vis = K3.attention_mask(qpos[bi:bi + 1, q0:q1],
                                            kpos[bi:bi + 1, k0:k1], causal,
                                            window)[0]   # (n, keys)
                    s = torch.where(vis[:, None, None, :], s, K3.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "qhgk,khd->qhgd", p, v[bi, k0:k1])
                m = m_new
            o = acc / l.clamp_min(1e-30)[..., None]
            masked = m == K3.NEG_INF
            o = torch.where(masked[..., None],
                            mean_v[bi][None, :, None, :].expand_as(o), o)
            out[bi, q0:q1] = o
    return out


# name: (b, sq, sk, kvh, g, dh, window, q0, cache keys valid, padded rows)
_SKIP_CASES = {
    "empty_cache_row": (1, 40, 64 + 40, 2, 8, 16, 0, 0, 0, 0),
    "split_behind_cache": (2, 24, 50 + 24, 2, 5, 16, 0, 50, 50, 0),
    "sliding_window": (1, 48, 60 + 48, 1, 1, 32, 20, 60, 60, 0),
    "padded_queries": (2, 30, 40 + 30, 2, 8, 16, 0, 40, 40, 6),
    "ragged_sk": (1, 21, 37 + 21, 3, 5, 16, 0, 30, 25, 3),
    "window_padded_g1": (1, 33, 70 + 33, 2, 1, 16, 24, 70, 64, 5),
}


def _skip_inputs(name):
    b, sq, sk, kvh, g, dh, window, q0, k_valid, pad = _SKIP_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    q = rng.randn(b, sq, kvh, g, dh).astype(np.float32)
    k = rng.randn(b, sk, kvh, dh).astype(np.float32)
    v = rng.randn(b, sk, kvh, dh).astype(np.float32)
    qpos = np.arange(q0, q0 + sq)
    kpos = np.full(sk, -1)                 # empty cache slots
    kpos[:k_valid] = np.arange(k_valid)    # valid cache keys
    kpos[sk - sq:] = qpos                  # the chunk's own keys
    if pad:
        qpos[-pad:] = -1                   # padded prefill rows ...
        kpos[-pad:] = -1                   # ... whose keys are padding
    qpos = np.broadcast_to(qpos, (b, sq)).astype(np.int32).copy()
    kpos = np.broadcast_to(kpos, (b, sk)).astype(np.int32).copy()
    return (q, k, v, qpos, kpos), window


def _tiling(g):
    """A small tiling with the kernel's shape: CTA rows = queries x G."""
    return max(1, 16 // g), 8


@pytest.mark.parametrize("name", sorted(_SKIP_CASES))
def test_live_tile_skipping_matches_reference(name):
    """The kernel's algorithm restricted to the live-tile table equals the
    model path's _attn_ref in fp32, rows with no visible key included."""
    (q, k, v, qpos, kpos), window = _skip_inputs(name)
    g, dh = q.shape[3], q.shape[4]
    qpc, kpt = _tiling(g)
    t = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    live = K3.live_tiles(t[3], t[4], causal=True, window=window,
                         queries_per_cta=qpc, keys_per_tile=kpt)
    assert live.shape == (q.shape[0], -(-q.shape[1] // qpc),
                          -(-k.shape[1] // kpt)) and live.dtype == torch.uint8
    assert 0 < int((live > 0).sum()) < live.numel()  # some tiles skipped
    got = _skipping_attention(*t, live, causal=True, window=window,
                              queries_per_cta=qpc, keys_per_tile=kpt,
                              scale=dh ** -0.5)
    want = j_attn_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                      causal=True, window=window, sm_scale=dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = K3.flash_attention_plain(*t, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    # every visible pair lies in a live tile; every pair of a full tile
    # (2) is visible and lies inside Sk
    vis = K3.attention_mask(t[3], t[4], True, window)     # (b, sq, sk)
    sk_pad = live.shape[2] * kpt
    vis = torch.nn.functional.pad(vis, (0, sk_pad - k.shape[1]))
    tile_of = live.repeat_interleave(qpc, 1)[:, :q.shape[1]] \
        .repeat_interleave(kpt, 2)
    assert not bool((vis & (tile_of == 0)).any())
    assert bool(vis[tile_of == 2].all())
    assert bool((live == 1).any())
    if window == 0:      # a 16-query tile never fits 8 keys in a window of 20
        assert bool((live == 2).any())


@pytest.mark.parametrize("name", ["empty_cache_row", "padded_queries"])
def test_live_tile_skipping_catches_a_dropped_live_tile(name):
    """Dropping one tile that holds a visible pair must break the match:
    the comparison above would catch a rule that skips too much."""
    (q, k, v, qpos, kpos), window = _skip_inputs(name)
    g, dh = q.shape[3], q.shape[4]
    qpc, kpt = _tiling(g)
    t = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    live = K3.live_tiles(t[3], t[4], causal=True, window=window,
                         queries_per_cta=qpc, keys_per_tile=kpt)
    bi, qt, kt = (int(i) for i in live.nonzero()[-1])  # the diagonal tile
    live[bi, qt, kt] = 0
    got = _skipping_attention(*t, live, causal=True, window=window,
                              queries_per_cta=qpc, keys_per_tile=kpt,
                              scale=dh ** -0.5)
    want = np.asarray(j_attn_ref(*(jnp.asarray(a) for a in
                                   (q, k, v, qpos, kpos)),
                                 causal=True, window=window,
                                 sm_scale=dh ** -0.5))
    assert np.abs(got.numpy() - want).max() > 1e-2


def test_kernel_input_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        K2.check_inputs(x, x, torch.zeros(64, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        K2.check_inputs(x, torch.zeros(64, 4).t(), torch.zeros(64))
    K2.check_inputs(x, x, torch.zeros(64))

    q = torch.zeros(1, 8, 2, 4, 32)
    k = torch.zeros(1, 16, 2, 32)
    qp = torch.zeros(1, 8, dtype=torch.int32)
    kp = torch.zeros(1, 16, dtype=torch.int32)
    K3.check_inputs(q, k, k, qp, kp)
    with pytest.raises(TypeError):
        K3.check_inputs(q, k, k, qp.long(), kp)
    with pytest.raises(ValueError):
        K3.check_inputs(torch.zeros(1, 8, 2, 4, 48), torch.zeros(1, 16, 2, 48),
                        torch.zeros(1, 16, 2, 48), qp, kp)
    with pytest.raises(ValueError):
        K3.check_inputs(q, k, k[:, :8], qp, kp)
    # the bfloat16 body (wgmma over 128-byte rows) takes head dims 64 and 128
    bf = dict(dtype=torch.bfloat16)
    for dh in (16, 32):
        with pytest.raises(ValueError, match="head dim"):
            K3.check_inputs(torch.zeros(1, 8, 2, 4, dh, **bf),
                            torch.zeros(1, 16, 2, dh, **bf),
                            torch.zeros(1, 16, 2, dh, **bf), qp, kp)
    for dh in (64, 128):
        K3.check_inputs(torch.zeros(1, 8, 2, 4, dh, **bf),
                        torch.zeros(1, 16, 2, dh, **bf),
                        torch.zeros(1, 16, 2, dh, **bf), qp, kp)
