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
