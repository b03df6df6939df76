"""The port's training path against the JAX reference on the CPU, part
two: ``train_loss`` and its gradient for the ssm, hybrid and encdec
families (``test_torch_training.check_family``: the loss within 1e-5
relative, every gradient leaf within 1e-4 of max(1, the leaf's largest
magnitude)); the K2 / K3 autograd Functions against autograd through the
plain versions (within 1e-6) and K1 refusing a gradient; the training
form of the Mamba-1 scan bit-equal to the serving form.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import fused_rmsnorm as K2
from repro_torch.kernels import ops
from repro_torch.layers import ssm as TS
from test_torch_training import check_family

FN_TOL = 1e-6


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec"])
def test_train_loss_and_gradients_match_reference(family, mesh11):
    check_family(family, mesh11)


# --------------------------------------------------------------------------
# the kernels inside autograd; the training form of the scan
# --------------------------------------------------------------------------

def _autograd(fn, inputs, g_out):
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, [t for t in leaves if t.requires_grad],
                                g_out)
    return outs, grads


@pytest.mark.parametrize("window", [0, 6])
def test_k3_autograd_function_matches_plain(window):
    g = torch.Generator().manual_seed(window)
    b, s, kvh, grp, dh = 2, 24, 2, 3, 16
    q = torch.randn(b, s, kvh, grp, dh, generator=g)
    k = torch.randn(b, s, kvh, dh, generator=g)
    v = torch.randn(b, s, kvh, dh, generator=g)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s).contiguous()
    g_out = (torch.randn(b, s, kvh, grp, dh, generator=g),)
    kw = dict(causal=True, window=window)
    got = _autograd(lambda q, k, v: ops.flash_attention(q, k, v, pos, pos,
                                                        **kw),
                    (q, k, v), g_out)
    want = _autograd(lambda q, k, v: K3.flash_attention_plain(
        q, k, v, pos, pos, **kw), (q, k, v), g_out)
    for a, b_ in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b_, rtol=FN_TOL, atol=FN_TOL)


def test_k2_autograd_function_matches_plain_and_k1_refuses_a_gradient():
    g = torch.Generator().manual_seed(2)
    x, r = torch.randn(12, 32, generator=g), torch.randn(12, 32, generator=g)
    w = 1 + 0.1 * torch.randn(32, generator=g)
    g_out = (torch.randn(12, 32, generator=g), torch.randn(12, 32,
                                                           generator=g))
    got = _autograd(lambda x, r, w: ops.fused_residual_rmsnorm(
        x, r, w, use_pallas=True), (x, r, w), g_out)
    want = _autograd(lambda x, r, w: K2.fused_residual_rmsnorm_plain(
        x, r, w), (x, r, w), g_out)
    for a, b_ in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b_, rtol=FN_TOL, atol=FN_TOL)
    xs = torch.randn(2, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ar_rmsnorm(xs, torch.zeros(2, 4, 32), w, use_pallas=True)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_training_scan_bit_equal_to_serving_scan(n):
    g = torch.Generator().manual_seed(n)
    a = torch.rand(2, 3, n, 4, 5, generator=g)
    b = torch.randn(2, 3, n, 4, 5, generator=g)
    h = torch.randn(2, 3, 4, 5, generator=g)
    serve = TS._prefix_scan(a, b, 2)
    train = TS._prefix_scan_train(a, b, 2)
    for s_, t_ in zip(serve, train):
        assert torch.equal(s_, t_)
    h_s, end_s = TS._scan_chunk(a, b, h, 2)
    h_t, end_t = TS._scan_chunk(a.requires_grad_(), b, h, 2)
    assert torch.equal(h_s, h_t.detach()) and torch.equal(end_s,
                                                          end_t.detach())
    h_t.sum().backward()
    assert torch.isfinite(a.grad).all()
