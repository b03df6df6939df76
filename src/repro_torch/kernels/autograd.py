"""Kernels K2 and K3 inside ``torch.autograd``.

The reference's Pallas kernels have no backward (no ``custom_vjp``): its
training differentiates through what ``jax.grad`` makes of them.  Here
each kernel is a ``torch.autograd.Function`` whose forward is the
kernel's wrapper (the hand-written kernel on CUDA tensors, its plain
version on CPU and meta tensors) and whose backward runs the plain
version again from the saved inputs under ``torch.enable_grad()`` and
returns its gradients.  A backward kernel is queued in ROADMAP.md.

``kernels/ops.py`` applies these only where a gradient may be asked
(``needs_grad``); serving calls the wrappers directly.  K1 has no
backward: the training comm modes (vanilla, reordered, fused, nocomm)
never reach it, and ``ops.ar_rmsnorm`` refuses a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import fused_rmsnorm as K2


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def _plain_grads(ctx, fn, grads_out):
    """Gradients of ``fn`` (the plain version) at the saved inputs, for
    the inputs that need them; None elsewhere."""
    saved = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need) if t.is_floating_point()
              else t for t, need in zip(saved, ctx.needs_input_grad)]
    wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
    with torch.enable_grad():
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  wanted, [g for _, g in pairs],
                                  allow_unused=True)
    it = iter(got)
    return tuple(next(it) if need else None
                 for need in ctx.needs_input_grad[:len(saved)])


class FusedResidualRMSNorm(torch.autograd.Function):
    """K2: (normed, new_residual) = fused_residual_rmsnorm(x, residual,
    weight)."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps: float):
        ctx.eps = eps
        ctx.save_for_backward(x, residual, weight)
        return K2.fused_residual_rmsnorm(x, residual, weight, eps=eps)

    @staticmethod
    def backward(ctx, g_out, g_res):
        grads = _plain_grads(
            ctx, lambda x, r, w: K2.fused_residual_rmsnorm_plain(
                x, r, w, ctx.eps), (g_out, g_res))
        return (*grads, None)


class FlashAttention(torch.autograd.Function):
    """K3: out = flash_attention(q, k, v, qpos, kpos)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal: bool, window: int,
                sm_scale):
        ctx.kw = dict(causal=causal, window=window, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, qpos, kpos)
        return K3.flash_attention(q, k, v, qpos, kpos, **ctx.kw)

    @staticmethod
    def backward(ctx, g_out):
        grads = _plain_grads(
            ctx, lambda q, k, v, qp, kp: K3.flash_attention_plain(
                q, k, v, qp, kp, **ctx.kw), (g_out,))
        return (*grads, None, None, None)
