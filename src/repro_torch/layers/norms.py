"""RMSNorm and the unfused residual-add + RMSNorm, with float32 math
whatever the activation dtype (as ``repro.layers.norms``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def residual_rmsnorm_unfused(x, residual, weight, eps: float = 1e-6):
    """Two-pass form: r = residual + x (rounded to the residual dtype),
    then out = rms_norm(r).  Returns (out, r)."""
    r = (residual.float() + x.float()).to(residual.dtype)
    return rms_norm(r, weight, eps), r
