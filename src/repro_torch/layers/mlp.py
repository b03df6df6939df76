"""Tensor-parallel FFN, as ``repro.layers.mlp``: column-parallel up/gate,
row-parallel down, batched over the rank axis R.  The output is *partial*
over the ranks; its reduction is ``core.fused_collectives.comm_norm``, so
the AllReduce fuses with the residual add and the RMSNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_forward(params, x: torch.Tensor, *, act: str = "silu", ctx=None):
    """x (R, B, S, d), the same on every rank -> partial (R, B, S, d).
    Activations run in float32 and are cast back to x.dtype.  The psum
    sums over ``ctx.tp`` ranks (R without a ``ctx``: a process of a
    group holds one of them)."""
    r, b, s, d = x.shape
    xf = x.reshape(r, b * s, d)
    if "w_gate" in params:
        g = xf @ params["w_gate"]                # (R, T, f/R)
        u = xf @ params["w_up"]
        gf = g.float()
        gact = F.gelu(gf, approximate="tanh") if act == "geglu" else F.silu(gf)
        out = (gact.to(x.dtype) * u) @ params["w_down"]
    else:
        h = xf @ params["w_in"] + params["b_in"][:, None]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        # the psum downstream sums tp copies of the bias: pre-divide
        tp = r if ctx is None else ctx.tp
        out = h @ params["w_out"] + params["b_out"] / tp
    return out.reshape(r, b, s, d)
