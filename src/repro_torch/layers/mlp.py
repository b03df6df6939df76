"""Gated FFN (SwiGLU for the llama family), as ``repro.layers.mlp``.

At tp=1 the down projection's output is complete; the reduction slot
that follows is ``core.fused_collectives.comm_norm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_forward(params, x: torch.Tensor, *, act: str = "silu"):
    """x: (B, S, d) -> (B, S, d).  The activation runs in float32 and is
    cast back to x.dtype before the product with the up projection."""
    if "w_gate" not in params:
        raise NotImplementedError(
            "only the gated (silu/geglu) FFN is ported (ROADMAP.md A10)")
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    gf = g.float()
    gact = F.gelu(gf, approximate="tanh") if act == "geglu" else F.silu(gf)
    h = gact.to(x.dtype) * u
    return h @ params["w_down"]
