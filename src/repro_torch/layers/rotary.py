"""Rotary position embeddings, rotate-half (llama) convention, as
``repro.layers.rotary.apply_rope``.  M-RoPE comes with the VLM family."""
from __future__ import annotations

import torch


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim//2), float32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, dh); positions: (B, S)."""
    dh = x.shape[-1]
    cos, sin = _rope_angles(positions, dh, theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
