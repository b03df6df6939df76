"""Rotary position embeddings, rotate-half (llama) convention, as
``repro.layers.rotary``: standard RoPE and Qwen2-VL's M-RoPE."""
from __future__ import annotations

import torch


def _freqs(dim: int, theta: float, device) -> torch.Tensor:
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh) rotated by angles (B, S, dh/2), in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, dh); positions: (B, S)."""
    freq = _freqs(x.shape[-1], theta, positions.device)
    return _rotate(x, positions.float()[..., None] * freq)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float):
    """Qwen2-VL M-RoPE.  x: (B, S, H, dh); positions3: (B, 3, S), the
    (temporal, height, width) ids; ``sections`` splits the dh/2 frequency
    bands, band r rotated by position row r.  Text tokens carry equal
    t/h/w ids, for which M-RoPE is plain RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    freq = _freqs(x.shape[-1], theta, positions3.device)
    ang = positions3.float()[..., None] * freq           # (B, 3, S, half)
    bands, lo = [], 0
    for r, sec in enumerate(sections):
        bands.append(ang[:, r, :, lo:lo + sec])
        lo += sec
    return _rotate(x, torch.cat(bands, dim=-1))
