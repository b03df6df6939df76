"""Embedding, LM head and greedy argmax over vocab-sharded logits
(``repro.layers.embedding``) at tp=1: one shard holds the whole
(possibly padded) vocabulary."""
from __future__ import annotations

import torch


def embed_tokens(params, ids: torch.Tensor, *, scale: float = 1.0):
    """ids: (B, S) int -> (B, S, d).  Ids outside the table give zero rows,
    as the reference's masked gather does."""
    table = params["embed"]                      # (V_pad, d)
    v = table.shape[0]
    in_range = (ids >= 0) & (ids < v)
    out = table[ids.long().clamp(0, v - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))
    return out * scale if scale != 1.0 else out


def lm_head_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> logits (B, S, V_pad)."""
    if "lm_head" in params:
        return x @ params["lm_head"]             # (d, V_pad)
    return x @ params["embed"].t()               # tied


def sharded_argmax(logits: torch.Tensor, *, vocab_size: int) -> torch.Tensor:
    """Greedy ids (B, S) from (B, S, V_pad) logits.  The padded vocab tail
    is masked to -inf; ties break toward the smallest id."""
    lg = logits.float()
    col = torch.arange(lg.shape[-1], device=lg.device)
    lg = torch.where(col < vocab_size, lg, float("-inf"))
    gmax = lg.max(dim=-1, keepdim=True).values
    big = torch.iinfo(torch.int32).max
    cand = torch.where(lg >= gmax, col.to(torch.int32),
                       torch.full((), big, dtype=torch.int32,
                                  device=lg.device))
    return cand.min(dim=-1).values
