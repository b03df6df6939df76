"""Token sampling over vocab-sharded logits, as ``repro.runtime.sampler``.

Everything here takes logits ``(R, B, S, V_loc)`` on the rank axis and
composes what the reference does with collectives as reductions over
dim 0, never gathering the full vocabulary into one row:

* greedy / Gumbel-max sampling -> ``sharded_argmax`` (ties broken toward
  the smallest id);
* top-k -> the global k-th largest logit is found among the ranks'
  top-k candidates, concatenated over ranks (k·R scalars, not V);
* top-p (nucleus) -> the probability threshold is found by the
  reference's fixed 30-step bisection on the kept mass summed over
  ranks, so the kept set is the reference's (up to a probability within
  about 2^-30 of the threshold, where the sums' order can decide).

Randomness comes only from an explicit ``torch.Generator`` on the
logits' device, never from the global RNG.

Under a ``process_group`` ``ctx`` (``distributed/context.py``) the logits
are this process's shard (1, B, S, V_loc) and each reduction over the
ranks goes over the model group (``distributed/collectives.py``): the
top-k candidates are gathered, the top-p maxima and sums reduced, and
the Gumbel argmax gathers each rank's (max, id).  Every rank draws the
noise of all tp shards and keeps its own, so a seeded draw is the rank
axis's draw, token for token.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.layers.embedding import sharded_argmax

NEG_INF = -1e30


def vocab_cols(local_logits, ctx=None) -> torch.Tensor:
    """Global vocab id of each local column: (R, 1, .., V_loc)."""
    r, v_loc = local_logits.shape[0], local_logits.shape[-1]
    first = 0 if ctx is None else ctx.rank
    col = ((torch.arange(r, device=local_logits.device)[:, None] + first)
           * v_loc + torch.arange(v_loc, device=local_logits.device))
    return col.reshape((r,) + (1,) * (local_logits.ndim - 2) + (v_loc,))


def _mask_vocab_pad(local_logits, *, vocab_size: int, ctx=None):
    """float32 local logits with the padded vocab tail forced to -inf."""
    return torch.where(vocab_cols(local_logits, ctx) < vocab_size,
                       local_logits.float(), NEG_INF)


def apply_top_k(local_logits, k: int, ctx=None):
    """Mask local logits below the global k-th largest value to -inf.
    Ties at the threshold are all kept (the set may exceed k)."""
    if k <= 0:
        return local_logits
    v_loc = local_logits.shape[-1]
    cand = local_logits.topk(min(k, v_loc), dim=-1).values  # (R, .., k_loc)
    cand = C.gather_ranks(cand, ctx)                        # (tp, .., k_loc)
    cand = cand.movedim(0, -2).flatten(-2)                  # (.., tp·k_loc)
    thresh = cand.topk(min(k, cand.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(local_logits >= thresh[None], local_logits, NEG_INF)


def apply_top_p(local_logits, p: float, *, iters: int = 30, ctx=None):
    """Nucleus filtering: keep the smallest set of tokens whose mass
    reaches ``p`` (the crossing token included), -inf elsewhere: a
    bisection for the largest probability threshold t with
    mass{prob >= t} >= p, one sum over ranks per step."""
    if p >= 1.0:
        return local_logits
    lg = local_logits.float()
    m = C.pmax(lg.amax(dim=-1), ctx)                        # (..)
    e = torch.exp(lg - m[None, ..., None])
    z = C.psum(e.sum(dim=-1), ctx)
    prob = e / z[None, ..., None]
    lo = torch.zeros_like(m)
    hi = C.pmax(prob.amax(dim=-1), ctx)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = C.psum(torch.where(prob >= mid[None, ..., None], prob,
                                  0.0).sum(dim=-1), ctx)
        ok = mass >= p                 # threshold still admissible -> raise
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(prob >= lo[None, ..., None], local_logits, NEG_INF)


def filtered_logits(local_logits, *, vocab_size: int,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, ctx=None):
    """Target-distribution logits: temperature scaling, then top-k, then
    top-p, with the padded vocab tail masked throughout.  float32."""
    lg = _mask_vocab_pad(local_logits, vocab_size=vocab_size, ctx=ctx)
    if temperature > 0.0:
        lg = lg / temperature
    lg = apply_top_k(lg, top_k, ctx=ctx)
    return apply_top_p(lg, top_p, ctx=ctx)


def gumbel_argmax(local_logits, generator: torch.Generator, *,
                  vocab_size: int, ctx=None):
    """One Gumbel-max draw per row (B, S) from (already filtered) local
    logits: one standard Gumbel per vocabulary entry of every rank, drawn
    from ``generator`` (under a process group every rank draws all tp
    shards' noise and keeps its own)."""
    r = local_logits.shape[0]
    tp, first = (r, 0) if ctx is None else (ctx.tp, ctx.rank)
    u = torch.rand((tp, *local_logits.shape[1:]), generator=generator,
                   device=local_logits.device)[first:first + r]
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return sharded_argmax(local_logits.float() + g, vocab_size=vocab_size,
                          ctx=ctx)


def sample(logits, *, vocab_size: int, temperature: float = 0.0,
           top_k: int = 0, top_p: float = 1.0,
           generator: torch.Generator = None, ctx=None):
    """Vocab-sharded logits (R, B, 1, V_loc) -> token ids (B,).
    temperature == 0 is greedy with ties broken toward the smallest id;
    otherwise temperature/top-k/top-p filtering and one Gumbel-max draw
    from ``generator``.  ``ctx``: a ``process_group`` CommCtx when the
    logits are one process's shard."""
    if temperature <= 0.0:
        return sharded_argmax(logits, vocab_size=vocab_size, ctx=ctx)[:, 0]
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    lg = filtered_logits(logits, vocab_size=vocab_size,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         ctx=ctx)
    return gumbel_argmax(lg, generator, vocab_size=vocab_size,
                         ctx=ctx)[:, 0]
