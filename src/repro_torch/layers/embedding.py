"""Vocab-sharded embedding, LM head, the cross-entropy and greedy argmax
over vocab-sharded logits, as ``repro.layers.embedding``.

Rank r holds vocabulary rows ``[r·V_loc, (r+1)·V_loc)`` of the padded
vocabulary (``V_pad = pad_to_multiple(V, tp)``), on the rank axis R
(``ctx.rank`` = 0) or, under the ``process_group`` backend, as the one
local rank of its process (``ctx.rank`` = its model rank).  The
embedding lookup gives *partial* rows, complete after the psum that the
entry norm's ``comm_norm`` folds in.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C


def embed_tokens(params, ids: torch.Tensor, *, scale: float = 1.0,
                 ctx=None):
    """ids (B, S) -> partial (R, B, S, d): rank r gathers the ids in its
    range and gives zero rows for the others (so do ids outside the
    vocabulary, as the reference's masked gather).  The table's first
    local rank is ``ctx.rank`` (0 without a ``ctx``)."""
    table = params["embed"]                      # (R, V_loc, d)
    r, v_loc, d = table.shape
    lo = torch.arange(r, device=ids.device)[:, None, None] * v_loc
    first = 0 if ctx is None else ctx.rank * v_loc
    local = ids.long()[None] - lo - first        # (R, B, S)
    in_range = (local >= 0) & (local < v_loc)
    out = table.reshape(r * v_loc, d)[local.clamp(0, v_loc - 1) + lo]
    out = torch.where(in_range[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out * scale if scale != 1.0 else out


def lm_head_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x (R, B, S, d), the same on every rank -> local logits
    (R, B, S, V_loc)."""
    r, b, s, d = x.shape
    w = (params["lm_head"] if "lm_head" in params        # (R, d, V_loc)
         else params["embed"].transpose(1, 2))           # tied
    return (x.reshape(r, b * s, d) @ w).reshape(r, b, s, -1)


def sharded_argmax(logits: torch.Tensor, *, vocab_size: int,
                   ctx=None) -> torch.Tensor:
    """Greedy ids (B, S) from vocab-sharded logits (R, B, S, V_loc): the
    global max over every rank's shard, the padded vocab tail masked to
    -inf, ties broken toward the smallest global id.  Each local rank
    gives its (max, first global id at it) as a float64 pair (both
    exact); the pairs of all tp ranks (``gather_ranks``: the rank axis
    itself, or the model group's under a ``process_group`` ``ctx``) give
    the largest max and, among equal ones, the smallest id."""
    r, b, s, v_loc = logits.shape
    first = 0 if ctx is None else ctx.rank
    col = ((torch.arange(r, device=logits.device)[:, None] + first) * v_loc
           + torch.arange(v_loc, device=logits.device))[:, None, None]
    lg = torch.where(col < vocab_size, logits.float(), float("-inf"))
    m = lg.max(dim=-1, keepdim=True).values                 # (R, B, S, 1)
    none = torch.full((), float("inf"), dtype=torch.float64,
                      device=logits.device)
    ids = torch.where(lg >= m, col.double(), none).amin(dim=-1)
    every = C.gather_ranks(torch.stack([m[..., 0].double(), ids], dim=1),
                           ctx)                             # (tp, 2, B, S)
    gmax = every[:, 0].amax(dim=0)
    return torch.where(every[:, 0] >= gmax, every[:, 1],
                       none).amin(dim=0).to(torch.int32)


def sharded_softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                         vocab_size: int, ignore_id: int = -100, ctx=None):
    """Cross-entropy over vocab-sharded logits (R, B, S, V_loc), rank r's
    shard the global ids ``[r·V_loc, (r+1)·V_loc)``, against global
    ``labels`` (B, S).  Returns (the summed loss over the labels that are
    not ``ignore_id``, their count), float32 scalars.

    As the reference: the padded vocabulary tail is -inf, the stability
    max (the max over every rank's shard) carries no gradient, the
    log-sum-exp sums each rank's partial sum of exponentials, and the
    label's logit is picked from the rank that holds it.  Under a
    ``process_group`` ``ctx`` the local shard is the process's rank's
    (``ctx.rank``), the max is a ``pmax`` over the model group and the two
    sums are ``psum``s, whose backward sums the ranks' cotangents
    (``distributed/collectives.py``); the loss is then the same on every
    model rank."""
    grouped = ctx is not None and ctx.process_group
    r, b, s, v_loc = logits.shape
    lg = logits.float()
    first = ctx.rank if grouped else 0
    lo = (torch.arange(r, device=lg.device)[:, None, None, None]
          + first) * v_loc
    col = lo + torch.arange(v_loc, device=lg.device)
    lg = torch.where(col < vocab_size, lg, float("-inf"))
    m = lg.detach().amax(dim=-1)                                # (R, B, S)
    m = C.pmax(m, ctx) if grouped else m.amax(dim=0)            # (B, S)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)               # (R, B, S)
    lse = torch.log(C.psum(se, ctx) if grouped else se.sum(dim=0)) + m
    local = labels.long()[None] - lo[..., 0]                    # (R, B, S)
    in_range = (local >= 0) & (local < v_loc)
    picked = torch.gather(lg, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = torch.where(in_range, picked, 0.0)
    correct = C.psum(picked, ctx) if grouped else picked.sum(dim=0)
    valid = labels != ignore_id
    nll = torch.where(valid, lse - correct, 0.0)
    return nll.sum(), valid.sum().to(torch.float32)
