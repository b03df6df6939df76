"""Speculative decoding, as ``repro.runtime.spec``: draft proposers and
the multi-token verification rules over vocab-sharded logits.

A draft proposes gamma tokens, the target model scores the window of
1 + gamma tokens in ONE forward, and verification commits the longest
accepted prefix plus one corrected or bonus token, so a decode
iteration carries ``B * (gamma+1)`` tokens: decode looks like a small
prefill and can cross the weave's threshold.

* greedy (temperature == 0): a draft token is accepted iff it equals the
  target argmax at its position, and the emitted token IS the target
  argmax, so the committed stream is token-identical to plain greedy
  decoding;
* stochastic: each draft token is a deterministic proposal, accepted
  with probability p_target(d); on rejection the token is drawn from
  p(x)/(1-p(d)), x != d.  For any draft, P(committed = x) = p_target(x).

Both rules take logits ``(R, B, gamma+1, V_loc)`` on the rank axis and
reduce over dim 0 where the reference reduces over the mesh axis; the
stochastic rule draws its uniforms and Gumbel noise from an explicit
``torch.Generator``.  Drafting is host work on the requests' token
lists; ``ModelDraft`` runs its rollout forwards on the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.layers import embedding as E
from repro_torch.runtime.sampler import (filtered_logits, gumbel_argmax,
                                         vocab_cols)

# ==========================================================================
# device side: verification over vocab-sharded logits
# ==========================================================================


def _leading_accepts(accept) -> torch.Tensor:
    """(B, gamma) bool -> (B,) length of the leading all-True run."""
    return torch.cumprod(accept.long(), dim=1).sum(dim=1)


def verify_greedy(logits, draft, *, vocab_size: int):
    """Greedy verification.  logits (R, B, gamma+1, V_loc); draft (B,
    gamma) integer, -1 = no proposal.  Returns (n_acc (B,), emit (B,)):
    the accepted draft tokens and the one extra committed token, the
    target argmax at the first mismatch (correction) or at the window's
    end (bonus)."""
    gamma = draft.shape[1]
    draft = draft.to(logits.device)
    tgt = E.sharded_argmax(logits, vocab_size=vocab_size)    # (B, gamma+1)
    match = (draft == tgt[:, :gamma]) & (draft >= 0)
    n_acc = _leading_accepts(match)
    emit = torch.gather(tgt, 1, n_acc[:, None])[:, 0]
    return n_acc, emit


def verify_sample(logits, draft, generator: torch.Generator, *,
                  vocab_size: int, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Stochastic rejection-sampling verification (the deterministic-
    proposal rule of the module docstring) against the temperature/
    top-k/top-p-filtered softmax.  Draws, in order: gamma uniforms per
    row, Gumbel noise over the window's first gamma positions (the
    residuals), Gumbel noise over its last (the bonus).  Returns
    (n_acc (B,), emit (B,))."""
    r, b, s, v_loc = logits.shape
    gamma = draft.shape[1]
    draft = draft.to(logits.device).long()
    lg = filtered_logits(logits, vocab_size=vocab_size,
                         temperature=temperature, top_k=top_k, top_p=top_p)

    # p_target(draft_i | window prefix): a stable softmax over all ranks
    m = lg.amax(dim=-1).amax(dim=0)                           # (B, S)
    z = torch.exp(lg - m[None, ..., None]).sum(dim=-1).sum(dim=0)
    lo = torch.arange(r, device=lg.device)[:, None, None] * v_loc
    d_loc = draft[None] - lo                                  # (R, B, gamma)
    in_range = (d_loc >= 0) & (d_loc < v_loc) & (draft >= 0)[None]
    picked = torch.gather(lg[:, :, :gamma], 3,
                          d_loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    p_draft = torch.where(
        in_range, torch.exp(picked - m[None, :, :gamma]) / z[None, :, :gamma],
        0.0).sum(dim=0)                                       # (B, gamma)

    u = torch.rand((b, gamma), generator=generator, device=lg.device)
    accept = (u < p_draft) & (draft >= 0)
    n_acc = _leading_accepts(accept)

    # residual samples: the drafted token's mass removed at each position,
    # the rest renormalized, by Gumbel-max over the masked logits
    drafted_here = (vocab_cols(lg) == draft[None, ..., None]) & \
        (draft >= 0)[None, ..., None]                         # (R,B,gamma,V)
    residual = torch.where(drafted_here, float("-inf"), lg[:, :, :gamma])
    res = gumbel_argmax(residual, generator, vocab_size=vocab_size)
    bonus = gumbel_argmax(lg[:, :, gamma:], generator,
                          vocab_size=vocab_size)[:, 0]
    cand = torch.cat([res, bonus[:, None]], dim=1)            # (B, gamma+1)
    emit = torch.gather(cand, 1, n_acc[:, None])[:, 0]
    return n_acc, emit


def verify_tokens(logits, draft, generator=None, *, vocab_size: int,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Greedy verification at temperature 0, rejection sampling above."""
    if temperature <= 0.0:
        return verify_greedy(logits, draft, vocab_size=vocab_size)
    if generator is None:
        raise ValueError("stochastic verification needs a torch.Generator")
    return verify_sample(logits, draft, generator, vocab_size=vocab_size,
                         temperature=temperature, top_k=top_k, top_p=top_p)


# ==========================================================================
# host side: draft proposers
# ==========================================================================


class DraftProposer:
    """Interface: ``propose(contexts)`` maps each request's full token
    context (prompt + generated so far, INCLUDING the pending decode input)
    to at most ``gamma`` proposed continuation tokens."""

    gamma: int

    def propose(self, contexts: Sequence[Sequence[int]]) -> List[List[int]]:
        raise NotImplementedError


class NgramDraft(DraftProposer):
    """Prompt-lookup / n-gram drafting: match the context's trailing n-gram
    against earlier context (most recent occurrence wins, longer n-grams
    tried first) and propose the tokens that followed it."""

    def __init__(self, gamma: int, n: int = 3, min_n: int = 1):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.gamma = gamma
        self.n = n
        self.min_n = min_n

    def _propose_one(self, ctx: Sequence[int]) -> List[int]:
        ctx = list(ctx)
        for n in range(min(self.n, len(ctx) - 1), self.min_n - 1, -1):
            pat = ctx[-n:]
            # most recent earlier occurrence; the range start excludes the
            # trailing self-match, so the continuation is never empty
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    return ctx[i + n:i + n + self.gamma]
        return []

    def propose(self, contexts):
        return [self._propose_one(c) for c in contexts]


class ModelDraft(DraftProposer):
    """Small-draft-model proposer over ``models/build.ModelApi``: gamma
    greedy rollout steps, each a full-context forward of the draft model
    on the params' device.  Stateless, as the reference's: no KV cache,
    lengths bucketed to ``len_bucket``, the batch padded to a multiple of
    ``max_batch``.  Its greediness affects only the acceptance rate, never
    the committed tokens."""

    def __init__(self, api, params, gamma: int, *, len_bucket: int = 64,
                 max_batch: int = 8):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.api = api
        self.params = params
        self.gamma = gamma
        self.len_bucket = len_bucket
        self.max_batch = max_batch
        self.device = params["embedding"]["embed"].device

    @torch.no_grad()
    def _next_tokens(self, tokens, positions, last_idx) -> np.ndarray:
        h, _ = self.api.forward(self.params, tokens, positions)
        r, _, _, d = h.shape
        idx = last_idx[None, :, None, None].expand(r, -1, 1, d)
        lg = E.lm_head_logits(self.params["embedding"], torch.gather(h, 2, idx))
        return E.sharded_argmax(lg, vocab_size=self.api.cfg.vocab_size
                                )[:, 0].cpu().numpy()

    def propose(self, contexts):
        ctxs = [list(c) for c in contexts]
        props: List[List[int]] = [[] for _ in ctxs]
        lb = self.len_bucket
        b = self.max_batch * (-(-max(len(ctxs), 1) // self.max_batch))
        for _ in range(self.gamma):
            lens = [len(c) + len(p) for c, p in zip(ctxs, props)]
            s = max(lb, ((max(lens) + lb - 1) // lb) * lb)
            tokens = np.zeros((b, s), np.int64)
            positions = np.full((b, s), -1, np.int32)
            last_idx = np.zeros(b, np.int64)
            for i, (c, p) in enumerate(zip(ctxs, props)):
                row = c + p
                tokens[i, :len(row)] = row
                positions[i, :len(row)] = np.arange(len(row))
                last_idx[i] = len(row) - 1
            nxt = self._next_tokens(
                *(torch.from_numpy(a).to(self.device)
                  for a in (tokens, positions, last_idx)))
            for i in range(len(ctxs)):
                props[i].append(int(nxt[i]))
        return props


def make_draft(kind: str, gamma: int, *, ngram: int = 3) -> DraftProposer:
    """The engine's default draft (model drafts are built by the caller,
    who owns the draft params)."""
    if kind == "ngram":
        return NgramDraft(gamma, n=ngram)
    raise ValueError(f"unknown draft kind {kind!r} "
                     "(pass a ModelDraft instance for model drafting)")


# ==========================================================================
# stats
# ==========================================================================


@dataclasses.dataclass
class SpecStats:
    verify_steps: int = 0        # engine iterations that ran a verify batch
    draft_proposed: int = 0      # draft tokens scored by the target model
    draft_accepted: int = 0      # draft tokens committed
    emitted: int = 0             # all committed tokens (accepted + 1/req)

    @property
    def acceptance_rate(self) -> float:
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed else 0.0)

    @property
    def tokens_per_step(self) -> float:
        """Mean committed tokens per verified sequence per engine step
        (plain decode == 1.0 by definition)."""
        seqs = self.emitted - self.draft_accepted   # one bonus/correction each
        return self.emitted / seqs if seqs else 0.0
