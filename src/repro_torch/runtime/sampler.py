"""Token sampling, as ``repro.runtime.sampler``; greedy only so far."""
from __future__ import annotations

from repro_torch.layers.embedding import sharded_argmax


def sample(logits, *, vocab_size: int, temperature: float = 0.0):
    """Vocab-sharded logits (R, B, 1, V_loc) -> token ids (B,).
    temperature == 0 is greedy with ties broken toward the smallest id."""
    if temperature > 0.0:
        raise NotImplementedError("stochastic sampling is not ported yet "
                                  "(ROADMAP.md A6)")
    return sharded_argmax(logits, vocab_size=vocab_size)[:, 0]
