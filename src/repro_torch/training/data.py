"""Synthetic LM data pipeline: deterministic, shardable, host-side, as
``repro.training.data`` (a copy of its numpy code: batches are bit-equal
to the reference's for the same seed, step and host).

Generates a stationary Markov-chain token stream (learnable structure, so
tiny-model training loss visibly decreases) with per-host sharding by batch
index — the pattern a real pipeline (e.g. grain) would follow.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, order: int = 2):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        rng = np.random.RandomState(seed)
        # sparse-ish transition table -> learnable bigram structure
        self._table = rng.randint(0, vocab, size=(vocab, 4))
        self._seed = seed

    def batch(self, step: int, host_index: int = 0, host_count: int = 1):
        b_local = self.global_batch // host_count
        rng = np.random.RandomState((self._seed, step, host_index))
        toks = np.empty((b_local, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, size=b_local)
        choices = rng.randint(0, 4, size=(b_local, self.seq_len))
        noise = rng.random(size=(b_local, self.seq_len)) < 0.05
        rand_tok = rng.randint(0, self.vocab, size=(b_local, self.seq_len))
        for t in range(self.seq_len):
            nxt = self._table[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def family_inputs(cfg, batch: dict, step: int, *, seed: int = 0,
                  image_rows: int = 8) -> dict:
    """``batch`` with the inputs a family's ``train_loss`` takes beside
    the tokens, drawn from (``seed``, ``step``) for every row at once, so
    that any data-parallel shard's rows are the same wherever they are
    cut: encdec's stub frame embeddings ``frames`` (B,
    ``cfg.max_source_positions``, d), and vlm's ``image_rows`` patch
    embeddings in front of the text (``extra_embeds`` (B, image_rows,
    d)) with their M-RoPE ids (``mrope_positions`` (B, 3, image_rows +
    S), image then text, each row of ids the 1-D positions); float32.
    Other families' batches come back as they are."""
    b, s = batch["tokens"].shape
    rng = np.random.RandomState((seed, step, 1))
    out = dict(batch)
    if cfg.family == "encdec":
        out["frames"] = rng.randn(b, cfg.max_source_positions,
                                  cfg.d_model).astype(np.float32)
    elif cfg.family == "vlm":
        out["extra_embeds"] = rng.randn(b, image_rows,
                                        cfg.d_model).astype(np.float32)
        out["mrope_positions"] = np.broadcast_to(
            np.arange(image_rows + s, dtype=np.int32)[None, None],
            (b, 3, image_rows + s)).copy()
    return out
