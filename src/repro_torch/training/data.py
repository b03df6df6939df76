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
