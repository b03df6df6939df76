"""Slot KV cache management, as ``repro.runtime.kv_cache``: per-request
slots of fixed length C, with ring-buffer insertion for sliding-window
layers (C = window).  The cache is a list with one {"k", "v", "pos"} dict
per layer: k and v are (R, B, C, kv_store, dh), one slab per rank of the
rank axis, and pos is (B, C), the same on every rank.  ``insert_chunk``
and ``reset_slots`` update it in place, across all ranks.  With a data
axis D (``distributed/context.py``) the cache keeps the reference's
global layout: B holds the D data shards' rows one shard after the other,
or, under ``seq_shard_kv``, a full-attention layer's C slots lie over the
D shards (shard d owning ``[d·C/D, (d+1)·C/D)``) and a position p still
goes to slot ``p % C``; so every function here serves both unchanged.

The encdec family's cache is {"self": such a list, "cross": per decoder
layer the encoder's projected keys and values, one whole row per slot},
written by ``insert_chunk`` and ``write_rows``.

The ssm family's slot cache is its stacked recurrent state instead
(``layers/ssm.py``: nested tuples of (L, R or 1, B, ...) leaves, the slot
on dim 2); ``gather_state_rows`` and ``scatter_state_rows`` move a
prefill group's rows out of it and back.
"""
from __future__ import annotations

import torch


def insert_chunk(cache, kv_chunk, offsets, slot_ids):
    """Write a prefill chunk's KV into the slots ``slot_ids``.

    kv_chunk: per layer (k (R, B, S, h, dh), v, pos (B, S)); offsets (B,):
    the chunk's first position per row.  The chunk is written in segments
    of at most C positions, so a chunk longer than a ring window writes in
    order; entries with pos < 0 (padding) are dropped instead of
    clobbering live slots."""
    for layer, (k, v, pos) in zip(cache, kv_chunk):
        b_sel, s = pos.shape
        c = layer["k"].shape[2]
        dev = pos.device
        bidx = slot_ids.to(dev).long()[:, None].expand(b_sel, min(s, c))
        for lo in range(0, s, c):
            ks, vs = k[:, :, lo:lo + c], v[:, :, lo:lo + c]
            ps = pos[:, lo:lo + c]
            seg = ps.shape[1]
            slots = (offsets.to(dev).long()[:, None] + lo
                     + torch.arange(seg, device=dev)[None, :]) % c
            keep = ps >= 0
            rows = bidx[:, :seg][keep]
            cols = slots[keep]
            layer["k"][:, rows, cols] = ks[:, keep].to(layer["k"].dtype)
            layer["v"][:, rows, cols] = vs[:, keep].to(layer["v"].dtype)
            layer["pos"][rows, cols] = ps[keep].to(torch.int32)
    return cache


def write_rows(cache, rows, slot_ids):
    """Write whole cache rows into the slots ``slot_ids``: ``rows`` per
    layer {"k", "v" (R, B_sel, C, h, dh), "pos" (B_sel, C)} of the cache's
    row length C (the encdec cross caches that ``prefill`` returns)."""
    for layer, src in zip(cache, rows):
        idx = slot_ids.to(layer["pos"].device).long()
        for name, t in src.items():
            dst = layer[name]
            if name == "pos":
                dst[idx] = t.to(dst.dtype)
            else:
                dst[:, idx] = t.to(dst.dtype)
    return cache


def gather_slots(cache, slot_ids):
    """Copies of the cache rows of the given slots (same structure)."""
    idx = slot_ids.long()
    return [{name: (t[idx] if name == "pos" else t[:, idx])
             for name, t in layer.items()} for layer in cache]


def reset_slots(cache, slot_ids):
    """Invalidate slots (release finished requests): pos = -1."""
    idx = torch.as_tensor(slot_ids, dtype=torch.long)
    for layer in cache:
        layer["pos"][idx.to(layer["pos"].device)] = -1
    return cache


def gather_state_rows(cache, slot_ids, fresh):
    """Copies of the state rows of the given slots (dim 2 of every leaf);
    rows where ``fresh`` (B_sel,) is True start from zero state (a request
    whose prefill starts at offset 0)."""
    if isinstance(cache, tuple):
        return tuple(gather_state_rows(c, slot_ids, fresh) for c in cache)
    rows = cache[:, :, slot_ids.long()]
    m = fresh.to(rows.device).reshape(1, 1, -1, *([1] * (rows.dim() - 3)))
    return torch.where(m, torch.zeros((), dtype=rows.dtype,
                                      device=rows.device), rows)


def scatter_state_rows(cache, slot_ids, rows) -> None:
    """Write ``gather_state_rows``' rows (updated) back to their slots."""
    if isinstance(cache, tuple):
        for c, r in zip(cache, rows):
            scatter_state_rows(c, slot_ids, r)
        return
    cache[:, :, slot_ids.long()] = rows
