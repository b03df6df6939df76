"""Hash-chained prefix cache over paged KV blocks, as
``repro.runtime.prefix_cache`` (pure Python, kept bit-equal: the chain
hashes are the same blake2b digests, so a block hashed by one package is
found by the other).

Only FULL blocks participate: a block's key is the chain hash of every
token in it plus the previous block's hash, so a hit on block *i* implies
the entire token prefix ``[0, (i+1) * block_size)`` is identical.  Partial
tail blocks are never shared — each request writes its tail into a private
block — which keeps copy-on-write a defensive invariant rather than a hot
path (see ``BlockManager.ensure_writable``).

The cache stores only the hash -> physical-block mapping plus the reverse
map; residency/eviction order is owned by the ``BlockAllocator`` (blocks
whose refcount drops to zero stay in the allocator's LRU "cached free"
list and remain hittable until evicted for a fresh allocation).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

# hash of the empty prefix (chain seed); any fixed value works
_SEED = 0x9E3779B97F4A7C15


def _hash_block(prev: int, tokens: Sequence[int]) -> int:
    """128-bit keyed chain hash.  A non-cryptographic hash here would let
    a colliding block silently serve another request's KV (the flaw class
    behind vLLM's CVE-2025-25183); blake2b makes accidental or crafted
    collisions a non-issue and there is no token-comparison on hit."""
    h = hashlib.blake2b(digest_size=16)
    h.update(prev.to_bytes(16, "little"))
    h.update(np.asarray(tokens, np.int64).tobytes())
    return int.from_bytes(h.digest(), "little")


def chain_hashes(tokens: Sequence[int], block_size: int, *,
                 start_block: int = 0,
                 prev: Optional[int] = None) -> List[int]:
    """Chain hash per FULL block of ``tokens`` (len(tokens)//block_size).

    ``start_block``/``prev`` resume an existing chain (hashes for blocks
    [start_block, n_full) given block start_block-1's hash), letting
    callers amortize to O(1) per new block instead of re-hashing the
    whole context."""
    hashes: List[int] = []
    prev = _SEED if prev is None else prev
    for lo in range(start_block * block_size,
                    (len(tokens) // block_size) * block_size, block_size):
        prev = _hash_block(prev, tokens[lo:lo + block_size])
        hashes.append(prev)
    return hashes


class PrefixCache:
    """hash -> physical block id (full blocks only)."""

    def __init__(self):
        self.table: Dict[int, int] = {}
        self.block_hash: Dict[int, int] = {}   # reverse map

    def lookup(self, h: int) -> Optional[int]:
        return self.table.get(h)

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Longest-prefix match: physical blocks for leading hash hits."""
        blocks = []
        for h in hashes:
            b = self.table.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def register(self, h: int, block: int) -> bool:
        """Map ``h`` to ``block`` unless the hash is already cached (first
        writer wins — the existing block keeps serving hits)."""
        if h in self.table or block in self.block_hash:
            return False
        self.table[h] = block
        self.block_hash[block] = h
        return True

    def drop_block(self, block: int) -> None:
        """Forget a block (its storage is being reused for new content)."""
        h = self.block_hash.pop(block, None)
        if h is not None:
            del self.table[h]

    def is_cached(self, block: int) -> bool:
        return block in self.block_hash

    def __len__(self) -> int:
        return len(self.table)
