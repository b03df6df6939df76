"""Paged KV cache, as ``repro.runtime.paging``: the block pool, the
device-side gather/scatter through block tables, and the host-side block
manager (allocation, refcounted prefix sharing, LRU eviction,
copy-on-write, preemption support).

Device side.  The pool is a list with one {"k", "v", "pos"} dict per
layer, laid out like the slot cache (``runtime/kv_cache.py``) with the
block axis in place of the batch axis: k and v are (R, nb, bs, kv_store,
dh), one slab per rank of the rank axis, and pos is (nb, bs), the same on
every rank, -1 marking an unwritten cell.  Every request carries a
fixed-length block table (``max_blocks`` int32 entries, -1 =
unallocated).  Reads gather ``pool[table]`` into a rectangular
(B, max_blocks·bs) view whose cells of unallocated entries read block 0
and are masked with pos -1; writes scatter through ``table[pos // bs]``.
The reference drops masked writes with an out-of-range index
(``mode="drop"``); here they are filtered out with a mask, since an
out-of-range index in a CUDA ``index_put_`` is a device-side assert.
Every function updates the pool IN PLACE (the reference returns a new
one).  All layers use full-length storage: sliding windows are enforced
by the attention mask, not a ring buffer, as in the reference.

Host side (pure Python, the reference's code): ``BlockManager`` composes

* ``BlockAllocator`` — free list + refcounts + an LRU list of "cached free"
  blocks (refcount 0 but still registered in the prefix cache; they are
  evicted — hash dropped, contents recycled — only when the plain free list
  runs dry).
* ``PrefixCache`` (prefix_cache.py) — chain-hash -> block map; hits at
  admission shrink a request's prefill to its miss suffix, which is what
  the scheduler charges against ``chunk_tokens``.
* copy-on-write — any write path asks ``ensure_writable`` first; a shared
  (refcount > 1) target block is replaced by a private copy and the device
  copy is queued for the engine to apply.

Preemption policy lives in the engine (latest-arrival victim, recompute
readmission); the manager only provides alloc/free/reset primitives.

KV migration (disaggregated serving, ``runtime/cluster.py``):
``export_blocks``/``import_blocks`` move a request's block table and
refcounts between managers, ``extract_blocks``/``implant_blocks`` its
cells between pools.  The payload between them has the reference's layout,
not this pool's: ``{"k": (L, n, bs, H, dh), "v": ..., "pos": (L, n, bs)}``
when the reference's pool is stacked (``scan_layers`` with uniform layer
kinds, ``payload_stacked``), else ``{"layer_i": {"k": (n, bs, H, dh), ...}}``,
the rank axis folded back into the global head axis H = R·kv_store.  So a
payload, its byte count and its wire frame equal the reference's, and
either package's engine adopts the other's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime.prefix_cache import PrefixCache, chain_hashes
from repro_torch.weights import to_torch


# ==========================================================================
# device side: pool construction + gather/scatter indirection
# ==========================================================================

def init_paged_cache(num_blocks: int, block_size: int, cfg, tp: int = 1, *,
                     device=None, dtype=None, ranks: int | None = None):
    """The pool for ``tp`` ranks on ``device`` (CUDA unless given): one
    {"k": (R, nb, bs, kv_store, dh), "v": ..., "pos": (nb, bs)} dict per
    layer.  Rank r stores its kv_store heads, the reference's global head
    axis ``[r·kv_store, (r+1)·kv_store)``.  R is ``ranks`` (tp unless
    given; 1 for a process of a model group)."""
    from repro_torch.device import resolve_device
    from repro_torch.layers.attention import attention_layout
    from repro_torch.models.transformer import layer_kinds

    device = resolve_device(device)
    lay = attention_layout(tp, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (ranks or tp, num_blocks, block_size, lay.kv_store,
             cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "pos": torch.full((num_blocks, block_size), -1,
                               dtype=torch.int32, device=device)}
            for _ in layer_kinds(cfg)]


def gather_layer(layer, block_tables):
    """One layer's rectangular view through ``block_tables`` (B, nblk):
    k, v (R, B, nblk·bs, kv, dh) and pos (B, nblk·bs), -1 in the cells of
    unallocated entries (which read block 0)."""
    bt = block_tables.long()
    safe = bt.clamp_min(0)
    b, nblk = bt.shape
    bs = layer["pos"].shape[1]
    r, _, _, h, dh = layer["k"].shape
    k = layer["k"][:, safe].reshape(r, b, nblk * bs, h, dh)
    v = layer["v"][:, safe].reshape(r, b, nblk * bs, h, dh)
    pos = torch.where(bt[:, :, None] >= 0, layer["pos"][safe],
                      -1).reshape(b, nblk * bs)
    return {"k": k, "v": v, "pos": pos}


def gather_block_rows(pool, block_tables):
    """Per-request rectangular views of every layer, with the structure of
    the slot cache's gathered rows (``kv_cache.gather_slots``), so the
    model's prefill path takes paged and slot caches alike."""
    return [gather_layer(layer, block_tables) for layer in pool]


def scatter_index(positions, rows, block_tables, block_size: int):
    """Where each token goes: (idx, phys, off), the indices of the tokens
    kept among ``positions`` (N,), owned by block-table rows ``rows`` (N,),
    and their blocks and offsets.  It drops what the reference drops with
    an out-of-range index: pos < 0, row < 0, a block past the table and an
    unallocated block.  One host sync (the kept count); callers reuse the
    result for every layer."""
    pos = positions.long()
    nblk = block_tables.shape[1]
    blk = torch.where(pos >= 0, pos // block_size, 0)
    inside = blk < nblk
    phys = block_tables.long()[rows.long().clamp_min(0),
                               blk.clamp_max(nblk - 1)]
    keep = (pos >= 0) & (rows >= 0) & inside & (phys >= 0)
    idx = keep.nonzero().squeeze(1)
    return idx, phys[idx], (pos % block_size)[idx]


def write_tokens(layer, k, v, positions, where):
    """Write tokens k, v (R, N, kv, dh) at positions (N,) into one layer,
    at ``where`` = ``scatter_index``'s (idx, phys, off)."""
    idx, phys, off = where
    layer["k"][:, phys, off] = k[:, idx].to(layer["k"].dtype)
    layer["v"][:, phys, off] = v[:, idx].to(layer["v"].dtype)
    layer["pos"][phys, off] = positions[idx].to(torch.int32)


def insert_chunk_paged(pool, kv_chunk, block_tables, *, positions=None):
    """Scatter a prefill chunk's KV (per layer: k (R, B, S, kv, dh), v,
    pos (B, S)) through the block tables (B, nblk).  Tokens with pos < 0
    (padding) or an unallocated block are dropped.  ``positions``: a host
    copy of the chunk's pos, with host ``block_tables``, so the index math
    runs on the host (no device sync)."""
    if not kv_chunk:
        return pool
    pos = kv_chunk[0][2] if positions is None else positions
    b, s = pos.shape
    bs = pool[0]["pos"].shape[1]
    rows = torch.arange(b, device=pos.device)[:, None].expand(b, s)
    dev = pool[0]["pos"].device
    where = tuple(t.to(dev) for t in scatter_index(
        pos.reshape(-1), rows.reshape(-1), block_tables.to(pos.device), bs))
    for layer, (k, v, p) in zip(pool, kv_chunk):
        r, _, _, h, dh = k.shape
        write_tokens(layer, k.reshape(r, b * s, h, dh),
                     v.reshape(r, b * s, h, dh), p.reshape(-1), where)
    return pool


def reset_blocks(pool, block_ids):
    """Invalidate recycled blocks (pos = -1) so stale entries from a prior
    owner can never be attended by the next request."""
    for layer in pool:
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=layer["pos"].device)
        layer["pos"][ids] = -1
    return pool


def copy_blocks(pool, copies: Sequence[Tuple[int, int]]):
    """Apply queued copy-on-write copies [(src, dst), ...].  Every source
    is read before any destination is written, so a block that is both a
    destination and a source in one batch gives its old contents, as the
    reference's functional update does."""
    if not copies:
        return pool
    for layer in pool:
        dev = layer["pos"].device
        src = torch.tensor([s for s, _ in copies], dtype=torch.long,
                           device=dev)
        dst = torch.tensor([d for _, d in copies], dtype=torch.long,
                           device=dev)
        old = {"k": layer["k"][:, src], "v": layer["v"][:, src],
               "pos": layer["pos"][src]}
        layer["k"][:, dst] = old["k"]
        layer["v"][:, dst] = old["v"]
        layer["pos"][dst] = old["pos"]
    return pool


def payload_stacked(cfg, pcfg) -> bool:
    """The reference's pool, and so the payload, is stacked along a layer
    axis when ``pcfg.scan_layers`` and every layer has the same kind."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    return bool(pcfg.scan_layers) and all(k == kinds[0] for k in kinds)


def _block_ids(pool, block_ids) -> torch.Tensor:
    return torch.as_tensor(list(block_ids), dtype=torch.long,
                           device=pool[0]["pos"].device)


def extract_blocks(pool, block_ids: Sequence[int], *, stacked: bool):
    """The (k, v, pos) payload of the given physical blocks, on the host:
    the device half of a KV-migration export.  One gather per leaf on the
    device, then one copy to the host per leaf; the block axis shrinks to
    ``len(block_ids)`` and ``pos`` rides along, so the importer's blocks
    are fully initialized."""
    ids = _block_ids(pool, block_ids)

    def leaf(layer, name):
        a = layer[name].index_select(0 if name == "pos" else 1, ids)
        if name == "pos":
            return a
        r, n, bs, h, dh = a.shape        # ranks back into the head axis
        return a.permute(1, 2, 0, 3, 4).reshape(n, bs, r * h, dh)

    # keys in sorted order at every level, as the reference's payload comes
    # back from ``jax.device_get`` (so its frames are the same bytes)
    names = ("k", "pos", "v")
    if stacked:
        return {name: torch.stack([leaf(layer, name) for layer in pool]).cpu()
                for name in names}
    return dict(sorted(
        (f"layer_{i}", {name: leaf(layer, name).cpu() for name in names})
        for i, layer in enumerate(pool)))


def implant_blocks(pool, payload, block_ids: Sequence[int]):
    """Write a payload (either form; torch tensors or numpy arrays) into
    the pool at ``block_ids``: the device half of a KV-migration import.
    Every cell of each target block (k, v and pos) is overwritten, so the
    importer needs no separate reset; one copy to the device per leaf."""
    ids = _block_ids(pool, block_ids)
    dev = ids.device

    def on_device(a, dtype):
        t = a if isinstance(a, torch.Tensor) else to_torch(a)
        return t.to(device=dev, dtype=dtype)

    stacked = "k" in payload
    if stacked:
        leaves = {name: on_device(a, pool[0][name].dtype)
                  for name, a in payload.items()}
    for i, layer in enumerate(pool):
        for name, dst in layer.items():
            src = (leaves[name][i] if stacked else
                   on_device(payload[f"layer_{i}"][name], dst.dtype))
            if name == "pos":
                dst.index_copy_(0, ids, src)
                continue
            r, _, bs, h, dh = dst.shape
            src = src.reshape(len(ids), bs, r, h, dh).permute(2, 0, 1, 3, 4)
            dst.index_copy_(1, ids, src.contiguous())
    return pool


def select_payload(payload, idx: Sequence[int]):
    """Subset a payload along its block axis (the importer implants only
    the blocks it could not share from its own prefix cache)."""
    sel = list(idx)
    if "k" not in payload:
        return {name: {k: a[sel] for k, a in layer.items()}
                for name, layer in payload.items()}
    return {k: a[:, sel] for k, a in payload.items()}


def payload_nbytes(payload) -> int:
    """Raw KV bytes of a payload tree, either form: what the wire
    transport prices."""
    if "k" not in payload:
        return sum(int(a.nbytes) for layer in payload.values()
                   for a in layer.values())
    return sum(int(a.nbytes) for a in payload.values())


# ==========================================================================
# host side: allocator + manager
# ==========================================================================

class BlockAllocator:
    """Refcounted physical-block allocator with an LRU of evictable
    prefix-cached blocks.

    Invariants:
      * a block is in exactly one of {free, cached_free, referenced}
      * refcount > 0 blocks are NEVER evicted or handed out by alloc()
      * eviction only recycles cached_free blocks (refcount 0), oldest
        first, and drops their prefix-cache hash via the on_evict hook
    """

    def __init__(self, num_blocks: int, on_evict=None):
        self.num_blocks = num_blocks
        self.free: deque = deque(range(num_blocks))
        self.cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.ref = [0] * num_blocks
        self.on_evict = on_evict or (lambda b: None)

    # ---- queries ---------------------------------------------------------
    def num_available(self) -> int:
        return len(self.free) + len(self.cached_free)

    def refcount(self, b: int) -> int:
        return self.ref[b]

    # ---- alloc/free ------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """A fresh block for new content; returns None when exhausted.
        The caller must reset the block's pos if it came from eviction —
        alloc reports this by leaving the block's hash dropped."""
        if self.free:
            b = self.free.popleft()
        elif self.cached_free:
            b, _ = self.cached_free.popitem(last=False)   # LRU
            self.on_evict(b)      # eviction accounting lives in the hook
        else:
            return None
        assert self.ref[b] == 0
        self.ref[b] = 1
        return b

    def share(self, b: int) -> None:
        """Take a reference on a prefix-cache hit. Revives a cached_free
        block (contents intact) or adds a reader to a live one."""
        if b in self.cached_free:
            del self.cached_free[b]
        self.ref[b] += 1

    def decref(self, b: int, cached: bool) -> bool:
        """Drop a reference; returns True when the block became free.
        ``cached``: block is registered in the prefix cache, so park it in
        the LRU (still hittable) instead of the plain free list."""
        assert self.ref[b] > 0, f"double free of block {b}"
        self.ref[b] -= 1
        if self.ref[b] > 0:
            return False
        if cached:
            self.cached_free[b] = None        # lands at the MRU end
        else:
            self.free.append(b)
        return True


@dataclasses.dataclass
class PagingStats:
    hit_tokens: int = 0          # prefill tokens skipped via prefix cache
    miss_tokens: int = 0         # prefill tokens actually computed
    evictions: int = 0
    preemptions: int = 0
    cow_copies: int = 0
    registered_blocks: int = 0
    # --- disaggregated KV migration (runtime/cluster.py) ---
    migrations_out: int = 0      # requests exported off this manager
    migrations_in: int = 0       # requests adopted by this manager
    import_shared_blocks: int = 0  # import hits served from the prefix cache
    import_copied_blocks: int = 0  # import blocks filled by payload copy

    @property
    def hit_rate(self) -> float:
        tot = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / tot if tot else 0.0


class BlockManager:
    """Per-engine paging state: block tables keyed by request id, the
    allocator, the prefix cache, and the queues of device-side fixups
    (block resets, COW copies) the engine drains each step."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_req: int, prefix_caching: bool = True):
        self.block_size = block_size
        self.max_blocks_per_req = max_blocks_per_req
        self.prefix = PrefixCache()
        self.alloc = BlockAllocator(num_blocks,
                                    on_evict=self._on_evict)
        self.tables: Dict[int, List[int]] = {}     # rid -> physical blocks
        # rid -> (blocks hashed so far, last chain hash): registration
        # resumes the chain instead of re-hashing the whole context
        self._reg_cursor: Dict[int, Tuple[int, Optional[int]]] = {}
        self.stats = PagingStats()
        self._pending_resets: List[int] = []
        self._pending_copies: List[Tuple[int, int]] = []
        self.prefix_caching = prefix_caching

    # ---- device fixup queues --------------------------------------------
    def _on_evict(self, b: int) -> None:
        self.prefix.drop_block(b)
        self._pending_resets.append(b)
        self.stats.evictions += 1

    def take_pending_resets(self) -> List[int]:
        out, self._pending_resets = self._pending_resets, []
        return out

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        out, self._pending_copies = self._pending_copies, []
        return out

    # ---- admission -------------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        bs = self.block_size
        return (n_tokens + bs - 1) // bs

    def _build_table(self, hit_blocks: Sequence[int], n_total: int,
                     headroom: int
                     ) -> Optional[Tuple[List[int], List[int]]]:
        """Take a reference on every prefix-hit block, allocate private
        blocks up to ``n_total``, and require ``headroom`` spares to
        remain.  Returns ``(table, fresh_idx)`` (the table positions that
        were freshly allocated), or ``None`` with every acquired reference
        rolled back."""
        table: List[int] = []
        fresh: List[int] = []
        for b in hit_blocks:
            self.alloc.share(b)
            table.append(b)
        ok = True
        for i in range(len(hit_blocks), n_total):
            b = self.alloc.alloc()
            if b is None:
                ok = False
                break
            table.append(b)
            fresh.append(i)
        if ok and self.alloc.num_available() < headroom:
            ok = False
        if not ok:
            for b in table:
                self.alloc.decref(b, cached=self.prefix.is_cached(b))
            return None
        return table, fresh

    def allocate_prompt(self, rid: int, context: Sequence[int], *,
                        headroom: int = 1) -> int:
        """Build the request's block table: share prefix-hit blocks, then
        allocate private blocks for the miss suffix, requiring ``headroom``
        spare blocks to remain (decode growth).  Returns hit tokens
        (always < len(context): at least one token is recomputed so the
        engine has logits to sample the first output from).  Returns -1
        and rolls back when the pool cannot cover it (caller defers or
        preempts)."""
        assert rid not in self.tables
        bs = self.block_size
        hit_blocks: List[int] = []
        if self.prefix_caching:
            hit_blocks = self.prefix.match(chain_hashes(context, bs))
        if len(hit_blocks) * bs >= len(context):   # leave >= 1 miss token
            hit_blocks = hit_blocks[:-1]
        built = self._build_table(hit_blocks, self.blocks_needed(
            len(context)), headroom)
        if built is None:
            return -1
        self.tables[rid] = built[0]
        hit = len(hit_blocks) * bs
        self.stats.hit_tokens += hit
        self.stats.miss_tokens += len(context) - hit
        return hit

    # ---- decode growth + COW --------------------------------------------
    def ensure_writable(self, rid: int, position: int) -> bool:
        """Guarantee the block holding ``position`` exists and is private.
        Grows the table (alloc) and copy-on-writes a shared target.
        Returns False when a needed allocation fails (caller preempts)."""
        table = self.tables[rid]
        idx = position // self.block_size
        assert idx <= len(table), (rid, position, len(table))
        if idx == len(table):
            if idx >= self.max_blocks_per_req:
                return False   # context at the cache ceiling; caller stops
            b = self.alloc.alloc()
            if b is None:
                return False
            table.append(b)
            return True
        b = table[idx]
        if self.alloc.refcount(b) > 1:            # shared -> copy-on-write
            nb = self.alloc.alloc()
            if nb is None:
                return False
            self._pending_copies.append((b, nb))
            self.alloc.decref(b, cached=self.prefix.is_cached(b))
            table[idx] = nb
            self.stats.cow_copies += 1
        return True

    # ---- prefix-cache registration --------------------------------------
    def register_filled(self, rid: int, context: Sequence[int],
                        n_written: int) -> None:
        """Register every full block covered by the first ``n_written``
        context tokens.  First writer wins; an already-cached hash leaves
        the request's private block unregistered."""
        if not self.prefix_caching:
            return
        table = self.tables[rid]
        bs = self.block_size
        done, prev = self._reg_cursor.get(rid, (0, None))
        n_full = n_written // bs
        if n_full <= done:
            return
        new_hashes = chain_hashes(context[:n_full * bs], bs,
                                  start_block=done, prev=prev)
        for j, h in enumerate(new_hashes):
            i = done + j
            existing = self.prefix.lookup(h)
            if existing is not None:
                continue
            if self.prefix.is_cached(table[i]):   # already holds a hash
                continue
            if self.prefix.register(h, table[i]):
                self.stats.registered_blocks += 1
        self._reg_cursor[rid] = (n_full, new_hashes[-1])

    # ---- speculative-decode rollback ------------------------------------
    def truncate(self, rid: int, n_tokens: int) -> None:
        """Shrink the request's block table to cover exactly the first
        ``n_tokens`` context positions — the KV rollback after a partially
        accepted verify window.  Tail blocks are always private, so freed
        uncached blocks queue a pos reset exactly like ``free_request``;
        stale cells left in the KEPT partial block are harmless, since the
        next write window starts at ``n_tokens``."""
        table = self.tables[rid]
        keep = self.blocks_needed(n_tokens)
        assert keep >= 1, (rid, n_tokens)
        done, _ = self._reg_cursor.get(rid, (0, None))
        assert keep >= done, ("truncate below registered blocks",
                              rid, keep, done)
        while len(table) > keep:
            b = table.pop()
            cached = self.prefix.is_cached(b)
            freed = self.alloc.decref(b, cached=cached)
            if freed and not cached:
                self._pending_resets.append(b)

    # ---- disaggregated KV migration --------------------------------------
    def export_blocks(self, rid: int, n_tokens: int) -> List[int]:
        """Begin a KV migration: the physical blocks covering the request's
        first ``n_tokens`` committed positions, in table order.  The table
        stays intact: the caller extracts the payload from these blocks
        (``extract_blocks``), then releases the exporter's references with
        ``free_request`` (shared prefix blocks keep their other readers,
        private blocks recycle)."""
        table = self.tables[rid]
        keep = self.blocks_needed(n_tokens)
        assert keep <= len(table), (rid, n_tokens, len(table))
        self.stats.migrations_out += 1
        return list(table[:keep])

    def import_blocks(self, rid: int, context: Sequence[int],
                      n_tokens: int, *, headroom: int = 1
                      ) -> Optional[Tuple[List[int], List[int]]]:
        """Adopt a migrated request: build its block table here.  Full
        blocks whose chain hash this manager's prefix cache holds are
        shared (the hash chain guarantees the same content); the rest are
        allocated private.  A 100% full-block match is fine: the next input
        token was already sampled by the exporter.

        Returns ``(table, copy_idx)``, ``copy_idx`` the table positions that
        need a payload implant, or ``None`` with every acquired reference
        rolled back when the pool cannot cover ``blocks_needed(n_tokens)``
        plus ``headroom``.  The caller re-registers the prefix-cache entries
        afterwards (``register_filled``)."""
        assert rid not in self.tables, rid
        bs = self.block_size
        n_full = n_tokens // bs
        hit_blocks: List[int] = []
        if self.prefix_caching:
            hit_blocks = self.prefix.match(
                chain_hashes(context[:n_full * bs], bs))
        built = self._build_table(hit_blocks, self.blocks_needed(n_tokens),
                                  headroom)
        if built is None:
            return None
        table, copy_idx = built
        self.tables[rid] = table
        self.stats.migrations_in += 1
        self.stats.import_shared_blocks += len(hit_blocks)
        self.stats.import_copied_blocks += len(copy_idx)
        return table, copy_idx

    # ---- release ---------------------------------------------------------
    def free_request(self, rid: int) -> None:
        """Drop all references; uncached blocks are queued for a pos reset
        so their stale entries can never leak into the next owner."""
        table = self.tables.pop(rid, None)
        self._reg_cursor.pop(rid, None)
        if table is None:
            return
        for b in table:
            cached = self.prefix.is_cached(b)
            freed = self.alloc.decref(b, cached=cached)
            if freed and not cached:
                self._pending_resets.append(b)

    # ---- block-table export ---------------------------------------------
    def table_array(self, rid: int) -> np.ndarray:
        """Static-shape int32 table row (-1 padded) for device use."""
        row = np.full(self.max_blocks_per_req, -1, np.int32)
        t = self.tables.get(rid, ())
        row[:len(t)] = t
        return row
