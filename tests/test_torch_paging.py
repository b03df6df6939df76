"""The PyTorch port's paged KV cache (``repro_torch.runtime.paging`` and
``prefix_cache``) against the JAX reference's, on the CPU.

Host side: the prefix cache's chain hashes are bit-equal, and the block
manager's whole state (tables, refcounts, free list and LRU order, hash
maps, registration cursors, pending resets and copies, stats) equals the
reference's after the same seeded sequence of operations, eviction and
copy-on-write included.  Device side: gather, chunk insert, reset and
copy give bit-equal pools on the same numpy inputs, with unallocated
table entries, padded positions and a copy whose destination is another
copy's source.  The port's pool keeps the rank axis: the reference's
global head axis (tp·kv_store) is split into (R, ..., kv_store).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import paging as JPG
from repro.runtime import prefix_cache as JPC

from repro_torch.runtime import paging as TPG
from repro_torch.runtime import prefix_cache as TPC


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_hashes_bit_equal(block_size):
    rng = np.random.RandomState(block_size)
    tokens = [int(t) for t in rng.randint(0, 2 ** 31 - 1, 200)]
    want = JPC.chain_hashes(tokens, block_size)
    assert TPC.chain_hashes(tokens, block_size) == want
    # resuming a chain half way gives the same tail
    k = len(want) // 2
    assert TPC.chain_hashes(tokens, block_size, start_block=k,
                            prev=want[k - 1]) == want[k:]
    assert TPC.chain_hashes(np.asarray(tokens[:37]), block_size) == \
        JPC.chain_hashes(np.asarray(tokens[:37]), block_size)


def _mgr_state(m):
    return {"tables": {k: list(v) for k, v in m.tables.items()},
            "ref": list(m.alloc.ref), "free": list(m.alloc.free),
            "cached_free": list(m.alloc.cached_free),
            "prefix": dict(m.prefix.table),
            "block_hash": dict(m.prefix.block_hash),
            "cursor": dict(m._reg_cursor),
            "resets": list(m._pending_resets),
            "copies": list(m._pending_copies),
            "stats": dataclasses.asdict(m.stats)}


@pytest.mark.parametrize("seed", range(4))
def test_block_manager_state_matches_reference(seed):
    """Seeded random allocate / register / ensure_writable (growth and
    COW) / truncate / free, with fixups drained now and then, on a pool
    small enough that the LRU evicts."""
    rng = np.random.RandomState(seed)
    bs, nb, maxb = 4, 24, 12
    shared = [int(t) for t in rng.randint(0, 50, 10)]
    mgrs = [JPG.BlockManager(nb, bs, maxb), TPG.BlockManager(nb, bs, maxb)]
    live, ctx, next_rid = [], {}, 0
    for _ in range(300):
        op = rng.randint(6)
        if op <= 1 or not live:                       # admit
            tail = [int(t) for t in rng.randint(0, 50, rng.randint(1, 14))]
            c = (shared[:rng.randint(0, 11)] + tail)[:maxb * bs - 8]
            hits = [m.allocate_prompt(next_rid, c) for m in mgrs]
            assert hits[0] == hits[1]
            if hits[0] >= 0:
                live.append(next_rid)
                ctx[next_rid] = c
                for m in mgrs:
                    m.register_filled(next_rid, c, len(c))
            next_rid += 1
        elif op == 2:                                 # decode growth
            rid = live[rng.randint(len(live))]
            pos = len(ctx[rid])
            oks = [m.ensure_writable(rid, pos) for m in mgrs]
            assert oks[0] == oks[1]
            if oks[0]:
                ctx[rid].append(int(rng.randint(50)))
                for m in mgrs:
                    m.register_filled(rid, ctx[rid], len(ctx[rid]))
        elif op == 3:                                 # write into a block
            rid = live[rng.randint(len(live))]
            pos = int(rng.randint(len(ctx[rid])))
            assert len({m.ensure_writable(rid, pos) for m in mgrs}) == 1
        elif op == 4:                                 # roll back a tail
            rid = live[rng.randint(len(live))]
            done = mgrs[0]._reg_cursor.get(rid, (0, None))[0]
            n = max(done * bs, int(rng.randint(1, len(ctx[rid]) + 1)), 1)
            for m in mgrs:
                m.truncate(rid, n)
            ctx[rid] = ctx[rid][:n]
        else:                                         # finish
            rid = live.pop(rng.randint(len(live)))
            for m in mgrs:
                m.free_request(rid)
        if rng.rand() < 0.3:
            assert mgrs[0].take_pending_resets() == \
                mgrs[1].take_pending_resets()
            assert mgrs[0].take_pending_copies() == \
                mgrs[1].take_pending_copies()
        assert _mgr_state(mgrs[1]) == _mgr_state(mgrs[0])
        for rid in live:
            np.testing.assert_array_equal(mgrs[1].table_array(rid),
                                          mgrs[0].table_array(rid))
    st = mgrs[1].stats
    assert st.evictions and st.cow_copies and st.hit_tokens, st


# --------------------------------------------------------------------------
# device side
# --------------------------------------------------------------------------

NL, NB, BS, TP, KV, DH = 2, 9, 4, 2, 2, 3


def _np_pool(rng):
    """Reference stacked pool (L, nb, bs, TP·KV, dh), pos with holes."""
    k = rng.randn(NL, NB, BS, TP * KV, DH).astype(np.float32)
    v = rng.randn(NL, NB, BS, TP * KV, DH).astype(np.float32)
    pos = rng.randint(-1, 40, (NL, NB, BS)).astype(np.int32)
    return {"k": k, "v": v, "pos": pos}


def _heads_to_ranks(a):
    """(..., TP·KV, dh) -> (TP, ..., KV, dh)."""
    a = a.reshape(*a.shape[:-2], TP, KV, a.shape[-1])
    return np.ascontiguousarray(np.moveaxis(a, -3, 0))


def _torch_pool(np_pool):
    return [{"k": torch.from_numpy(_heads_to_ranks(np_pool["k"][i])),
             "v": torch.from_numpy(_heads_to_ranks(np_pool["v"][i])),
             "pos": torch.from_numpy(np_pool["pos"][i].copy())}
            for i in range(NL)]


def _assert_pool_equal(tpool, jpool):
    for i, layer in enumerate(tpool):
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                layer[name].numpy(),
                _heads_to_ranks(np.asarray(jpool[name][i])))
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      np.asarray(jpool["pos"][i]))


def _tables():
    return np.array([[3, -1, 5, 0], [8, 1, -1, -1], [-1, -1, -1, -1]],
                    np.int32)


def test_init_paged_cache_layout():
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=128, dtype="float32")
    pool = TPG.init_paged_cache(5, 4, cfg, 2, device="cpu")
    assert len(pool) == 2
    assert pool[0]["k"].shape == (2, 5, 4, 1, 16)
    assert pool[0]["pos"].shape == (5, 4)
    assert bool((pool[1]["pos"] == -1).all())


def test_gather_block_rows_bit_equal():
    np_pool = _np_pool(np.random.RandomState(0))
    bt = _tables()
    want = JPG.gather_block_rows({k: jnp.asarray(a) for k, a in
                                  np_pool.items()}, jnp.asarray(bt))
    got = TPG.gather_block_rows(_torch_pool(np_pool), torch.from_numpy(bt))
    for i, layer in enumerate(got):
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                layer[name].numpy(),
                _heads_to_ranks(np.asarray(want[name][i])))
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      np.asarray(want["pos"][i]))
    # unallocated entries read as empty cells
    assert bool((got[0]["pos"][2] == -1).all())


@pytest.mark.parametrize("host", [False, True])
def test_insert_chunk_paged_bit_equal(host):
    rng = np.random.RandomState(1)
    np_pool = _np_pool(rng)
    bt = _tables()
    b, s = 3, 7
    pos = np.full((NL, b, s), -1, np.int32)
    pos[:, 0, :] = np.arange(2, 9)            # crosses an unallocated block
    pos[:, 1, :5] = np.arange(0, 5)           # the rest is padding
    pos[:, 2, :3] = np.arange(0, 3)           # a row with no block at all
    k = rng.randn(NL, b, s, TP * KV, DH).astype(np.float32)
    v = rng.randn(NL, b, s, TP * KV, DH).astype(np.float32)
    want = JPG.insert_chunk_paged(
        {n: jnp.asarray(a) for n, a in np_pool.items()},
        tuple(map(jnp.asarray, (k, v, pos))), jnp.asarray(bt))
    kv = [(torch.from_numpy(_heads_to_ranks(k[i])),
           torch.from_numpy(_heads_to_ranks(v[i])),
           torch.from_numpy(pos[i].copy())) for i in range(NL)]
    got = TPG.insert_chunk_paged(
        _torch_pool(np_pool), kv, torch.from_numpy(bt),
        positions=torch.from_numpy(pos[0].copy()) if host else None)
    _assert_pool_equal(got, want)


def test_reset_and_copy_blocks_bit_equal():
    np_pool = _np_pool(np.random.RandomState(2))
    jpool = {n: jnp.asarray(a) for n, a in np_pool.items()}
    tpool = _torch_pool(np_pool)
    resets = [4, 0, 7]
    # (1 -> 2) and (2 -> 3): block 2 is a destination and a source, so 3
    # must receive block 2's OLD contents
    copies = [(1, 2), (2, 3), (6, 5)]
    jpool = JPG.copy_blocks(JPG.reset_blocks(jpool, resets), copies)
    TPG.copy_blocks(TPG.reset_blocks(tpool, resets), copies)
    _assert_pool_equal(tpool, jpool)
    np.testing.assert_array_equal(tpool[0]["pos"][3].numpy(),
                                  np_pool["pos"][0][2])
    assert TPG.copy_blocks(tpool, []) is tpool


def test_scatter_index_drops_what_the_reference_drops():
    bt = torch.from_numpy(_tables())
    pos = torch.tensor([2, 4, 20, -1, 0, 1, 3], dtype=torch.int32)
    rows = torch.tensor([0, 0, 0, 0, 1, -1, 2])
    idx, phys, off = TPG.scatter_index(pos, rows, bt, BS)
    # kept: pos 2 -> block 3 off 2; pos 0 of row 1 -> block 8 off 0.
    # dropped: an unallocated entry (pos 4), past the table (20),
    # padding (-1), no owner (row -1), a row with no block (row 2)
    assert idx.tolist() == [0, 4]
    assert phys.tolist() == [3, 8]
    assert off.tolist() == [2, 0]
