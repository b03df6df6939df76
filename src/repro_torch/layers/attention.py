"""Tensor-parallel GQA attention, as ``repro.layers.attention``: prefill
(with the weave's ``kv_prefix``), single-token decode and the multi-token
verify window over the slot KV cache or the paged pool, and packed
mixed-segment steps over either.

The tp ranks sit on a leading rank axis R (``distributed/context.py``):
weights are ``(R, ...)`` (``wq (R, d, h_loc·dh)``, ``wo (R, h_loc·dh, d)``),
activations ``(R, B, S, ...)``, and the projections are products batched
over R.  ``attention_layout`` maps heads to ranks as the reference does
(KV heads duplicated when tp exceeds them, replicated head shards scaled
by ``o_scale``).  The output is partial over the ranks; its reduction is
``comm_norm``.

Implementations of prefill attention: ``impl="pallas"`` runs kernel K3
(``kernels/flash_attention.py``, through ``kernels.ops``, as an autograd
Function where a gradient is asked) with R folded into the batch; ``"ref"``
and ``"chunked"`` compute the same function with the plain version.
Decode attention and the encdec decoder's cross attention
(``attn_cross``) are plain tensor code, as in the reference (no Pallas
kernel there).  Context-parallel decode (``attn_decode(seq_shards=D)``,
the reference's ``seq_axis``) splits a full-attention layer's cache
sequence over the data rank axis and combines the D chunks' softmax
statistics as flash decoding does.  Packed steps have no Pallas kernel in the reference
either; its form gathers every token's whole cache row.  Under
``attn_impl="pallas"`` the port gathers each segment's row once instead
and runs K3 over the split's segments (``attn_packed_paged``).

Cache layout per layer: {"k": (R, B, C, kv_store, dh), "v": ..., "pos":
(B, C) int32, -1 = empty; positions are the same on every rank}.  Decode
and verify write the cache IN PLACE (the reference returns an updated
copy); a view of some rows (``cache_rows``) writes through to the full
cache, which the decode batch split relies on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import CommCtx
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.flash_attention import attention_mask as _mask
from repro_torch.kernels.flash_attention import flash_attention_plain as _attn_ref
from repro_torch.kernels.ops import flash_attention
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rotary import apply_mrope, apply_rope
from repro_torch.runtime import paging as PG


@dataclasses.dataclass(frozen=True)
class AttnLayout:
    tp: int            # model-axis size
    attn_tp: int       # head-sharding degree (divides tp)
    h_loc: int         # query heads per shard
    kv_store: int      # KV heads stored per shard
    replicas: int      # tp // attn_tp (redundant head-shard copies)
    num_heads: int
    num_kv_heads: int
    head_dim: int

    @property
    def o_scale(self) -> float:
        return 1.0 / self.replicas


def attention_layout(tp: int, num_heads: int, num_kv_heads: int,
                     head_dim: int) -> AttnLayout:
    attn_tp = math.gcd(tp, num_heads)
    while attn_tp > 1:
        if attn_tp <= num_kv_heads:
            if num_kv_heads % attn_tp == 0:
                break
        else:
            g = num_heads // num_kv_heads
            if attn_tp % num_kv_heads == 0 and g % (attn_tp // num_kv_heads) == 0:
                break
        attn_tp //= 2
    h_loc = num_heads // attn_tp
    kv_store = num_kv_heads // attn_tp if attn_tp <= num_kv_heads else 1
    return AttnLayout(tp=tp, attn_tp=attn_tp, h_loc=h_loc, kv_store=kv_store,
                      replicas=tp // attn_tp, num_heads=num_heads,
                      num_kv_heads=num_kv_heads, head_dim=head_dim)


def multihead_attention(q, k, v, qpos, kpos, *, causal: bool, window: int = 0,
                        impl: str = "chunked",
                        sm_scale: Optional[float] = None):
    """q: (B, Sq, Hq, dh), grouped internally; k/v: (B, Sk, KVh, dh)."""
    b, sq, hq, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, hq // kvh, dh)
    if sm_scale is None:
        sm_scale = dh ** -0.5
    if impl in ("ref", "chunked"):
        out = _attn_ref(qg, k, v, qpos, kpos, causal=causal, window=window,
                        sm_scale=sm_scale)
    elif impl == "pallas":
        out = flash_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                              qpos.contiguous(), kpos.contiguous(),
                              causal=causal, window=window, sm_scale=sm_scale)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return out.reshape(b, sq, hq, dh)


def _project_qkv(params, x, cfg, lay: AttnLayout, *, positions, theta,
                 mrope_positions=None):
    """x (R, B, S, d) -> q (R, B, S, h_loc, dh), k and v (R, B, S,
    kv_store, dh), rotated by M-RoPE at ``mrope_positions`` (B, 3, S) when
    the config has sections and the caller gives them, else by RoPE at
    ``positions`` (B, S) unless the model learns its positions.  The 1-D
    ``positions`` still place the keys in the cache and mask them: after
    an image the two differ (a 256-patch image takes 256 positions but 16
    M-RoPE ids)."""
    r, b, s, d = x.shape
    dh = cfg.head_dim
    xf = x.reshape(r, b * s, d)
    q = xf @ params["wq"]
    k = xf @ params["wk"]
    v = xf @ params["wv"]
    if "bq" in params:
        q = q + params["bq"][:, None]
        k = k + params["bk"][:, None]
        v = v + params["bv"][:, None]
    q = q.reshape(r, b, s, lay.h_loc, dh)
    k = k.reshape(r, b, s, lay.kv_store, dh)
    v = v.reshape(r, b, s, lay.kv_store, dh)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections, theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections, theta)
    elif not cfg.learned_positions:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(params, out, lay: AttnLayout, x_dtype):
    """(R, B, S, h_loc·dh) attention output -> partial (R, B, S, d)."""
    r, b, s, f = out.shape
    partial = out.to(x_dtype).reshape(r, b * s, f) @ params["wo"]
    if lay.replicas > 1:
        partial = partial * lay.o_scale
    return partial.reshape(r, b, s, -1)


def attn_prefill(params, x, *, positions, cfg, lay: AttnLayout, theta,
                 causal: bool = True, window: int = 0,
                 kv_prefix: Optional[Tuple] = None, mrope_positions=None,
                 impl: str = "chunked"):
    """Returns (partial out (R, B, S, d), (k, v, kpos) of this chunk).

    ``kv_prefix``: (k, v, kpos) the chunk also attends — the cache rows
    and, for the suffix split, the prefix split's keys (paper §3.1)."""
    r, b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, lay, positions=positions,
                           theta=theta, mrope_positions=mrope_positions)
    kpos = positions
    if kv_prefix is not None:
        pk, pv, ppos = kv_prefix
        k_all = torch.cat([pk, k], dim=2)
        v_all = torch.cat([pv, v], dim=2)
        kpos_all = torch.cat([ppos, kpos], dim=1)
    else:
        k_all, v_all, kpos_all = k, v, kpos
    sk = k_all.shape[2]
    # every rank attends its own heads: fold R into the batch
    out = multihead_attention(
        q.reshape(r * b, s, lay.h_loc, cfg.head_dim),
        k_all.reshape(r * b, sk, lay.kv_store, cfg.head_dim),
        v_all.reshape(r * b, sk, lay.kv_store, cfg.head_dim),
        positions.repeat(r, 1), kpos_all.repeat(r, 1),
        causal=causal, window=window, impl=impl)
    out = _out_proj(params, out.reshape(r, b, s, -1), lay, x.dtype)
    return out, (k, v, kpos)


def attn_decode(params, x, cache, *, positions, cfg, lay: AttnLayout, theta,
                window: int = 0, mrope_positions=None,
                seq_shards: Optional[int] = None, ctx=None):
    """Single-token decode against the slot cache: the S == 1 case of
    ``attn_verify``, unless ``seq_shards``.

    ``seq_shards`` = D (the reference's ``seq_axis``, here its size):
    context-parallel KV.  The cache's C = c·D slots lie over the D data
    shards, shard d owning slots ``[d·c, (d+1)·c)``; position p goes to
    global slot ``p % (c·D)`` on owner ``(p % (c·D)) // c``, so the global
    layout is the unsharded one.  As in the reference every row writes,
    a row at position -1 too (into the last slot, with position -1).  The
    attention combines the shards' chunks (``_decode_attn_math``).  On the
    rank axis ``cache`` holds all C slots; under a ``process_group``
    ``ctx`` it holds this data rank's c, only the owner writes a row,
    and the combine runs over the data group."""
    if seq_shards is None:
        return attn_verify(params, x, cache, positions=positions, cfg=cfg,
                           lay=lay, theta=theta, window=window,
                           mrope_positions=mrope_positions)
    b = positions.shape[0]
    grouped = ctx is not None and ctx.process_group
    c_all = cache["k"].shape[2] * (seq_shards if grouped else 1)
    if c_all % seq_shards:
        raise ValueError(f"a cache of {c_all} slots does not split over "
                         f"{seq_shards} data shards")
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta,
                                   mrope_positions=mrope_positions)
    pos = positions[:, 0]
    gslot = (pos % c_all).long()
    bidx = torch.arange(b, device=x.device)
    if grouped:
        _write_owned(cache, bidx, gslot, k_new[:, :, 0], v_new[:, :, 0], pos,
                     c_all // seq_shards, ctx.groups.data_rank)
    else:
        cache["k"][:, bidx, gslot] = k_new[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, bidx, gslot] = v_new[:, :, 0].to(cache["v"].dtype)
        cache["pos"][bidx, gslot] = pos.to(torch.int32)
    partial = _decode_attn_math(params, q, cache["k"], cache["v"],
                                cache["pos"], positions, x_dtype=x.dtype,
                                cfg=cfg, lay=lay, window=window,
                                seq_shards=seq_shards, ctx=ctx)
    return partial, cache


def _write_owned(cache, bidx, gslot, k, v, pos, c: int, shard: int):
    """Context-parallel decode's write on data rank ``shard`` of a group:
    the rows whose global slot lies in ``[shard·c, (shard+1)·c)`` write
    local slot ``gslot - shard·c``; the others write back what their
    slot 0 holds (no host sync to pick the rows)."""
    own = (gslot // c) == shard
    lslot = torch.where(own, gslot - shard * c, 0)
    for name, new in (("k", k), ("v", v)):
        old = cache[name][:, bidx, lslot]
        cache[name][:, bidx, lslot] = torch.where(
            own[None, :, None, None], new.to(old.dtype), old)
    cache["pos"][bidx, lslot] = torch.where(
        own, pos.to(torch.int32), cache["pos"][bidx, lslot])


def _decode_attn_math(params, q, k, v, kpos, positions, *, x_dtype, cfg,
                      lay: AttnLayout, window, seq_shards=None, ctx=None):
    """Decode/verify epilogue: grouped QK logits (float32 accumulation of
    the cache-dtype operands), masked stable softmax, P cast to the cache
    dtype, V accumulate in float32, output projection.  q (R, B, Sq, h,
    dh); k, v (R, B, C, kv, dh), possibly a strided view of the cache.

    ``seq_shards`` = D: flash decoding over the D data shards' chunks of
    the cache: each chunk's max, then their max (``pmax_dp``, the
    reference's ``pmax``); each chunk's denominator and accumulator
    against that max, then their sums over the chunks (``psum_dp``), all
    in float32.  On the rank axis k and v hold all D chunks; under a
    ``process_group`` ``ctx`` they are this data rank's chunk, and the max
    and the sums go over the data group."""
    r, b, sq = q.shape[:3]
    kvh = k.shape[3]
    g = lay.h_loc // kvh
    qg = q.reshape(r, b, sq, kvh, g, cfg.head_dim)
    logits = torch.einsum("rbqhgd,rbkhd->rbhgqk", qg.float(), k.float()) \
        * (cfg.head_dim ** -0.5)
    msk = _mask(positions, kpos, True, window)           # (B, Sq, C)
    logits = torch.where(msk[None, :, None, None], logits, NEG_INF)
    if seq_shards is None:
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        denom = p.sum(dim=-1)
        acc = torch.einsum("rbhgqk,rbkhd->rbhgqd", p.to(v.dtype).float(),
                           v.float())
    else:
        # the chunk axis leads, as the data shards of ``psum_dp``: the D
        # chunks of the rank axis's whole cache, or a process's own one
        if ctx is None or not ctx.process_group:
            ctx = CommCtx(dp=seq_shards)
        n = ctx.dp if not ctx.process_group else 1
        chunks = logits.unflatten(-1, (n, -1)).movedim(-2, 0)
        vc = v.unflatten(2, (n, -1)).movedim(2, 0)      # (n, R, B, c, ...)
        m = C.pmax_dp(chunks.amax(dim=-1), ctx)[0]
        p = torch.exp(chunks - m[None, ..., None])
        denom = C.psum_dp(p.sum(dim=-1), ctx)[0]
        acc = C.psum_dp(torch.einsum("nrbhgqk,nrbkhd->nrbhgqd",
                                     p.to(v.dtype).float(), vc.float()),
                        ctx)[0]
    out = acc / denom.clamp_min(1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(r, b, sq,
                                                lay.h_loc * cfg.head_dim)
    return _out_proj(params, out, lay, x_dtype)


def attn_verify(params, x, cache, *, positions, cfg, lay: AttnLayout, theta,
                window: int = 0, mrope_positions=None):
    """Multi-token decode window (R, B, S_v, d) against the slot cache:
    every token with position >= 0 is written into slot ``pos % C`` of
    every rank first, then attention runs with the causal mask.  Writes
    with position < 0 (inactive rows, unused window slots) are dropped."""
    b, s = positions.shape
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta,
                                   mrope_positions=mrope_positions)
    c = cache["k"].shape[2]
    valid = positions >= 0
    # a write of static shape (no host sync): a dropped entry repeats the
    # first kept entry of its row (the same slot, the same value), and a
    # row with none writes its slot 0's old contents back
    keep = valid.any(dim=1)
    first = valid.int().argmax(dim=1, keepdim=True)
    src = torch.where(valid, torch.arange(s, device=x.device)[None], first)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s)
    slot = torch.where(keep[:, None], positions.gather(1, src) % c,
                       0).long()
    for name, new in (("k", k_new), ("v", v_new)):
        old = cache[name][:, bidx, slot]
        cache[name][:, bidx, slot] = torch.where(
            keep[None, :, None, None, None], new[:, bidx, src].to(old.dtype),
            old)
    cache["pos"][bidx, slot] = torch.where(
        keep[:, None], positions.gather(1, src).to(torch.int32),
        cache["pos"][bidx, slot])
    partial = _decode_attn_math(params, q, cache["k"], cache["v"],
                                cache["pos"], positions, x_dtype=x.dtype,
                                cfg=cfg, lay=lay, window=window)
    return partial, cache


def attn_decode_paged(params, x, pool_layer, block_tables, *, positions, cfg,
                      lay: AttnLayout, theta, window: int = 0,
                      mrope_positions=None, where=None):
    """Single-token decode against one layer of the paged pool: the
    S == 1 case of ``attn_verify_paged``."""
    return attn_verify_paged(params, x, pool_layer, block_tables,
                             positions=positions, cfg=cfg, lay=lay,
                             theta=theta, window=window,
                             mrope_positions=mrope_positions, where=where)


def attn_verify_paged(params, x, pool_layer, block_tables, *, positions, cfg,
                      lay: AttnLayout, theta, window: int = 0,
                      mrope_positions=None, where=None):
    """Decode window (R, B, S_v, d) against one layer of the paged pool
    (``runtime/paging.py``): the tokens scatter through ``block_tables``
    (B, nblk) first (writes with pos < 0 or an unallocated block are
    dropped), then attention runs over the gathered (B, nblk·bs) view with
    the causal mask, the epilogue shared with ``attn_verify``.  ``where``:
    ``paging.scatter_index`` of these tokens, computed once per forward
    (on the host when the caller has the tables there)."""
    b, s = positions.shape
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta,
                                   mrope_positions=mrope_positions)
    if where is None:
        rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
        where = PG.scatter_index(positions.reshape(-1), rows.reshape(-1),
                                 block_tables, pool_layer["pos"].shape[1])
    r = k_new.shape[0]
    PG.write_tokens(pool_layer, k_new.reshape(r, b * s, *k_new.shape[3:]),
                    v_new.reshape(r, b * s, *v_new.shape[3:]),
                    positions.reshape(-1), where)
    view = PG.gather_layer(pool_layer, block_tables)
    partial = _decode_attn_math(params, q, view["k"], view["v"], view["pos"],
                                positions, x_dtype=x.dtype, cfg=cfg, lay=lay,
                                window=window)
    return partial, pool_layer


# --------------------------------------------------------------------------
# packed mixed-segment steps
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SegmentLayout:
    """One split of a packed step laid out for the segment form, built on
    the host once per forward (``segment_layout``) and used by every
    layer.  A segment is the run of the split's tokens owned by one cache
    row (slots) or block-table row (paged); segments are laid out as the
    rows of an (n_seg, L) rectangle, L the longest, padded with qpos -1.

    tok (N,): split-local index of each real token (seg_slots >= 0, pos
    >= 0); cell (N,): its cell seg·L + col of the rectangle; qpos (n_seg,
    L) int32; write: the cache cells the real tokens go to, (idx, phys,
    off) into the pool (idx indexes ``tok``'s tokens that have a block)
    or (idx, row, slot) into the slot cache; rows (n_seg,): each
    segment's cache row (slots); tables (n_seg, nblk) int32: each
    segment's block-table row (paged); keys: the key length the segments
    attend, cut to the cells that can hold a position <= the split's
    largest (the rest are hidden by the causal mask)."""
    tok: torch.Tensor
    cell: torch.Tensor
    qpos: torch.Tensor
    write: tuple
    rows: torch.Tensor
    tables: Optional[torch.Tensor]
    keys: int

    @property
    def n_seg(self) -> int:
        return self.qpos.shape[0]


def segment_layout(positions, seg_slots, *, device, block_tables=None,
                   block_size: int = 0, cache_len: int = 0) -> SegmentLayout:
    """The ``SegmentLayout`` of one split from host copies of its
    positions (T,), owners seg_slots (T,) and, paged, the block tables
    (B, nblk) with ``block_size``; slots: the cache length ``cache_len``.
    A split with no real token gives n_seg == 0."""
    pos = np.asarray(positions, np.int64).reshape(-1)
    seg = np.asarray(seg_slots, np.int64).reshape(-1)
    real = np.nonzero((seg >= 0) & (pos >= 0))[0]
    rows, inv = np.unique(seg[real], return_inverse=True)
    inv = inv.reshape(-1)
    counts = np.bincount(inv, minlength=len(rows))
    order = np.argsort(inv, kind="stable")
    col = np.empty_like(inv)
    col[order] = np.arange(len(inv)) - np.repeat(np.cumsum(counts) - counts,
                                                 counts)
    n_seg, length = len(rows), int(counts.max(initial=0))
    qpos = np.full((n_seg, length), -1, np.int32)
    qpos[inv, col] = pos[real]
    top = int(pos[real].max(initial=0))
    tables = None
    if block_tables is not None:
        bt = np.asarray(block_tables, np.int64)
        blk = pos[real] // block_size
        phys = np.full(len(real), -1, np.int64)
        inside = blk < bt.shape[1]
        phys[inside] = bt[seg[real][inside], blk[inside]]
        idx = np.nonzero(phys >= 0)[0]
        write = (idx, phys[idx], pos[real][idx] % block_size)
        nblk = min(top // block_size + 1, bt.shape[1])
        tables = bt[rows, :nblk].astype(np.int32)
        keys = nblk * block_size
    else:
        write = (np.arange(len(real)), seg[real], pos[real] % cache_len)
        # slot s holds position s while no position wraps the row
        keys = top + 1 if top < cache_len else cache_len

    def dev(a):
        return torch.as_tensor(a).to(device)
    return SegmentLayout(tok=dev(real), cell=dev(inv * length + col),
                         qpos=dev(qpos), write=tuple(map(dev, write)),
                         rows=dev(rows), keys=keys,
                         tables=None if tables is None else dev(tables))


def _host_layout(positions, seg_slots, cache_layer, block_tables=None):
    """``segment_layout`` from these tensors (read back to the host when
    they are on the device; the model's forward builds it from host
    copies once instead)."""
    return segment_layout(
        positions.cpu().numpy(), seg_slots.cpu().numpy(),
        device=positions.device,
        block_tables=(None if block_tables is None
                      else block_tables.cpu().numpy()),
        block_size=cache_layer["pos"].shape[1],
        cache_len=cache_layer["pos"].shape[1])


# named ranges around the segment form's data movement, so a profile can
# split its device time from K3's (chip_smoke.py's packed breakdown)
SCATTER_RANGE = "repro_torch.packed.scatter"     # tokens into the cache
GATHER_RANGE = "repro_torch.packed.gather"       # each segment's key view
LAYOUT_RANGE = "repro_torch.packed.layout"       # queries in, outputs out


def _attn_segments(params, x, cache_layer, segs: SegmentLayout, *, cfg,
                   lay: AttnLayout, theta, window, positions, paged: bool):
    """The segment form of ``attn_packed``/``attn_packed_paged``: scatter
    the split's tokens into the cache, take each segment's key view once,
    run kernel K3 once over all the split's segments (ranks folded into
    the batch), and scatter the outputs back to packed order.  Tokens
    that own no segment (padding) get a zero attention output."""
    if segs.n_seg == 0:
        return torch.zeros_like(x)
    r, _, t, _ = x.shape
    dh = cfg.head_dim
    record = torch.profiler.record_function
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta)
    with record(SCATTER_RANGE):
        idx, a, b = segs.write
        tok = segs.tok[idx]
        dt = cache_layer["k"].dtype
        cache_layer["k"][:, a, b] = k_new[:, 0, tok].to(dt)
        cache_layer["v"][:, a, b] = v_new[:, 0, tok].to(dt)
        cache_layer["pos"][a, b] = positions[0, tok].to(torch.int32)
    with record(GATHER_RANGE):
        if paged:
            view = PG.gather_layer(cache_layer, segs.tables)
            k, v, kpos = view["k"], view["v"], view["pos"]
        else:
            k = cache_layer["k"][:, segs.rows, :segs.keys]
            v = cache_layer["v"][:, segs.rows, :segs.keys]
            kpos = cache_layer["pos"][segs.rows, :segs.keys]
    n, length = segs.qpos.shape
    with record(LAYOUT_RANGE):
        q_seg = q.new_zeros(r, n * length, lay.h_loc, dh)
        q_seg[:, segs.cell] = q[:, 0, segs.tok]
    out = multihead_attention(
        q_seg.reshape(r * n, length, lay.h_loc, dh),
        k.reshape(r * n, segs.keys, lay.kv_store, dh),
        v.reshape(r * n, segs.keys, lay.kv_store, dh),
        segs.qpos.repeat(r, 1), kpos.repeat(r, 1), causal=True,
        window=window, impl="pallas")
    with record(LAYOUT_RANGE):
        out_tok = out.new_zeros(r, t, lay.h_loc * dh)
        out_tok[:, segs.tok] = out.reshape(r, n * length, -1)[:, segs.cell]
    return _out_proj(params, out_tok.reshape(r, 1, t, -1), lay, x.dtype)


def attn_packed(params, x, cache, *, positions, seg_slots, cfg,
                lay: AttnLayout, theta, window: int = 0,
                impl: str = "chunked", segs=None):
    """Packed mixed-segment step (R, 1, T, d) against the slot cache.
    seg_slots (T,): the cache row owning each token (-1 = padding);
    positions (1, T) (-1 = padding).  All T tokens scatter into their rows
    first, then every token attends its own row with the causal mask, so a
    segment's later tokens see its earlier ones and no token sees another
    segment.  Full-attention layers only (a ring buffer could evict a key
    an earlier query of the step still needs; the engine refuses packed
    slots for windowed models).

    ``impl="pallas"`` runs the segment form (``_attn_segments``, kernel
    K3) over ``segs``, the split's ``segment_layout`` (built here when not
    given); other impls the reference's plain form: a per-token gather of
    the owning row, (T, C, kv, dh), and the decode epilogue.  They agree
    on every real token."""
    if impl == "pallas":
        if segs is None:
            segs = _host_layout(positions[0], seg_slots, cache)
        return _attn_segments(params, x, cache, segs, cfg=cfg, lay=lay,
                              theta=theta, window=window,
                              positions=positions, paged=False), cache
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta)
    bslots, c = cache["pos"].shape
    pos = positions[0]
    keep = ((seg_slots >= 0) & (pos >= 0)).nonzero().squeeze(1)
    row, slot = seg_slots[keep].long(), (pos[keep] % c).long()
    cache["k"][:, row, slot] = k_new[:, 0, keep].to(cache["k"].dtype)
    cache["v"][:, row, slot] = v_new[:, 0, keep].to(cache["v"].dtype)
    cache["pos"][row, slot] = pos[keep].to(torch.int32)
    # per-token gather of the owning row; padding reads row 0, masked by
    # its qpos -1
    rsafe = seg_slots.long().clamp(0, bslots - 1)
    partial = _decode_attn_math(params, q[:, 0, :, None], cache["k"][:, rsafe],
                                cache["v"][:, rsafe], cache["pos"][rsafe],
                                pos[:, None], x_dtype=x.dtype, cfg=cfg,
                                lay=lay, window=window)      # (R, T, 1, d)
    return partial.transpose(1, 2), cache


def attn_packed_paged(params, x, pool_layer, block_tables, *, positions,
                      seg_slots, cfg, lay: AttnLayout, theta,
                      window: int = 0, impl: str = "chunked", segs=None):
    """Packed mixed-segment step against one layer of the paged pool:
    each token scatters through its owning request's block-table row
    (seg_slots indexes ``block_tables`` (B, nblk)), then attends that
    row's gathered view.  Packed steps CAN weave: the splits run over the
    same pool in sequence, so the suffix split reads what the prefix split
    wrote.  ``impl`` and ``segs`` as in ``attn_packed``; the plain form's
    per-token view is (T, nblk·bs, kv, dh), 17 GB per layer at
    Llama-3.3-70B width and T = 2048: a reference, never the card's path."""
    if impl == "pallas":
        if segs is None:
            segs = _host_layout(positions[0], seg_slots, pool_layer,
                                block_tables)
        return _attn_segments(params, x, pool_layer, segs, cfg=cfg, lay=lay,
                              theta=theta, window=window,
                              positions=positions, paged=True), pool_layer
    q, k_new, v_new = _project_qkv(params, x, cfg, lay, positions=positions,
                                   theta=theta)
    pos = positions[0]
    where = PG.scatter_index(pos, seg_slots, block_tables,
                             pool_layer["pos"].shape[1])
    PG.write_tokens(pool_layer, k_new[:, 0], v_new[:, 0], pos, where)
    rsafe = seg_slots.long().clamp(0, block_tables.shape[0] - 1)
    view = PG.gather_layer(pool_layer, block_tables[rsafe])
    partial = _decode_attn_math(params, q[:, 0, :, None], view["k"],
                                view["v"], view["pos"], pos[:, None],
                                x_dtype=x.dtype, cfg=cfg, lay=lay,
                                window=window)                # (R, T, 1, d)
    return partial.transpose(1, 2), pool_layer


# --------------------------------------------------------------------------
# cross attention (the encdec decoder over the encoder's output)
# --------------------------------------------------------------------------

def attn_cross(params, x, enc_kv, *, cfg, lay: AttnLayout):
    """Whisper-style cross attention: queries from the decoder's x (R, B,
    S, d), keys and values precomputed from the encoder's output (enc_kv =
    (k, v (R, B, S_enc, kv_store, dh), kpos (B, S_enc))), no rotation, no
    mask but padded keys.  Returns the partial output (R, B, S, d).  The
    reference computes it in jnp (``impl="ref"``/``"chunked"``), not in a
    Pallas kernel; so does the port, with K3's plain version: its S is
    the decoder's few prompt tokens or one decode token."""
    r, b, s, d = x.shape
    dh = cfg.head_dim
    k, v, kpos = enc_kv
    q = (x.reshape(r, b * s, d) @ params["wq"]).reshape(r * b, s, lay.h_loc,
                                                        dh)
    sk = k.shape[2]
    qpos = torch.zeros(r * b, s, dtype=torch.int32, device=x.device)
    out = multihead_attention(
        q, k.reshape(r * b, sk, lay.kv_store, dh),
        v.reshape(r * b, sk, lay.kv_store, dh), qpos, kpos.repeat(r, 1),
        causal=False, impl="ref")
    return _out_proj(params, out.reshape(r, b, s, -1), lay, x.dtype)


def project_cross_kv(params, enc_out, *, cfg, lay: AttnLayout):
    """The encoder's output (R, B, S_enc, d) -> one decoder layer's cross
    (k, v (R, B, S_enc, kv_store, dh), kpos (B, S_enc) = 0..S_enc-1)."""
    r, b, s, d = enc_out.shape
    dh = cfg.head_dim
    xf = enc_out.reshape(r, b * s, d)
    k = (xf @ params["wk"]).reshape(r, b, s, lay.kv_store, dh)
    v = (xf @ params["wv"]).reshape(r, b, s, lay.kv_store, dh)
    kpos = torch.arange(s, dtype=torch.int32,
                        device=enc_out.device)[None].expand(b, s)
    return k, v, kpos


def cache_rows(cache_layer, off: int, rows: int):
    """Views of batch rows ``[off, off + rows)`` of one cache layer; writes
    through them land in the full cache."""
    return {name: (t[off:off + rows] if name == "pos"
                   else t[:, off:off + rows])
            for name, t in cache_layer.items()}


def init_kv_cache(batch: int, max_len: int, cfg, tp: int, *, window: int = 0,
                  dtype=None, device=None, ranks: Optional[int] = None):
    """One layer's slot cache; C = min(max_len, window) for sliding layers
    (the ring buffer is the window).  Rank r stores its kv_store heads,
    the reference's global head axis ``[r·kv_store, (r+1)·kv_store)``.
    The layout is global over a data axis: ``batch`` counts every data
    shard's rows, and context-parallel decode (``attn_decode``) splits C
    over the shards in place.  ``ranks``: the leading rank axis (tp
    unless given; 1 for a process of a model group)."""
    lay = attention_layout(tp, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    c = min(max_len, window) if window > 0 else max_len
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (ranks or tp, batch, c, lay.kv_store, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, c), -1, dtype=torch.int32, device=device),
    }
