"""Tensor-parallel GQA attention for the two-dispatch serving path, as
``repro.layers.attention``: prefill (with the weave's ``kv_prefix``),
single-token decode and the multi-token verify window over the slot KV
cache.

The tp ranks sit on a leading rank axis R (``distributed/context.py``):
weights are ``(R, ...)`` (``wq (R, d, h_loc·dh)``, ``wo (R, h_loc·dh, d)``),
activations ``(R, B, S, ...)``, and the projections are products batched
over R.  ``attention_layout`` maps heads to ranks as the reference does
(KV heads duplicated when tp exceeds them, replicated head shards scaled
by ``o_scale``).  The output is partial over the ranks; its reduction is
``comm_norm``.

Implementations of prefill attention: ``impl="pallas"`` runs kernel K3
(``kernels/flash_attention.py``) with R folded into the batch; ``"ref"``
and ``"chunked"`` compute the same function with the plain version.
Decode attention is plain tensor code, as in the reference (no Pallas
kernel there).

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

import torch

from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.flash_attention import attention_mask as _mask
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import flash_attention_plain as _attn_ref
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rotary import apply_rope


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
    kv_store, dh), roped at ``positions`` (B, S)."""
    if cfg.mrope_sections and mrope_positions is not None:
        raise NotImplementedError("M-RoPE is not ported (ROADMAP.md A10)")
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
    if not cfg.learned_positions:
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
                window: int = 0, mrope_positions=None, seq_axis=None):
    """Single-token decode against the slot cache: the S == 1 case of
    ``attn_verify``.  Context-parallel KV (``seq_axis``) is not ported."""
    if seq_axis is not None:
        raise NotImplementedError("context-parallel KV (seq_shard_kv) is "
                                  "not ported")
    return attn_verify(params, x, cache, positions=positions, cfg=cfg,
                       lay=lay, theta=theta, window=window,
                       mrope_positions=mrope_positions)


def _decode_attn_math(params, q, k, v, kpos, positions, *, x_dtype, cfg,
                      lay: AttnLayout, window):
    """Decode/verify epilogue: grouped QK logits (float32 accumulation of
    the cache-dtype operands), masked stable softmax, P cast to the cache
    dtype, V accumulate in float32, output projection.  q (R, B, Sq, h,
    dh); k, v (R, B, C, kv, dh), possibly a strided view of the cache."""
    r, b, sq = q.shape[:3]
    kvh = k.shape[3]
    g = lay.h_loc // kvh
    qg = q.reshape(r, b, sq, kvh, g, cfg.head_dim)
    logits = torch.einsum("rbqhgd,rbkhd->rbhgqk", qg.float(), k.float()) \
        * (cfg.head_dim ** -0.5)
    msk = _mask(positions, kpos, True, window)           # (B, Sq, C)
    logits = torch.where(msk[None, :, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    denom = p.sum(dim=-1)
    acc = torch.einsum("rbhgqk,rbkhd->rbhgqd", p.to(v.dtype).float(),
                       v.float())
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
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s)[valid]
    slot = (positions % c)[valid].long()
    cache["k"][:, bidx, slot] = k_new[:, valid].to(cache["k"].dtype)
    cache["v"][:, bidx, slot] = v_new[:, valid].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = positions[valid].to(torch.int32)
    partial = _decode_attn_math(params, q, cache["k"], cache["v"],
                                cache["pos"], positions, x_dtype=x.dtype,
                                cfg=cfg, lay=lay, window=window)
    return partial, cache


def cache_rows(cache_layer, off: int, rows: int):
    """Views of batch rows ``[off, off + rows)`` of one cache layer; writes
    through them land in the full cache."""
    return {name: (t[off:off + rows] if name == "pos"
                   else t[:, off:off + rows])
            for name, t in cache_layer.items()}


def init_kv_cache(batch: int, max_len: int, cfg, tp: int, *, window: int = 0,
                  dtype=None, device=None):
    """One layer's slot cache; C = min(max_len, window) for sliding layers
    (the ring buffer is the window).  Rank r stores its kv_store heads,
    the reference's global head axis ``[r·kv_store, (r+1)·kv_store)``."""
    lay = attention_layout(tp, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    c = min(max_len, window) if window > 0 else max_len
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (tp, batch, c, lay.kv_store, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, c), -1, dtype=torch.int32, device=device),
    }
