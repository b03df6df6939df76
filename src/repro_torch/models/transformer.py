"""Decoder-only transformer (dense family) with the TokenWeave two-split
weave, as ``repro.models.transformer``.

The weave (paper Fig. 8) emits, with two token splits s0/s1,

    attn(s0) ; AR-norm(s0) ; attn(s1) ; AR-norm(s1) ;
    ffn(s0)  ; AR-norm(s0) ; ffn(s1)  ; AR-norm(s1)

and the suffix split's attention takes the prefix split's KV as
``kv_prefix`` (§3.1).  At tp=1 there is no collective to overlap, so the
splits run one after the other on one stream; the split points, and with
them every key each split sees, are the reference's exactly.  CUDA streams
and events come with the tp>1 slice.

Parameters are a plain dict: {"embedding": {"embed" (V, d), "lm_head"
(d, V)}, "norm_first" (d,), "layers": [per-layer dicts]} — the reference's
pytree without its per-shard axis.  Norm-weight convention (off by one,
like vLLM's fused add+norm): layer i's post-FFN add+norm applies layer
i+1's input norm; ``norm_ffn`` of the last layer is the final norm;
``norm_first`` is layer 0's input norm, applied at the embedding.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import fused_collectives as fc
from repro_torch.core.policy import DEFAULT_POLICY, ThresholdPolicy
from repro_torch.core.splitting import token_bucket
from repro_torch.device import resolve_device
from repro_torch.distributed.context import CommCtx
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mlp as M


@dataclasses.dataclass(frozen=True)
class LayerKind:
    window: int          # 0 = full attention
    theta: float
    is_moe: bool = False


def layer_kinds(cfg: ModelConfig) -> List[LayerKind]:
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.local_global_period:
            is_global = (i % cfg.local_global_period) == cfg.local_global_period - 1
            kinds.append(LayerKind(
                window=0 if is_global else cfg.sliding_window,
                theta=cfg.rope_theta if is_global else
                (cfg.rope_theta_local or cfg.rope_theta),
                is_moe=cfg.is_moe))
        else:
            kinds.append(LayerKind(window=cfg.sliding_window,
                                   theta=cfg.rope_theta, is_moe=cfg.is_moe))
    return kinds


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (CUDA unless given), with the reference's scales (attention and MLP
    inputs d^-0.5, MLP down d_ff^-0.5, embedding 0.02, LM head d^-0.5;
    norms ones).  The values differ from the reference's jax.random ones;
    tests move the reference's weights over with
    ``weights.from_jax_params`` instead."""
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError("only the dense family is ported")
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = A.attention_layout(1, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    s = d ** -0.5

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype) * scale

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": rnd((d, lay.h_loc * dh), s),
                "wk": rnd((d, lay.kv_store * dh), s),
                "wv": rnd((d, lay.kv_store * dh), s),
                "wo": rnd((lay.h_loc * dh, d), s)}
        if cfg.qkv_bias:
            for name, w in (("bq", lay.h_loc), ("bk", lay.kv_store),
                            ("bv", lay.kv_store)):
                attn[name] = torch.zeros(w * dh, dtype=dtype, device=device)
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones(dh, dtype=dtype, device=device)
            attn["k_norm"] = torch.ones(dh, dtype=dtype, device=device)
        mlp = {"w_gate": rnd((d, f), s), "w_up": rnd((d, f), s),
               "w_down": rnd((f, d), f ** -0.5)}
        lp = {"attn": attn, "norm_attn": ones(), "norm_ffn": ones(),
              "mlp": mlp}
        if cfg.sandwich_norms:
            lp["norm_attn_post"] = ones()
            lp["norm_ffn_post"] = ones()
        layers.append(lp)
    emb = {"embed": rnd((cfg.vocab_size, d), 0.02)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = rnd((d, cfg.vocab_size), s)
    return {"embedding": emb, "norm_first": ones(), "layers": layers}


# --------------------------------------------------------------------------
# single layer on one split
# --------------------------------------------------------------------------

def _layer_split(lp, h, res, *, positions, kind: LayerKind, cfg, pcfg,
                 ctx: CommCtx, lay, kv_prefix, cache_layer, decode: bool):
    """One transformer layer on one token split.
    Returns (h_next, res, chunk kv (prefill) or the cache layer (decode))."""
    if kind.is_moe:
        raise NotImplementedError("MoE layers are not ported (ROADMAP.md A10)")
    if decode and h.shape[1] > 1:
        a_part, kv_out = A.attn_verify(
            lp["attn"], h, cache_layer, positions=positions, cfg=cfg,
            lay=lay, theta=kind.theta, window=kind.window)
    elif decode:
        a_part, kv_out = A.attn_decode(
            lp["attn"], h, cache_layer, positions=positions, cfg=cfg, lay=lay,
            theta=kind.theta, window=kind.window)
    else:
        a_part, kv_out = A.attn_prefill(
            lp["attn"], h, positions=positions, cfg=cfg, lay=lay,
            theta=kind.theta, window=kind.window, kv_prefix=kv_prefix,
            impl=pcfg.attn_impl)

    b, s, d = h.shape
    h2_flat, res = fc.comm_norm(a_part.reshape(b * s, d), res,
                                lp["norm_attn"], ctx=ctx,
                                weight_post=lp.get("norm_attn_post"))
    f_part = M.mlp_forward(lp["mlp"], h2_flat.reshape(b, s, d), act=cfg.act)
    h3_flat, res = fc.comm_norm(f_part.reshape(b * s, d), res,
                                lp["norm_ffn"], ctx=ctx,
                                weight_post=lp.get("norm_ffn_post"))
    return h3_flat.reshape(b, s, d), res, kv_out


def _weave_layer(lp, state, cache_layer, *, kind, cfg, pcfg, ctx, lay,
                 decode: bool):
    """Run one layer over one or two splits in paper-Fig.8 order.
    Returns (state, chunk kv (prefill) or the updated cache layer)."""
    n = len(state["h"])
    new_h, new_res = list(state["h"]), list(state["res"])
    if decode:
        # batch split: each split updates its own rows of the cache in
        # place through views, so the full cache is the result
        off = 0
        for i in range(n):
            rows = state["h"][i].shape[0]
            cl = {name: t[off:off + rows] for name, t in cache_layer.items()}
            new_h[i], new_res[i], _ = _layer_split(
                lp, state["h"][i], state["res"][i],
                positions=state["positions"][i], kind=kind, cfg=cfg,
                pcfg=pcfg, ctx=ctx, lay=lay, kv_prefix=None, cache_layer=cl,
                decode=True)
            off += rows
        return dict(state, h=new_h, res=new_res), cache_layer

    kv_prev = _cache_prefix(cache_layer)
    kv_outs = []
    for i in range(n):
        new_h[i], new_res[i], kv = _layer_split(
            lp, state["h"][i], state["res"][i],
            positions=state["positions"][i], kind=kind, cfg=cfg, pcfg=pcfg,
            ctx=ctx, lay=lay, kv_prefix=kv_prev, cache_layer=None,
            decode=False)
        kv_outs.append(kv)
        # later splits attend to cache prefix + all earlier splits' kv
        kv_prev = kv if kv_prev is None else tuple(
            torch.cat([a, b], dim=1) for a, b in zip(kv_prev, kv))
    kv_new = kv_outs[0] if n == 1 else tuple(
        torch.cat([a, b], dim=1) for a, b in zip(*kv_outs))
    return dict(state, h=new_h, res=new_res), kv_new


def _cache_prefix(cache_layer):
    if cache_layer is None:
        return None
    return (cache_layer["k"], cache_layer["v"], cache_layer["pos"])


# --------------------------------------------------------------------------
# weave decision
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeaveInfo:
    """The weave decision for one forward dispatch: the split (in the
    dispatch's native axis units) and why it was or wasn't taken."""
    weave: bool
    split: Optional[Tuple[int, int]]
    reason: str   # split | weave_disabled | below_min_tokens | below_wave_floor
    axis: str     # batch | seq
    threshold: int  # configured tokenweave_min_tokens (tokens)
    unit: int       # effective wave quantum the decision used
    site: str = ""      # prefill | decode | verify
    plan_id: int = 0
    bucket: str = ""


def _active_policy(pcfg: ParallelConfig):
    policy = pcfg.overlap_policy or DEFAULT_POLICY
    if not isinstance(policy, ThresholdPolicy):
        raise NotImplementedError("tuned overlap plans (TunedPolicy) are not "
                                  "ported yet (ROADMAP.md A2)")
    return policy


def weave_decision_info(b: int, s: int, *, tp: int, pcfg: ParallelConfig,
                        decode: bool = False, packed: bool = False,
                        paged_pool: bool = False,
                        family: str = "dense") -> WeaveInfo:
    """Host-side weave split decision, as the reference's: prefill splits
    along the sequence (all rows cut at the same position), decode and
    verify along the batch."""
    if packed or paged_pool:
        raise NotImplementedError("packed and paged dispatch are the next "
                                  "slice (ROADMAP.md A6)")
    thr = pcfg.tokenweave_min_tokens
    policy = _active_policy(pcfg)
    site = ("decode" if decode and s == 1 else
            "verify" if decode else "prefill")
    if not pcfg.tokenweave:
        return WeaveInfo(False, None, "weave_disabled",
                         "batch" if decode else "seq", thr, 0, site=site,
                         plan_id=policy.plan_id, bucket=token_bucket(b * s))
    if decode:
        unit = max(tp, 8)
        if s > 1:
            min_rows = max(2 * unit, -(-thr // s))
            d = policy.decide("verify", b, unit=unit, min_tokens=min_rows,
                              tp=tp, family=family, bucket_tokens=b * s)
        else:
            d = policy.decide("decode", b, unit=unit, min_tokens=2 * unit,
                              tp=tp, family=family)
        return WeaveInfo(d.split is not None, d.split, d.reason, "batch",
                         thr, d.unit, site=site, plan_id=d.plan_id,
                         bucket=d.bucket)
    d = policy.decide("prefill", b * s, unit=pcfg.split_unit_for(tp),
                      min_tokens=thr, row_multiple=b, tp=tp, family=family)
    split = None if d.split is None else (d.split[0] // b, d.split[1] // b)
    return WeaveInfo(split is not None, split, d.reason, "seq", thr, d.unit,
                     site="prefill", plan_id=d.plan_id, bucket=d.bucket)


def _comm_ctx(pcfg: ParallelConfig, cfg: ModelConfig, t_local: int,
              tp: int) -> CommCtx:
    """The token-sharded modes need t_local divisible by tp; otherwise fall
    back to vanilla (the paper's fallback for small decode batches)."""
    mode = pcfg.comm_mode
    if (mode in ("fused", "reordered", "ring")
            and (t_local % tp != 0 or t_local < tp)):
        mode = "vanilla"
    return CommCtx(mode=mode, eps=cfg.norm_eps,
                   use_pallas=pcfg.use_pallas_norm, tp=tp)


def _entry_norm(emb, w_first, ctx):
    """Split-local embedding -> residual birth + first input norm."""
    b, s, d = emb.shape
    res0 = fc.fresh_residual(b * s, d, emb.dtype, ctx=ctx, device=emb.device)
    h_flat, res = fc.comm_norm(emb.reshape(b * s, d), res0, w_first, ctx=ctx)
    return h_flat.reshape(b, s, d), res


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig,
            positions=None, cache=None, decode: bool = False):
    """Shared forward.  Returns (hidden_normed (B, S, d), kv_or_cache).

    prefill chunk: ``cache`` = the request rows of the KV cache (attended
    as prefix); returns the chunk's new kv per layer, [(k, v, pos)], for
    the engine to insert.
    decode: ``cache`` = the full slot cache (updated in place and
    returned); S == 1, or S == gamma+1 for a verify window.
    """
    tp = 1
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    winfo = weave_decision_info(b, s, tp=tp, pcfg=pcfg, decode=decode,
                                family=cfg.family)
    ctx = _comm_ctx(pcfg, cfg, b * s, tp)
    emb = E.embed_tokens(params["embedding"], tokens, scale=cfg.embed_scale)
    w_first = params["norm_first"]

    split = winfo.split
    if split is not None and not decode:
        s1 = split[0]
        embs = [emb[:, :s1], emb[:, s1:]]
        poss = [positions[:, :s1], positions[:, s1:]]
    elif split is not None:
        b1 = split[0]
        embs = [emb[:b1], emb[b1:]]
        poss = [positions[:b1], positions[b1:]]
    else:
        embs, poss = [emb], [positions]

    hs, ress = [], []
    for e in embs:
        h_i, r_i = _entry_norm(e, w_first, ctx)
        hs.append(h_i)
        ress.append(r_i)
    state = {"h": hs, "res": ress, "positions": poss}

    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    kv_all = []
    for i, kind in enumerate(layer_kinds(cfg)):
        cache_layer = None if cache is None else cache[i]
        state, kv_new = _weave_layer(
            params["layers"][i], state, cache_layer, kind=kind, cfg=cfg,
            pcfg=pcfg, ctx=ctx, lay=lay, decode=decode)
        kv_all.append(kv_new)

    h_out = (torch.cat(state["h"], dim=0 if decode else 1)
             if len(state["h"]) == 2 else state["h"][0])
    return h_out, kv_all


def prefill(params, tokens, cache, *, cfg, pcfg, positions, last_idx=None):
    """One (chunked) prefill step.  Returns (logits at each row's last
    valid token (B, 1, V), chunk kv per layer).  ``last_idx``: per-row
    index of the last unpadded token in the chunk."""
    h, kv = forward(params, tokens, cfg=cfg, pcfg=pcfg, positions=positions,
                    cache=cache)
    if last_idx is None:
        h_last = h[:, -1:]
    else:
        idx = last_idx.long()[:, None, None].expand(-1, 1, h.shape[-1])
        h_last = torch.gather(h, 1, idx)
    return E.lm_head_logits(params["embedding"], h_last), kv


def decode_step(params, tokens, cache, *, cfg, pcfg, positions):
    """Single-token decode (or verify window).  Returns (logits (B, S, V),
    the cache, updated in place)."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions, cache=cache, decode=True)
    return E.lm_head_logits(params["embedding"], h), new_cache


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               device=None, dtype=None):
    """Slot KV cache on ``device`` (CUDA unless given): one {"k", "v",
    "pos"} dict per layer."""
    device = resolve_device(device)
    return [A.init_kv_cache(batch, max_len, cfg, tp, window=k.window,
                            dtype=dtype, device=device)
            for k in layer_kinds(cfg)]
