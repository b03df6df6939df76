"""Whisper-style encoder-decoder, as ``repro.models.encdec``: the conv
frontend is stubbed (the caller gives frame embeddings (B, S_enc, d)),
positions are learned tables, the FFN is GELU with biases.

Encoder: bidirectional self-attention (kernel K3 with ``causal=False``)
and the FFN, two add+norm slots a layer.  Its weave splits the *batch*
(a sequence split would make each half's keys depend on the other's),
by its own rule: half the rows, shrunk until both halves' tokens divide
over the ranks, when there are at least 2 rows and
``tokenweave_min_tokens`` tokens.  Decoder: causal self-attention over
the self cache (K3 for the prompt), cross-attention over the encoder's
projected keys and values, and the FFN, three slots a layer, woven as
the dense stack (``models.transformer``'s ``_Weave``, ``_decide_split``,
``_comm_ctx`` and ``_entry_norm``): a prompt split along the sequence
hands the suffix the prefix's KV, a decode split along the batch slices
the cross caches' rows.  The port issues each layer in Fig. 8's order
(every split's attention and slot, then every split's next block); the
reference runs each split's whole layer in turn: the same function.

Parameters: {"embedding", "pos_enc" (S_enc, d), "pos_dec" (P, d),
"norm_first_enc" (d,), "norm_first" (d,), "enc_layers": [{"attn",
"mlp", "norm_attn", "norm_ffn"}], "dec_layers": [{"attn", "cross" (no
q/k/v bias), "mlp", "norm_attn", "norm_cross", "norm_ffn"}]}.  The
decoder table is grown to ``max_positions`` (4096), the reference's
documented deviation from Whisper's 448.

Cache: {"self": one slot KV dict per decoder layer, as the
transformer's; "cross": per decoder layer {"k", "v" (R, B, S_enc,
kv_store, dh), "pos" (B, S_enc)}}.  ``prefill`` returns the prompt's
self KV per layer, [(k, v, pos)], and the cross caches, for the caller to
write into the cache (``runtime.kv_cache.insert_chunk`` and
``write_rows``); ``decode_step`` updates the self cache in place.  The
engine does not serve this family; the reference serves it by direct
calls too.

With ``dp`` = D data shards the batch lies over D, as the reference's
self and cross caches' batch over ``dp_axes``: the frames, the tokens
and both caches hold the D shards' rows one shard after the other, the
encoder's and the decoder's weave decisions, the comm mode's fallback
and the slots' token ownership follow each shard's rows, and a batch
split (the encoder's, a decode's) takes the same rows of every shard.

With ``groups`` each process holds one model rank (R = 1:
``init_params(rank=)`` cuts encoder and decoder layers alike), the
frames and the decoder's positional rows enter the entry norms divided
by the model group's tp, and every slot runs over the group; cross
attention needs no collective of its own (its keys and values are the
rank's heads of the replicated encoder output, its output is partial
like self attention's and goes through the ``norm_cross`` slot); at a
data group of D > 1 it holds its data shard's rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import generator, randn_ranks, resolve_device
from repro_torch.distributed.context import Groups
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mlp as M
from repro_torch.models import transformer as TR
from repro_torch.models.mamba_model import embedding_params, group_dp, xent
from repro_torch.runtime import kv_cache as KC

MAX_DECODER_POSITIONS = 4096


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, dtype=None,
                tp: int = 1, max_positions: int = MAX_DECODER_POSITIONS,
                rank: Optional[int] = None):
    """Random weights for ``tp`` ranks from a seeded ``torch.Generator``
    on ``device`` (CUDA unless given), with the reference's scales
    (projections d^-0.5, FFN out d_ff^-0.5, position tables 0.02, biases
    zero, norms ones) and shapes.  With ``rank``, model rank ``rank``'s
    weights alone (``weights.take_rank`` of the tp-rank draw), each leaf
    drawn whole and cut at once."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = generator(device, seed)
    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    if f % tp:
        raise ValueError(f"d_ff={f} is not a multiple of tp={tp}")
    s = d ** -0.5
    r = tp if rank is None else 1

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def sharded(shape, scale):
        return (randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(n=d):
        return torch.ones(n, dtype=dtype, device=device)

    def attn(cross: bool):
        p = {"wq": sharded((d, lay.h_loc * dh), s),
             "wk": sharded((d, lay.kv_store * dh), s),
             "wv": sharded((d, lay.kv_store * dh), s),
             "wo": sharded((lay.h_loc * dh, d), s)}
        if cfg.qkv_bias and not cross:
            p.update(bq=zeros(r, lay.h_loc * dh),
                     bk=zeros(r, lay.kv_store * dh),
                     bv=zeros(r, lay.kv_store * dh))
        if cfg.qk_norm:
            p.update(q_norm=ones(dh), k_norm=ones(dh))
        return p

    def mlp():
        return {"w_in": sharded((d, f // tp), s), "b_in": zeros(r, f // tp),
                "w_out": sharded((f // tp, d), f ** -0.5), "b_out": zeros(d)}

    enc = [{"attn": attn(False), "mlp": mlp(), "norm_attn": ones(),
            "norm_ffn": ones()} for _ in range(cfg.encoder_layers)]
    dec = [{"attn": attn(False), "cross": attn(True), "mlp": mlp(),
            "norm_attn": ones(), "norm_cross": ones(), "norm_ffn": ones()}
           for _ in range(cfg.num_layers)]
    return {"embedding": embedding_params(gen, cfg, tp, device=device,
                                          dtype=dtype, rank=rank),
            "pos_enc": rnd((cfg.max_source_positions, d), 0.02),
            "pos_dec": rnd((max_positions, d), 0.02),
            "norm_first_enc": ones(), "norm_first": ones(),
            "enc_layers": enc, "dec_layers": dec}


def _layout(cfg: ModelConfig, tp: int) -> A.AttnLayout:
    return A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim)


def encoder_split(b: int, s: int, *, tp: int, pcfg: ParallelConfig):
    """The encoder weave's cut along the batch (rows of the first split),
    or None: half the rows, shrunk until both halves' b·s tokens divide
    by tp, when b >= 2 and b·s >= ``tokenweave_min_tokens``."""
    if not (pcfg.tokenweave and b >= 2
            and b * s >= pcfg.tokenweave_min_tokens):
        return None
    half = b // 2
    while half > 0 and ((half * s) % tp or ((b - half) * s) % tp):
        half -= 1
    return half or None


def _enc_layer(lp, hs, ress, *, positions, cfg, pcfg, lay, weave):
    """One encoder layer over the batch splits ``hs``."""
    hs, ress = list(hs), list(ress)
    s = positions.shape[1]
    for i in range(len(hs)):
        weave.wait(i)
        a_part, _ = A.attn_prefill(
            lp["attn"], hs[i], positions=positions.expand(hs[i].shape[1], s),
            cfg=cfg, lay=lay, theta=cfg.rope_theta, causal=False,
            impl=pcfg.attn_impl)
        hs[i], ress[i] = weave.comm_norm(i, a_part, ress[i],
                                         lp["norm_attn"])
    for i in range(len(hs)):
        weave.wait(i)
        hs[i], ress[i] = weave.comm_norm(
            i, M.mlp_forward(lp["mlp"], hs[i], ctx=weave.ctx), ress[i],
            lp["norm_ffn"])
    return hs, ress


def _data_ctx(pcfg, cfg, b: int, s: int, tp: int, dp: int, groups):
    """(rows per data shard, data shards folded into the batch, the
    CommCtx) of a forward over ``b`` rows of ``s`` tokens."""
    b_loc, dsplit = (b, 1) if groups is not None else TR.batch_layout(b, dp)
    ctx = TR._comm_ctx(pcfg, cfg, b_loc * s, tp, groups=groups,
                       dp=dsplit if groups is None else group_dp(groups))
    return b_loc, dsplit, ctx


def encode(params, frames, *, cfg: ModelConfig, pcfg: ParallelConfig,
           train: bool = False, dp: int = 1,
           groups: Optional[Groups] = None):
    """frames (B, S_enc, d), stub embeddings -> the encoder's output (R,
    B, S_enc, d), the same on every rank.  ``train``: each layer under
    ``remat`` when ``pcfg.remat``.  ``dp``: B holds that many data shards'
    rows (module docstring).  ``groups``: this process holds one model
    rank of the model group (R = 1)."""
    tp = TR._model_ranks(params, groups)
    b, s, _ = frames.shape
    dev = frames.device
    b_loc, dsplit, ctx = _data_ctx(pcfg, cfg, b, s, tp, dp, groups)
    x = frames + params["pos_enc"][:s].to(frames.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    b1 = encoder_split(b_loc, s, tp=tp, pcfg=pcfg)
    split = None if b1 is None else (b1, b_loc - b1)
    rows = TR.shard_split_rows(split, b_loc, dsplit, dev)
    xs = ([x[idx] for idx in rows] if rows[0] is not None
          else [x[lo:hi] for lo, hi in TR._split_cuts(split, b)])
    weave = TR._Weave(len(xs), ctx, dev, overlap=not train)
    # the frames are complete values: /tp, so the entry norm's sum over
    # the ranks gives them back
    hs, ress = map(list, zip(*(
        TR._entry_norm(weave, i, (xi / tp).expand(ctx.local_ranks, *xi.shape),
                       params["norm_first_enc"])
        for i, xi in enumerate(xs))))
    layer = TR.remat(_enc_layer, train and pcfg.remat)
    for lp in params["enc_layers"]:
        hs, ress = layer(lp, hs, ress, positions=positions, cfg=cfg,
                         pcfg=pcfg, lay=_layout(cfg, tp), weave=weave)
    for i in range(len(hs)):
        weave.wait(i)
    return TR.rows_in_batch_order(
        torch.cat(hs, dim=1) if len(hs) == 2 else hs[0], rows)


def project_cross_caches(params, enc_out, *, cfg: ModelConfig,
                         pcfg: ParallelConfig,
                         groups: Optional[Groups] = None):
    """Each decoder layer's cross keys and values from the encoder's
    output (R, B, S_enc, d): [{"k", "v" (R, B, S_enc, kv_store, dh),
    "pos" (B, S_enc)}], the local ranks' heads."""
    lay = _layout(cfg, TR._model_ranks(params, groups))
    return [dict(zip(("k", "v", "pos"), A.project_cross_kv(
        lp["cross"], enc_out, cfg=cfg, lay=lay)))
        for lp in params["dec_layers"]]


def _split_cache(cache_l, i: int, hs, split_rows):
    """Decode split i's rows of a cache layer: views of its contiguous
    rows, or (with the batch over D) a copy of ``split_rows[i]``'s."""
    if split_rows[i] is not None:
        return KC.gather_slots([cache_l], split_rows[i])[0]
    off = sum(h.shape[1] for h in hs[:i])
    return A.cache_rows(cache_l, off, hs[i].shape[1])


def _dec_layer(lp, hs, ress, cache_l, cross_l, *, poss, split_rows,
               decode: bool, cfg, pcfg, lay, weave):
    """One decoder layer over the splits: self attention (prefill: the
    cache rows ``cache_l`` and every earlier split's KV as prefix; decode:
    each split's rows of ``cache_l``, written in place), cross attention
    over ``cross_l`` and the FFN.  ``split_rows``: a decode split's rows
    (``transformer.shard_split_rows``).  Returns (hs, ress, the prompt's
    self KV (prefill) or None)."""
    hs, ress = list(hs), list(ress)

    def cross_of(i):
        """Split i's rows of the cross cache (a decode split slices the
        batch; prompt splits share every row)."""
        c = cross_l
        if decode and len(hs) == 2:
            c = _split_cache(c, i, hs, split_rows)
        return c["k"], c["v"], c["pos"]

    kv_prev = (None if decode or cache_l is None else
               (cache_l["k"], cache_l["v"], cache_l["pos"]))
    kv_outs = []
    for i in range(len(hs)):
        weave.wait(i)
        geo = dict(positions=poss[i], cfg=cfg, lay=lay,
                   theta=cfg.rope_theta)
        if decode:
            cl = _split_cache(cache_l, i, hs, split_rows)
            a_part, _ = A.attn_decode(lp["attn"], hs[i], cl, **geo)
            if split_rows[i] is not None:
                KC.write_rows([cache_l], [cl], split_rows[i])
        else:
            a_part, kv = A.attn_prefill(lp["attn"], hs[i],
                                        kv_prefix=kv_prev,
                                        impl=pcfg.attn_impl, **geo)
            kv_outs.append(kv)
            kv_prev = kv if kv_prev is None else TR.cat_kv(kv_prev, kv)
        hs[i], ress[i] = weave.comm_norm(i, a_part, ress[i],
                                         lp["norm_attn"])
    for i in range(len(hs)):
        weave.wait(i)
        c_part = A.attn_cross(lp["cross"], hs[i], cross_of(i), cfg=cfg,
                              lay=lay)
        hs[i], ress[i] = weave.comm_norm(i, c_part, ress[i],
                                         lp["norm_cross"])
    for i in range(len(hs)):
        weave.wait(i)
        hs[i], ress[i] = weave.comm_norm(
            i, M.mlp_forward(lp["mlp"], hs[i], ctx=weave.ctx), ress[i],
            lp["norm_ffn"])
    if decode:
        return hs, ress, None
    return hs, ress, (kv_outs[0] if len(kv_outs) == 1
                      else TR.cat_kv(*kv_outs))


def decoder_forward(params, tokens, *, cfg: ModelConfig,
                    pcfg: ParallelConfig, cross_kv, positions=None,
                    cache=None, decode: bool = False, train: bool = False,
                    dp: int = 1, groups: Optional[Groups] = None):
    """The causal decoder over ``cross_kv`` (``project_cross_caches``).
    Returns (hidden (R, B, S, d), the same on every rank, the prompt's
    self KV per layer [(k, v, pos)] (prefill: ``cache``, the self cache's
    rows, is attended as prefix) or ``cache``, updated in place
    (decode)).  ``train``: no cache, no KV kept (None returned), each
    layer under ``remat`` when ``pcfg.remat``.  ``dp``: the batch holds
    that many data shards' rows (module docstring).  ``groups``: this
    process holds one model rank of the model group (R = 1)."""
    tp = TR._model_ranks(params, groups)
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
    positions = positions.to(dev)
    b_loc, dsplit, ctx = _data_ctx(pcfg, cfg, b, s, tp, dp, groups)
    emb = E.embed_tokens(params["embedding"], tokens, ctx=ctx)
    table = params["pos_dec"]
    pos_emb = table[positions.long().clamp(0, table.shape[0] - 1)]
    emb = emb + pos_emb.to(emb.dtype) / tp

    split = TR._decide_split(b_loc, s, tp=tp, pcfg=pcfg, decode=decode)
    cuts = TR._split_cuts(split, b if decode else s)
    rows = (TR.shard_split_rows(split, b_loc, dsplit, dev) if decode
            else [None] * len(cuts))
    if rows[0] is not None:
        embs = [emb[:, idx] for idx in rows]
        poss = [positions[idx] for idx in rows]
    elif decode:
        embs = [emb[:, lo:hi] for lo, hi in cuts]
        poss = [positions[lo:hi] for lo, hi in cuts]
    else:
        embs = [emb[:, :, lo:hi] for lo, hi in cuts]
        poss = [positions[:, lo:hi] for lo, hi in cuts]

    weave = TR._Weave(len(embs), ctx, dev, overlap=not train)
    hs, ress = map(list, zip(*(TR._entry_norm(weave, i, e,
                                              params["norm_first"])
                               for i, e in enumerate(embs))))
    layer = TR.remat(_dec_layer, train and pcfg.remat)
    kv_all = []
    for li, lp in enumerate(params["dec_layers"]):
        cache_l = None if cache is None else cache[li]
        hs, ress, kv = layer(lp, hs, ress, cache_l, cross_kv[li], poss=poss,
                             split_rows=rows, decode=decode, cfg=cfg,
                             pcfg=pcfg, lay=_layout(cfg, tp), weave=weave)
        if not train:
            kv_all.append(cache_l if decode else kv)
    for i in range(len(hs)):
        weave.wait(i)
    h_out = (torch.cat(hs, dim=1 if decode else 2) if len(hs) == 2
             else hs[0])
    return (TR.rows_in_batch_order(h_out, rows),
            None if train else cache if decode else kv_all)


def train_loss(params, batch, *, cfg: ModelConfig, pcfg: ParallelConfig,
               aux_weight: float = 0.0, dp: int = 1,
               groups: Optional[Groups] = None):
    """batch {"frames" (B, S_enc, d), "tokens" (B, S), "labels" (B, S)} ->
    (loss_sum, denom, aux), each (D,) float32, one entry per data shard of
    the ``dp`` the batch splits over (no aux loss): the encoder over the
    frames, the cross caches, the decoder over the tokens.  With
    ``groups`` the batch is this process's data-parallel shard's rows and
    each is (1,)."""
    frames = batch["frames"].to(params["pos_enc"].dtype)
    kw = dict(cfg=cfg, pcfg=pcfg, groups=groups)
    enc_out = encode(params, frames, train=True, dp=dp, **kw)
    cross = project_cross_caches(params, enc_out, **kw)
    h, _ = decoder_forward(params, batch["tokens"].to(frames.device),
                           cross_kv=cross, train=True, dp=dp, **kw)
    ls, dn = xent(params, h, batch["labels"], cfg, pcfg, groups, dp)
    return ls, dn, torch.zeros_like(ls)


def prefill(params, tokens, cache, *, cfg: ModelConfig,
            pcfg: ParallelConfig, frames, positions=None, dp: int = 1,
            groups: Optional[Groups] = None):
    """Encode ``frames`` (B, S_enc, d), project the cross caches and run
    the decoder prompt ``tokens`` (B, S) (attending ``cache["self"]``'s
    rows as prefix when a cache is given).  Returns (local logits at the
    last position (R, B, 1, V_loc), {"self": the prompt's KV per layer,
    "cross": the cross caches})."""
    enc_out = encode(params, frames, cfg=cfg, pcfg=pcfg, dp=dp,
                     groups=groups)
    cross = project_cross_caches(params, enc_out, cfg=cfg, pcfg=pcfg,
                                 groups=groups)
    h, kv = decoder_forward(params, tokens, cfg=cfg, pcfg=pcfg,
                            cross_kv=cross, positions=positions,
                            cache=None if cache is None else cache["self"],
                            dp=dp, groups=groups)
    return (E.lm_head_logits(params["embedding"], h[:, :, -1:]),
            {"self": kv, "cross": cross})


def decode_step(params, tokens, cache, *, cfg: ModelConfig,
                pcfg: ParallelConfig, positions, dp: int = 1,
                groups: Optional[Groups] = None):
    """One token per row over the self and cross caches.  Returns (local
    logits (R, B, 1, V_loc), the cache, its self part updated in
    place)."""
    h, _ = decoder_forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           cross_kv=cache["cross"], positions=positions,
                           cache=cache["self"], decode=True, dp=dp,
                           groups=groups)
    return E.lm_head_logits(params["embedding"], h), cache


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               enc_len: int | None = None, device=None, dtype=None,
               dp: int = 1, groups: Optional[Groups] = None):
    """Empty self caches of ``max_len`` slots and zero cross caches of
    ``enc_len`` (the config's source length unless given) encoder
    positions, per decoder layer, on ``device`` (CUDA unless given), in
    the global layout the reference shards over its data axes: ``batch``
    rows over ``dp`` data shards.  With ``groups``, this process's model
    rank's heads (R = 1) of its data shard's ``batch`` / ``dp`` rows."""
    device = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    s_enc = enc_len or cfg.max_source_positions
    lay = _layout(cfg, tp)
    ranks = tp if groups is None else 1
    rows, _ = TR.batch_layout(batch, dp)
    if groups is not None:
        batch = rows
    shape = (ranks, batch, s_enc, lay.kv_store, cfg.head_dim)

    def cross():
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "pos": torch.zeros(batch, s_enc, dtype=torch.int32,
                                   device=device)}
    return {"self": [A.init_kv_cache(batch, max_len, cfg, tp, dtype=dtype,
                                     device=device, ranks=ranks)
                     for _ in range(cfg.num_layers)],
            "cross": [cross() for _ in range(cfg.num_layers)]}
