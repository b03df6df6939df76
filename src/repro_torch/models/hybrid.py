"""Zamba2-style hybrid: a Mamba-2 backbone plus one *shared* attention
block applied every ``shared_attn_period`` layers with a per-invocation
LoRA, as ``repro.models.hybrid`` (arXiv:2411.15242).

The shared block is a 2·d-wide attention: its input is concat(hidden,
initial embedding), re-normed by its own input norm, with head dim
2·d / heads and no qk-norm or bias (``_shared_attn_cfg``); a rank-16 LoRA
modulates its q projection per invocation, and its output projection maps
back to d.  Placement is uniform: ``n_inv`` groups of (shared block,
``period`` Mamba-2 layers), then the remaining tail layers.  The weave: the
shared attention behaves like a dense layer (the suffix split attends the
prefix split's KV, its prefill through K3), each Mamba-2 layer passes the
prefix split's final state to the suffix (``mamba_model.mamba_weave``);
every block's output goes through the AllReduce-norm slot.

The embedding is summed over the ranks once (every shared-block input
reuses the complete rows) and enters the entry norm divided by tp, whose
AllReduce gives it back whole.

Parameters: {"embedding", "norm_first" (d,), "layers": [{"mamba": Mamba-2
weights, "norm_out" (d,)}], "shared": {"attn": {"wq" (R, 2d, h_loc·dh),
"wk", "wv", "wo" (R, h_loc·dh, d)}, "norm_in" (2d,), "norm_out" (n_inv,
d), "lora_a" (n_inv, 2d, 16), "lora_b" (n_inv, R, 16, h_loc·dh)}}.

Cache: {"mamba": ``layers.ssm.init_mamba2_state``'s stacked state, "shared":
one slot KV cache dict per invocation, as the transformer's layers}.
``prefill`` reads it (the shared blocks attend its KV as prefix, the
Mamba-2 layers resume its state), writes the new Mamba-2 state into it in
place, and returns the chunk's shared KV per invocation, [(k, v, pos)],
for the caller to insert (``runtime.kv_cache.insert_chunk``); ``decode_step``
updates both in place.  The engine does not serve this family; the
reference serves it by direct calls too.

Under ``pcfg.seq_shard_kv`` with ``dp`` = D data shards the shared
block's decode is context-parallel, as the reference's: its caches'
sequence lies over D and each decode combines the D chunks
(``layers.attention.attn_decode(seq_shards=D)``); the batch is whole on
every shard.  A batch split over D is not ported for this family.

With ``groups`` each process holds one model rank (R = 1: ``init_params(
rank=)``, the shared block's ``lora_b`` cut on its rank axis, axis 1),
the embedding's sum and the slots run over the model group; under
``seq_shard_kv`` at a data group of D > 1 each data rank holds C/D slots
of every shared cache and the shared block's decode combines over the
data group (its batch over D stays unported, as on the rank axis).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import generator, randn_ranks, resolve_device
from repro_torch.distributed.collectives import psum
from repro_torch.distributed.context import Groups
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.layers.norms import rms_norm
from repro_torch.models import mamba_model as MM
from repro_torch.models import transformer as TR

LORA_RANK = 16


def _n_groups(cfg: ModelConfig):
    p = cfg.shared_attn_period
    return cfg.num_layers // p, cfg.num_layers % p


def _shared_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, d_model=2 * cfg.d_model,
        head_dim=2 * cfg.d_model // cfg.num_heads, qk_norm=False,
        qkv_bias=False, mrope_sections=())


def _shared_layout(cfg: ModelConfig, tp: int):
    acfg = _shared_attn_cfg(cfg)
    return acfg, A.attention_layout(tp, acfg.num_heads, acfg.num_kv_heads,
                                    acfg.head_dim)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, dtype=None,
                tp: int = 1, rank: Optional[int] = None):
    """Random weights for ``tp`` ranks from a seeded ``torch.Generator``
    on ``device`` (CUDA unless given), with the reference's scales and
    shapes (LoRA A 0.01, LoRA B zero, the shared output projection
    (2d)^-0.5).  With ``rank``, model rank ``rank``'s weights alone
    (``weights.take_rank`` of the tp-rank draw), each leaf drawn whole
    and cut at once."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = generator(device, seed)
    d = cfg.d_model
    n_inv, _ = _n_groups(cfg)
    acfg, lay = _shared_layout(cfg, tp)
    hd = lay.h_loc * acfg.head_dim

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def sharded(shape, scale):
        return (randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    layers = [{"mamba": S.init_mamba2_params(gen, cfg, tp, device=device,
                                             dtype=dtype, rank=rank),
               "norm_out": torch.ones(d, dtype=dtype, device=device)}
              for _ in range(cfg.num_layers)]
    s2 = (2 * d) ** -0.5
    shared = {
        "attn": {"wq": sharded((2 * d, hd), s2),
                 "wk": sharded((2 * d, lay.kv_store * acfg.head_dim), s2),
                 "wv": sharded((2 * d, lay.kv_store * acfg.head_dim), s2),
                 "wo": sharded((hd, d), s2)},
        "norm_in": torch.ones(2 * d, dtype=dtype, device=device),
        "norm_out": torch.ones(n_inv, d, dtype=dtype, device=device),
        "lora_a": rnd((n_inv, 2 * d, LORA_RANK), 0.01),
        "lora_b": torch.zeros(n_inv, tp if rank is None else 1, LORA_RANK,
                              hd, dtype=dtype, device=device),
    }
    return {"embedding": MM.embedding_params(gen, cfg, tp, device=device,
                                             dtype=dtype, rank=rank),
            "norm_first": torch.ones(d, dtype=dtype, device=device),
            "layers": layers, "shared": shared}


# --------------------------------------------------------------------------
# the shared block over one or two splits
# --------------------------------------------------------------------------

def _shared_weave(shared, g: int, hs, ress, embs, poss, cache_inv, *, cfg,
                  pcfg, weave, decode: bool, dp: int = 1):
    """Invocation g of the shared attention block over every split.
    Prefill: the splits attend ``cache_inv``'s KV (earlier chunks) and
    every earlier split's; returns the chunk's (k, v, pos).  Decode: each
    split writes and reads its own rows of ``cache_inv`` in place (under
    ``seq_shard_kv`` its data rank's slots, combined over the data axis
    that ``weave.ctx`` names); returns the cache dict."""
    acfg, lay = _shared_layout(cfg, weave.ctx.tp)
    p_eff = dict(shared["attn"])
    lora_a = shared["lora_a"][g]
    delta = (lora_a.float() @ shared["lora_b"][g].float()).to(lora_a.dtype)
    p_eff["wq"] = shared["attn"]["wq"] + delta
    w_out = shared["norm_out"][g]
    kv_prev = (None if decode or cache_inv is None else
               (cache_inv["k"], cache_inv["v"], cache_inv["pos"]))
    kv_outs, off = [], 0
    for i in range(len(hs)):
        weave.wait(i)
        h = hs[i]
        e = embs[i].to(h.dtype).expand(h.shape[0], *embs[i].shape)
        u = rms_norm(torch.cat([h, e], dim=-1), shared["norm_in"],
                     cfg.norm_eps)
        geo = dict(positions=poss[i], cfg=acfg, lay=lay,
                   theta=cfg.rope_theta)
        if decode:
            rows = h.shape[1]
            a_part, _ = A.attn_decode(
                p_eff, u, A.cache_rows(cache_inv, off, rows), **geo,
                seq_shards=dp if pcfg.seq_shard_kv else None, ctx=weave.ctx)
            off += rows
        else:
            a_part, kv = A.attn_prefill(p_eff, u, kv_prefix=kv_prev,
                                        impl=pcfg.attn_impl, **geo)
            kv_outs.append(kv)
            kv_prev = kv if kv_prev is None else TR.cat_kv(kv_prev, kv)
        hs[i], ress[i] = weave.comm_norm(i, a_part, ress[i], w_out)
    if decode:
        return hs, ress, cache_inv
    return hs, ress, (kv_outs[0] if len(kv_outs) == 1
                      else TR.cat_kv(*kv_outs))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig,
            positions=None, cache=None, decode: bool = False,
            ssm_chunk: int = 128, dp: int = 1, train: bool = False,
            groups: Optional[Groups] = None):
    """Returns (hidden (R, B, S, d), the same on every rank, {"mamba": the
    state cache, "shared": per invocation the chunk's (k, v, pos)
    (prefill) or the KV cache dict (decode)}).  Without ``cache`` the
    shared blocks see no prefix and the recurrence starts from zero.
    ``dp`` > 1 needs ``pcfg.seq_shard_kv`` (module docstring).
    ``train``: no cache and none returned; each shared-block invocation
    and each Mamba-2 layer under ``remat`` when ``pcfg.remat``.
    ``groups``: this process holds one model rank of the model group (R
    = 1) and, at ``dp`` > 1, one data rank of a context-parallel decode
    (the whole batch, its C/D slots of each shared cache)."""
    _check_dp(dp, pcfg.seq_shard_kv)
    tp = TR._model_ranks(params, groups)
    if groups is not None and train:
        raise NotImplementedError(
            "the hybrid family over the process_group backend does not "
            "train (ROADMAP.md A17)")
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
    positions = positions.to(dev)
    ctx = TR._comm_ctx(pcfg, cfg, b * s, tp, groups=groups,
                       dp=1 if groups is None else dp)
    emb = E.embed_tokens(params["embedding"], tokens, scale=cfg.embed_scale,
                         ctx=ctx)
    # the complete embedding: every shared-block input reuses it
    emb = psum(emb, ctx)                                  # (B, S, d)
    split = TR._decide_split(b, s, tp=tp, pcfg=pcfg, decode=decode)
    cuts = TR._split_cuts(split, b if decode else s)
    embs = [emb[lo:hi] if decode else emb[:, lo:hi] for lo, hi in cuts]
    poss = [positions[lo:hi] if decode else positions[:, lo:hi]
            for lo, hi in cuts]
    weave = TR._Weave(len(embs), ctx, dev, overlap=not train)
    hs, ress = map(list, zip(*(
        TR._entry_norm(weave, i, (e / tp).expand(ctx.local_ranks, *e.shape),
                       params["norm_first"]) for i, e in enumerate(embs))))

    n_inv, _ = _n_groups(cfg)
    period = cfg.shared_attn_period
    if train:
        return _train_layers(params, hs, ress, embs, poss, cfg=cfg,
                             pcfg=pcfg, weave=weave, chunk=ssm_chunk), None
    mcache = (S.init_mamba2_state(b, cfg, tp, cfg.num_layers, device=dev,
                                  dtype=emb.dtype, ranks=ctx.local_ranks)
              if cache is None else cache["mamba"])
    kw = dict(weave=weave, decode=decode,
              split_rows=split[0] if split else 0,
              chunk=1 if decode else ssm_chunk)

    def mamba_layer(i, hs, ress):
        hs, ress, st = MM.mamba_weave(
            lambda p, x, **k: S.mamba2_forward(p, x, cfg=cfg, **k),
            params["layers"][i], hs, ress, MM.layer_state(mcache, i), **kw)
        MM.write_layer_state(mcache, i, st)
        return hs, ress

    shared_out = []
    for g in range(n_inv):
        hs, ress, kv = _shared_weave(
            params["shared"], g, hs, ress, embs, poss,
            None if cache is None else cache["shared"][g], cfg=cfg,
            pcfg=pcfg, weave=weave, decode=decode, dp=dp)
        shared_out.append(kv)
        for i in range(g * period, (g + 1) * period):
            hs, ress = mamba_layer(i, hs, ress)
    for i in range(n_inv * period, cfg.num_layers):      # the tail
        hs, ress = mamba_layer(i, hs, ress)
    for i in range(len(hs)):
        weave.wait(i)
    h_out = torch.cat(hs, dim=1 if decode else 2) if len(hs) == 2 else hs[0]
    return h_out, {"mamba": mcache, "shared": shared_out}


def _shared_train(shared, g: int, hs, ress, embs, poss, *, cfg, pcfg,
                  weave):
    hs, ress, _ = _shared_weave(shared, g, list(hs), list(ress), embs, poss,
                                None, cfg=cfg, pcfg=pcfg, weave=weave,
                                decode=False)
    return hs, ress


def _train_layers(params, hs, ress, embs, poss, *, cfg, pcfg, weave,
                  chunk: int):
    """The training forward's blocks in the serving order, from a zero
    state and no prefix; the hidden output (R, B, S, d)."""
    shared = TR.remat(_shared_train, pcfg.remat)
    layer = MM.train_layer(functools.partial(S.mamba2_forward, cfg=cfg),
                           pcfg)
    n_inv, _ = _n_groups(cfg)
    period = cfg.shared_attn_period
    for g in range(n_inv):
        hs, ress = shared(params["shared"], g, hs, ress, embs, poss, cfg=cfg,
                          pcfg=pcfg, weave=weave)
        for i in range(g * period, (g + 1) * period):
            hs, ress = layer(params["layers"][i], hs, ress, weave=weave,
                             chunk=chunk)
    for i in range(n_inv * period, cfg.num_layers):      # the tail
        hs, ress = layer(params["layers"][i], hs, ress, weave=weave,
                         chunk=chunk)
    return torch.cat(hs, dim=2) if len(hs) == 2 else hs[0]


def train_loss(params, batch, *, cfg: ModelConfig, pcfg: ParallelConfig,
               aux_weight: float = 0.0):
    """batch {"tokens" (B, S), "labels" (B, S)} -> (loss_sum, denom,
    aux), each (1,) float32 (no aux loss)."""
    h, _ = forward(params, batch["tokens"], cfg=cfg, pcfg=pcfg, train=True)
    ls, dn = MM.xent(params, h, batch["labels"], cfg)
    return ls, dn, torch.zeros_like(ls)


def prefill(params, tokens, cache, *, cfg, pcfg, positions=None,
            last_idx=None, dp: int = 1, groups: Optional[Groups] = None):
    """One (chunked) prefill step.  Returns (local logits at each row's
    last token, or at ``last_idx`` (R, B, 1, V_loc), {"mamba": the state
    cache, "shared": the chunk's KV per invocation})."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions, cache=cache, dp=dp,
                           groups=groups)
    return MM.lm_logits_at(params, h, last_idx), new_cache


def decode_step(params, tokens, cache, *, cfg, pcfg, positions, dp: int = 1,
                groups: Optional[Groups] = None):
    """One token per row.  Returns (local logits (R, B, 1, V_loc), the
    cache, updated in place)."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions, cache=cache, decode=True,
                           dp=dp, groups=groups)
    return E.lm_head_logits(params["embedding"], h), new_cache


def _check_dp(dp: int, seq_shard_kv: bool) -> None:
    if dp > 1 and not seq_shard_kv:
        raise NotImplementedError(
            "the hybrid family takes a data axis for context-parallel "
            "decode (seq_shard_kv) only; its batch over D is not ported")


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               device=None, dtype=None, dp: int = 1,
               seq_shard_kv: bool = False, groups: Optional[Groups] = None):
    """Zero Mamba-2 state and empty shared KV (one slot cache of
    ``max_len`` per invocation) for ``batch`` rows on ``device`` (CUDA
    unless given); with ``seq_shard_kv`` the shared caches' ``max_len``
    slots lie over ``dp`` data shards, in the unsharded layout.  With
    ``groups``, this process's model rank's (R = 1) and, under
    ``seq_shard_kv``, its data rank's ``max_len`` / ``dp`` slots of each
    shared cache."""
    device = resolve_device(device)
    _check_dp(dp, seq_shard_kv)
    if max_len % dp:
        raise ValueError(f"max_len={max_len} does not split over {dp} "
                         f"data shards")
    n_inv, _ = _n_groups(cfg)
    acfg = _shared_attn_cfg(cfg)
    ranks = None if groups is None else 1
    slots = max_len if groups is None else max_len // dp
    return {"mamba": S.init_mamba2_state(batch, cfg, tp, cfg.num_layers,
                                         device=device, dtype=dtype,
                                         ranks=ranks),
            "shared": [A.init_kv_cache(batch, slots, acfg, tp,
                                       dtype=dtype, device=device,
                                       ranks=ranks)
                       for _ in range(n_inv)]}
