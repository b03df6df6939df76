"""Decoder-only transformer (dense and MoE families) with the TokenWeave
two-split weave, as ``repro.models.transformer``.

The tp ranks sit on a leading rank axis R of one device
(``distributed/context.py``): every sharded weight is ``(R, ...)`` as in
the reference's pytree, activations are ``(R, B, S, d)``, and the
AllReduce + residual + RMSNorm slots go through
``core.fused_collectives.comm_norm`` (kernel K1 in ``ring`` mode).

The weave (paper Fig. 8) emits, with two token splits s0/s1,

    attn(s0) ; AR-norm(s0) ; attn(s1) ; AR-norm(s1) ;
    ffn(s0)  ; AR-norm(s0) ; ffn(s1)  ; AR-norm(s1)

where a MoE layer's ffn is ``layers.moe.moe_forward``, run per split so
that each split's expert capacity follows from its own token count, and
the suffix split's attention takes the prefix split's KV as
``kv_prefix`` (§3.1).  At tp>1 on CUDA each AR-norm runs on a comm stream:
it waits on an event recorded after its split's row-parallel product, and
the compute stream waits on the AR-norm's event only before that split's
next layer part, so the other split's compute is queued in between
(``_Weave``).  At tp=1, or unsplit, or on the CPU, everything runs in that
order on the current stream.

Parameters are a plain dict: {"embedding": {"embed" (R, V_pad/R, d),
"lm_head" (R, d, V_pad/R)}, "norm_first" (d,), "layers": [per-layer
dicts]}.  Norm-weight convention (off by one, like vLLM's fused
add+norm): layer i's post-FFN add+norm applies layer i+1's input norm;
``norm_ffn`` of the last layer is the final norm; ``norm_first`` is layer
0's input norm, applied at the embedding.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import fused_collectives as fc
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.core.splitting import pad_to_multiple, token_bucket
from repro_torch.device import resolve_device
from repro_torch.distributed.context import CommCtx
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mlp as M
from repro_torch.layers import moe as X
from repro_torch.runtime import paging as PG


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

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, dtype=None,
                tp: int = 1):
    """Random weights for ``tp`` ranks from a seeded ``torch.Generator`` on
    ``device`` (CUDA unless given), with the reference's scales (attention
    and MLP inputs d^-0.5, MLP down d_ff^-0.5, embedding 0.02, LM head
    d^-0.5; norms ones; MoE layers as ``layers.moe.init_moe_params``) and
    shapes (every sharded weight (tp, ...)).  The values differ from the
    reference's jax.random ones; tests move the reference's weights over
    with ``weights.from_jax_params`` instead."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md A10)")
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    if not cfg.is_moe and f % tp:
        raise ValueError(f"d_ff={f} is not a multiple of tp={tp}")
    s = d ** -0.5

    def rnd(shape, scale):
        return torch.randn((tp,) + shape, generator=gen, device=device,
                           dtype=dtype) * scale

    def ones(n=d):
        return torch.ones(n, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": rnd((d, lay.h_loc * dh), s),
                "wk": rnd((d, lay.kv_store * dh), s),
                "wv": rnd((d, lay.kv_store * dh), s),
                "wo": rnd((lay.h_loc * dh, d), s)}
        if cfg.qkv_bias:
            for name, w in (("bq", lay.h_loc), ("bk", lay.kv_store),
                            ("bv", lay.kv_store)):
                attn[name] = torch.zeros(tp, w * dh, dtype=dtype,
                                         device=device)
        if cfg.qk_norm:
            attn["q_norm"] = ones(dh)
            attn["k_norm"] = ones(dh)
        lp = {"attn": attn, "norm_attn": ones(), "norm_ffn": ones()}
        if cfg.is_moe:
            lp["moe"] = X.init_moe_params(gen, cfg, tp, device=device,
                                          dtype=dtype)
        else:
            lp["mlp"] = {"w_gate": rnd((d, f // tp), s),
                         "w_up": rnd((d, f // tp), s),
                         "w_down": rnd((f // tp, d), f ** -0.5)}
        if cfg.sandwich_norms:
            lp["norm_attn_post"] = ones()
            lp["norm_ffn_post"] = ones()
        layers.append(lp)
    v_loc = pad_to_multiple(cfg.vocab_size, tp) // tp
    emb = {"embed": rnd((v_loc, d), 0.02)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = rnd((d, v_loc), s)
    return {"embedding": emb, "norm_first": ones(), "layers": layers}


# --------------------------------------------------------------------------
# the weave: one layer over one or two splits
# --------------------------------------------------------------------------

class _Weave:
    """Where each split's AllReduce-norm runs.  With two splits at tp>1
    on CUDA: on a high-priority comm stream (from PyTorch's stream pool),
    so its few CTAs are scheduled ahead of queued compute CTAs, after an
    event recorded on the compute stream behind the split's row-parallel
    product; ``wait(i)`` makes the compute stream wait for split i's last
    AR-norm before it reads that split's output.  Tensors that cross
    streams get ``record_stream`` so the caching allocator does not hand
    their memory out early.  Otherwise every call runs in order on the
    current stream."""

    def __init__(self, n_splits: int, ctx: CommCtx, device: torch.device):
        self.ctx = ctx
        self.comm = None
        if ctx.tp > 1 and n_splits == 2 and device.type == "cuda":
            self.compute = torch.cuda.current_stream(device)
            self.comm = torch.cuda.Stream(device=device, priority=-1)
            self.done = [None] * n_splits

    def comm_norm(self, i: int, x, res, weight, weight_post=None):
        """comm_norm of split i's block output x (R, B, S, d)."""
        r, b, s, d = x.shape
        xf = x.reshape(r, b * s, d)
        if self.comm is None:
            out, res = fc.comm_norm(xf, res, weight, ctx=self.ctx,
                                    weight_post=weight_post)
            return out.reshape(r, b, s, d), res
        ready = torch.cuda.Event()
        ready.record(self.compute)
        self.comm.wait_event(ready)
        xf.record_stream(self.comm)
        res.record_stream(self.comm)
        with torch.cuda.stream(self.comm):
            out, res = fc.comm_norm(xf, res, weight, ctx=self.ctx,
                                    weight_post=weight_post)
            done = torch.cuda.Event()
            done.record(self.comm)
        out.record_stream(self.compute)
        self.done[i] = done
        return out.reshape(r, b, s, d), res

    def wait(self, i: int):
        if self.comm is not None and self.done[i] is not None:
            self.compute.wait_event(self.done[i])


def _weave_layer(lp, state, cache_layer, *, kind: LayerKind, cfg, pcfg,
                 lay, weave: _Weave, decode: bool, block_tables=None):
    """Run one layer over one or two splits in paper-Fig.8 order.
    Returns (state, chunk kv (prefill) or the cache layer, updated in
    place (decode, packed)).

    Packed steps (``state["pslots"]``): the splits run over the SAME
    cache in sequence, so the suffix split's attention reads the prefix
    split's freshly scattered KV (a segment straddling the cut needs its
    earlier tokens).  Paged decode runs unsplit: a batch split would fork
    the shared pool.  A MoE layer's aux loss is dropped (serving)."""
    n = len(state["h"])
    packed = state.get("pslots") is not None
    hs, ress = list(state["h"]), list(state["res"])
    kv_prev = None if decode or packed else _cache_prefix(cache_layer)
    kv_outs, off = [], 0
    for i in range(n):
        weave.wait(i)
        h, pos = hs[i], state["positions"][i]
        geo = dict(positions=pos, cfg=cfg, lay=lay, theta=kind.theta,
                   window=kind.window)
        if packed:
            segs = state["segs"][i]
            if block_tables is not None:
                a_part, _ = A.attn_packed_paged(
                    lp["attn"], h, cache_layer, block_tables,
                    seg_slots=state["pslots"][i], impl=pcfg.attn_impl,
                    segs=segs, **geo)
            else:
                a_part, _ = A.attn_packed(
                    lp["attn"], h, cache_layer, seg_slots=state["pslots"][i],
                    impl=pcfg.attn_impl, segs=segs, **geo)
        elif decode and block_tables is not None:
            assert n == 1, "paged decode cannot weave-split the shared pool"
            attn = (A.attn_verify_paged if h.shape[2] > 1
                    else A.attn_decode_paged)
            a_part, _ = attn(lp["attn"], h, cache_layer, block_tables,
                             where=state["where"], **geo)
        elif decode:
            # batch split: each split updates its own rows of the cache in
            # place through views, so the full cache is the result
            rows = h.shape[1]
            attn = A.attn_verify if h.shape[2] > 1 else A.attn_decode
            a_part, _ = attn(lp["attn"], h,
                             A.cache_rows(cache_layer, off, rows), **geo)
            off += rows
        else:
            a_part, kv = A.attn_prefill(lp["attn"], h, kv_prefix=kv_prev,
                                        impl=pcfg.attn_impl, **geo)
            kv_outs.append(kv)
            # later splits attend to cache prefix + all earlier splits' kv
            kv_prev = kv if kv_prev is None else (
                torch.cat([kv_prev[0], kv[0]], dim=2),
                torch.cat([kv_prev[1], kv[1]], dim=2),
                torch.cat([kv_prev[2], kv[2]], dim=1))
        hs[i], ress[i] = weave.comm_norm(i, a_part, ress[i], lp["norm_attn"],
                                         lp.get("norm_attn_post"))
    for i in range(n):
        weave.wait(i)
        if kind.is_moe:
            f_part, _ = X.moe_forward(lp["moe"], hs[i], cfg)
        else:
            f_part = M.mlp_forward(lp["mlp"], hs[i], act=cfg.act)
        hs[i], ress[i] = weave.comm_norm(i, f_part, ress[i], lp["norm_ffn"],
                                         lp.get("norm_ffn_post"))
    state = dict(state, h=hs, res=ress)
    if decode or packed:
        return state, cache_layer
    if n == 1:
        return state, kv_outs[0]
    (k0, v0, p0), (k1, v1, p1) = kv_outs
    return state, (torch.cat([k0, k1], dim=2), torch.cat([v0, v1], dim=2),
                   torch.cat([p0, p1], dim=1))


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
    reason: str   # split | weave_disabled | paged_pool_unsplit |
    #               below_min_tokens | below_wave_floor | plan_split |
    #               plan_unsplit
    axis: str     # packed | batch | seq
    threshold: int  # configured tokenweave_min_tokens (tokens)
    unit: int       # effective wave quantum the decision used
    site: str = ""      # prefill | decode | verify | packed
    plan_id: int = 0
    bucket: str = ""
    budget: float = 1.0   # comm budget the plan granted (K1's CTAs)
    sim_method: str = ""  # plan-forced pricing mode of the reference's sim
    comm_mode: str = ""   # plan-forced comm_norm mode; "" = pcfg.comm_mode


def _active_policy(pcfg: ParallelConfig):
    return pcfg.overlap_policy or DEFAULT_POLICY


def _plan_meta(policy, site: str, tokens: int, tp: int, family: str,
               has_split: bool = False) -> Tuple[float, str, str]:
    """(budget, sim_method, comm_mode) granted by the active plan: method
    ``none`` prices as vanilla; the fused methods force comm mode "ring"
    (kernel K1), priced ``ring`` unsplit and ``ringweave`` when the split
    fired."""
    plan = policy.plan_for(site, tokens, tp=tp, family=family)
    if plan is None:
        return 1.0, "", ""
    if plan.method == "none":
        return plan.budget, "vanilla", ""
    if plan.method == "fused-unsplit":
        return plan.budget, "ring", "ring"
    if plan.method == "fused":
        return plan.budget, "ringweave" if has_split else "ring", "ring"
    return plan.budget, "", ""


def weave_decision_info(b: int, s: int, *, tp: int, pcfg: ParallelConfig,
                        decode: bool = False, packed: bool = False,
                        paged_pool: bool = False,
                        family: str = "dense") -> WeaveInfo:
    """Host-side weave split decision, as the reference's, delegated to
    the active overlap policy at one of four sites: prefill splits along
    the sequence (all rows cut at the same position), decode and verify
    along the batch, packed along the flat token axis (b == 1).
    ``paged_pool`` marks a non-packed paged decode, which runs unsplit
    (a batch split would fork the shared pool) but keeps the plan's
    method."""
    thr = pcfg.tokenweave_min_tokens
    policy = _active_policy(pcfg)
    pid = getattr(policy, "plan_id", 0)
    site = ("packed" if packed else
            "decode" if decode and s == 1 else
            "verify" if decode else "prefill")
    if not pcfg.tokenweave:
        return WeaveInfo(False, None, "weave_disabled", "packed" if packed
                         else ("batch" if decode else "seq"), thr, 0,
                         site=site, plan_id=pid, bucket=token_bucket(b * s))
    if paged_pool and not packed:
        budget, sim, cm = _plan_meta(policy, site, b * s, tp, family)
        return WeaveInfo(False, None, "paged_pool_unsplit",
                         "batch" if decode else "seq", thr, 0, site=site,
                         plan_id=pid, bucket=token_bucket(b * s),
                         budget=budget, sim_method=sim, comm_mode=cm)
    if packed:
        d = policy.decide("packed", b * s, unit=pcfg.split_unit_for(tp),
                          min_tokens=thr, tp=tp, family=family)
        split, axis = d.split, "packed"
    elif decode:
        unit = max(tp, 8)
        if s > 1:
            min_rows = max(2 * unit, -(-thr // s))
            d = policy.decide("verify", b, unit=unit, min_tokens=min_rows,
                              tp=tp, family=family, bucket_tokens=b * s)
        else:
            d = policy.decide("decode", b, unit=unit, min_tokens=2 * unit,
                              tp=tp, family=family)
        split, axis = d.split, "batch"
    else:
        d = policy.decide("prefill", b * s, unit=pcfg.split_unit_for(tp),
                          min_tokens=thr, row_multiple=b, tp=tp,
                          family=family)
        split = None if d.split is None else (d.split[0] // b,
                                              d.split[1] // b)
        axis = "seq"
    budget, sim, cm = _plan_meta(policy, site, b * s, tp, family,
                                 has_split=split is not None)
    return WeaveInfo(split is not None, split, d.reason, axis, thr, d.unit,
                     site=site, plan_id=d.plan_id, bucket=d.bucket,
                     budget=budget, sim_method=sim, comm_mode=cm)


def _comm_ctx(pcfg: ParallelConfig, cfg: ModelConfig, t_local: int,
              tp: int, *, mode: Optional[str] = None,
              budget: float = 1.0) -> CommCtx:
    """Pick the effective comm mode: the token-sharded (fused/reordered/
    ring) layouts need t_local divisible by tp; otherwise fall back to
    vanilla (the paper's fallback for small decode batches).  ``mode``
    overrides ``pcfg.comm_mode`` when the overlap plan forces one;
    ``budget`` sizes K1's grid."""
    mode = mode or pcfg.comm_mode
    if (mode in ("fused", "reordered", "ring")
            and (t_local % tp != 0 or t_local < tp)):
        mode = "vanilla"
    return CommCtx(mode=mode, eps=cfg.norm_eps,
                   use_pallas=pcfg.use_pallas_norm, tp=tp,
                   comm_budget=budget)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig,
            positions=None, cache=None, decode: bool = False,
            block_tables=None, packed_slots=None):
    """Shared forward.  Returns (hidden_normed (R, B, S, d), the same on
    every rank, kv_or_cache).  tp is the rank axis of ``params``.

    prefill chunk: ``cache`` = the request rows of the KV cache (attended
    as prefix); returns the chunk's new kv per layer, [(k, v, pos)], for
    the engine to insert.
    decode: ``cache`` = the full slot cache, or the paged pool with
    ``block_tables`` (B, max_blocks); updated in place and returned;
    S == 1, or S == gamma+1 for a verify window.
    packed: ``packed_slots`` (T,) = the cache row (slots) or block-table
    row (paged) owning each token of the (1, T) packed axis, -1 =
    padding; ``cache`` = the full slot cache or the pool; updated in
    place and returned.  The weave splits the flat packed axis.

    The packed and paged-decode index math (which cache cells each token
    writes, each split's segments) runs once per forward on the host:
    pass ``positions``, ``block_tables`` and ``packed_slots`` as CPU
    tensors and nothing is read back from the device.
    """
    tp = params["embedding"]["embed"].shape[0]
    b, s = tokens.shape
    dev = tokens.device
    packed = packed_slots is not None
    paged_decode = decode and block_tables is not None and not packed
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
    winfo = weave_decision_info(b, s, tp=tp, pcfg=pcfg, decode=decode,
                                packed=packed, paged_pool=paged_decode,
                                family=cfg.family)
    ctx = _comm_ctx(pcfg, cfg, b * s, tp, mode=winfo.comm_mode or None,
                    budget=winfo.budget)

    # the splits' [lo, hi) along the batch (decode) or the sequence
    split = winfo.split
    n = b if decode else s
    cuts = [(0, n)] if split is None else [(0, split[0]), (split[0], n)]
    state_extra = {}
    if packed and pcfg.attn_impl == "pallas":
        host_pos = positions.cpu().numpy()[0]
        host_slots = packed_slots.cpu().numpy()
        host_bt = None if block_tables is None else block_tables.cpu().numpy()
        state_extra["segs"] = [A.segment_layout(
            host_pos[lo:hi], host_slots[lo:hi], device=dev,
            block_tables=host_bt, block_size=cache[0]["pos"].shape[1],
            cache_len=cache[0]["pos"].shape[1]) for lo, hi in cuts]
    elif packed:
        state_extra["segs"] = [None] * len(cuts)
    if paged_decode:
        rows = torch.arange(b)[:, None].expand(b, s).reshape(-1)
        state_extra["where"] = tuple(t.to(dev) for t in PG.scatter_index(
            positions.cpu().reshape(-1), rows, block_tables.cpu(),
            cache[0]["pos"].shape[1]))
    positions = positions.to(dev)
    if block_tables is not None:
        block_tables = block_tables.to(dev)
    if packed:
        packed_slots = packed_slots.to(dev)
        state_extra["pslots"] = [packed_slots[lo:hi] for lo, hi in cuts]

    emb = E.embed_tokens(params["embedding"], tokens, scale=cfg.embed_scale)
    if decode:
        embs = [emb[:, lo:hi] for lo, hi in cuts]
        poss = [positions[lo:hi] for lo, hi in cuts]
    else:
        embs = [emb[:, :, lo:hi] for lo, hi in cuts]
        poss = [positions[:, lo:hi] for lo, hi in cuts]

    # residual birth + layer 0's input norm, split-local: the embedding's
    # partial rows are completed by this first AllReduce
    weave = _Weave(len(embs), ctx, emb.device)
    hs, ress = [], []
    for i, e in enumerate(embs):
        res0 = fc.fresh_residual(e.shape[1] * e.shape[2], e.shape[3],
                                 e.dtype, ctx=ctx, device=e.device)
        h_i, r_i = weave.comm_norm(i, e, res0, params["norm_first"])
        hs.append(h_i)
        ress.append(r_i)
    state = {"h": hs, "res": ress, "positions": poss, **state_extra}

    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    kv_all = []
    for i, kind in enumerate(layer_kinds(cfg)):
        cache_layer = None if cache is None else cache[i]
        state, kv_new = _weave_layer(
            params["layers"][i], state, cache_layer, kind=kind, cfg=cfg,
            pcfg=pcfg, lay=lay, weave=weave, decode=decode,
            block_tables=block_tables)
        kv_all.append(kv_new)

    for i in range(len(embs)):
        weave.wait(i)
    h_out = (torch.cat(state["h"], dim=1 if decode else 2)
             if len(state["h"]) == 2 else state["h"][0])
    return h_out, kv_all


def prefill(params, tokens, cache, *, cfg, pcfg, positions, last_idx=None):
    """One (chunked) prefill step.  Returns (local logits at each row's
    last valid token (R, B, 1, V_loc), chunk kv per layer).  ``last_idx``:
    per-row index of the last unpadded token in the chunk."""
    h, kv = forward(params, tokens, cfg=cfg, pcfg=pcfg, positions=positions,
                    cache=cache)
    if last_idx is None:
        h_last = h[:, :, -1:]
    else:
        r, _, _, d = h.shape
        idx = last_idx.long()[None, :, None, None].expand(r, -1, 1, d)
        h_last = torch.gather(h, 2, idx)
    return E.lm_head_logits(params["embedding"], h_last), kv


def decode_step(params, tokens, cache, *, cfg, pcfg, positions,
                block_tables=None):
    """Single-token decode (or verify window).  Returns (local logits
    (R, B, S, V_loc), the cache, updated in place).  ``block_tables``
    (B, max_blocks) selects the paged pool (``runtime/paging.py``)."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions, cache=cache, decode=True,
                           block_tables=block_tables)
    return E.lm_head_logits(params["embedding"], h), new_cache


def verify_step(params, tokens, cache, *, cfg, pcfg, positions,
                block_tables=None):
    """Speculative multi-token verify: tokens (B, gamma+1) are the
    pending decode input followed by the draft, positions -1 where a row
    has no (or a short) draft.  Returns (local logits (R, B, gamma+1,
    V_loc), one target distribution per window position, and the cache
    with the whole window's KV written in place; the engine rolls back
    rejected positions on the host).  The decode path at S = gamma+1."""
    return decode_step(params, tokens, cache, cfg=cfg, pcfg=pcfg,
                       positions=positions, block_tables=block_tables)


def packed_step(params, tokens, cache, *, cfg, pcfg, positions, seg_slots,
                sample_idx, block_tables=None):
    """One packed hybrid forward: tokens (1, T) carry prefill-chunk
    segments, single-token decode slots and verify windows on one axis;
    ``seg_slots``
    (T,) maps each token to its cache row (slots) or block-table row
    (paged), -1 = padding.  ``sample_idx`` (Nseg, W) indexes each
    segment's sampling window into the packed axis (row 0 the position a
    plain sample uses, rows 1..gamma a verify window; -1 = unused,
    clamped to 0).  Returns (local logits (R, Nseg, W, V_loc), the cache, updated
    in place)."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions, cache=cache,
                           block_tables=block_tables, packed_slots=seg_slots)
    idx = sample_idx.to(h.device).long().clamp_min(0)
    return E.lm_head_logits(params["embedding"], h[:, 0][:, idx]), new_cache


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               device=None, dtype=None):
    """Slot KV cache for ``tp`` ranks on ``device`` (CUDA unless given):
    one {"k", "v", "pos"} dict per layer."""
    device = resolve_device(device)
    return [A.init_kv_cache(batch, max_len, cfg, tp, window=k.window,
                            dtype=dtype, device=device)
            for k in layer_kinds(cfg)]
