"""Decoder-only transformer (dense, MoE and vlm families) with the
TokenWeave two-split weave, as ``repro.models.transformer``; its weave
helpers (``_Weave``, ``_decide_split``, ``_comm_ctx``, ``_entry_norm``)
serve the ssm, hybrid and encdec models too.

The vlm family (Qwen2-VL) is the dense stack with a stubbed vision
frontend: ``extra_embeds`` (B, S_img, d), complete patch embeddings, go
in front of the text rows, and M-RoPE ids ``mrope_positions`` (B, 3, S)
rotate q and k where given (``layers/rotary.py``); the 1-D positions
still place and mask the keys.  Without M-RoPE ids (the engine's
text-only serving, packed steps) it rotates by plain RoPE.

The tp ranks sit on a leading rank axis R of one device
(``distributed/context.py``): every sharded weight is ``(R, ...)`` as in
the reference's pytree, activations are ``(R, B, S, d)``, and the
AllReduce + residual + RMSNorm slots go through
``core.fused_collectives.comm_norm`` (kernel K1 in ``ring`` mode).  With
``groups`` (``launch.mesh.init_groups``) each process holds one (data,
model) rank instead, R = 1 (``init_params(rank=, data_rank=)``,
``weights.take_rank``), and the slots, the embedding's offsets, a MoE
layer's experts and the LM head's shard follow
``CommCtx(backend="process_group")``.  With the batch over the data
group a process's batch is its data shard's rows alone (the weave, the
fallback and the slots' token ownership follow them, as each shard's on
the rank axis) and an ``ep2d`` layer's all-to-alls go over the data
group; under ``seq_shard_kv`` each data rank holds C/D slots of every
full-attention cache and context-parallel decode combines over the data
group.

The reference's ``data`` axis is the data rank axis D (``dp``), used two
ways, as the reference uses it:
* the batch over D (``dp > 1`` without ``pcfg.seq_shard_kv``): B holds
  the D data shards' rows one shard after the other (shard d's rows
  ``[d·B/D, (d+1)·B/D)``) and every layer runs on the folded batch; the
  weave decision, the comm mode's fallback and the comm slots' token
  ownership follow each shard's own B/D rows, a MoE layer routes and
  drops per shard and runs ``ep2d``'s all-to-alls over D, and a decode
  batch split takes the same rows of every shard (not contiguous in the
  folded batch: ``_weave_layer`` gathers them and writes them back);
* context-parallel decode (``pcfg.seq_shard_kv``): the batch is whole on
  every shard (the reference's ``long_500k`` has one row), and each
  full-attention layer's decode combines the D chunks of its cache's
  sequence (``layers.attention.attn_decode(seq_shards=D)``); an ``ep2d``
  layer then dispatches every shard's copy of the tokens.
Packed steps and the paged pool run at D = 1, as the reference's engine
serves them.

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
(``_Weave``); under ``process_group`` on NCCL the slot's collectives are
issued on that comm stream, so NCCL's stream follows it and the done
event follows the last collective.  At tp=1, or unsplit, or on the CPU,
everything runs in that order on the current stream.

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
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import fused_collectives as fc
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.core.splitting import pad_to_multiple, token_bucket
from repro_torch.device import generator, randn_ranks, resolve_device
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mlp as M
from repro_torch.layers import moe as X
from repro_torch.runtime import kv_cache as KC
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
                tp: int = 1, ep: int = 1, rank: Optional[int] = None,
                data_rank: Optional[int] = None):
    """Random weights for ``tp`` ranks from a seeded ``torch.Generator`` on
    ``device`` (CUDA unless given), with the reference's scales (attention
    and MLP inputs d^-0.5, MLP down d_ff^-0.5, embedding 0.02, LM head
    d^-0.5; norms ones; MoE layers as ``layers.moe.init_moe_params``) and
    shapes (every sharded weight (tp, ...); ``ep2d`` expert weights (ep,
    tp, ...)).  The values differ from the reference's jax.random ones;
    tests move the reference's weights over with
    ``weights.from_jax_params`` instead.

    With ``rank``, model rank ``rank``'s weights alone
    (``weights.take_rank`` of the tp-rank draw, the same values; an
    ``ep2d`` layer's experts at ``data_rank`` too): each leaf is drawn
    whole and cut at once, so the peak is one whole leaf beside the
    rank's tree, never the whole model."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"family {cfg.family!r} has its own model module "
                         f"(models.build.build_model picks it)")
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = generator(device, seed)
    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    if not cfg.is_moe and f % tp:
        raise ValueError(f"d_ff={f} is not a multiple of tp={tp}")
    s = d ** -0.5

    def rnd(shape, scale):
        return randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
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
                attn[name] = torch.zeros(1 if rank is not None else tp,
                                         w * dh, dtype=dtype, device=device)
        if cfg.qk_norm:
            attn["q_norm"] = ones(dh)
            attn["k_norm"] = ones(dh)
        lp = {"attn": attn, "norm_attn": ones(), "norm_ffn": ones()}
        if cfg.is_moe:
            lp["moe"] = X.init_moe_params(gen, cfg, tp, ep, device=device,
                                          dtype=dtype, rank=rank,
                                          data_rank=data_rank)
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
    current stream, as it does with ``overlap=False`` (training: the
    backward runs the layers again on the current stream)."""

    def __init__(self, n_splits: int, ctx: CommCtx, device: torch.device,
                 overlap: bool = True):
        self.ctx = ctx
        self.comm = None
        if overlap and ctx.tp > 1 and n_splits == 2 and device.type == "cuda":
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
    the shared pool.  A MoE layer's aux loss is added to ``state["aux"]``
    where the state has one (training) and dropped otherwise (serving)."""
    n = len(state["h"])
    packed = state.get("pslots") is not None
    dp = state["dp"]
    hs, ress = list(state["h"]), list(state["res"])
    kv_prev = None if decode or packed else _cache_prefix(cache_layer)
    kv_outs, auxes, off = [], [], 0
    for i in range(n):
        weave.wait(i)
        h, pos = hs[i], state["positions"][i]
        geo = dict(positions=pos, cfg=cfg, lay=lay, theta=kind.theta,
                   window=kind.window)
        mrope = dict(mrope_positions=state["mrope"][i])
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
                             where=state["where"], **geo, **mrope)
        elif decode:
            # batch split: each split updates its own rows of the cache in
            # place through views, so the full cache is the result; with
            # the batch over D a split's rows are the same rows of every
            # data shard, gathered and written back
            rows = h.shape[1]
            idx = state["rows"][i]
            cl = (A.cache_rows(cache_layer, off, rows) if idx is None
                  else KC.gather_slots([cache_layer], idx)[0])
            if h.shape[2] > 1:
                a_part, _ = A.attn_verify(lp["attn"], h, cl, **geo, **mrope)
            else:
                # context-parallel KV on full-attention layers only
                cp = dp if pcfg.seq_shard_kv and kind.window == 0 else None
                a_part, _ = A.attn_decode(lp["attn"], h, cl, **geo, **mrope,
                                          seq_shards=cp, ctx=weave.ctx)
            if idx is not None:
                KC.write_rows([cache_layer], [cl], idx)
            off += rows
        else:
            a_part, kv = A.attn_prefill(lp["attn"], h, kv_prefix=kv_prev,
                                        impl=pcfg.attn_impl, **geo, **mrope)
            kv_outs.append(kv)
            # later splits attend to cache prefix + all earlier splits' kv
            kv_prev = kv if kv_prev is None else cat_kv(kv_prev, kv)
        hs[i], ress[i] = weave.comm_norm(i, a_part, ress[i], lp["norm_attn"],
                                         lp.get("norm_attn_post"))
    for i in range(n):
        weave.wait(i)
        if kind.is_moe:
            f_part, aux = _moe(lp["moe"], hs[i], cfg, dp, pcfg.seq_shard_kv,
                               weave.ctx)
            auxes.append(aux)
        else:
            f_part = M.mlp_forward(lp["mlp"], hs[i], act=cfg.act,
                                   ctx=weave.ctx)
        hs[i], ress[i] = weave.comm_norm(i, f_part, ress[i], lp["norm_ffn"],
                                         lp.get("norm_ffn_post"))
    state = dict(state, h=hs, res=ress)
    if auxes and "aux" in state:
        state["aux"] = state["aux"] + sum(auxes)
    if decode or packed:
        return state, cache_layer
    return state, kv_outs[0] if n == 1 else cat_kv(*kv_outs)


def _moe(params, h, cfg, dp: int, seq_shard_kv: bool, ctx: CommCtx):
    """A MoE layer's (partial output, aux loss per data shard the batch
    splits over).  With the batch over D each data shard routes its own
    rows; under context parallelism (the batch whole on every shard)
    ``ep2d`` still dispatches every shard's copy of the tokens, as the
    reference's shards do, and keeps shard 0's output (all D are equal);
    ``expert``/``ffn`` have nothing to exchange.  ``ctx`` names the model
    ranks the local ones are (a process's one under ``process_group``),
    and under ``process_group`` h is the process's own rows: its data
    shard's (the batch over D) or its copy of the whole batch, routed
    through the data group's all-to-alls for ``ep2d``.  The aux loss is
    the same on every rank (routing reads the replicated input): rank
    0's, or this process's rank's."""
    if dp > 1 and not ctx.process_group:
        if not seq_shard_kv:
            out, aux = X.moe_forward(params, h, cfg, dp=dp)
            return out, aux[0]
        if cfg.moe_partition == "ep2d":
            out, aux = X.moe_forward(params, h.repeat(1, dp, 1, 1), cfg,
                                     dp=dp)
            return out[:, :h.shape[1]], aux[0, :1]
    out, aux = X.moe_forward(params, h, cfg, ctx=ctx)
    return out, aux[:1]


def cat_kv(a, b):
    """Two (k, v (R, B, S, h, dh), pos (B, S)) chunks one after the other
    along the sequence."""
    return (torch.cat([a[0], b[0]], dim=2), torch.cat([a[1], b[1]], dim=2),
            torch.cat([a[2], b[2]], dim=1))


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


def _decide_split(b: int, s: int, *, tp: int, pcfg: ParallelConfig,
                  decode: bool, packed: bool = False,
                  family: str = "dense") -> Optional[Tuple[int, int]]:
    """The weave's split (per-dim sizes) or None: a thin view over
    ``weave_decision_info``, as the reference's."""
    return weave_decision_info(b, s, tp=tp, pcfg=pcfg, decode=decode,
                               packed=packed, family=family).split


def _split_cuts(split: Optional[Tuple[int, int]], n: int):
    """The splits' [lo, hi) along an axis of length n."""
    return [(0, n)] if split is None else [(0, split[0]), (split[0], n)]


def _comm_ctx(pcfg: ParallelConfig, cfg: ModelConfig, t_local: int,
              tp: int, *, mode: Optional[str] = None,
              budget: float = 1.0, dp: int = 1,
              groups: Optional[Groups] = None) -> CommCtx:
    """Pick the effective comm mode: the token-sharded (fused/reordered/
    ring) layouts need t_local, one data shard's tokens, divisible by tp;
    otherwise fall back to vanilla (the paper's fallback for small decode
    batches).  ``mode`` overrides ``pcfg.comm_mode`` when the overlap plan
    forces one; ``budget`` sizes K1's grid; ``dp`` data shards lie one
    after the other on the token axis.  ``groups``: the process_group
    backend over them (a process holds one data shard's rows, and ``dp``
    is the data group's size)."""
    mode = mode or pcfg.comm_mode
    if (mode in ("fused", "reordered", "ring")
            and (t_local % tp != 0 or t_local < tp)):
        mode = "vanilla"
    return CommCtx(mode=mode, eps=cfg.norm_eps,
                   use_pallas=pcfg.use_pallas_norm, tp=tp,
                   comm_budget=budget, dp=dp, groups=groups,
                   backend=("rank_axis" if groups is None
                            else "process_group"),
                   bf16_wire=pcfg.bf16_wire)


def remat(fn, on: bool):
    """``fn`` under ``torch.utils.checkpoint`` when ``on``: the
    reference's ``jax.checkpoint(..., nothing_saveable)`` around a layer
    (``pcfg.remat``, training only): the backward keeps the layer's
    inputs alone and runs it again.  ``fn`` must not change its inputs
    (the run again reads them)."""
    if not on:
        return fn

    def run(*args, **kw):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return run


def _entry_norm(weave: _Weave, i: int, emb, w_first):
    """Split i's partial embedding (R, B, S, d) -> residual birth + the
    first input norm: the embedding's partial rows are completed by this
    first AllReduce.  Returns (normed (R, B, S, d), residual)."""
    res0 = fc.fresh_residual(emb.shape[1] * emb.shape[2], emb.shape[3],
                             emb.dtype, ctx=weave.ctx, device=emb.device)
    return weave.comm_norm(i, emb, res0, w_first)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def data_layout(b: int, dp: int, pcfg: ParallelConfig) -> Tuple[int, int]:
    """(rows per data shard, data shards the batch is split over) for a
    batch of ``b`` rows at data size ``dp``: the batch splits over D
    unless the cache's sequence does (``seq_shard_kv``)."""
    if dp == 1 or pcfg.seq_shard_kv:
        return b, 1
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over {dp} "
                         f"data shards")
    return b // dp, dp


def _model_ranks(params, groups: Optional[Groups]) -> int:
    """tp: the params' rank axis, or the model group's size when this
    process holds one rank of it."""
    local = params["embedding"]["embed"].shape[0]
    if groups is None:
        return local
    if local != 1:
        raise ValueError(f"a process of a model group holds one rank's "
                         f"params, these hold {local}")
    return groups.model_size


def forward(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig,
            positions=None, mrope_positions=None, extra_embeds=None,
            cache=None, decode: bool = False, block_tables=None,
            packed_slots=None, dp: int = 1, train: bool = False,
            groups: Optional[Groups] = None):
    """Shared forward.  Returns (hidden_normed (R, B, S, d), the same on
    every rank, kv_or_cache), or with ``train`` (hidden, the MoE aux loss
    summed over layers and splits per data shard the batch splits over,
    (D,) float32): no cache, no KV kept, each layer under ``remat`` when
    ``pcfg.remat``.  tp is the rank axis of ``params``; ``dp``
    the data axis (module docstring): the batch's rows over D, or under
    ``pcfg.seq_shard_kv`` the full-attention caches' sequence.

    vlm: ``extra_embeds`` (B, S_img, d) are complete patch embeddings
    that go in front of the text rows (S counts them; the default
    positions are 0..S-1), ``mrope_positions`` (B, 3, S) the M-RoPE ids,
    split with the sequence (prefill) or the batch (decode); a packed
    step carries none.

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

    ``groups``: this process holds one model rank of ``groups``' model
    group (params with a rank axis of 1) and, at ``dp`` =
    ``groups.data_size`` > 1, one data rank: ``tokens`` are its data
    shard's rows (the batch over D) or, under ``pcfg.seq_shard_kv``, the
    whole batch of a context-parallel decode.
    """
    tp = _model_ranks(params, groups)
    if groups is not None and train:
        raise NotImplementedError(
            "training over the process_group backend is not ported "
            "(autograd-aware collectives; ROADMAP.md)")
    b = tokens.shape[0]
    s = tokens.shape[1] + (0 if extra_embeds is None
                           else extra_embeds.shape[1])
    dev = tokens.device
    packed = packed_slots is not None
    if train and (cache is not None or decode or packed):
        raise ValueError("a training forward takes no cache")
    paged_decode = decode and block_tables is not None and not packed
    # the data shards folded into this batch: under groups a process
    # holds one shard's rows
    b_loc, dsplit = (b, 1) if groups is not None else data_layout(b, dp,
                                                                   pcfg)
    if (dp > 1 and not pcfg.seq_shard_kv
            and (packed or block_tables is not None)):
        raise ValueError("packed steps and the paged pool run at data size "
                         "1, as the reference's engine serves them")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
    winfo = weave_decision_info(b_loc, s, tp=tp, pcfg=pcfg, decode=decode,
                                packed=packed, paged_pool=paged_decode,
                                family=cfg.family)
    ctx = _comm_ctx(pcfg, cfg, b_loc * s, tp, mode=winfo.comm_mode or None,
                    budget=winfo.budget, dp=dsplit if groups is None else dp,
                    groups=groups)

    # the splits' [lo, hi) along the batch (decode) or the sequence; a
    # batch split over D takes rows [lo, hi) of every data shard
    cuts = _split_cuts(winfo.split, b if decode else s)
    split_rows = [None] * len(cuts)
    if decode and dsplit > 1 and winfo.split is not None:
        split_rows = [torch.cat([torch.arange(d * b_loc + lo, d * b_loc + hi)
                                 for d in range(dsplit)]).to(dev)
                      for lo, hi in _split_cuts(winfo.split, b_loc)]
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

    emb = E.embed_tokens(params["embedding"], tokens, scale=cfg.embed_scale,
                         ctx=ctx)
    if extra_embeds is not None:
        # complete values: divided by tp so that the entry norm's sum over
        # the ranks gives them back beside the partial text rows
        img = (extra_embeds.to(dev) / tp).to(emb.dtype)
        emb = torch.cat([img.expand(emb.shape[0], *img.shape), emb], dim=2)
    if mrope_positions is not None:
        mrope_positions = mrope_positions.to(dev)
    if decode and split_rows[0] is not None:
        embs = [emb[:, idx] for idx in split_rows]
        poss = [positions[idx] for idx in split_rows]
        mrs = [None if mrope_positions is None else mrope_positions[idx]
               for idx in split_rows]
    elif decode:
        embs = [emb[:, lo:hi] for lo, hi in cuts]
        poss = [positions[lo:hi] for lo, hi in cuts]
        mrs = [None if mrope_positions is None else mrope_positions[lo:hi]
               for lo, hi in cuts]
    else:
        embs = [emb[:, :, lo:hi] for lo, hi in cuts]
        poss = [positions[:, lo:hi] for lo, hi in cuts]
        mrs = [None if mrope_positions is None or packed
               else mrope_positions[:, :, lo:hi] for lo, hi in cuts]

    # residual birth + layer 0's input norm, split-local
    weave = _Weave(len(embs), ctx, emb.device, overlap=not train)
    hs, ress = map(list, zip(*(_entry_norm(weave, i, e, params["norm_first"])
                               for i, e in enumerate(embs))))
    state = {"h": hs, "res": ress, "positions": poss, "mrope": mrs,
             "rows": split_rows, "dp": dp, **state_extra}
    if train:
        state["aux"] = torch.zeros(dsplit, dtype=torch.float32, device=dev)

    lay = A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim)
    layer_fn = remat(_weave_layer, train and pcfg.remat)
    kv_all = []
    for i, kind in enumerate(layer_kinds(cfg)):
        cache_layer = None if cache is None else cache[i]
        state, kv_new = layer_fn(
            params["layers"][i], state, cache_layer, kind=kind, cfg=cfg,
            pcfg=pcfg, lay=lay, weave=weave, decode=decode,
            block_tables=block_tables)
        if not train:
            kv_all.append(kv_new)

    for i in range(len(embs)):
        weave.wait(i)
    h_out = (torch.cat(state["h"], dim=1 if decode else 2)
             if len(state["h"]) == 2 else state["h"][0])
    if split_rows[0] is not None:
        # the data shards' rows back in batch order
        h_out = h_out.index_copy(1, torch.cat(split_rows), h_out)
    if train:
        return h_out, state["aux"]
    return h_out, kv_all


def train_loss(params, batch, *, cfg: ModelConfig, pcfg: ParallelConfig,
               dp: int = 1, aux_weight: float = 0.01):
    """batch {"tokens" (B, S), "labels" (B, S_labels), and for vlm
    "mrope_positions", "extra_embeds"} -> (loss_sum, denom, aux *
    aux_weight), each (D,) float32: one entry per data shard the batch
    splits over (``data_layout``), as the reference's per-shard values.
    vlm: the image positions in front carry no loss (the hidden rows are
    cut to the labels' last S_labels)."""
    h, aux = forward(params, batch["tokens"], cfg=cfg, pcfg=pcfg,
                     mrope_positions=batch.get("mrope_positions"),
                     extra_embeds=batch.get("extra_embeds"), dp=dp,
                     train=True)
    labels = batch["labels"].to(h.device)
    if h.shape[2] != labels.shape[1]:
        h = h[:, :, h.shape[2] - labels.shape[1]:]
    logits = E.lm_head_logits(params["embedding"], h)
    b_loc, dsplit = data_layout(labels.shape[0], dp, pcfg)
    ls, dn = zip(*(E.sharded_softmax_xent(
        logits[:, d * b_loc:(d + 1) * b_loc],
        labels[d * b_loc:(d + 1) * b_loc], vocab_size=cfg.vocab_size)
        for d in range(dsplit)))
    return torch.stack(ls), torch.stack(dn), aux * aux_weight


def prefill(params, tokens, cache, *, cfg, pcfg, positions,
            mrope_positions=None, extra_embeds=None, last_idx=None,
            dp: int = 1, groups: Optional[Groups] = None):
    """One (chunked) prefill step.  Returns (local logits at each row's
    last valid token (R, B, 1, V_loc), chunk kv per layer).  ``last_idx``:
    per-row index of the last unpadded token in the chunk (the patch rows
    of ``extra_embeds`` counted)."""
    h, kv = forward(params, tokens, cfg=cfg, pcfg=pcfg, positions=positions,
                    mrope_positions=mrope_positions,
                    extra_embeds=extra_embeds, cache=cache, dp=dp,
                    groups=groups)
    if last_idx is None:
        h_last = h[:, :, -1:]
    else:
        r, _, _, d = h.shape
        idx = last_idx.long()[None, :, None, None].expand(r, -1, 1, d)
        h_last = torch.gather(h, 2, idx)
    return E.lm_head_logits(params["embedding"], h_last), kv


def decode_step(params, tokens, cache, *, cfg, pcfg, positions,
                mrope_positions=None, block_tables=None, dp: int = 1,
                groups: Optional[Groups] = None):
    """Single-token decode (or verify window).  Returns (local logits
    (R, B, S, V_loc), the cache, updated in place).  ``block_tables``
    (B, max_blocks) selects the paged pool (``runtime/paging.py``)."""
    h, new_cache = forward(params, tokens, cfg=cfg, pcfg=pcfg,
                           positions=positions,
                           mrope_positions=mrope_positions, cache=cache,
                           decode=True, block_tables=block_tables, dp=dp,
                           groups=groups)
    return E.lm_head_logits(params["embedding"], h), new_cache


def verify_step(params, tokens, cache, *, cfg, pcfg, positions,
                mrope_positions=None, block_tables=None, dp: int = 1,
                groups: Optional[Groups] = None):
    """Speculative multi-token verify: tokens (B, gamma+1) are the
    pending decode input followed by the draft, positions -1 where a row
    has no (or a short) draft.  Returns (local logits (R, B, gamma+1,
    V_loc), one target distribution per window position, and the cache
    with the whole window's KV written in place; the engine rolls back
    rejected positions on the host).  The decode path at S = gamma+1."""
    return decode_step(params, tokens, cache, cfg=cfg, pcfg=pcfg,
                       positions=positions, mrope_positions=mrope_positions,
                       block_tables=block_tables, dp=dp, groups=groups)


def packed_step(params, tokens, cache, *, cfg, pcfg, positions, seg_slots,
                sample_idx, block_tables=None, dp: int = 1,
                groups: Optional[Groups] = None):
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
                           block_tables=block_tables, packed_slots=seg_slots,
                           dp=dp, groups=groups)
    idx = sample_idx.to(h.device).long().clamp_min(0)
    return E.lm_head_logits(params["embedding"], h[:, 0][:, idx]), new_cache


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               device=None, dtype=None, dp: int = 1,
               seq_shard_kv: bool = False, groups: Optional[Groups] = None):
    """Slot KV cache for ``tp`` ranks on ``device`` (CUDA unless given):
    one {"k", "v", "pos"} dict per layer, in the global layout the
    reference shards over its data axis: ``batch`` rows over ``dp`` data
    shards, or (``seq_shard_kv``) every full-attention layer's
    ``max_len`` slots over them (shard d owning ``[d·C/D, (d+1)·C/D)``;
    the sliding-window ring buffers stay whole).  With ``groups`` the
    cache is this process's: one rank's heads and its data rank's part,
    C/D slots of each full-attention layer under ``seq_shard_kv``, else
    ``batch`` / D rows (its data shard's)."""
    device = resolve_device(device)
    if seq_shard_kv and max_len % dp:
        raise ValueError(f"max_len={max_len} does not split over {dp} "
                         f"data shards")
    if not seq_shard_kv and batch % dp:
        raise ValueError(f"batch={batch} does not split over {dp} data "
                         f"shards")
    if groups is not None:
        rows = batch if seq_shard_kv else batch // dp
        return [A.init_kv_cache(
            rows, max_len // dp if seq_shard_kv and k.window == 0
            else max_len, cfg, tp, window=k.window, dtype=dtype,
            device=device, ranks=1) for k in layer_kinds(cfg)]
    return [A.init_kv_cache(batch, max_len, cfg, tp, window=k.window,
                            dtype=dtype, device=device)
            for k in layer_kinds(cfg)]
