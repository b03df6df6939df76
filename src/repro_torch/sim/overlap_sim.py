"""Two-stream (compute / comm) event simulator for the TokenWeave
schedule, as ``repro.sim.overlap_sim``.

Per-op durations derive from roofline terms (flops / peak, bytes / HBM
rate, wire bytes / interconnect rate), and the schedule is executed by a
dependency-respecting list scheduler with one compute stream and one
comm stream — the two CUDA streams of the port's weave
(``core/fused_collectives.py``).  Wave quantization is modeled by rounding
compute tokens up to the tile unit, which is what makes smart-splitting
matter (paper Fig. 9).

The arithmetic is the reference's, operation for operation: with equal
``HW`` fields both packages return bit-equal floats.  Only the defaults
differ: ``HW()`` holds one H100's constants (``analysis/roofline.py``),
and ``analysis/calibration.py`` fits ``mfu_cap``, ``ici`` and
``overhead`` to the card's measured forwards.

Modes (match core.fused_collectives + the weave):
    vanilla    serial: AR -> unfused add+norm on every device
    reordered  serial: RS -> add+norm(1/N) -> AG, unfused ops
    fuseonly   serial: fused RS+norm+AG composition (collectives + the
               fused add/norm kernel K2 between them)
    tokenweave composed-fused kernel + two-split overlap (naive-weave /
               the pre-ring full TokenWeave)
    ring       serial: the one-kernel AllReduce-RMSNorm (K1,
               ``csrc/ar_rmsnorm.cu``) — the norm math never leaves the
               kernel, priced from its channel budget (``ring_channels``,
               K1's CTAs) instead of the generic contention model
    ringweave  ring kernel + two-split overlap — the full TokenWeave
               configuration the paper ships (plan method ``fused``)
    nocomm     collectives removed (paper vllm-nocomm counterfactual)

Speculative decoding (``spec_decode_latency`` / ``spec_decode_summary``)
re-models the decode step as a gamma+1-token verify batch per sequence, so
the weave-vs-unsplit crossover on the latency-critical decode path is
visible analytically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.roofline import HBM_BW, ICI_EFF, PEAK_FLOPS
from repro_torch.configs.base import ModelConfig
from repro_torch.core.splitting import (MAX_RING_CHANNELS, naive_split,
                                  ring_channels, smart_split)

BYTES = 2  # bf16


@dataclasses.dataclass
class Op:
    name: str
    stream: str                  # "compute" | "comm"
    duration: float
    deps: Tuple[str, ...] = ()


def simulate(ops: List[Op]) -> Tuple[float, Dict[str, Tuple[float, float]]]:
    """List-schedule ops on two serial streams; returns (makespan, spans)."""
    done: Dict[str, float] = {}
    spans: Dict[str, Tuple[float, float]] = {}
    stream_free = {"compute": 0.0, "comm": 0.0}
    pending = list(ops)
    while pending:
        progressed = False
        for op in list(pending):
            if all(d in done for d in op.deps):
                start = max(stream_free[op.stream],
                            max((done[d] for d in op.deps), default=0.0))
                end = start + op.duration
                stream_free[op.stream] = end
                done[op.name] = end
                spans[op.name] = (start, end)
                pending.remove(op)
                progressed = True
        if not progressed:
            raise RuntimeError("dependency cycle in schedule")
    return max(done.values(), default=0.0), spans


# --------------------------------------------------------------------------
# per-op cost models (per device)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HW:
    peak: float = PEAK_FLOPS
    hbm: float = HBM_BW
    ici: float = ICI_EFF            # per-GPU ring rate (roofline.py)
    tile: int = 256                 # token tile (wave quantum)
    mfu_cap: float = 0.6            # achievable fraction of peak on GEMMs
    overhead: float = 0.0           # fixed per-dispatch seconds (launch,
    #                                 host sync, runtime bookkeeping) —
    #                                 fitted by analysis/calibration.py;
    #                                 0.0 keeps legacy pure-roofline numbers

    @classmethod
    def from_calibration(cls, cal) -> "HW":
        """Rebuild the fitted hardware model from a ``CalibrationReport``
        (analysis/calibration.py, DESIGN.md §13) or its ``to_dict()`` /
        JSON-loaded mapping.  Missing fields fall back to the defaults so
        partial calibrations (e.g. mfu_cap only) still load."""
        def get(key, default):
            if isinstance(cal, dict):
                return cal.get(key, default)
            return getattr(cal, key, default)
        return cls(peak=float(get("peak", PEAK_FLOPS)),
                   hbm=float(get("hbm", HBM_BW)),
                   ici=float(get("ici", ICI_EFF)),
                   tile=int(get("tile", 256)),
                   mfu_cap=float(get("mfu_cap", 0.6)),
                   overhead=float(get("overhead", 0.0)))


def _quantize(t: int, hw: HW) -> int:
    return max(hw.tile, math.ceil(t / hw.tile) * hw.tile)


def t_gemm(tokens: int, flops_per_token: float, weight_bytes: float,
           hw: HW) -> float:
    tq = _quantize(tokens, hw)
    f = flops_per_token * tq
    return max(f / (hw.peak * hw.mfu_cap),
               (weight_bytes + tq * 0) / hw.hbm)


def t_attn_layer(cfg: ModelConfig, tokens: int, ctx: int, tp: int,
                 hw: HW) -> float:
    """QKV+O projections + scores/values for `tokens` new tokens vs ctx."""
    d, dh = cfg.d_model, cfg.head_dim
    h_loc = max(cfg.num_heads // tp, 1)
    kv_loc = max(cfg.num_kv_heads // tp, 1)
    proj_flops = 2 * d * (h_loc + 2 * kv_loc) * dh + 2 * h_loc * dh * d
    attn_flops = 4 * h_loc * dh * ctx / 2          # causal
    w_bytes = (d * (h_loc + 2 * kv_loc) * dh + h_loc * dh * d) * BYTES
    kv_bytes = 2 * ctx * kv_loc * dh * BYTES       # stream KV once (flash)
    tq = _quantize(tokens, hw)
    f = (proj_flops + attn_flops) * tq
    return max(f / (hw.peak * hw.mfu_cap), (w_bytes + kv_bytes) / hw.hbm)


def t_ffn_layer(cfg: ModelConfig, tokens: int, tp: int, hw: HW) -> float:
    d = cfg.d_model
    if cfg.is_moe:
        f_loc = cfg.moe_d_ff * cfg.num_experts_per_tok
        mult = 3
        w_bytes = 3 * d * cfg.moe_d_ff * BYTES * max(
            cfg.num_experts // tp, 1)              # expert weights streamed
    else:
        f_loc = cfg.d_ff // tp
        mult = 3 if cfg.act in ("silu", "geglu") else 2
        w_bytes = mult * d * f_loc * BYTES
    flops_per_tok = 2 * mult * d * (f_loc if not cfg.is_moe else
                                    f_loc // tp)
    tq = _quantize(tokens, hw)
    return max(flops_per_tok * tq / (hw.peak * hw.mfu_cap), w_bytes / hw.hbm)


def t_allreduce(tokens: int, d: int, n: int, hw: HW) -> float:
    return 2 * (n - 1) / n * tokens * d * BYTES / hw.ici


def t_rs_or_ag(tokens: int, d: int, n: int, hw: HW) -> float:
    return (n - 1) / n * tokens * d * BYTES / hw.ici


def t_norm(tokens: int, d: int, hw: HW, *, fused: bool) -> float:
    """unfused residual+norm: write r, read r twice, write out (+reads);
    fused single pass: read x + res, write r' + out."""
    passes = 5 if not fused else 4
    return passes * tokens * d * BYTES / hw.hbm


def t_ring_norm(tokens: int, d: int, hw: HW) -> float:
    """The one-kernel ring path's norm epilogue on the owned 1/N chunk:
    the reduced x arrives over the wire straight into the kernel and the
    normed output leaves the same way, so only the residual stream
    touches HBM — one read + one write (2 passes vs the composed path's
    4; the paper's 'minimal HBM traffic' property, K1)."""
    return 2 * tokens * d * BYTES / hw.hbm


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

# comm-budget contention model (DESIGN.md §14): a tuned plan may cap the
# fraction b of interconnect/SM resources the fused collective kernel
# claims (Flash Communication's knob).  b scales wire bandwidth directly
# (ici_eff = ici*b) and RELIEVES compute by the share of the MFU cap the
# resident comm kernel taxes: mfu_eff = mfu_cap*(1 - TAX*b)/(1 - TAX),
# normalized so b = 1.0 reproduces the legacy single-hw numbers bit-exactly
# (the default mfu_cap already prices a full-budget comm kernel).
_BUDGET_TAX = 0.2


def _budgeted(hw: HW, comm_budget: Optional[float]) -> Tuple[HW, HW]:
    """(hw_compute, hw_comm) under comm resource-budget fraction b."""
    if comm_budget is None or comm_budget == 1.0:
        return hw, hw
    b = comm_budget
    if not (0.0 < b <= 1.0):
        raise ValueError(f"comm_budget must be in (0, 1], got {b}")
    hw_comm = dataclasses.replace(hw, ici=hw.ici * b)
    mfu = hw.mfu_cap * (1.0 - _BUDGET_TAX * b) / (1.0 - _BUDGET_TAX)
    hw_compute = dataclasses.replace(hw, mfu_cap=mfu)
    return hw_compute, hw_comm


# ring-kernel resource model (DESIGN.md §14): the fused ring kernel's
# resource grant is its LANE COUNT c = ring_channels(budget), the paper's
# 2-8 SM knob.  A few lanes already saturate the wire (the paper's fused
# kernel holds AR bandwidth with 2-8 of 132 SMs): wire efficiency is
# min(1, c/_RING_SAT).  Compute is relieved by the lanes NOT granted —
# the same MFU-tax shape as ``_budgeted`` with b_eff = c/MAX_RING_CHANNELS
# — so a half-budget ring entry keeps full wire speed while returning
# compute, which is exactly why the tuner prefers it over the composed
# path's linear-in-b wire model.
_RING_SAT = 4


def _ring_budgeted(hw: HW, comm_budget: Optional[float]) -> Tuple[HW, HW]:
    """(hw_compute, hw_comm) for the ring modes, priced from lanes."""
    b = 1.0 if comm_budget is None else comm_budget
    if not (0.0 < b <= 1.0):
        raise ValueError(f"comm_budget must be in (0, 1], got {b}")
    c = max(1, ring_channels(b))
    hw_comm = dataclasses.replace(hw, ici=hw.ici * min(1.0, c / _RING_SAT))
    b_eff = c / MAX_RING_CHANNELS
    mfu = hw.mfu_cap * (1.0 - _BUDGET_TAX * b_eff) / (1.0 - _BUDGET_TAX)
    hw_compute = dataclasses.replace(hw, mfu_cap=mfu)
    return hw_compute, hw_comm


def layer_ops(cfg: ModelConfig, mode: str, tokens: int, ctx: int, tp: int,
              hw: HW, n_layers: int = 4, smart: bool = True,
              split: Optional[Tuple[int, int]] = None,
              comm_budget: Optional[float] = None
              ) -> List[Op]:
    """Build the op list for `n_layers` consecutive layers.

    ``split`` pins the tokenweave split point explicitly (a tuned plan's
    ``plan_split``); None keeps the built-in smart/naive split.
    ``comm_budget`` applies the §14 resource-budget contention model;
    None / 1.0 is the legacy full-budget pricing, bit-exact."""
    d = cfg.d_model
    n = tp
    ops: List[Op] = []
    ring = mode in ("ring", "ringweave")
    hwc, hwm = (_ring_budgeted if ring else _budgeted)(hw, comm_budget)

    def comm_block(tag: str, t: int, deps) -> Tuple[str, List[Op]]:
        """the AR(+norm) slot; returns (terminal op name, ops)."""
        if ring:
            # one-kernel ring RS+norm+AG: norm never leaves K1
            dur = (2 * t_rs_or_ag(t, d, n, hwm)
                   + t_ring_norm(max(t // n, 1), d, hwm))
            o = Op(f"ring{tag}", "comm", dur, tuple(deps))
            return o.name, [o]
        if mode == "nocomm":
            o = Op(f"norm{tag}", "compute", t_norm(t, d, hwc, fused=False),
                   tuple(deps))
            return o.name, [o]
        if mode == "vanilla":
            a = Op(f"ar{tag}", "comm", t_allreduce(t, d, n, hwm), tuple(deps))
            b = Op(f"norm{tag}", "compute", t_norm(t, d, hwc, fused=False),
                   (a.name,))
            return b.name, [a, b]
        if mode == "reordered":
            a = Op(f"rs{tag}", "comm", t_rs_or_ag(t, d, n, hwm), tuple(deps))
            b = Op(f"norm{tag}", "compute",
                   t_norm(max(t // n, 1), d, hwc, fused=False), (a.name,))
            c = Op(f"ag{tag}", "comm", t_rs_or_ag(t, d, n, hwm), (b.name,))
            return c.name, [a, b, c]
        # fused kernel: RS + single-pass norm on t/N + AG as ONE comm op
        dur = (2 * t_rs_or_ag(t, d, n, hwm)
               + t_norm(max(t // n, 1), d, hwm, fused=True))
        o = Op(f"fused{tag}", "comm", dur, tuple(deps))
        return o.name, [o]

    if mode in ("vanilla", "reordered", "fuseonly", "nocomm", "ring"):
        prev = ()
        for i in range(n_layers):
            at = Op(f"attn{i}", "compute",
                    t_attn_layer(cfg, tokens, ctx, tp, hwc), prev)
            ops.append(at)
            t1, blk = comm_block(f"_a{i}", tokens, [at.name])
            ops += blk
            ff = Op(f"ffn{i}", "compute", t_ffn_layer(cfg, tokens, tp, hwc),
                    (t1,))
            ops.append(ff)
            t2, blk2 = comm_block(f"_f{i}", tokens, [ff.name])
            ops += blk2
            prev = (t2,)
        return ops

    assert mode in ("tokenweave", "ringweave")
    if split is None:
        split = smart_split(tokens, hw.tile) if smart else naive_split(tokens)
    if split is None:
        return layer_ops(cfg, "ring" if ring else "fuseonly", tokens, ctx,
                         tp, hw, n_layers, comm_budget=comm_budget)
    t0, t1v = split
    cache_ctx = max(ctx - tokens, 0)   # pre-existing (chunked-prefill) kv
    prev = {0: (), 1: ()}
    for i in range(n_layers):
        # paper Fig 8 order; suffix attends prefix's kv -> dep on attn0
        a0 = Op(f"attn0_{i}", "compute",
                t_attn_layer(cfg, t0, cache_ctx + t0, tp, hwc),
                prev[0])
        c0, blk0 = comm_block(f"_a0{i}", t0, [a0.name])
        a1 = Op(f"attn1_{i}", "compute",
                t_attn_layer(cfg, t1v, cache_ctx + tokens, tp, hwc),
                prev[1] + (a0.name,))
        c1, blk1 = comm_block(f"_a1{i}", t1v, [a1.name])
        f0 = Op(f"ffn0_{i}", "compute", t_ffn_layer(cfg, t0, tp, hwc), (c0,))
        d0, blkd0 = comm_block(f"_f0{i}", t0, [f0.name])
        f1 = Op(f"ffn1_{i}", "compute", t_ffn_layer(cfg, t1v, tp, hwc), (c1,))
        d1, blkd1 = comm_block(f"_f1{i}", t1v, [f1.name])
        ops += [a0, a1, f0, f1] + blk0 + blk1 + blkd0 + blkd1
        prev = {0: (d0,), 1: (d1,)}
    return ops


def layer_latency(cfg: ModelConfig, mode: str, tokens: int, *, tp: int = 8,
                  ctx: Optional[int] = None, hw: Optional[HW] = None,
                  n_layers: int = 4, smart: bool = True,
                  split: Optional[Tuple[int, int]] = None,
                  comm_budget: Optional[float] = None) -> float:
    """Steady-state per-layer latency (simulate n_layers, divide)."""
    hw = hw or HW()
    ctx = ctx if ctx is not None else tokens
    total, _ = simulate(layer_ops(cfg, mode, tokens, ctx, tp, hw,
                                  n_layers=n_layers, smart=smart,
                                  split=split, comm_budget=comm_budget))
    return total / n_layers


def e2e_latency(cfg: ModelConfig, mode: str, tokens: int, *,
                hw: Optional[HW] = None, **kw) -> float:
    per_layer = layer_latency(cfg, mode, tokens, hw=hw, **kw)
    return per_layer * cfg.num_layers + (hw.overhead if hw else 0.0)


def step_attribution(cfg: ModelConfig, mode: str, tokens: int, *,
                     tp: int = 8, ctx: Optional[int] = None,
                     hw: Optional[HW] = None, n_layers: int = 4,
                     split: Optional[Tuple[int, int]] = None,
                     comm_budget: Optional[float] = None
                     ) -> Dict[str, float]:
    """Per-forward compute/comm/overlap attribution (DESIGN.md §12).

    Runs the mode's schedule through the two-stream simulator and
    decomposes the makespan into stream-busy totals:

        overlapped = compute_busy + comm_busy - makespan   (clamped >= 0)

    i.e. the virtual time where both streams were occupied at once — the
    quantity TokenWeave exists to maximize.  Scaled from the simulated
    ``n_layers`` window to the full ``cfg.num_layers`` model, matching
    ``e2e_latency``.  This prices the per-forward weave attribution
    record the engine attaches to trace spans (obs/attribution.py).

    ``hw.overhead`` (the fixed per-dispatch cost fitted by
    analysis/calibration.py, DESIGN.md §13) is added once to the makespan
    — it is neither compute- nor comm-stream time, so the busy totals and
    the overlapped term are unaffected.

    ``split`` / ``comm_budget`` price a tuned plan's explicit split point
    and resource budget (DESIGN.md §14); the defaults keep the legacy
    smart-split full-budget pricing bit-exact — this is what the
    ``analysis/autotune.py`` offline search evaluates per candidate."""
    hw = hw or HW()
    ctx = ctx if ctx is not None else tokens
    ops = layer_ops(cfg, mode, tokens, ctx, tp, hw, n_layers=n_layers,
                    split=split, comm_budget=comm_budget)
    makespan, _ = simulate(ops)
    busy = {"compute": 0.0, "comm": 0.0}
    for op in ops:
        busy[op.stream] += op.duration
    scale = cfg.num_layers / n_layers
    return {
        "compute": busy["compute"] * scale,
        "comm": busy["comm"] * scale,
        "overlapped": max(busy["compute"] + busy["comm"] - makespan, 0.0)
        * scale,
        "makespan": makespan * scale + hw.overhead,
    }


# --------------------------------------------------------------------------
# speculative decoding (runtime/spec.py, DESIGN.md §8): decode modeled as a
# gamma+1-token verify batch per sequence
# --------------------------------------------------------------------------

def expected_tokens_per_step(gamma: int, alpha: float) -> float:
    """E[committed tokens per sequence per verify step] when each draft
    token is accepted independently with probability ``alpha``:
    1 + a + ... + a^gamma (Leviathan et al., 2023)."""
    return sum(alpha ** i for i in range(gamma + 1))


def spec_decode_latency(cfg: ModelConfig, mode: str, batch: int, gamma: int,
                        alpha: float, *, tp: int = 8, ctx: int = 8192,
                        hw: Optional[HW] = None, n_layers: int = 4,
                        smart: bool = True) -> float:
    """Per-COMMITTED-token decode latency under speculative verification.

    A plain decode iteration over ``batch`` sequences carries ``batch``
    tokens (``gamma == 0`` reduces to exactly that); a verify iteration
    carries ``batch * (gamma+1)`` tokens and commits
    ``batch * E[tokens/step]`` of them.  Because the verify batch is what
    the model actually sees, the TokenWeave split decision applies to it —
    this is where the weave-vs-unsplit crossover on the latency-critical
    decode path becomes visible: ``mode='tokenweave'`` only diverges from
    ``'fuseonly'`` once ``batch*(gamma+1)`` clears the wave/threshold
    floor, which plain decode (gamma = 0) essentially never does.
    """
    toks = batch * (gamma + 1)
    step = e2e_latency(cfg, mode, toks, tp=tp, ctx=ctx, hw=hw,
                       n_layers=n_layers, smart=smart)
    return step / (batch * expected_tokens_per_step(gamma, alpha))


def spec_decode_summary(cfg: ModelConfig, batch: int, gamma: int,
                        alpha: float, *, tp: int = 8, ctx: int = 8192,
                        hw: Optional[HW] = None) -> Dict[str, float]:
    """Per-committed-token latencies for the spec-vs-plain / weave-vs-unsplit
    grid the `serve/spec_decode` benchmark reports."""
    out = {}
    for mode in ("vanilla", "fuseonly", "tokenweave"):
        out[f"plain/{mode}"] = spec_decode_latency(
            cfg, mode, batch, 0, 0.0, tp=tp, ctx=ctx, hw=hw)
        out[f"spec/{mode}"] = spec_decode_latency(
            cfg, mode, batch, gamma, alpha, tp=tp, ctx=ctx, hw=hw)
    out["tokens_per_step"] = expected_tokens_per_step(gamma, alpha)
    out["verify_tokens"] = float(batch * (gamma + 1))
    return out


# --------------------------------------------------------------------------
# packed hybrid batching (DESIGN.md §6): the two-dispatch engine judges the
# decode batch and the prefill chunk against the weave threshold SEPARATELY;
# a packed iteration is one forward over the combined token count
# --------------------------------------------------------------------------

def packed_hybrid_latency(cfg: ModelConfig, mode: str, decode_tokens: int,
                          chunk_tokens: int, *, tp: int = 8, ctx: int = 8192,
                          hw: Optional[HW] = None,
                          n_layers: int = 4) -> Dict[str, float]:
    """One mixed continuous-batching iteration, both dispatch schemes.

    two_dispatch: decode forward (``decode_tokens``) + prefill forward
    (``chunk_tokens``), each independently falling back to the unsplit
    path when it alone sits under the wave/threshold floor.
    packed: ONE forward over ``decode_tokens + chunk_tokens`` — the weave
    decision sees the true combined iteration size, which is exactly the
    regime the two-dispatch scheme misses: each half sub-threshold, the
    sum comfortably above it.
    """
    kw = dict(tp=tp, ctx=ctx, hw=hw, n_layers=n_layers)
    two = (e2e_latency(cfg, mode, decode_tokens, **kw)
           + e2e_latency(cfg, mode, chunk_tokens, **kw))
    packed = e2e_latency(cfg, mode, decode_tokens + chunk_tokens, **kw)
    return {"two_dispatch": two, "packed": packed}


def online_load_mix(cfg: ModelConfig, mode: str, rate: float, *,
                    mean_in: int = 161, mean_out: int = 338, tp: int = 8,
                    ctx: int = 8192, hw: Optional[HW] = None,
                    packed: bool = True, iters: int = 60,
                    max_decode_tokens: int = 512,
                    max_chunk_tokens: int = 2048) -> Dict[str, float]:
    """Steady-state per-iteration token mix at offered load ``rate``
    (requests per virtual-time unit), via a Little's-law fixed point.

    At rate λ the engine must retire λ·mean_in prefill and λ·mean_out
    decode tokens per unit time; with iteration time t the per-iteration
    shares are c = λ·mean_in·t (chunk) and d = λ·mean_out·t (decode batch:
    λ·mean_out·t sequences × 1 token).  t itself depends on (d, c) through
    the latency model — packed: one forward over d+c; two-dispatch: two
    forwards judged separately — so we iterate to the fixed point (damped;
    converges because latency is flat under the wave quantum and ~linear
    above it).  This is what makes the ONLINE weave rate load-dependent:
    low load ⇒ tiny iterations ⇒ no weave; the packed engine crosses the
    threshold at a LOWER offered load than two-dispatch because it judges
    the combined d+c (DESIGN.md §10).

    ``max_decode_tokens`` / ``max_chunk_tokens`` mirror the engine's
    max_batch / chunk_tokens admission caps: past saturation the mix pins
    at the caps (queues grow unboundedly instead — the regime where
    goodput, not latency, is the metric) rather than diverging.
    """
    hw = hw or HW()
    kw = dict(tp=tp, ctx=ctx, hw=hw)
    t = e2e_latency(cfg, mode, 1, **kw)
    d = c = 1.0
    for _ in range(iters):
        d = min(max(rate * mean_out * t, 1.0), float(max_decode_tokens))
        c = min(max(rate * mean_in * t, 1.0), float(max_chunk_tokens))
        if packed:
            t_new = e2e_latency(cfg, mode, int(round(d + c)), **kw)
        else:
            t_new = (e2e_latency(cfg, mode, int(round(d)), **kw)
                     + e2e_latency(cfg, mode, int(round(c)), **kw))
        t = 0.5 * t + 0.5 * t_new
    return {"t_iter": t, "decode_tokens": d, "chunk_tokens": c}


def online_summary(cfg: ModelConfig, rates: List[float], *,
                   mean_in: int = 161, mean_out: int = 338, tp: int = 8,
                   ctx: int = 8192, hw: Optional[HW] = None,
                   max_decode_tokens: int = 256,
                   max_chunk_tokens: int = 2048
                   ) -> Dict[float, Dict[str, float]]:
    """Weave activation and latency vs offered load, both dispatch schemes
    — the `serve/online` analytic rows.  Per rate: the steady-state token
    mix, whether the packed iteration / the separate halves clear the
    split floor, and the tokenweave-vs-fuseonly iteration latencies.

    The default ``max_decode_tokens`` (= engine max_batch) sits under the
    2·tile split floor on purpose: a pure decode batch then NEVER weaves
    under two-dispatch — exactly the vLLM serving regime the paper calls
    out — so the mid-load window where the packed d+c clears the floor
    while both halves sit under it is visible in the sweep."""
    hw = hw or HW()
    caps = dict(max_decode_tokens=max_decode_tokens,
                max_chunk_tokens=max_chunk_tokens)
    out: Dict[float, Dict[str, float]] = {}
    for rate in rates:
        pk = online_load_mix(cfg, "tokenweave", rate, mean_in=mean_in,
                             mean_out=mean_out, tp=tp, ctx=ctx, hw=hw,
                             packed=True, **caps)
        two = online_load_mix(cfg, "tokenweave", rate, mean_in=mean_in,
                              mean_out=mean_out, tp=tp, ctx=ctx, hw=hw,
                              packed=False, **caps)
        pk_fo = online_load_mix(cfg, "fuseonly", rate, mean_in=mean_in,
                                mean_out=mean_out, tp=tp, ctx=ctx, hw=hw,
                                packed=True, **caps)
        d, c = pk["decode_tokens"], pk["chunk_tokens"]
        d2, c2 = two["decode_tokens"], two["chunk_tokens"]
        out[rate] = {
            "decode_tokens": d, "chunk_tokens": c,
            "t_iter_packed": pk["t_iter"], "t_iter_two": two["t_iter"],
            "packed_gain": pk_fo["t_iter"] / pk["t_iter"],
            "packed_weaves": float(
                smart_split(int(round(d + c)), hw.tile) is not None),
            "halves_weave": float(
                smart_split(int(round(d2)), hw.tile) is not None
                or smart_split(int(round(c2)), hw.tile) is not None),
        }
    return out


def online_crossover_rate(cfg: ModelConfig, rates: List[float],
                          **kw) -> Optional[float]:
    """Lowest offered load where the packed iteration weaves but the
    two-dispatch halves do not — the load window the online frontend
    opens (None when no swept rate lands in it)."""
    summary = online_summary(cfg, sorted(rates), **kw)
    for rate in sorted(summary):
        s = summary[rate]
        if s["packed_weaves"] and not s["halves_weave"]:
            return rate
    return None


def decode_fleet_mix(cfg: ModelConfig, mode: str, rate: float, *,
                     mean_out: int = 338, tp: int = 8, ctx: int = 8192,
                     hw: Optional[HW] = None, iters: int = 60,
                     max_decode_tokens: int = 1024) -> Dict[str, float]:
    """Steady-state per-iteration token count of a DEDICATED decode
    replica absorbing decode traffic at ``rate`` requests per virtual-time
    unit (runtime/cluster.py's disaggregated mode, DESIGN.md §11): the
    Little's-law fixed point ``d = rate * mean_out * t(d)`` with pure
    decode iterations (no chunk share — prefill lives on other replicas),
    capped by the replica's batch capacity."""
    hw = hw or HW()
    kw = dict(tp=tp, ctx=ctx, hw=hw)
    t = e2e_latency(cfg, mode, 1, **kw)
    d = 1.0
    for _ in range(iters):
        d = min(max(rate * mean_out * t, 1.0), float(max_decode_tokens))
        t = 0.5 * t + 0.5 * e2e_latency(cfg, mode, int(round(d)), **kw)
    return {"t_iter": t, "decode_tokens": d}


def cluster_summary(cfg: ModelConfig, rates: List[float], n_replicas: int,
                    *, n_decode: int = 1, mean_in: int = 161,
                    mean_out: int = 338, tp: int = 8, ctx: int = 8192,
                    hw: Optional[HW] = None, max_decode_tokens: int = 1024,
                    max_chunk_tokens: int = 2048
                    ) -> Dict[float, Dict[str, float]]:
    """Disaggregation crossover vs TOTAL offered load (the `serve/cluster`
    analytic rows, DESIGN.md §11).

    Monolithic fleet: ``n_replicas`` engines each serving ``rate /
    n_replicas`` of the mixed traffic — per-replica packed iterations of
    ``d + c`` tokens from ``online_load_mix``.  Disaggregated fleet of the
    SAME size: ``n_decode`` dedicated decode replicas concentrate the
    whole load's decode tokens (``rate / n_decode`` each), so their merged
    batches grow ``n_replicas * mean_out / (n_decode * (mean_in +
    mean_out))``-fold relative to a monolithic engine's share — the factor
    that pushes them over the TokenWeave split floor first."""
    hw = hw or HW()
    out: Dict[float, Dict[str, float]] = {}
    for rate in rates:
        mono = online_load_mix(cfg, "tokenweave", rate / n_replicas,
                               mean_in=mean_in, mean_out=mean_out, tp=tp,
                               ctx=ctx, hw=hw, packed=True,
                               max_decode_tokens=max_decode_tokens,
                               max_chunk_tokens=max_chunk_tokens)
        fleet = decode_fleet_mix(cfg, "tokenweave", rate / n_decode,
                                 mean_out=mean_out, tp=tp, ctx=ctx, hw=hw,
                                 max_decode_tokens=max_decode_tokens)
        m_tok = int(round(mono["decode_tokens"] + mono["chunk_tokens"]))
        d_tok = int(round(fleet["decode_tokens"]))
        fleet_fo = decode_fleet_mix(cfg, "fuseonly", rate / n_decode,
                                    mean_out=mean_out, tp=tp, ctx=ctx,
                                    hw=hw,
                                    max_decode_tokens=max_decode_tokens)
        out[rate] = {
            "mono_iter_tokens": float(m_tok),
            "decode_fleet_tokens": float(d_tok),
            "t_iter_mono": mono["t_iter"],
            "t_iter_decode_fleet": fleet["t_iter"],
            "decode_fleet_gain": fleet_fo["t_iter"] / fleet["t_iter"],
            "mono_weaves": float(smart_split(m_tok, hw.tile) is not None),
            "decode_fleet_weaves": float(
                smart_split(d_tok, hw.tile) is not None),
        }
    return out


def cluster_crossover_rate(cfg: ModelConfig, rates: List[float],
                           n_replicas: int, **kw) -> Optional[float]:
    """Lowest TOTAL offered load where the disaggregated decode fleet's
    merged batches weave while a monolithic engine's share of the same
    traffic does not — the load window disaggregation opens (None when no
    swept rate lands in it)."""
    summary = cluster_summary(cfg, sorted(rates), n_replicas, **kw)
    for rate in sorted(summary):
        s = summary[rate]
        if s["decode_fleet_weaves"] and not s["mono_weaves"]:
            return rate
    return None


def packed_summary(cfg: ModelConfig, decode_tokens: int, chunk_tokens: int,
                   *, tp: int = 8, ctx: int = 8192,
                   hw: Optional[HW] = None) -> Dict[str, float]:
    """The weave-crossover grid the `serve/packed` benchmark reports.

    ``packed_weaves`` / ``halves_weave`` expose the split decisions so the
    interesting cell — halves both unsplit, packed split — is visible:
    there ``two/tokenweave == two/fuseonly`` (the weave never fired) while
    ``packed/tokenweave < packed/fuseonly`` (it did)."""
    hw = hw or HW()
    out: Dict[str, float] = {}
    for mode in ("fuseonly", "tokenweave"):
        r = packed_hybrid_latency(cfg, mode, decode_tokens, chunk_tokens,
                                  tp=tp, ctx=ctx, hw=hw)
        out[f"two/{mode}"] = r["two_dispatch"]
        out[f"packed/{mode}"] = r["packed"]
    out["halves_weave"] = float(
        smart_split(decode_tokens, hw.tile) is not None
        or smart_split(chunk_tokens, hw.tile) is not None)
    out["packed_weaves"] = float(
        smart_split(decode_tokens + chunk_tokens, hw.tile) is not None)
    return out
