"""Mixture-of-experts FFN, as ``repro.layers.moe``, in the ``expert`` and
``ffn`` partitionings, batched over the rank axis R.

    expert : whole experts split over the ranks (E % tp == 0): rank r holds
             experts [r·E/tp, (r+1)·E/tp).  (olmoe)
    ffn    : every rank holds a d_ff slice of every expert (E < tp is
             fine).  (mixtral)

In both the output is partial over the ranks, as ``layers.mlp``'s is, so
the layer's AllReduce is still the one ``comm_norm`` slot and kernels
K1/K2 apply unchanged.  Dispatch is static-capacity (GShard-style): each
expert takes at most ``cap`` assignments, in token order, and drops the
rest; ``cap`` follows from the token count alone, so every shape is known
on the host and nothing is read back from the device.  ``ep2d`` (experts
over a data rank axis, all-to-all dispatch) needs a data axis the port's
``CommCtx`` does not have (ROADMAP.md A10, A4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# named ranges around moe_forward's parts, so a profile can split their
# device time (chip_smoke.py's MoE breakdown)
ROUTE_RANGE = "repro_torch.moe.route"        # router product, softmax, top-k
DISPATCH_RANGE = "repro_torch.moe.dispatch"  # one-hot, cumsum, scatter, gather
EXPERTS_RANGE = "repro_torch.moe.experts"    # the batched expert products
COMBINE_RANGE = "repro_torch.moe.combine"    # gather, weight, sum over k

EP2D_REFUSAL = ("MoE partitioning 'ep2d' needs a data rank axis and "
                "all-to-all, which the port does not have yet "
                "(ROADMAP.md A10, A4)")


def local_sizes(cfg, tp: int):
    """(experts, expert d_ff) each rank holds."""
    e, f, mode = cfg.num_experts, cfg.moe_d_ff, cfg.moe_partition
    if mode == "expert":
        if e % tp:
            raise ValueError(f"num_experts={e} is not a multiple of tp={tp}")
        return e // tp, f
    if mode == "ffn":
        if f % tp:
            raise ValueError(f"moe_d_ff={f} is not a multiple of tp={tp}")
        return e, f // tp
    if mode == "ep2d":
        raise NotImplementedError(EP2D_REFUSAL)
    raise ValueError(mode)


def expert_offsets(cfg, tp: int, device) -> torch.Tensor:
    """(R,) index of each rank's first local expert: r·E/tp in ``expert``
    mode, 0 in ``ffn`` mode."""
    e_loc, _ = local_sizes(cfg, tp)
    step = e_loc if cfg.moe_partition == "expert" else 0
    return torch.arange(tp, device=device) * step


def init_moe_params(gen: torch.Generator, cfg, tp: int, *, device, dtype):
    """Random MoE weights with the reference's scales: router and expert
    inputs d^-0.5, expert down d_ff^-0.5.  The router is replicated
    ``(d, E)`` and float32 whatever ``dtype``; expert weights are
    ``(R, E_loc, d, f_loc)`` (``w_down`` ``(R, E_loc, f_loc, d)``)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    e_loc, f_loc = local_sizes(cfg, tp)
    s = d ** -0.5

    def w(*shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt) * scale

    return {"router": w(d, e, scale=s, dt=torch.float32),
            "w_gate": w(tp, e_loc, d, f_loc, scale=s),
            "w_up": w(tp, e_loc, d, f_loc, scale=s),
            "w_down": w(tp, e_loc, f_loc, d, scale=f ** -0.5)}


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: ties go to the lower index (a
    stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, cfg):
    """x (R, T, d) -> (weights (R, T, k) in x.dtype, ids (R, T, k), aux
    (R,)).  Routing runs in float32; aux is the Switch load-balancing loss
    E·sum_e(f_e·P_e), f_e by top-1 assignment."""
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    e = cfg.num_experts
    experts = torch.arange(e, device=x.device)
    f_e = (topi[..., 0, None] == experts).float().mean(dim=1)
    p_e = probs.mean(dim=1)
    aux = e * (f_e * p_e).sum(dim=-1)
    return topw.to(x.dtype), topi, aux


def _capacity_dispatch(x, topi, topw, *, n_local: int, lo: torch.Tensor,
                       capacity: int):
    """Place each rank's local assignments into per-expert buffers of
    ``capacity`` rows, in token order.  x (R, T, d), topi/topw (R, T, k),
    lo (R,) each rank's first local expert.

    Returns (buf (R, n_local, C, d), slot (R, T·k) with -1 for dropped or
    remote assignments, flat_w (R, T·k)).  The buffer row of each kept
    slot is found by scattering token indices into a slot table whose
    last entry collects the dropped ones; that entry is reset after the
    scatter, so its duplicate writes are harmless, and it and every
    unfilled slot point at a zero row."""
    r, t, k = topi.shape
    d = x.shape[-1]
    flat_e = topi.reshape(r, t * k) - lo[:, None]
    flat_w = topw.reshape(r, t * k)
    local = (flat_e >= 0) & (flat_e < n_local)
    le = torch.where(local, flat_e, n_local)           # n_local = trash bin
    # each assignment's place in its expert's queue: a running count along
    # the token order, in the last dim, where CUDA scans the rows in
    # parallel (a scan along a middle dim is many times slower)
    experts = torch.arange(n_local + 1, device=x.device)
    oh = (le[:, None, :] == experts[:, None]).int()    # (R, n_local+1, T·k)
    pos = oh.cumsum(dim=2).gather(1, le[:, None, :])[:, 0] - 1
    keep = local & (pos < capacity)
    slot = torch.where(keep, le * capacity + pos, -1)
    trash = n_local * capacity
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    src = torch.full((r, trash + 1), t, dtype=torch.long, device=x.device)
    src.scatter_(1, torch.where(keep, slot, trash), tok.expand(r, -1))
    src[:, trash] = t
    rows = torch.cat([x, x.new_zeros(r, 1, d)], dim=1)  # row t is zero
    buf = rows.gather(1, src[:, :trash, None].expand(-1, -1, d))
    return buf.reshape(r, n_local, capacity, d), slot, flat_w


def _expert_ffn(buf, params):
    """buf (R, E_loc, C, d) -> (R, E_loc, C, d): batched expert products,
    SiLU in float32 cast back to the buffer's dtype."""
    g = buf @ params["w_gate"]
    u = buf @ params["w_up"]
    h = F.silu(g.float()).to(buf.dtype) * u
    return h @ params["w_down"]


def _combine(out_buf, slot, flat_w, t: int, k: int):
    """Gather each assignment's expert output (zero where dropped), weight
    it in the output's dtype and sum over k."""
    r, n_local, c, d = out_buf.shape
    flat = torch.cat([out_buf.reshape(r, n_local * c, d),
                      out_buf.new_zeros(r, 1, d)], dim=1)
    idx = torch.where(slot >= 0, slot, n_local * c)
    gathered = flat.gather(1, idx[..., None].expand(-1, -1, d))
    gathered = gathered * flat_w[..., None].to(gathered.dtype)
    return gathered.reshape(r, t, k, d).sum(dim=2)


def moe_forward(params, x: torch.Tensor, cfg):
    """x (R, B, S, d), the same on every rank -> (partial out (R, B, S, d),
    aux (R,)).  The caller's ``comm_norm`` reduces the output over R.
    Capacity per expert is max(ceil(T·k/E·capacity_factor), 4) with T =
    B·S, padding rows included."""
    r, b, s, d = x.shape
    e_loc, _ = local_sizes(cfg, r)          # refuses ep2d
    xt = x.reshape(r, b * s, d)
    t = b * s
    k = cfg.num_experts_per_tok
    record = torch.profiler.record_function
    with record(ROUTE_RANGE):
        topw, topi, aux = _route(xt, params["router"], cfg)
    cap = int(math.ceil(t * k / cfg.num_experts * cfg.capacity_factor))
    cap = max(cap, 4)
    with record(DISPATCH_RANGE):
        buf, slot, flat_w = _capacity_dispatch(
            xt, topi, topw, n_local=e_loc,
            lo=expert_offsets(cfg, r, x.device), capacity=cap)
    with record(EXPERTS_RANGE):
        out_buf = _expert_ffn(buf, params)
    with record(COMBINE_RANGE):
        out = _combine(out_buf, slot, flat_w, t, k)
    return out.reshape(r, b, s, d), aux
