"""Mixture-of-experts FFN, as ``repro.layers.moe``, in its three
partitionings, batched over the rank axis R and the data rank axis D
(``distributed/context.py``).

    expert : whole experts split over the ranks (E % tp == 0): rank r holds
             experts [r·E/tp, (r+1)·E/tp).  (olmoe)
    ffn    : every rank holds a d_ff slice of every expert (E < tp is
             fine).  (mixtral)
    ep2d   : experts over the data axis (data shard d holds experts
             [d·E/D, (d+1)·E/D)) and each expert's d_ff over the model
             ranks.  (qwen3-moe)  The reference queues each token's
             assignments by destination data shard and sends their rows
             and local expert ids with ``all_to_all(tiled=True)`` over
             ``data``, dispatches again into per-expert buffers on arrival,
             and sends the outputs home with a third all-to-all.  The port
             runs each dispatch as a send half and a receive half around
             ``collectives.all_to_all`` (``_ep2d_dispatch``,
             ``_ep2d_combine``): an index op on the one-device rank axes,
             ``all_to_all_single`` over the data group under
             ``process_group``, where a process routes, queues and drops
             its own data shard's tokens and runs its own experts' d_ff
             slice.

In all three the output is partial over the model ranks, as
``layers.mlp``'s is, so the layer's AllReduce is still the one
``comm_norm`` slot and kernels K1/K2 apply unchanged (the all-to-alls
commute with the sum over the model ranks).  Dispatch is static-capacity
(GShard-style): each expert (``ep2d``: each destination shard, then each
expert there) takes at most a capacity's worth of assignments, in token
(arrival) order, and drops the rest; every capacity follows from the data
shard's token count alone, so every shape is known on the host and nothing
is read back from the device.  With D > 1 the input holds the D data
shards' tokens one shard after the other, and each shard routes and drops
its own, as the reference's shards do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import randn_ranks
from repro_torch.distributed import collectives as COL
from repro_torch.distributed.context import CommCtx

# named ranges around moe_forward's parts, so a profile can split their
# device time (chip_smoke.py's MoE breakdown)
ROUTE_RANGE = "repro_torch.moe.route"        # router product, softmax, top-k
DISPATCH_RANGE = "repro_torch.moe.dispatch"  # queues, scatter, gather (ep2d:
#                                              both dispatches, the a2a of
#                                              rows and ids)
EXPERTS_RANGE = "repro_torch.moe.experts"    # the batched expert products
COMBINE_RANGE = "repro_torch.moe.combine"    # gather (ep2d: the a2a back),
#                                              weight, sum over k


def local_sizes(cfg, tp: int, ep: int = 1):
    """(experts, expert d_ff) each rank holds; ``ep`` is the data axis's
    size, which only ``ep2d`` splits experts over."""
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
        if e % ep:
            raise ValueError(f"num_experts={e} is not a multiple of ep={ep}")
        if f % tp:
            raise ValueError(f"moe_d_ff={f} is not a multiple of tp={tp}")
        return e // ep, f // tp
    raise ValueError(mode)


def expert_offsets(cfg, tp: int, device, ranks=None) -> torch.Tensor:
    """(R,) index of each local rank's first expert: r·E/tp in ``expert``
    mode, 0 in ``ffn`` mode, for the model ranks ``ranks`` (a range;
    all tp unless given)."""
    e_loc, _ = local_sizes(cfg, tp)
    step = e_loc if cfg.moe_partition == "expert" else 0
    ranks = range(tp) if ranks is None else ranks
    return torch.arange(ranks.start, ranks.stop, device=device) * step


def init_moe_params(gen: torch.Generator, cfg, tp: int, ep: int = 1, *,
                    device, dtype, rank=None, data_rank=None):
    """Random MoE weights with the reference's scales: router and expert
    inputs d^-0.5, expert down d_ff^-0.5.  The router is replicated
    ``(d, E)`` and float32 whatever ``dtype``; expert weights are
    ``(R, E_loc, d, f_loc)`` (``w_down`` ``(R, E_loc, f_loc, d)``), and
    ``(D, R, ...)`` for ``ep2d``, D = ``ep``.  With ``rank``, model rank
    ``rank``'s expert weights (for ``ep2d`` with ``data_rank``, the
    (data_rank, rank) slice, ``(1, 1, ...)``), each drawn whole and cut at
    once (``device.randn_ranks``)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    e_loc, f_loc = local_sizes(cfg, tp, ep)
    ep2d = cfg.moe_partition == "ep2d"
    lead = (ep, tp) if ep2d else (tp,)
    if rank is not None and ep2d and data_rank is None:
        raise ValueError("one rank's ep2d experts need its data_rank too: "
                         "they split over the data group")
    s = d ** -0.5

    def w(*shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt) * scale

    def expert(*shape, scale):
        return randn_ranks(gen, lead + shape, rank=rank,
                           data_rank=data_rank if ep2d else None,
                           device=device, dtype=dtype) * scale

    return {"router": w(d, e, scale=s, dt=torch.float32),
            "w_gate": expert(e_loc, d, f_loc, scale=s),
            "w_up": expert(e_loc, d, f_loc, scale=s),
            "w_down": expert(e_loc, f_loc, d, scale=f ** -0.5)}


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: ties go to the lower index (a
    stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, cfg):
    """x (N, T, d) -> (weights (N, T, k) in x.dtype, ids (N, T, k), aux
    (N,)).  Routing runs in float32; aux is the Switch load-balancing loss
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


def _queue(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Each entry's place in its bin's queue, in order along the last dim
    of ``bins`` (N, L) with values in [0, n_bins): a running count of a
    one-hot in the last dim, where CUDA scans the rows in parallel (a scan
    along a middle dim is many times slower)."""
    ids = torch.arange(n_bins, device=bins.device)
    oh = (bins[:, None, :] == ids[:, None]).int()      # (N, n_bins, L)
    return oh.cumsum(dim=2).gather(1, bins[:, None, :])[:, 0] - 1


def _fill(index: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
          n_slots: int, empty: int) -> torch.Tensor:
    """The table (N, n_slots) of what each slot holds: ``index`` (N, L)
    scattered to ``slot`` where ``keep``, ``empty`` elsewhere.  The
    dropped entries go to an extra last column, cut off after the scatter,
    so their duplicate writes are harmless."""
    n = slot.shape[0]
    table = torch.full((n, n_slots + 1), empty, dtype=torch.long,
                       device=slot.device)
    table.scatter_(1, torch.where(keep, slot, n_slots),
                   index.expand(n, -1))
    return table[:, :n_slots]


def _capacity_dispatch(x, topi, topw, *, n_local: int, lo: torch.Tensor,
                       capacity: int):
    """Place each rank's local assignments into per-expert buffers of
    ``capacity`` rows, in token order.  x (R, T, d), topi/topw (R, T, k),
    lo (R,) each rank's first local expert.

    Returns (buf (R, n_local, C, d), slot (R, T·k) with -1 for dropped or
    remote assignments, flat_w (R, T·k)).  Every unfilled slot points at a
    zero row."""
    r, t, k = topi.shape
    d = x.shape[-1]
    flat_e = topi.reshape(r, t * k) - lo[:, None]
    flat_w = topw.reshape(r, t * k)
    local = (flat_e >= 0) & (flat_e < n_local)
    le = torch.where(local, flat_e, n_local)           # n_local = trash bin
    pos = _queue(le, n_local + 1)
    keep = local & (pos < capacity)
    slot = torch.where(keep, le * capacity + pos, -1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    src = _fill(tok, keep, slot, n_local * capacity, t)
    rows = torch.cat([x, x.new_zeros(r, 1, d)], dim=1)  # row t is zero
    buf = rows.gather(1, src[:, :, None].expand(-1, -1, d))
    return buf.reshape(r, n_local, capacity, d), slot, flat_w


def _expert_ffn(buf, params):
    """Batched expert products, SiLU in float32 cast back to the buffer's
    dtype.  buf (..., E_loc, C, d) broadcasts against the weights' leading
    axes: (R, E_loc, C, d) for ``expert``/``ffn``, (R, D, E_loc, C, d)
    against unsqueezed weights with D data shards, (D, 1, E_loc, C, d)
    for ``ep2d``'s (D, R, ...) weights -> (D, R, E_loc, C, d)."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if buf.dim() > wg.dim():
        wg, wu, wd = wg[:, None], wu[:, None], wd[:, None]
    g = buf @ wg
    u = buf @ wu
    h = F.silu(g.float()).to(buf.dtype) * u
    return h @ wd


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


def _ep2d_send(xs, topi, *, dp: int, e_loc: int, cs: int):
    """The first dispatch's send half.  xs (N, T_loc, d) and topi (N,
    T_loc, k), N the data shards held here (D on the rank axis, 1 in a
    process).  Each shard queues its assignments by destination shard,
    ``cs`` a destination, in token order.  Returns (its send buffer's rows
    (N, D·cs, d), zero where empty, and their local expert ids (N, D·cs),
    -1 where empty; slot (N, T_loc·k), each assignment's send row j·cs + p
    or -1 where dropped)."""
    n, t_loc, k = topi.shape
    d = xs.shape[-1]
    flat = topi.reshape(n, t_loc * k)
    dest = flat // e_loc                                # destination shard
    pos = _queue(dest, dp)
    keep = pos < cs
    slot = torch.where(keep, dest * cs + pos, -1)
    tok = torch.arange(t_loc, device=xs.device).repeat_interleave(k)
    send_tok = _fill(tok, keep, slot, dp * cs, t_loc)   # t_loc: empty
    send_eid = _fill(flat % e_loc, keep, slot, dp * cs, -1)
    rows = torch.cat([xs, xs.new_zeros(n, 1, d)], dim=1)  # row t_loc is 0
    return (rows.gather(1, send_tok[..., None].expand(-1, -1, d)), send_eid,
            slot)


def _ep2d_receive(rows, eids, *, e_loc: int, cap2: int):
    """The second dispatch, on arrival: rows (N, D·cs, d) and their local
    expert ids (N, D·cs), source shard after source shard.  Each shard
    queues its arrivals by local expert, ``cap2`` an expert, in arrival
    order, so the drops here depend on the source order.  Returns (buf
    (N, e_loc, cap2, d), zero where unfilled; slot2 (N, D·cs), each
    arrival row's buffer row or -1 where empty or dropped)."""
    n, rt, d = rows.shape
    valid = eids >= 0
    le = torch.where(valid, eids, e_loc)                # e_loc = trash bin
    pos2 = _queue(le, e_loc + 1)
    keep2 = valid & (pos2 < cap2)
    slot2 = torch.where(keep2, le * cap2 + pos2, -1)
    arrival = _fill(torch.arange(rt, device=rows.device), keep2, slot2,
                    e_loc * cap2, rt)                   # rt: empty
    rows = torch.cat([rows, rows.new_zeros(n, 1, d)], dim=1)
    buf = rows.gather(1, arrival[..., None].expand(-1, -1, d))
    return buf.reshape(n, e_loc, cap2, d), slot2


def _ep2d_dispatch(xs, topi, *, e_loc: int, cs: int, cap2: int, ctx):
    """``ep2d``'s two dispatches around the all-to-all of the rows and
    their local expert ids over the data axis (``collectives.all_to_all``,
    tiled: arrival row s·cs + p on shard j is send row j·cs + p of shard
    s).  xs (N, T_loc, d), topi (N, T_loc, k).  Returns (buf (N, e_loc,
    cap2, d), slot (N, T_loc·k) each assignment's send row or -1, slot2
    (N, D·cs) each arrival row's buffer row or -1)."""
    rows, eids, slot = _ep2d_send(xs, topi, dp=ctx.dp, e_loc=e_loc, cs=cs)
    rows, eids = COL.all_to_all(rows[None], ctx, ids=eids[None])
    buf, slot2 = _ep2d_receive(rows[0], eids[0], e_loc=e_loc, cap2=cap2)
    return buf, slot, slot2


def _ep2d_reply(out_buf, slot2):
    """The return's send half: out_buf (N, R, e_loc, cap2, d), partial
    over the model ranks -> (R, N, D·cs, d), each arrival row's output at
    its arrival row (zero where empty or dropped)."""
    n, r, e_loc, cap2, d = out_buf.shape
    trash = e_loc * cap2
    flat = torch.cat([out_buf.reshape(n, r, trash, d),
                      out_buf.new_zeros(n, r, 1, d)], dim=2)
    row = torch.where(slot2 >= 0, slot2, trash)
    back = flat.gather(2, row[:, None, :, None].expand(-1, r, -1, d))
    return back.transpose(0, 1)


def _ep2d_home(reply, slot, topw):
    """The combine at each token's home shard: reply (R, N, D·cs, d), the
    output of each of its send rows at that row; slot as
    ``_ep2d_dispatch`` gives it; topw (N, T_loc, k) (the weights never
    left home).  Returns (R, N·T_loc, d), partial over the ranks."""
    r, n, rt, d = reply.shape
    _, t_loc, k = topw.shape
    flat = torch.cat([reply, reply.new_zeros(r, n, 1, d)], dim=2)
    idx = torch.where(slot >= 0, slot, rt)              # (N, T_loc·k)
    gathered = flat.gather(2, idx[None, :, :, None].expand(r, -1, -1, d))
    gathered = gathered * topw.reshape(1, n, t_loc * k, 1).to(
        gathered.dtype)
    return gathered.reshape(r, n, t_loc, k, d).sum(dim=3).reshape(
        r, n * t_loc, d)


def _ep2d_combine(out_buf, slot, slot2, topw, *, ctx):
    """The all-to-all back and the combine at home: out_buf (N, R, e_loc,
    cap2, d) partial over the model ranks; slot, slot2 as
    ``_ep2d_dispatch`` gives them; topw (N, T_loc, k).  Assignment a of
    shard s sent to send row j·cs + p arrived at row s·cs + p of shard j;
    its output is that row's buffer row (zero where dropped at either
    dispatch).  Returns the output (R, N·T_loc, d), partial over the
    ranks."""
    reply = COL.all_to_all(_ep2d_reply(out_buf, slot2), ctx)
    return _ep2d_home(reply, slot, topw)


def _ep2d_forward(params, xs, cfg, ctx):
    """``ep2d`` over xs (N, T_loc, d), each of the N data shards held here
    one after the other: the D = ``ctx.dp`` shards on the rank axis, where
    routing and dispatch run once for every rank (they are the same on
    each), or this process's one.  The expert products run on each rank's
    d_ff slice.  Returns (out (R, N·T_loc, d), partial over the ranks,
    aux (N,))."""
    record = torch.profiler.record_function
    n, t_loc, d = xs.shape
    dp, k = ctx.dp, cfg.num_experts_per_tok
    e_loc, _ = local_sizes(cfg, ctx.tp, dp)
    want = (n, ctx.local_ranks)
    if params["w_gate"].shape[:2] != want:
        raise ValueError(f"ep2d expert weights hold (D, R) = "
                         f"{tuple(params['w_gate'].shape[:2])}, the input "
                         f"{want}")
    with record(ROUTE_RANGE):
        topw, topi, aux = _route(xs, params["router"], cfg)
    cs = max(int(math.ceil(t_loc * k / dp * cfg.capacity_factor)), 4)
    cap2 = int(math.ceil(dp * cs / e_loc * cfg.capacity_factor))
    with record(DISPATCH_RANGE):
        buf, slot, slot2 = _ep2d_dispatch(xs, topi, e_loc=e_loc, cs=cs,
                                          cap2=cap2, ctx=ctx)
    with record(EXPERTS_RANGE):
        out_buf = _expert_ffn(buf[:, None], params)
    with record(COMBINE_RANGE):
        out = _ep2d_combine(out_buf, slot, slot2, topw, ctx=ctx)
    return out, aux


def moe_forward(params, x: torch.Tensor, cfg, *, dp: int = 1, ctx=None):
    """x (R, B, S, d), the same on every rank, B holding the ``dp`` data
    shards' rows one shard after the other -> (partial out (R, B, S, d),
    aux (R,), or (R, D) when dp > 1).  The caller's ``comm_norm`` reduces
    the output over R.  Each data shard's capacity follows from its own
    T_loc = B·S / D tokens, padding rows included: per expert
    max(ceil(T_loc·k/E·capacity_factor), 4) for ``expert``/``ffn``; for
    ``ep2d`` cs = max(ceil(T_loc·k/D·capacity_factor), 4) per destination
    shard, then ceil(D·cs/E_loc·capacity_factor) per expert.

    ``ctx`` (a ``CommCtx``) gives the model group's size tp and the model
    rank of the first local rank: under ``process_group`` R = 1 is model
    rank ``ctx.rank`` of ``ctx.tp``, and in ``expert`` mode it holds
    experts [rank·E/tp, (rank+1)·E/tp).  For ``ep2d`` under
    ``process_group`` x is this process's data shard's tokens (``dp`` is
    1), D is the data group's size ``ctx.dp``, the weights are the
    process's (1, 1, E/D, ...) and the all-to-alls go over the data group.
    Without one, the R local ranks are all tp ranks."""
    r, b, s, d = x.shape
    tp, first = (r, 0) if ctx is None else (ctx.tp, ctx.rank)
    if b % dp:
        raise ValueError(f"{b} rows do not split over {dp} data shards")
    if cfg.moe_partition == "ep2d":
        if ctx is not None and ctx.process_group:
            if dp != 1:
                raise ValueError("a process holds one data shard's rows: "
                                 "dp is the data group's, ctx.dp")
            out, aux = _ep2d_forward(params, x.reshape(1, b * s, d), cfg,
                                     ctx)
            return out.reshape(r, b, s, d), aux
        out, aux = _ep2d_forward(params, x[0].reshape(dp, b * s // dp, d),
                                 cfg, CommCtx(tp=r, dp=dp))
        aux = aux.expand(r, dp) if dp > 1 else aux.expand(r)
        return out.reshape(r, b, s, d), aux
    t_loc = b * s // dp
    k = cfg.num_experts_per_tok
    record = torch.profiler.record_function
    e_loc, _ = local_sizes(cfg, tp)
    # each (rank, data shard) routes and queues its own tokens
    xt = x.reshape(r * dp, t_loc, d)
    with record(ROUTE_RANGE):
        topw, topi, aux = _route(xt, params["router"], cfg)
    cap = int(math.ceil(t_loc * k / cfg.num_experts * cfg.capacity_factor))
    cap = max(cap, 4)
    with record(DISPATCH_RANGE):
        buf, slot, flat_w = _capacity_dispatch(
            xt, topi, topw, n_local=e_loc,
            lo=expert_offsets(cfg, tp, x.device, range(first, first + r)
                              ).repeat_interleave(dp),
            capacity=cap)
    with record(EXPERTS_RANGE):
        if dp > 1:
            buf = buf.reshape(r, dp, *buf.shape[1:])
        out_buf = _expert_ffn(buf, params).reshape(r * dp, e_loc, cap, d)
    with record(COMBINE_RANGE):
        out = _combine(out_buf, slot, flat_w, t_loc, k)
    return out.reshape(r, b, s, d), (aux.reshape(r, dp) if dp > 1 else aux)
