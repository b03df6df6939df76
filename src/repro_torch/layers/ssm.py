"""State-space layers, as ``repro.layers.ssm``: the Mamba-1 selective scan
(falcon-mamba) and the Mamba-2 SSD (zamba2), tensor-parallel over d_inner
/ heads.

The tp ranks sit on a leading rank axis R of one device
(``distributed/context.py``): sharded weights are ``(R, ...)`` as in the
reference's pytree, the layer input is ``(R, B, S, d)`` (the same on every
rank) and the output is partial over the ranks; its reduction is
``comm_norm``.  The reference's two collectives become sums over R, or
over the model group of a ``process_group`` ``ctx`` (R = 1 there): the
``x_proj`` output of Mamba-1 (``(dt_rank + 2·state)`` per token, in its
own ``record_function`` range) and the gated norm's scalar variance of
Mamba-2.  What is the same on every rank after them (Mamba-1's dt/B/C,
Mamba-2's B/C projection from the replicated layer input) is computed
once, without the rank axis.

The recurrences run in float32, chunk by chunk (Mamba-1 ``chunk=256``,
Mamba-2 ``chunk=128``), so no ``(B, S, d_inner, state)`` tensor of a whole
prompt is ever made: Mamba-1 scans each chunk with the reference's
associative operator in ``jax.lax.associative_scan``'s odd/even
recursion, Mamba-2 takes the reference's quadratic-within-chunk SSD step.
Neither has a Pallas kernel in the reference; both are plain PyTorch
here, in named ranges so that a profile can size them (``*_RANGE``).

State per layer, with the batch on dim 1 of every leaf:
Mamba-1 ``(conv (R, B, K-1, dil), h (R, B, dil, state) float32)``;
Mamba-2 ``((conv_x (R, B, K-1, dil), conv_bc (1, B, K-1, 2·state)),
h (R, B, nh_loc, head_dim, state) float32)`` -- the B/C conv state is
replicated, so it keeps a rank axis of size 1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import randn_ranks
from repro_torch.distributed.collectives import psum

IN_PROJ_RANGE = "repro_torch.ssm.in_proj"      # in_proj (and Mamba-2's B/C)
CONV_RANGE = "repro_torch.ssm.conv"            # causal depthwise conv, silu
XPROJ_RANGE = "repro_torch.ssm.x_proj_sum"     # x_proj and its sum over R
SCAN_RANGE = "repro_torch.ssm.scan"            # dt, the recurrence, y
OUT_PROJ_RANGE = "repro_torch.ssm.out_proj"    # gate / gated norm, out_proj
RANGES = {"ssm_in_proj": IN_PROJ_RANGE, "ssm_conv": CONV_RANGE,
          "ssm_x_proj_sum": XPROJ_RANGE, "ssm_scan": SCAN_RANGE,
          "ssm_out_proj": OUT_PROJ_RANGE}

_record = torch.profiler.record_function


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def _bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel (*lead, C) weight shaped to broadcast over x's
    (*lead, ..., S, C)."""
    return w.reshape(*w.shape[:-1], *([1] * (x.dim() - w.dim())),
                     w.shape[-1])


def causal_conv1d(x, w, b=None, *, state=None):
    """Depthwise causal conv.  x (*lead, S, C); w (*wlead, K, C), wlead a
    prefix of lead (the rank axis, or none); state (*lead, K-1, C): the
    carry-in from the previous chunk or token.  Returns (out,
    new_state)."""
    k, s = w.shape[-2], x.shape[-2]
    if state is None:
        state = torch.zeros(*x.shape[:-2], k - 1, x.shape[-1],
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=-2)
    out = 0
    for i in range(k):
        out = out + xp[..., i:i + s, :] * _bcast(w[..., i, :], x)
    if b is not None:
        out = out + _bcast(b, x)
    new_state = xp[..., s:, :] if k > 1 else state
    return out, new_state


def _slice(x, dim: int, start, stop=None, step=None):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _prefix_scan(a, b, dim: int, out=None):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along ``dim`` from h = 0
    with the reference's operator ((a_l, b_l), (a_r, b_r)) -> (a_l a_r,
    b_r + a_r b_l): (the cumulative products of a, the sums), written into
    ``out`` (two tensors like a and b, or views) when given.  The odd/even
    recursion of ``jax.lax.associative_scan``, so it rounds as the
    reference does: pair up neighbours, scan the pairs into the odd
    positions of the output, then give each even position its left
    neighbour's prefix; each level writes its results straight into the
    output's strided views."""
    if out is None:
        out = (torch.empty_like(a), torch.empty_like(b))
    oa, ob = out
    n = a.shape[dim]
    if n < 2:
        oa.copy_(a)
        ob.copy_(b)
        return out
    m, k = n // 2, (n - 1) // 2           # pairs; even positions past 0
    al, bl = _slice(a, dim, 0, 2 * m, 2), _slice(b, dim, 0, 2 * m, 2)
    ar, br = _slice(a, dim, 1, 2 * m, 2), _slice(b, dim, 1, 2 * m, 2)
    odd = (_slice(oa, dim, 1, 2 * m, 2), _slice(ob, dim, 1, 2 * m, 2))
    _prefix_scan(al * ar, torch.addcmul(br, ar, bl), dim, odd)
    _slice(oa, dim, 0, 1).copy_(_slice(a, dim, 0, 1))
    _slice(ob, dim, 0, 1).copy_(_slice(b, dim, 0, 1))
    if k:
        ae, be = _slice(a, dim, 2, None, 2), _slice(b, dim, 2, None, 2)
        pa, pb = (_slice(t, dim, 0, k) for t in odd)
        torch.mul(pa, ae, out=_slice(oa, dim, 2, None, 2))
        torch.addcmul(be, ae, pb, out=_slice(ob, dim, 2, None, 2))
    return out


def _interleave(even, odd, dim: int, n: int):
    """Positions 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd``
    along ``dim``, n in all."""
    if odd.shape[dim] < even.shape[dim]:                 # n odd
        odd = torch.cat([odd, _slice(even, dim, 0, 1)], dim=dim)
    both = torch.stack([even, odd], dim=dim + 1)
    both = both.flatten(dim, dim + 1)
    return _slice(both, dim, 0, n)


def _prefix_scan_train(a, b, dim: int):
    """``_prefix_scan`` for autograd: the same odd/even recursion and the
    same operations, so it rounds bit for bit as the serving form, but
    each level is built from new tensors (``torch.stack`` and an
    interleave) instead of writes into strided views of an output, which
    autograd refuses."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    m, k = n // 2, (n - 1) // 2
    al, bl = _slice(a, dim, 0, 2 * m, 2), _slice(b, dim, 0, 2 * m, 2)
    ar, br = _slice(a, dim, 1, 2 * m, 2), _slice(b, dim, 1, 2 * m, 2)
    oa, ob = _prefix_scan_train(al * ar, torch.addcmul(br, ar, bl), dim)
    ea, eb = _slice(a, dim, 0, 1), _slice(b, dim, 0, 1)
    if k:
        ae, be = _slice(a, dim, 2, None, 2), _slice(b, dim, 2, None, 2)
        pa, pb = (_slice(t, dim, 0, k) for t in (oa, ob))
        ea = torch.cat([ea, pa * ae], dim=dim)
        eb = torch.cat([eb, torch.addcmul(be, ae, pb)], dim=dim)
    return _interleave(ea, oa, dim, n), _interleave(eb, ob, dim, n)


def _scan_chunk(a, b, h, dim: int):
    """One chunk: h_t for every t of the chunk from the carry-in h (a[t]
    without the time axis).  Returns (h_all, h at the chunk's end).  The
    training form of the scan runs where autograd records the call."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h.requires_grad):
        pa, pb = _prefix_scan_train(a, b, dim)
    else:
        pa, pb = _prefix_scan(a, b, dim)
    h_all = torch.addcmul(pb, pa, h.unsqueeze(dim))
    return h_all, h_all.select(dim, -1)


def _ssm_scan_chunked(a, b, h0, chunk: int):
    """h_t = a_t * h_{t-1} + b_t along axis 1; a, b: (B, S, ...); h0 like
    a[:, 0].  Sequential over chunks, log-depth within.  Returns (h_all,
    h_f)."""
    s = a.shape[1]
    q = min(chunk, s)
    outs, h = [], h0
    for lo in range(0, s, q):
        h_all, h = _scan_chunk(a[:, lo:lo + q], b[:, lo:lo + q], h, 1)
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def _split_rows(state, lo: int, hi: int):
    """Rows [lo, hi) of a state (nested tuples of (R, B, ...) leaves)."""
    if isinstance(state, tuple):
        return tuple(_split_rows(t, lo, hi) for t in state)
    return state[:, lo:hi]


def _cat_rows(states):
    """Join per-split states along the batch (dim 1 of every leaf)."""
    if isinstance(states[0], tuple):
        return tuple(_cat_rows([st[i] for st in states])
                     for i in range(len(states[0])))
    return torch.cat(states, dim=1)


# --------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# --------------------------------------------------------------------------

def init_mamba1_params(gen, cfg, tp: int, *, device, dtype, rank=None):
    """Random Mamba-1 weights for ``tp`` ranks with the reference's scales
    and shapes (``repro.layers.ssm.init_mamba1_params``), from ``gen``;
    model rank ``rank``'s alone when given (``device.randn_ranks``)."""
    d, di, s_st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.ssm_dt_rank, cfg.ssm_conv
    if di % tp:
        raise ValueError(f"d_inner={di} is not a multiple of tp={tp}")
    dil, r = di // tp, tp if rank is None else 1

    def rnd(shape, scale):
        return (randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    a_init = torch.arange(1, s_st + 1, dtype=torch.float32,
                          device=device)[None].expand(dil, s_st)
    return {
        "in_proj": rnd((d, 2 * dil), d ** -0.5),
        "conv_w": rnd((k, dil), 0.2),
        "conv_b": torch.zeros(r, dil, dtype=dtype, device=device),
        "x_proj": rnd((dil, dtr + 2 * s_st), di ** -0.5),
        "dt_w": rnd((dtr, dil), dtr ** -0.5),
        "dt_b": torch.full((r, dil), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a_init)[None].repeat(r, 1, 1),
        "D": torch.ones(r, dil, dtype=torch.float32, device=device),
        "out_proj": rnd((dil, d), di ** -0.5),
    }


def mamba1_forward(params, x, *, cfg, init_state: Optional[Tuple] = None,
                   chunk: int = 256, ctx=None):
    """x (R, B, S, d), the same on every rank -> (partial out (R, B, S,
    d), (conv_state, h_state)).  ``init_state``: (conv_state, h) from a
    prefix token split (or the decode cache); the suffix resumes the
    recurrence exactly.  ``ctx``: the ``CommCtx`` the x_proj sum runs
    over (the rank axis when None)."""
    r, bsz, s, d = x.shape
    dil = params["conv_b"].shape[-1]
    s_st, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    conv_st, h = init_state if init_state is not None else (None, None)

    with _record(IN_PROJ_RANGE):
        xz = (x.reshape(r, bsz * s, d) @ params["in_proj"]
              ).reshape(r, bsz, s, 2 * dil)
        xs, z = xz[..., :dil], xz[..., dil:]
    with _record(CONV_RANGE):
        u, conv_st = causal_conv1d(xs, params["conv_w"], params["conv_b"],
                                   state=conv_st)
        u = F.silu(u.float()).to(x.dtype)
    # dt/B/C from the full inner dim: local partial + its sum over ranks
    with _record(XPROJ_RANGE):
        dbc = psum(u.reshape(r, bsz * s, dil) @ params["x_proj"],
                   ctx).float().reshape(bsz, s, -1)
        dt_in = dbc[..., :dtr]
        b_ssm, c_ssm = dbc[..., dtr:dtr + s_st], dbc[..., dtr + s_st:]
    with _record(SCAN_RANGE):
        dt = F.softplus(
            (dt_in.reshape(1, bsz * s, dtr) @ params["dt_w"].float()
             ).reshape(r, bsz, s, dil)
            + _bcast(params["dt_b"].float(), u))           # (R, B, S, dil)
        a_mat = -torch.exp(params["A_log"])[:, None, None]  # (R,1,1,dil,n)
        uf = u.float()
        du = dt * uf
        if h is None:
            h = torch.zeros(r, bsz, dil, s_st, dtype=torch.float32,
                            device=x.device)
        q = min(chunk, s)
        ys = []
        for lo in range(0, s, q):
            sl = slice(lo, lo + q)
            a_bar = torch.exp(dt[:, :, sl, :, None] * a_mat)
            b_bar = du[:, :, sl, :, None] * b_ssm[None, :, sl, None, :]
            h_all, h = _scan_chunk(a_bar, b_bar, h, 2)
            ys.append((h_all @ c_ssm[None, :, sl, :, None])[..., 0])
        y = torch.cat(ys, dim=2) if len(ys) > 1 else ys[0]
        y = y + _bcast(params["D"], uf) * uf
    with _record(OUT_PROJ_RANGE):
        y = (y * F.silu(z.float())).to(x.dtype)
        partial = (y.reshape(r, bsz * s, dil) @ params["out_proj"]
                   ).reshape(r, bsz, s, d)
    return partial, (conv_st, h)


def mamba1_decode(params, x, state, *, cfg, ctx=None):
    """Single-token step; state = (conv_state (R, B, K-1, dil), h (R, B,
    dil, state))."""
    return mamba1_forward(params, x, cfg=cfg, init_state=state, chunk=1,
                          ctx=ctx)


def init_mamba1_state(batch: int, cfg, tp: int, layers: int, *, device,
                      dtype=None, ranks: Optional[int] = None):
    """Zero state for ``layers`` layers: (conv (L, R, B, K-1, dil), h (L,
    R, B, dil, state) float32); R = ``ranks`` (tp unless given; 1 in a
    process of a model group)."""
    dil, r = cfg.d_inner // tp, ranks or tp
    dtype = dtype or getattr(torch, cfg.dtype)
    return (
        torch.zeros(layers, r, batch, cfg.ssm_conv - 1, dil, dtype=dtype,
                    device=device),
        torch.zeros(layers, r, batch, dil, cfg.ssm_state,
                    dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2 backbone)
# --------------------------------------------------------------------------

def init_mamba2_params(gen, cfg, tp: int, *, device, dtype, rank=None):
    """Random Mamba-2 weights for ``tp`` ranks with the reference's scales
    and shapes; the replicated B/C projection and conv drop the size-1
    axis the reference gives them.  Model rank ``rank``'s alone when
    given (``device.randn_ranks``)."""
    d, di, s_st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, k = cfg.ssm_heads, cfg.ssm_conv
    if di % tp or nh % tp:
        raise ValueError(f"d_inner={di} and ssm_heads={nh} must be "
                         f"multiples of tp={tp}")
    dil, nhl, r = di // tp, nh // tp, tp if rank is None else 1

    def rnd(shape, scale):
        return (randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def replicated(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    return {
        "in_proj": rnd((d, 2 * dil + nhl), d ** -0.5),
        "in_proj_bc": replicated((d, 2 * s_st), d ** -0.5),
        "conv_x": rnd((k, dil), 0.2),
        "conv_bc": replicated((k, 2 * s_st), 0.2),
        "A_log": torch.zeros(r, nhl, dtype=torch.float32, device=device),
        "D": torch.ones(r, nhl, dtype=torch.float32, device=device),
        "dt_bias": torch.full((r, nhl), -4.6, dtype=torch.float32,
                              device=device),
        "gate_norm": torch.ones(r, dil, dtype=dtype, device=device),
        "out_proj": rnd((dil, d), di ** -0.5),
    }


def _gated_rmsnorm_tp(y, z, w, eps, ctx=None):
    """RMSNorm(y * silu(z)) with the variance over the FULL (sharded)
    d_inner: the per-rank sums of squares summed over the tp ranks (the
    rank axis, or ``ctx``'s model group).  y, z (R, ..., dil); w (R,
    dil)."""
    g = y.float() * F.silu(z.float())
    ss = (g * g).sum(dim=-1, keepdim=True)
    tp = g.shape[0] if ctx is None else ctx.tp
    if tp > 1:
        ss = psum(ss, ctx)[None]
    inv = torch.rsqrt(ss / (g.shape[-1] * tp) + eps)
    return (g * inv * _bcast(w.float(), g)).to(z.dtype)


def _ssd_chunk(h, xc, dc, bcu, ccu, a_h):
    """One SSD chunk of q tokens, as the reference's ``step``: xc (R, B,
    q, nh, dh), dc (R, B, q, nh), bcu / ccu (B, q, state), a_h (R, nh),
    h (R, B, nh, dh, state).  Returns (h after the chunk, y (R, B, q, nh,
    dh))."""
    q = xc.shape[2]
    la = dc * a_h[:, None, None]                        # log a_t
    cum = torch.cumsum(la, dim=2)                       # (R, B, q, nh)
    # intra-chunk (quadratic within the chunk)
    decay = torch.exp(cum[:, :, :, None] - cum[:, :, None, :])  # (R,B,q,k,nh)
    cb = torch.einsum("bqs,bks->bqk", ccu, bcu)         # (B, q, k)
    m = cb[None, ..., None] * decay * dc[:, :, None]
    causal = torch.ones(q, q, dtype=torch.bool, device=xc.device).tril()
    m = torch.where(causal[:, :, None], m, torch.zeros((), device=m.device))
    y_intra = torch.einsum("rbqkh,rbkhd->rbqhd", m, xc)
    # inter-chunk, from the carried state
    y_inter = torch.einsum("bqs,rbhds,rbqh->rbqhd", ccu, h, torch.exp(cum))
    # the chunk's state update
    decay_end = torch.exp(cum[:, :, -1:] - cum)         # (R, B, q, nh)
    s_c = torch.einsum("rbkh,bks,rbkhd->rbhds", dc * decay_end, bcu, xc)
    h_new = torch.exp(cum[:, :, -1])[..., None, None] * h + s_c
    return h_new, y_intra + y_inter


def mamba2_forward(params, x, *, cfg, init_state: Optional[Tuple] = None,
                   chunk: int = 128, ctx=None):
    """Chunked SSD.  x (R, B, S, d), the same on every rank -> (partial
    (R, B, S, d), ((conv_x_state, conv_bc_state), h_state)); h_state
    (R, B, nh_loc, dh, state).  B/C are shared across heads (n_groups=1)
    and computed once, from the first local rank's copy of the
    replicated input.  ``ctx``: the ``CommCtx`` the gated norm's variance
    sums over (the rank axis when None)."""
    r, bsz, s, d = x.shape
    s_st = cfg.ssm_state
    nhl = params["A_log"].shape[-1]
    dil = params["gate_norm"].shape[-1]
    dh = dil // nhl
    conv_st, h = init_state if init_state is not None else (None, None)

    with _record(IN_PROJ_RANGE):
        zxdt = (x.reshape(r, bsz * s, d) @ params["in_proj"]
                ).reshape(r, bsz, s, -1)
        z, xs, dt_raw = (zxdt[..., :dil], zxdt[..., dil:2 * dil],
                         zxdt[..., 2 * dil:])
        bc = (x[:1].reshape(1, bsz * s, d) @ params["in_proj_bc"]
              ).reshape(1, bsz, s, 2 * s_st)
    with _record(CONV_RANGE):
        xs, conv_x_st = causal_conv1d(
            xs, params["conv_x"], state=None if conv_st is None
            else conv_st[0])
        bc, conv_bc_st = causal_conv1d(
            bc, params["conv_bc"], state=None if conv_st is None
            else conv_st[1])
        xs = F.silu(xs.float()).to(x.dtype)
        bc = F.silu(bc.float())[0]                      # (B, S, 2·state)
    with _record(SCAN_RANGE):
        b_ssm, c_ssm = bc[..., :s_st], bc[..., s_st:]
        a_h = -torch.exp(params["A_log"])               # (R, nh)
        dt = F.softplus(dt_raw.float()
                        + params["dt_bias"][:, None, None])   # (R,B,S,nh)
        xh = xs.reshape(r, bsz, s, nhl, dh).float()
        if h is None:
            h = torch.zeros(r, bsz, nhl, dh, s_st, dtype=torch.float32,
                            device=x.device)
        q = min(chunk, s)
        ys = []
        for lo in range(0, s, q):
            sl = slice(lo, lo + q)
            h, y_c = _ssd_chunk(h, xh[:, :, sl], dt[:, :, sl],
                                b_ssm[:, sl], c_ssm[:, sl], a_h)
            ys.append(y_c)
        y = torch.cat(ys, dim=2) if len(ys) > 1 else ys[0]
        y = y + params["D"][:, None, None, :, None] * xh
        y = y.reshape(r, bsz, s, dil)
    with _record(OUT_PROJ_RANGE):
        y = _gated_rmsnorm_tp(y, z, params["gate_norm"], cfg.norm_eps, ctx)
        partial = (y.to(x.dtype).reshape(r, bsz * s, dil)
                   @ params["out_proj"]).reshape(r, bsz, s, d)
    return partial.to(x.dtype), ((conv_x_st, conv_bc_st), h)


def mamba2_decode(params, x, state, *, cfg, ctx=None):
    return mamba2_forward(params, x, cfg=cfg, init_state=state, chunk=1,
                          ctx=ctx)


def init_mamba2_state(batch: int, cfg, tp: int, layers: int, *, device,
                      dtype=None, ranks: Optional[int] = None):
    """Zero state for ``layers`` layers: ((conv_x (L, R, B, K-1, dil),
    conv_bc (L, 1, B, K-1, 2·state)), h (L, R, B, nh_loc, dh, state)
    float32); R = ``ranks`` (tp unless given; 1 in a process of a model
    group)."""
    di, nh, k = cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
    r = ranks or tp
    dtype = dtype or getattr(torch, cfg.dtype)
    return (
        (torch.zeros(layers, r, batch, k - 1, di // tp, dtype=dtype,
                     device=device),
         torch.zeros(layers, 1, batch, k - 1, 2 * cfg.ssm_state,
                     dtype=dtype, device=device)),
        torch.zeros(layers, r, batch, nh // tp, di // nh, cfg.ssm_state,
                    dtype=torch.float32, device=device),
    )
