"""K3: flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention``
(``src/repro/kernels/flash_attention.py``), which prefill attention reaches
through ``multihead_attention(impl="pallas")``.  It is bound by operations
(4·B·Sq·Sk·Hq·dh FLOPs over the visible pairs).  The CUDA kernel runs one
CTA per (batch, KV head, q tile) so one K/V tile in shared memory serves
the whole GQA group, with a running (m, l, acc) in fp32.  bfloat16 inputs
(head dim 64, 128, 224 or 256) go through a Hopper body: 128 query rows
per CTA in two consumer warpgroups running ``wgmma``, K/V tiles of 128
keys (64 above head dim 128) brought by a producer warp with TMA through a
ring of stages on ``mbarrier``s; float32 inputs (head dim 16 to 128) go
through plain FMA.  The source note names the numerics traps and why the
design is what it is.

Masked-tile skipping (bfloat16 body).  On the serving path most keys a
prefill chunk attends are hidden: the legacy cache slot of a fresh request
is empty (kpos −1) and the causal mask hides the upper half of the
chunk's own keys.  ``live_tiles`` is the one place the rule lives: a
(batch, q tile, key tile) table, built with torch ops and no host sync,
that marks a key tile live iff it holds a key some query of the q tile
may see.  The kernel visits only live tiles.  Skipping changes one
thing: a query row with no visible key (a padded prefill token, qpos −1)
must still get the uniform average of V over all Sk keys, as the model
path's ``_attn_ref`` gives it with its finite ``NEG_INF``; the kernel
takes that mean, in fp32, from a side pass over V that runs in the same
call (``vsum`` partials per (batch, KV head, chunk of keys)).

``flash_attention`` is the wrapper: on CPU and meta tensors it runs
``flash_attention_plain`` (the semantics of the model path's
``_attn_ref``); on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bfloat16 runs the wgmma body, whose tiles are rows of 64 bf16 (128 bytes);
# head dim 224 runs as 256 with a zero tail the kernel's TMA fills.  No
# model runs float32 on the card, so its FMA body stops at 128.
_HEAD_DIMS = {torch.float32: (16, 32, 64, 128),
              torch.bfloat16: (64, 128, 224, 256)}
_MAX_GROUP = 64
# named range around the live-tile table's ops, so a profile can count
# them as K3's
LIVE_TILES_RANGE = "repro_torch.flash_attention.live_tiles"
_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1


def attention_mask(qpos, kpos, causal: bool, window: int):
    """(B, Sq, Sk) bool: key visible to query.  kpos < 0 marks padding;
    window <= 0 means full attention."""
    m = (kpos[:, None, :] >= 0).expand(-1, qpos.shape[1], -1)
    if causal:
        m = m & (qpos[:, :, None] >= kpos[:, None, :])
    if window > 0:
        m = m & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    return m


def live_tiles(qpos, kpos, *, causal: bool, window: int = 0,
               queries_per_cta: int, keys_per_tile: int):
    """(B, ceil(Sq / queries_per_cta), ceil(Sk / keys_per_tile)) uint8
    table of (q tile, key tile) pairs: 0 where the mask hides every
    (query, key) pair of the two (the kernel skips the tile), 1 where some
    pair may be visible (the kernel visits the tile and masks it), 2 where
    every pair is visible (the kernel visits it without masking).

    A key can be visible only if kpos >= 0; under ``causal`` only if kpos
    <= the q tile's largest qpos; under ``window`` only if kpos > the q
    tile's smallest qpos - window.  A tile is live iff one key passes all
    three (each bound taken over the tile's keys), so the rule never
    drops a visible pair; it may keep a tile whose keys pass the bounds
    one by one but not together, which costs time, never a result.  A
    live tile is full iff it lies inside Sk, every key has kpos >= 0, and
    (causal) its largest kpos <= the q tile's smallest qpos and (window)
    the q tile's largest qpos - its smallest kpos < window.  Queries past
    Sq take no part.  Torch ops only, no host sync."""
    pad = torch.nn.functional.pad
    b, sq = qpos.shape
    sk = kpos.shape[1]
    nqt = -(-sq // queries_per_cta)
    nkt = -(-sk // keys_per_tile)
    kp = pad(kpos, (0, nkt * keys_per_tile - sk), value=-1
             ).view(b, nkt, keys_per_tile)
    valid = kp >= 0
    live = valid.any(-1)[:, None, :]                  # (B, 1, nkt)
    full = valid.all(-1)[:, None, :]
    padq = nqt * queries_per_cta - sq
    qmax = pad(qpos, (0, padq), value=_INT_MIN).view(b, nqt, -1).amax(-1)
    qmin = pad(qpos, (0, padq), value=_INT_MAX).view(b, nqt, -1).amin(-1)
    kmin = torch.where(valid, kp, _INT_MAX).amin(-1)[:, None, :]
    kmax = torch.where(valid, kp, _INT_MIN).amax(-1)[:, None, :]
    qmax, qmin = qmax[:, :, None], qmin[:, :, None]
    if causal:
        live = live & (kmin <= qmax)
        full = full & (kmax <= qmin)
    if window > 0:
        live = live & (kmax.long() > qmin.long() - window)
        full = full & (qmax.long() - kmin.long() < window)
    return (live.to(torch.uint8) * (1 + full.to(torch.uint8))).expand(
        b, nqt, nkt).contiguous()


def flash_attention_plain(q, k, v, qpos, kpos, *, causal: bool,
                          window: int = 0, sm_scale: float | None = None):
    """q (B, Sq, KVH, G, dh); k, v (B, Sk, KVH, dh); positions (B, S*)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * sm_scale
    mask = attention_mask(qpos, kpos, causal, window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom.clamp_min(1e-30),
                       v.float())
    return out.to(q.dtype)


def check_inputs(q, k, v, qpos, kpos) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("want q (B,Sq,KVH,G,dh) and k, v (B,Sk,KVH,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, kvh, g, dh = q.shape
    if k.shape[0] != b or k.shape[2] != kvh or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if qpos.shape != (b, sq) or kpos.shape != (b, k.shape[1]):
        raise ValueError(f"positions must be (B,Sq), (B,Sk); got "
                         f"{tuple(qpos.shape)}, {tuple(kpos.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if dh not in _HEAD_DIMS[q.dtype]:
        hint = (": no model runs float32 on the card; use bfloat16"
                if q.dtype == torch.float32 and dh > 128 else "")
        raise ValueError(f"head dim {dh} unsupported for {q.dtype} (one of "
                         f"{_HEAD_DIMS[q.dtype]}){hint}")
    if not 1 <= g <= _MAX_GROUP:
        raise ValueError(f"GQA group {g} outside [1, {_MAX_GROUP}]")
    if k.shape[1] < 1:
        raise ValueError("no keys")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                           ("qpos", qpos, 4), ("kpos", kpos, 4)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


_tilings: dict[int, tuple[int, int, int]] = {}


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.flash_attention_tiling.argtypes = [i, ip, ip, ip]
        for dh in _HEAD_DIMS[torch.bfloat16]:
            t = [ctypes.c_int() for _ in range(3)]
            lib.flash_attention_tiling(dh, *(ctypes.byref(x) for x in t))
            _tilings[dh] = tuple(x.value for x in t)
    return lib


def tiling(head_dim: int) -> tuple[int, int, int]:
    """The bfloat16 body's tiling at ``head_dim``, as the CUDA source
    sets it: query rows (queries x G) per CTA, keys per K/V tile, and keys
    per chunk of the side pass over V.  Builds or loads the library."""
    _lib()
    return _tilings[head_dim]


def flash_attention(q, k, v, qpos, kpos, *, causal: bool, window: int = 0,
                    sm_scale: float | None = None):
    """Attention forward; shapes as ``flash_attention_plain``."""
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, qpos, kpos, causal=causal,
                                     window=window, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_inputs(q, k, v, qpos, kpos)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    if b == 0 or sq == 0:
        return out
    lib = _lib()
    live = vsum = None
    if q.dtype == torch.bfloat16:
        rows, keys, vsum_keys = _tilings[dh]
        with torch.profiler.record_function(LIVE_TILES_RANGE):
            live = live_tiles(qpos, kpos, causal=causal, window=window,
                              queries_per_cta=rows // g, keys_per_tile=keys)
        vsum = torch.empty(b, kvh, -(-sk // vsum_keys), dh,
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(),
            None if live is None else live.data_ptr(),
            None if vsum is None else vsum.data_ptr(), b, sq, sk, kvh, g,
            dh, int(causal), int(window),
            0 if live is None else live.shape[2], float(sm_scale),
            _DTYPES[q.dtype], stream)
    build.check_status(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
