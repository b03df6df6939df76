"""K3: flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention``
(``src/repro/kernels/flash_attention.py``), which prefill attention reaches
through ``multihead_attention(impl="pallas")``.  It is bound by operations
(4·B·Sq·Sk·Hq·dh FLOPs).  The CUDA kernel runs one CTA per (batch, KV head,
q tile) so one K/V tile in shared memory serves the whole GQA group, with
a running (m, l, acc) in fp32; bfloat16 inputs go through the tensor cores
(``mma.sync``), float32 inputs through plain FMA.  The source note names
the numerics traps.

``flash_attention`` is the wrapper: on CPU tensors it runs
``flash_attention_plain`` (the semantics of the model path's
``_attn_ref``); on CUDA tensors it launches the kernel or raises.

Masking follows the model path: finite ``NEG_INF``, so a query row with
no visible key gets the uniform average of V over all keys.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 64


def attention_mask(qpos, kpos, causal: bool, window: int):
    """(B, Sq, Sk) bool: key visible to query.  kpos < 0 marks padding;
    window <= 0 means full attention."""
    m = (kpos[:, None, :] >= 0)
    if causal:
        m = m & (qpos[:, :, None] >= kpos[:, None, :])
    if window > 0:
        m = m & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    return m


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
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} unsupported (one of {_HEAD_DIMS})")
    if not 1 <= g <= _MAX_GROUP:
        raise ValueError(f"GQA group {g} outside [1, {_MAX_GROUP}]")
    if k.shape[1] < 1:
        raise ValueError("no keys")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    for name, t, align in (("q", q, 4), ("k", k, 16), ("v", v, 16),
                           ("qpos", qpos, 4), ("kpos", kpos, 4)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return lib


def flash_attention(q, k, v, qpos, kpos, *, causal: bool, window: int = 0,
                    sm_scale: float | None = None):
    """Attention forward; shapes as ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, qpos, kpos, causal=causal,
                                     window=window, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_inputs(q, k, v, qpos, kpos)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    b, sq, kvh, g, dh = q.shape
    if b == 0 or sq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(), b, sq, k.shape[1], kvh, g, dh,
            int(causal), int(window), float(sm_scale), _DTYPES[q.dtype],
            stream)
    build.check_status(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
