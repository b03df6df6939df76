"""K2: fused residual-add + RMSNorm (``csrc/fused_rmsnorm.cu``).

Replaces the Pallas TPU kernel ``_fused_rmsnorm_kernel`` /
``fused_residual_rmsnorm_pallas`` (``src/repro/kernels/fused_rmsnorm.py``).
It is bound by bytes: two reads and two writes of the (T, d) token slice.
The CUDA kernel runs one CTA per token row with 16-byte vector accesses and
keeps ``t = x + res`` on chip between the reduction and the scaling, so
each row crosses device memory exactly once each way (see the source
note).  A Triton kernel would serve as well — a fused elementwise pass plus
one row reduction is Triton's home ground — but CUDA C++ built with nvcc
shares one build route with K3 and needs no extra package.

``fused_residual_rmsnorm`` is the wrapper: on CPU and meta tensors it runs
``fused_residual_rmsnorm_plain``; on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024


def fused_residual_rmsnorm_plain(x, residual, weight, eps: float = 1e-6):
    """Plain PyTorch version (counterpart of
    ``repro.kernels.ref.fused_residual_rmsnorm_ref``)."""
    t = x.float() + residual.float()
    var = torch.mean(t * t, dim=-1, keepdim=True)
    out = t * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype), t.to(residual.dtype)


def check_inputs(x, residual, weight) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError(f"x and residual must be the same (T, d); got "
                         f"{tuple(x.shape)} and {tuple(residual.shape)}")
    if weight.shape != (x.shape[1],):
        raise ValueError(f"weight must be (d,) = ({x.shape[1]},); got "
                         f"{tuple(weight.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} unsupported (float32, bfloat16)")
    if residual.dtype != x.dtype or weight.dtype != x.dtype:
        raise TypeError("x, residual and weight must share one dtype")
    for name, t in (("x", x), ("residual", residual), ("weight", weight)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.shape[1] * 4 > _MAX_SMEM:
        raise ValueError(f"d={x.shape[1]} exceeds the kernel's shared-memory "
                         f"row buffer ({_MAX_SMEM // 4} floats)")


def _lib():
    lib = build.load("fused_rmsnorm")
    fn = lib.fused_residual_rmsnorm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return lib


def fused_residual_rmsnorm(x, residual, weight, *, eps: float = 1e-6):
    """(out, new_residual) for x, residual (T, d) and weight (d,)."""
    if x.device.type in build.PLAIN_DEVICES:
        return fused_residual_rmsnorm_plain(x, residual, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs(x, residual, weight)
    out = torch.empty_like(x)
    new_res = torch.empty_like(residual)
    rows, d = x.shape
    if rows == 0:
        return out, new_res
    elt = x.element_size()
    vec = (d * elt) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, residual, weight, out, new_res))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_residual_rmsnorm(
            x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            out.data_ptr(), new_res.data_ptr(), rows, d, float(eps),
            _DTYPES[x.dtype], int(vec), stream)
    build.check_status(lib, rc, "fused_residual_rmsnorm")
    fused_residual_rmsnorm.launches += 1
    return out, new_res


fused_residual_rmsnorm.launches = 0
