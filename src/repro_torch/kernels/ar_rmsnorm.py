"""K1: AllReduce + residual-add + RMSNorm in one kernel
(``csrc/ar_rmsnorm.cu``), the paper's fused AllReduce-RMSNorm.

Replaces the Pallas TPU kernel ``_kernel`` / ``ring_fused_ar_rmsnorm``
(``src/repro/kernels/ring_ar_rmsnorm.py``), which ``comm_norm(mode="ring")``
reaches at tp>1.  Its semantics are ``repro.kernels.ref.ring_ar_rmsnorm_ref``:
sum the N ranks' partials in fp32 (rank 0 first), round to x's dtype as
``psum_scatter``'s output is, add each rank's residual slice and apply the
norm on the chunk that rank owns, then give every rank the full result.

The N ranks sit on a leading rank axis of one device
(``distributed/context.py``): x ``(N, T, d)``, residual ``(N, T/N, d)``.
The CUDA kernel takes tables of per-rank pointers into those tensors, so
the same body takes peer-mapped pointers when the ranks are separate cards.
It is bound by bytes, (N + 1)·T·d elements read and as many written; its
grid is the comm budget's CTA count, 1 to 8 SMs (``core.splitting.ring_ctas``),
so alone on the card it stays well above that bound: what a few SMs move is
set by the bytes each keeps in flight.  The pipelined body therefore keeps
the next row's loads in flight (in registers) while the current row is
reduced and stored; rows it cannot hold (``pipelined``) take a scalar body
that does one row at a time.  Every grid gives the same bits (see the
source note).

``ar_rmsnorm`` is the wrapper: on CPU tensors it runs ``ar_rmsnorm_plain``;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_rmsnorm import fused_residual_rmsnorm_plain

MAX_RANKS = 8
MAX_CTAS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024
# the pipelined body (csrc/ar_rmsnorm.cu): 512 threads, each holding at most
# 2 16-byte vectors of a row (and the next row's N + 1) in registers
_PIPE_VECTORS = 512 * 2


class PtrTable(ctypes.Structure):
    """``struct PtrTable`` of the CUDA source: MAX_RANKS device pointers."""
    _fields_ = [("p", ctypes.c_void_p * MAX_RANKS)]


def _chunk_owner(rank: int, n: int) -> int:
    """The chunk rank ``rank`` norms: rows ``[r·C, (r+1)·C)`` with r the
    result, as ``psum_scatter(tiled=True)`` gives them (the reference's
    ``kernels/ref._chunk_owner``)."""
    return rank % n


def rank_sum(x):
    """The AllReduce of (N, ...) partials: their sum in fp32, rank 0 first,
    rounded to x's dtype (the order of the reference's oracle and of the
    kernel)."""
    if x.shape[0] == 1:
        return x[0]
    acc = x[0].float()
    for k in range(1, x.shape[0]):
        acc = acc + x[k].float()
    return acc.to(x.dtype)


def ar_rmsnorm_plain(x, residual, weight, eps: float = 1e-6):
    """Plain PyTorch version.  x (N, T, d) partial sums, residual (N, T/N, d),
    weight (d,).  Returns (out (N, T, d), one full copy per rank, and the
    new residual (N, T/N, d))."""
    n, t, d = x.shape
    c = t // n
    total = rank_sum(x)
    outs, new_res = [None] * n, []
    for i in range(n):
        own = _chunk_owner(i, n)
        out, res = fused_residual_rmsnorm_plain(
            total[own * c:(own + 1) * c], residual[i], weight, eps)
        outs[own] = out
        new_res.append(res)
    full = torch.cat(outs, dim=0)
    return full.expand(n, t, d).contiguous(), torch.stack(new_res)


def check_inputs(x, residual, weight) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be (N, T, d); got {tuple(x.shape)}")
    n, t, d = x.shape
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{n} ranks; the kernel takes 1 to {MAX_RANKS}")
    if t % n:
        raise ValueError(f"T={t} is not a multiple of N={n}")
    if residual.shape != (n, t // n, d):
        raise ValueError(f"residual must be (N, T/N, d) = {(n, t // n, d)}; "
                         f"got {tuple(residual.shape)}")
    if weight.shape != (d,):
        raise ValueError(f"weight must be (d,) = ({d},); got "
                         f"{tuple(weight.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} unsupported (float32, bfloat16)")
    if residual.dtype != x.dtype or weight.dtype != x.dtype:
        raise TypeError("x, residual and weight must share one dtype")
    for name, t_ in (("x", x), ("residual", residual), ("weight", weight)):
        if not t_.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t_.device != x.device:
            raise ValueError(f"{name} is on {t_.device}, x on {x.device}")
    if not pipelined(x, residual, weight) and d * 4 > _MAX_SMEM:
        raise ValueError(f"d={d} exceeds the scalar body's shared-memory "
                         f"row buffer ({_MAX_SMEM // 4} floats)")


def pipelined(*tensors) -> bool:
    """Whether the pipelined body takes these rows: each row a whole number
    of 16-byte vectors, at most ``_PIPE_VECTORS`` of them, and every pointer
    16-byte aligned.  The scalar body (one row at a time) takes the rest."""
    row_bytes = tensors[0].shape[-1] * tensors[0].element_size()
    return (row_bytes % 16 == 0 and row_bytes // 16 <= _PIPE_VECTORS
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _lib():
    lib = build.load("ar_rmsnorm")
    fn = lib.ar_rmsnorm
    if fn.argtypes is None:
        lib.ar_rmsnorm_table_bytes.restype = ctypes.c_int
        have = lib.ar_rmsnorm_table_bytes()
        if have != ctypes.sizeof(PtrTable):
            raise RuntimeError(f"pointer table is {have} bytes in the CUDA "
                               f"source, {ctypes.sizeof(PtrTable)} here")
        p, i, tab = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(PtrTable)
        fn.argtypes = [tab, tab, p, tab, tab, i, i, i, ctypes.c_float, i, i,
                       i, p]
        fn.restype = i
    return lib


def _table(t: torch.Tensor) -> PtrTable:
    """Pointers to each rank's slab of a contiguous (N, ...) tensor."""
    step = t[0].numel() * t.element_size()
    base = t.data_ptr()
    tab = PtrTable()
    for k in range(t.shape[0]):
        tab.p[k] = base + k * step
    return tab


def ar_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
               ctas: int = MAX_CTAS):
    """(out (N, T, d), new_residual (N, T/N, d)) for x (N, T, d),
    residual (N, T/N, d) and weight (d,), on ``ctas`` CTAs (1 to 8)."""
    if x.device.type == "cpu":
        return ar_rmsnorm_plain(x, residual, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs(x, residual, weight)
    if not 1 <= ctas <= MAX_CTAS:
        raise ValueError(f"ctas={ctas} outside [1, {MAX_CTAS}]")
    out = torch.empty_like(x)
    new_res = torch.empty_like(residual)
    n, t, d = x.shape
    if t == 0:
        return out, new_res
    vec = pipelined(x, residual, weight, out, new_res)
    tabs = [_table(a) for a in (x, residual, out, new_res)]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ar_rmsnorm(
            ctypes.byref(tabs[0]), ctypes.byref(tabs[1]), weight.data_ptr(),
            ctypes.byref(tabs[2]), ctypes.byref(tabs[3]), n, t, d,
            float(eps), _DTYPES[x.dtype], int(vec), int(ctas), stream)
    build.check_status(lib, rc, "ar_rmsnorm")
    ar_rmsnorm.launches += 1
    return out, new_res


ar_rmsnorm.launches = 0
