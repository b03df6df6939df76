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
The CUDA kernel takes tables of per-rank pointers into those tensors.
What bounds it: bytes, (N + 1)·T·d elements read and as many written, on
the comm budget's 1 to 8 SMs (``core.splitting.ring_ctas``), so what sets
its time is the bytes each SM keeps in flight.  A row used to take a whole
CTA and two CTA-wide barriers: at d 512 (1 KB rows) per-row latency, not
bytes, set the time.  Now a row goes to a group of threads sized to the
row (``row_group``: 16 rows at once on a CTA at d 512 bf16, 1 at d 8192;
the group size is a power of two, a template parameter of the kernels),
each group reducing with warp shuffles and a named barrier of its own.
Two routes feed the groups, with the same arithmetic: ``register`` (the
next row's vectors in registers while a row is reduced and stored) and
``bulk`` (rows of a whole CTA only: one producer thread's
``cp.async.bulk`` column slices into a shared-memory ring with mbarriers,
the normed row written by bulk stores, so loads and stores keep flying
while the CTA reduces its one row); ``route`` takes the bulk route at
rows of a whole CTA, 8 ranks and at least 16 rows a CTA, where it was the
faster.  Rows the vector body cannot hold (``pipelined``) take a scalar
body that does one row at a time.  Every grid and route gives the same
bits (see the source note).

``ar_rmsnorm`` is the wrapper: on CPU and meta tensors it runs
``ar_rmsnorm_plain``; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_rmsnorm import fused_residual_rmsnorm_plain

MAX_RANKS = 8
MAX_CTAS = 8
MAX_ROWS = 2 ** 31 - 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024
# the row engine (csrc/ar_rmsnorm_row.cuh): a CTA's row groups hold at most
# CTA_THREADS threads, each owning at most VECTORS 16-byte vectors of a row
CTA_THREADS = 512
VECTORS = 2
_PIPE_VECTORS = CTA_THREADS * VECTORS
# the C entry point's routes; the vector body's two feed the same row engine
ROUTES = {"scalar": 0, "register": 1, "bulk": 2}
# The bulk route takes rows of a whole CTA only (``row_group``'s g =
# CTA_THREADS), and runs where both routes were timed in turns and it was
# the faster (scripts/k1_ab.py; PERF.md §6): rows of a whole CTA at
# BULK_RANKS ranks, with at least BULK_MIN_ROWS rows a CTA, so that its ring
# refills while rows are reduced.  At 2 and 4 ranks, and below that many
# rows a CTA (decode and verify sizes), the register route was as fast or
# faster.
BULK_RANKS = 8
BULK_MIN_ROWS = 16


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
    if t > MAX_ROWS:
        raise ValueError(f"T={t} exceeds the kernel's {MAX_ROWS} rows (int32 "
                         f"row indices)")
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
        if not (t_.is_contiguous() if t_.dim() == 1 else slabs_contiguous(t_)):
            raise ValueError(f"{name} must be contiguous within each rank")
        if t_.device != x.device:
            raise ValueError(f"{name} is on {t_.device}, x on {x.device}")
    if not pipelined(x, residual, weight) and d * 4 > _MAX_SMEM:
        raise ValueError(f"d={d} exceeds the scalar body's shared-memory "
                         f"row buffer ({_MAX_SMEM // 4} floats)")


def row_group(d: int, dtype) -> tuple:
    """The row-group rule of ``csrc/ar_rmsnorm_row.cuh``: for a row of d
    elements of ``dtype``, (16-byte vectors, threads of its group, groups
    of a CTA), or None where the row is not whole 16-byte vectors or is
    wider than the vector body (the scalar body takes it)."""
    size = torch.empty((), dtype=dtype).element_size()
    if (d * size) % 16 or d * size // 16 > _PIPE_VECTORS:
        return None
    nv = d * size // 16
    g = 32
    while g < CTA_THREADS and g * VECTORS < nv:
        g *= 2
    return nv, g, CTA_THREADS // g


def rows_per_cta(t: int, d: int, dtype, ctas: int) -> int:
    """The most rows a CTA of the vector body takes (its first): group q
    of CTA b walks rows b·R + q + k·grid·R, R groups a CTA
    (``row_group``), on a grid of ``ctas`` CTAs or fewer where the rows
    do not fill them."""
    per = row_group(d, dtype)[2]
    stride = min(ctas, -(-t // per)) * per
    return sum(-(-(t - q) // stride) for q in range(min(per, t)))


def route(d: int, dtype, n: int, t: int, ctas: int, vec: bool = True) -> str:
    """The route the wrapper takes: ``bulk`` for rows of a whole CTA at
    BULK_RANKS ranks with at least BULK_MIN_ROWS rows a CTA, else
    ``register`` for vector rows, else ``scalar``."""
    if not vec:
        return "scalar"
    group = row_group(d, dtype)
    if (group[1] == CTA_THREADS and n == BULK_RANKS
            and rows_per_cta(t, d, dtype, ctas) >= BULK_MIN_ROWS):
        return "bulk"
    return "register"


def _pick_route(route_name, d: int, dtype, n: int, t: int, ctas: int,
                vec: bool) -> str:
    """``route``'s choice, or the vector route ``route_name`` forces
    where the rows are vectors; the bulk route only for rows of a whole
    CTA."""
    if route_name is None or not vec:
        return route(d, dtype, n, t, ctas, vec)
    g = row_group(d, dtype)[1]
    if route_name == "bulk" and g != CTA_THREADS:
        raise ValueError(f"the bulk route takes rows of a whole CTA; d={d} "
                         f"{dtype} takes a group of {g} threads")
    return route_name


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
        for name in ("ar_rmsnorm_group_threads", "ar_rmsnorm_group_rows"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = i
    return lib


def slabs_contiguous(t: torch.Tensor) -> bool:
    """Whether each rank's slab ``t[k]`` of an (N, rows, d) tensor is
    contiguous: the kernel reads and writes a slab through one pointer
    with a row stride of d, so a view of some rows of every rank (one
    data shard's, ``core.fused_collectives``) is taken without a copy."""
    return t[0].is_contiguous() and (t.shape[0] == 1
                                     or t.stride(0) >= t[0].numel())


def _table(t: torch.Tensor) -> PtrTable:
    """Pointers to each rank's slab of an (N, ...) tensor whose slabs are
    contiguous."""
    step = t.stride(0) * t.element_size()
    base = t.data_ptr()
    tab = PtrTable()
    for k in range(t.shape[0]):
        tab.p[k] = base + k * step
    return tab


def ar_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
               ctas: int = MAX_CTAS):
    """(out (N, T, d), new_residual (N, T/N, d)) for x (N, T, d),
    residual (N, T/N, d) and weight (d,), on ``ctas`` CTAs (1 to 8).  x
    and residual may be views whose rank slabs are contiguous
    (``slabs_contiguous``); the outputs are new contiguous tensors."""
    if x.device.type in build.PLAIN_DEVICES:
        return ar_rmsnorm_plain(x, residual, weight, eps)
    return _launch(x, residual, weight, eps, ctas, None)


def _launch(x, residual, weight, eps: float, ctas: int, route_name):
    """Launch the kernel on CUDA tensors, on ``route_name``'s route or,
    for None, ``route``'s.  A forced vector route (``register`` or
    ``bulk``) gives the same bits; the bulk route takes rows of a whole CTA
    only.  chip_smoke.py and scripts/k1_ab.py time each route through it."""
    if route_name not in (None, "register", "bulk"):
        raise ValueError(f"route {route_name!r}: register or bulk")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_inputs(x, residual, weight)
    if not 1 <= ctas <= MAX_CTAS:
        raise ValueError(f"ctas={ctas} outside [1, {MAX_CTAS}]")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    new_res = torch.empty(residual.shape, dtype=x.dtype, device=x.device)
    n, t, d = x.shape
    if t == 0:
        return out, new_res
    route_name = _pick_route(route_name, d, x.dtype, n, t, ctas,
                             pipelined(x, residual, weight, out, new_res))
    tabs = [_table(a) for a in (x, residual, out, new_res)]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ar_rmsnorm(
            ctypes.byref(tabs[0]), ctypes.byref(tabs[1]), weight.data_ptr(),
            ctypes.byref(tabs[2]), ctypes.byref(tabs[3]), n, t, d,
            float(eps), _DTYPES[x.dtype], ROUTES[route_name], int(ctas),
            stream)
    build.check_status(lib, rc, "ar_rmsnorm")
    ar_rmsnorm.launches += 1
    return out, new_res


ar_rmsnorm.launches = 0
