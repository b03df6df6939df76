"""K1 across ranks: AllReduce + residual-add + RMSNorm in one launch per
rank over peer-mapped buffers (``csrc/ar_rmsnorm_peer.cu``), the paper's
fused AllReduce-RMSNorm with one rank per GPU.

Replaces the remote part of the Pallas TPU kernel ``_kernel`` /
``ring_fused_ar_rmsnorm`` (``src/repro/kernels/ring_ar_rmsnorm.py``): its
remote DMAs and semaphore signals.  ``comm_norm(mode="ring")`` reaches it
under the ``process_group`` backend; the one-card form
(``kernels/ar_rmsnorm.py``) keeps the rank axis.  Semantics:
``repro.kernels.ref.ring_ar_rmsnorm_ref``, one rank's share of it: this
rank's partial x ``(1, T, d)`` and residual chunk ``(1, T/N, d)`` in,
the full normed ``(1, T, d)`` and the new residual chunk out.  The
kernel's bits equal the one-card K1's on the same inputs, on any grid.

The kernel reaches its peers only through a ``distributed.peer.
PeerWorkspace``: per rank a flag block (with the call epoch), N receive
slots, a ``gathered`` chunk and two publish blocks, mapped into every
peer.  ``tables`` turns the workspace's base addresses into the kernel's
pointer tables (host layout, testable without a card).  Two paths, with
the one-card K1's row engine and bits: three phases (push reduce-scatter,
add+norm of the owned chunk, pull all-gather; two flag waits), and for a
small T (``small_t``: decode and verify) one wait, after which every rank
computes every row from the rows its peers published into the publish
block of the call's parity.  The kernel reads and advances the epoch in
device memory, so a call can be captured into a CUDA graph and replayed
(see the source note for why the waits suffice and what bounds the
kernel).

``ar_rmsnorm_peer`` is the wrapper: on CPU and meta tensors it runs
``ar_rmsnorm_peer_plain`` over the context's process group; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.distributed import collectives as C
from repro_torch.kernels import build
from repro_torch.kernels.ar_rmsnorm import MAX_CTAS, MAX_RANKS, pipelined
from repro_torch.kernels.autograd import needs_grad
from repro_torch.kernels.fused_rmsnorm import fused_residual_rmsnorm_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024
# a rank's workspace: the flags, then N receive slots, then `gathered`,
# then the two publish blocks (parity 0, 1); in the flag block arrive is
# (MAX_CTAS, MAX_RANKS) uint64, ready, pub and epoch (MAX_CTAS,) each
ARRIVE_OFFSET = 0
READY_OFFSET = MAX_CTAS * MAX_RANKS * 8
PUB_FLAG_OFFSET = 1024
EPOCH_OFFSET = 2048
FLAG_BYTES = 4096
SLOT_ALIGN = 256
HANDLE_BYTES = 64                  # sizeof(cudaIpcMemHandle_t)

_ptrs = ctypes.c_void_p * MAX_RANKS


class PeerTables(ctypes.Structure):
    """``struct PeerTables`` of the CUDA source.  This rank's own entries
    of ``push``, ``recv`` and ``arrive_out`` are null: never read."""
    _fields_ = [("push", _ptrs), ("recv", _ptrs), ("gathered", _ptrs),
                ("arrive_out", _ptrs), ("ready", _ptrs), ("pub", _ptrs),
                ("pub_flag", _ptrs),
                ("arrive_in", ctypes.c_void_p),
                ("gathered_own", ctypes.c_void_p),
                ("ready_own", ctypes.c_void_p),
                ("epoch", ctypes.c_void_p),
                ("pub_stride", ctypes.c_ulonglong),
                ("pub_res", ctypes.c_ulonglong)]


def _aligned(nbytes: int) -> int:
    return -(-nbytes // SLOT_ALIGN) * SLOT_ALIGN


def small_t(t: int, n: int, ctas: int) -> bool:
    """Whether a call takes the one-wait path: fewer rows a rank (T/N)
    than CTAs, as a decode or verify step has."""
    return t // n < ctas


def small_rows(rows: int, n: int) -> int:
    """The most rows a one-wait call of a workspace for ``rows`` takes:
    T/N below MAX_CTAS, and no more than the workspace's forwards."""
    return min(rows // n, MAX_CTAS - 1) * n


def slot_bytes(rows: int, d: int, dtype: torch.dtype, n: int) -> int:
    """One receive slot (and ``gathered``): a chunk of the largest forward,
    ``rows // n`` rows of d elements, rounded up to SLOT_ALIGN bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    return _aligned((rows // n) * d * size)


def pub_bytes(rows: int, d: int, dtype: torch.dtype, n: int) -> tuple:
    """One publish block of the one-wait path, for a workspace of
    ``rows``: (its bytes, the residual's offset in it).  It holds a rank's
    partial of ``small_rows`` rows, then its residual chunk of those, each
    rounded up to SLOT_ALIGN bytes; a workspace has two, one per parity
    of the call epoch."""
    size = torch.empty((), dtype=dtype).element_size()
    t = small_rows(rows, n)
    x_bytes = _aligned(t * d * size)
    return x_bytes + _aligned((t // n) * d * size), x_bytes


def workspace_bytes(n: int, slot: int, pub: int) -> int:
    """A rank's workspace: the flags, N receive slots, ``gathered`` and
    the two publish blocks of ``pub`` bytes."""
    return FLAG_BYTES + (n + 1) * slot + 2 * pub


def tables(bases, rank: int, slot: int, pub: int,
           pub_res: int) -> PeerTables:
    """The kernel's pointer tables for ``rank`` from every rank's
    workspace base address (``bases[p]``; this rank's own is its local
    pointer): rank r pushes chunk c into peer c's slot r and raises
    arrive[b][r] there, reads its own slots and arrive flags, and pulls
    every rank's ``gathered`` after its ready[b]; in a one-wait call it
    publishes into its own publish block, raises its pub[b] and reads
    every rank's publish block after that rank's pub[b]."""
    n = len(bases)
    if not 1 <= n <= MAX_RANKS or not 0 <= rank < n:
        raise ValueError(f"rank {rank} of {n}; the kernel takes 1 to "
                         f"{MAX_RANKS} ranks")
    tab = PeerTables()
    for p, base in enumerate(bases):
        tab.gathered[p] = base + FLAG_BYTES + n * slot
        tab.ready[p] = base + READY_OFFSET
        tab.pub[p] = base + FLAG_BYTES + (n + 1) * slot
        tab.pub_flag[p] = base + PUB_FLAG_OFFSET
        if p != rank:
            tab.push[p] = base + FLAG_BYTES + rank * slot
            tab.recv[p] = bases[rank] + FLAG_BYTES + p * slot
            tab.arrive_out[p] = base + ARRIVE_OFFSET + rank * 8
    tab.arrive_in = bases[rank] + ARRIVE_OFFSET
    tab.gathered_own = tab.gathered[rank]
    tab.ready_own = tab.ready[rank]
    tab.epoch = bases[rank] + EPOCH_OFFSET
    tab.pub_stride, tab.pub_res = pub, pub_res
    return tab


def ar_rmsnorm_peer_plain(x, residual, weight, ctx, eps: float = 1e-6):
    """Plain PyTorch version over the context's model group: x (1, T, d)
    this rank's partial, residual (1, T/N, d) its chunk.  ``psum_scatter``
    on a float32 wire (the kernel's sum), the add+norm on the owned rows,
    ``all_gather``.  Returns (out (1, T, d), new residual (1, T/N, d))."""
    local = C.psum_scatter(x, dataclasses.replace(ctx, bf16_wire=False))
    out, new_res = fused_residual_rmsnorm_plain(local[0], residual[0],
                                                weight, eps)
    return C.all_gather(out[None], ctx), new_res[None]


def check_inputs(x, residual, weight, workspace, ctas: int,
                 ranks=None) -> None:
    """Raise on anything the CUDA kernel does not take; ``ranks`` is the
    caller's group size, which must be the workspace's."""
    if workspace is None:
        raise ValueError("no peer workspace: create one per model group "
                         "before the first forward (distributed.peer."
                         "attach)")
    n = workspace.n
    if ranks is not None and ranks != n:
        raise ValueError(f"{ranks} ranks against a workspace of {n}")
    if x.dim() != 3 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, T, d), this rank's; got "
                         f"{tuple(x.shape)}")
    _, t, d = x.shape
    if t % n:
        raise ValueError(f"T={t} is not a multiple of N={n}")
    if residual.shape != (1, t // n, d):
        raise ValueError(f"residual must be (1, T/N, d) = "
                         f"{(1, t // n, d)}; got {tuple(residual.shape)}")
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
        if t_.device != workspace.device:
            raise ValueError(f"{name} is on {t_.device}, the workspace on "
                             f"{workspace.device}")
    need = (t // n) * d * x.element_size()
    if need > workspace.slot_bytes:
        raise ValueError(f"T={t} x d={d} needs {need} bytes a chunk; the "
                         f"workspace holds {workspace.slot_bytes} (T up to "
                         f"{workspace.rows})")
    if not 1 <= ctas <= MAX_CTAS:
        raise ValueError(f"ctas={ctas} outside [1, {MAX_CTAS}]")
    if small_t(t, n, ctas) and (
            t * d * x.element_size() > workspace.pub_res
            or need > workspace.pub_bytes - workspace.pub_res):
        raise ValueError(f"T={t} x d={d} takes the one-wait path; the "
                         f"workspace's publish blocks hold "
                         f"{workspace.pub_res} bytes of x (T up to "
                         f"{small_rows(workspace.rows, n)})")
    if not pipelined(x, residual, weight) and d * 4 > _MAX_SMEM:
        raise ValueError(f"d={d} exceeds the scalar body's shared-memory "
                         f"row buffer ({_MAX_SMEM // 4} floats)")


def _lib():
    lib = build.load("ar_rmsnorm_peer")
    fn = lib.ar_rmsnorm_peer
    if fn.argtypes is None:
        lib.ar_rmsnorm_peer_table_bytes.restype = ctypes.c_int
        lib.peer_handle_bytes.restype = ctypes.c_int
        have = (lib.ar_rmsnorm_peer_table_bytes(), lib.peer_handle_bytes())
        want = (ctypes.sizeof(PeerTables), HANDLE_BYTES)
        if have != want:
            raise RuntimeError(f"tables and handle are {have} bytes in the "
                               f"CUDA source, {want} here")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.peer_alloc.argtypes = [i, ctypes.c_ulonglong,
                                   ctypes.POINTER(p)]
        lib.peer_free.argtypes = [i, p]
        lib.peer_get_handle.argtypes = [p, p]
        lib.peer_open_handle.argtypes = [i, p, ctypes.POINTER(p)]
        lib.peer_close_handle.argtypes = [i, p]
        for name in ("peer_alloc", "peer_free", "peer_get_handle",
                     "peer_open_handle", "peer_close_handle"):
            getattr(lib, name).restype = i
        fn.argtypes = [ctypes.POINTER(PeerTables), p, p, p, p, p, i, i, i, i,
                       ctypes.c_float, i, i, i, i, p]
        fn.restype = i
    return lib


def ar_rmsnorm_peer(x, residual, weight, ctx=None, *, eps: float = 1e-6,
                    ctas: int = MAX_CTAS, workspace=None):
    """(out (1, T, d), new residual (1, T/N, d)) for this rank's x (1, T,
    d), residual (1, T/N, d) and weight (d,).  On the CPU the plain
    version over ``ctx``'s process group; on CUDA the kernel on ``ctas``
    CTAs (1 to 8, the same on every rank) over ``workspace`` (default:
    ``ctx.groups.peer``).  Every rank must make the same calls in the same
    order; a call may be captured into a CUDA graph (the kernel draws its
    epoch from the workspace on the card)."""
    if needs_grad(x, residual, weight):
        raise RuntimeError(
            "kernel K1 (comm mode 'ring') has no backward: train with comm "
            "mode vanilla, reordered, fused or nocomm")
    if x.device.type in build.PLAIN_DEVICES:
        return ar_rmsnorm_peer_plain(x, residual, weight, ctx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if workspace is None and ctx is not None and ctx.groups is not None:
        workspace = ctx.groups.peer
    check_inputs(x, residual, weight, workspace, ctas,
                 None if ctx is None else ctx.tp)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    new_res = torch.empty(residual.shape, dtype=x.dtype, device=x.device)
    _, t, d = x.shape
    if t == 0:
        return out, new_res
    vec = pipelined(x, residual, weight, out, new_res)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ar_rmsnorm_peer(
            ctypes.byref(workspace.tables), x.data_ptr(), residual.data_ptr(),
            weight.data_ptr(), out.data_ptr(), new_res.data_ptr(),
            workspace.n, workspace.rank, t, d, float(eps), _DTYPES[x.dtype],
            int(vec), int(small_t(t, workspace.n, ctas)), int(ctas), stream)
    build.check_status(lib, rc, "ar_rmsnorm_peer")
    ar_rmsnorm_peer.launches += 1
    return out, new_res


ar_rmsnorm_peer.launches = 0
