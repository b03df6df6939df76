"""Peer-mapped buffers for K1's cross-rank form
(``kernels/ar_rmsnorm_peer.py``): the counterpart of the Pallas ring
kernel's ``comm_hbm`` buffer and its semaphores
(``src/repro/kernels/ring_ar_rmsnorm.py``).

A ``PeerWorkspace`` is one rank's view of a model group's buffers: its own
allocation (flags and the call epoch the kernel advances, N receive slots,
a ``gathered`` chunk, two publish blocks for the one-wait path;
``ar_rmsnorm_peer.workspace_bytes``), every peer's mapped into this
process, and the kernel's pointer tables.  It is sized for the largest forward a run makes at the model's
width and dtype: the scheduler's (``SchedulerConfig.max_forward_tokens``)
under the engine, ``direct_rows``' for direct ``ModelApi.prefill`` /
``decode_step`` calls (the hybrid's chunks, an encoder's frames).  A
forward larger than the workspace raises; nothing falls back.

``PeerWorkspace.create`` is collective over the model group (on a
(data, model) mesh each data shard's model group has buffers of its own,
and ``close`` waits for that group alone): each rank allocates its
buffer, the ranks exchange CUDA IPC handles with
``all_gather_object`` (gloo or NCCL both carry Python objects) and open
each other's (a rank uses its own buffer's local pointer: CUDA refuses to
open a process's own handle).  ``PeerWorkspace.local`` makes N ranks' in
one process, with plain pointers, for N launches on N streams.  ``close``
releases a workspace, collectively when it spans processes; ``attach``
puts one on a ``Groups`` (``Groups.peer``), where ``comm_norm`` finds it.
Create it once per model group before the first forward, never inside a
timed step.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.distributed.context import Groups
from repro_torch.kernels import ar_rmsnorm_peer as K
from repro_torch.kernels import build


def _alloc(lib, device: torch.device, nbytes: int) -> int:
    ptr = ctypes.c_void_p()
    rc = lib.peer_alloc(device.index, nbytes, ctypes.byref(ptr))
    build.check_status(lib, rc, "peer_alloc")
    return ptr.value


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a peer workspace lives on a CUDA device, not "
                         f"{device}")
    return torch.device("cuda", torch.cuda.current_device()
                        if device.index is None else device.index)


class PeerWorkspace:
    """One rank's view of a model group's peer-mapped buffers."""

    def __init__(self, *, rank: int, bases, rows: int, slot: int, pub: tuple,
                 device: torch.device, own: int, opened=(), group=None):
        self.rank, self.n = rank, len(bases)
        self.rows, self.slot_bytes = rows, slot
        self.pub_bytes, self.pub_res = pub
        self.device = device
        self.tables = K.tables(bases, rank, slot, *pub)
        self._own, self._opened, self._group = own, list(opened), group
        self.closed = False

    @classmethod
    def create(cls, groups: Groups, *, rows: int, d: int, dtype,
               device) -> "PeerWorkspace":
        """This rank's workspace over ``groups.model``, for forwards of up
        to ``rows`` tokens of width ``d`` in ``dtype``: collective."""
        import torch.distributed as dist

        device = _device(device)
        n, rank = groups.model_size, groups.model_rank
        slot = K.slot_bytes(rows, d, dtype, n)
        pub = K.pub_bytes(rows, d, dtype, n)
        lib = K._lib()
        own = _alloc(lib, device, K.workspace_bytes(n, slot, pub[0]))
        handle = ctypes.create_string_buffer(K.HANDLE_BYTES)
        build.check_status(lib, lib.peer_get_handle(own, handle),
                           "peer_get_handle")
        mine = (bytes(handle.raw), slot)
        every = [None] * n
        dist.all_gather_object(every, mine, group=groups.model)
        bases, opened = [], []
        for p, (raw, their_slot) in enumerate(every):
            if their_slot != slot:
                raise ValueError(f"rank {p} sized its slots {their_slot} "
                                 f"bytes, rank {rank} {slot}")
            if p == rank:
                bases.append(own)
                continue
            ptr = ctypes.c_void_p()
            rc = lib.peer_open_handle(device.index, raw, ctypes.byref(ptr))
            build.check_status(lib, rc, f"peer_open_handle (rank {p})")
            bases.append(ptr.value)
            opened.append(ptr.value)
        return cls(rank=rank, bases=bases, rows=rows, slot=slot, pub=pub,
                   device=device, own=own, opened=opened,
                   group=groups.model)

    @classmethod
    def local(cls, n: int, *, rows: int, d: int, dtype,
              device) -> list:
        """N ranks' workspaces in this process (plain pointers), for the
        N ranks' launches on N streams."""
        device = _device(device)
        slot = K.slot_bytes(rows, d, dtype, n)
        pub = K.pub_bytes(rows, d, dtype, n)
        lib = K._lib()
        owns = [_alloc(lib, device, K.workspace_bytes(n, slot, pub[0]))
                for _ in range(n)]
        return [cls(rank=r, bases=owns, rows=rows, slot=slot, pub=pub,
                    device=device, own=owns[r]) for r in range(n)]

    def close(self) -> None:
        """Wait for the card, unmap the peers' buffers and free this
        rank's; over a group, every rank calls it (a barrier keeps a
        buffer alive until no peer has it mapped)."""
        if self.closed:
            return
        import torch.distributed as dist

        lib = K._lib()
        torch.cuda.synchronize(self.device)
        for ptr in self._opened:
            build.check_status(lib, lib.peer_close_handle(
                self.device.index, ptr), "peer_close_handle")
        if self._group is not None:
            dist.barrier(group=self._group)
        build.check_status(lib, lib.peer_free(self.device.index, self._own),
                           "peer_free")
        self.closed = True


def attach(groups: Groups, *, rows: int, d: int, dtype, device) -> Groups:
    """``groups`` with a new workspace over its model group
    (``PeerWorkspace.create``; collective), for ``build_model(...,
    groups=)`` in comm mode ``ring`` on CUDA."""
    return dataclasses.replace(groups, peer=PeerWorkspace.create(
        groups, rows=rows, d=d, dtype=dtype, device=device))


def direct_rows(cfg, *, batch: int, chunk: int, dp: int = 1) -> int:
    """The most token rows one forward of a run of direct ``ModelApi``
    calls gives an add+norm slot: a prefill chunk's ``batch`` x ``chunk``
    (an image's patch rows counted in ``chunk``), a decode step's
    ``batch``, and for the encdec family the encoder's ``batch`` x
    ``max_source_positions`` frames: the ``rows`` of ``attach`` for a run
    with no ``SchedulerConfig``.  With the batch over ``dp`` data shards
    a process's forwards hold one shard's ``batch`` / ``dp`` rows, in
    every family (the ssm's, the hybrid's and encdec's slots too; Whisper's
    encoder over the shard's rows' frames)."""
    if batch % dp:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{dp} data shards")
    batch //= dp
    rows = batch * max(chunk, 1)
    if cfg.family == "encdec":
        rows = max(rows, batch * cfg.max_source_positions)
    return rows
