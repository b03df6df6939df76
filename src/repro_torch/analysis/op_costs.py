"""Per-device costs of one call of the port, counted on
``torch.device("meta")``: the counterpart of ``repro.analysis.hlo``, which
reads them from XLA's per-device HLO text.

``measure(fn, *args, devices=, fold=, ride=)`` runs ``fn`` once on meta
tensors (shapes and dtypes, no storage, no kernel) and counts:

* collectives, as the reference's ``Collective`` records (its kinds and
  its ring wire formulas), from the port's own collective entry points:
  ``distributed/collectives.py`` (``psum``, ``psum_scatter``,
  ``all_gather``, ``gather_ranks``, ``pmax``, ``psum_dp``, ``pmax_dp``,
  on the rank axis and under process groups alike) and the callers'
  ``note`` (the ``ep2d`` all-to-alls).  Each is recorded per device:
  the group size is the rank axis's R (model) or D (data), and the bytes
  are one rank's result.  On the rank axis one call serves every rank
  and every data shard folded into the batch, so a model-axis result's
  bytes are divided by ``fold`` (the data shards in the batch) and a
  data-axis result's by ``ride`` (the model ranks its tensor carries).
  A collective's own tensor ops are not counted below;
* FLOPs per device: ``torch.utils.flop_counter``'s formulas (matmuls,
  batched matmuls, convolutions, attention) over the call's ops, divided
  by ``devices``, the ranks the call holds on its rank axes.  Attention
  is counted as the plain version computes it, every query against
  every key of its block, where the reference's ``model_flops`` halves
  causal attention;
* bytes accessed per device: the operand and result bytes of every op
  that is not a view, divided by ``devices``.  This differs from XLA's
  count by design: XLA fuses elementwise chains and counts a fusion's
  inputs and output once, while every eager op here reads its operands
  and writes its result.

Both counts come from one ``TorchDispatchMode`` (``_Counter``).

``ModuleCosts`` and ``collective_summary`` keep the reference's keys.
The rank axis walks the layers in Python, so nothing repeats under a
loop: ``num_collectives_static`` equals ``num_collectives_dynamic``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as COL

_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default}


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: float
    group_size: int
    multiplier: float = 1.0

    @property
    def wire_bytes(self) -> float:
        """Bytes one device sends, by the ring formulas of
        ``repro.analysis.hlo``."""
        n = max(self.group_size, 1)
        rb = self.result_bytes
        if self.kind == "all-reduce":
            per = 2 * (n - 1) / n * rb
        elif self.kind == "reduce-scatter":
            per = (n - 1) * rb
        elif self.kind == "all-gather":
            per = (n - 1) / n * rb
        elif self.kind == "all-to-all":
            per = (n - 1) / n * rb
        else:
            per = rb
        return per * self.multiplier


@dataclasses.dataclass
class ModuleCosts:
    flops: float
    bytes_accessed: float
    wire_bytes: float
    by_kind: Dict[str, float]
    num_collectives_static: int
    num_collectives_dynamic: float
    per_computation: Dict[str, Tuple[float, float]]
    collectives: List[Collective] = dataclasses.field(default_factory=list)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of t: its elements, but no more
    than its storage holds (an expanded view reads its base once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


class _Counter(TorchDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas for the matmul-like
    ops) and operand and result bytes (every op that is not a view or an
    allocation) of each op, outside collectives.

    On meta tensors an op's outputs follow from its inputs' metadata
    alone, so a pure op (no view, no mutation) seen before with equal
    metadata and arguments takes its recorded outputs' metadata and
    counts instead of running again: the layers repeat their ops, and a
    meta kernel costs far more host time than the lookup."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.paused = 0
        self._seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _signature(func, args, kwargs)
        hit = self._seen.get(key) if key is not None else None
        if hit is not None:
            metas, spec, flops, byts = hit
            out = tree_unflatten([
                torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                if isinstance(m, tuple) else m for m in metas], spec)
        else:
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            byts = (0 if func.is_view or func in _ALLOCATIONS else sum(
                _nbytes(t) for t in tree_flatten((args, kwargs, out))[0]
                if isinstance(t, torch.Tensor)))
            if key is not None:
                leaves, spec = tree_flatten(out)
                if all(not isinstance(t, torch.Tensor) or t.device.type
                       == "meta" for t in leaves):
                    self._seen[key] = ([
                        (tuple(t.shape), t.stride(), t.dtype)
                        if isinstance(t, torch.Tensor) else t
                        for t in leaves], spec, flops, byts)
        if not self.paused:
            self.flops += flops
            self.bytes += byts
        return out


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _signature(func, args, kwargs):
    """A hashable key of a pure op on meta tensors and its arguments, or
    None where the op may alias or mutate or a tensor is not on meta."""
    schema = func._schema
    if (func.is_view or schema.is_mutable
            or any(r.alias_info is not None for r in schema.returns)):
        return None
    key = [func]
    if not (_key_of(args, key) and _key_of(tuple(kwargs.items()), key)):
        return None
    return tuple(key)


def _key_of(items, key: list) -> bool:
    """Append the metadata of ``items`` (tensors, scalars, nested
    sequences) to ``key``; False where one cannot be keyed."""
    for leaf in items:
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != "meta":
                return False
            key.append((tuple(leaf.shape), leaf.stride(), leaf.dtype,
                        leaf.storage_offset()))
        elif isinstance(leaf, (list, tuple)):
            key.append(len(leaf))
            if not _key_of(leaf, key):
                return False
        elif isinstance(leaf, _SCALARS):
            key.append((type(leaf), leaf))
        else:
            return False
    return True


class _Recorder:
    """What ``distributed.collectives.recording`` reports to."""

    def __init__(self, counter: _Counter, fold: int, ride: int):
        self.counter = counter
        self.fold, self.ride = fold, ride
        self.collectives: List[Collective] = []

    @property
    def inside(self) -> bool:
        return self.counter.paused > 0

    @contextlib.contextmanager
    def collective(self):
        self.counter.paused += 1
        try:
            yield
        finally:
            self.counter.paused -= 1

    def add(self, kind: str, nbytes: float, group: int, axis) -> None:
        if axis == "model":
            nbytes /= self.fold
        elif axis == "data":
            nbytes /= self.ride
        self.collectives.append(Collective(kind, nbytes, group))

    def note(self, kind: str, device_bytes: float, group: int) -> None:
        """Record a collective that the caller itself knows of (one
        device's result bytes)."""
        self.add(kind, device_bytes, group, None)


@contextlib.contextmanager
def counting(*, devices: int = 1, fold: int = 1, ride: int = 1):
    """Count the ops run inside the block; yields a list that holds the
    ``ModuleCosts`` once the block ends, and the recorder (``note``)."""
    result: list = []
    with _Counter() as counter:
        rec = _Recorder(counter, fold, ride)
        with COL.recording(rec):
            yield result, rec
    result.append(summarize(counter.flops / devices, counter.bytes / devices,
                            rec.collectives))


def summarize(flops: float, bytes_accessed: float,
              collectives: List[Collective]) -> ModuleCosts:
    by_kind: Dict[str, float] = {}
    for c in collectives:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
    n = len(collectives)
    return ModuleCosts(flops=float(flops),
                       bytes_accessed=float(bytes_accessed),
                       wire_bytes=sum(by_kind.values()), by_kind=by_kind,
                       num_collectives_static=n, num_collectives_dynamic=n,
                       per_computation={"main": (float(flops),
                                                 float(bytes_accessed))},
                       collectives=list(collectives))


def measure(fn, *args, devices: int = 1, fold: int = 1, ride: int = 1,
            **kwargs):
    """(fn(*args, **kwargs), its ``ModuleCosts`` per device)."""
    with counting(devices=devices, fold=fold, ride=ride) as (res, _):
        out = fn(*args, **kwargs)
    return out, res[0]


def collective_summary(costs: ModuleCosts) -> Dict:
    return {
        "total_wire_bytes_per_device": costs.wire_bytes,
        "by_kind": costs.by_kind,
        "num_ops_static": costs.num_collectives_static,
        "num_ops_dynamic": costs.num_collectives_dynamic,
    }
