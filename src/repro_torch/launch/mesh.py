"""Mesh factory, as ``repro.launch.mesh``.

A ``Mesh`` is only the axes' names and sizes that ``build_model`` and the
train steps take; making one touches no device.  The port lays a mesh out
two ways (``distributed/context.py``):

* every rank on one device: the ``model`` axis is the rank axis R
  (``build_model(..., tp=)``) and the data-parallel axes (``pod`` x
  ``data``, pod outer) fold into the data rank axis D
  (``build_model(..., ep=)``);
* one process per rank (``init_groups``): a ``(data, model)`` or
  ``(pod, data, model)`` mesh of ``torch.distributed`` processes, world
  rank = (pod index · data size + data index) · tp + model index (the
  device order of the reference's ``make_mesh``), with a group over each
  model row (``model``), each data column (``data``), each pod column
  (``pod``) and the data-parallel axes together (``dp``, pod outer); the
  groups go to ``build_model(..., groups=)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.distributed.context import Groups


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str) -> int:
        """An axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def dp_size(self, dp_axes) -> int:
        """The data rank axis D: the product of the data-parallel axes."""
        return math.prod(self.size(a) for a in dp_axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def init_groups(mesh: Mesh, *, backend: str, init_method: str, rank: int,
                world_size: int) -> Groups:
    """Join the process group of a ``(data, model)`` or ``(pod, data,
    model)`` mesh as world rank ``rank`` and make its groups:
    ``dist.init_process_group``, then ``dist.new_group`` for every model
    group (one per (pod, data) index), every data group (one per (pod,
    model) index), every pod group (one per (data, model) index; a group
    of one on a (data, model) mesh) and, on a pod mesh, every
    data-parallel group (pod x data, pod outer; one per model index), in
    that order in every process.  On a (data, model) mesh the
    data-parallel group is the data group.  World rank = (pod index ·
    data size + data index) · model size + model index, the device order
    of the reference's ``make_mesh``.  ``backend`` is the caller's:
    ``"gloo"`` for CPU tensors, ``"nccl"`` for CUDA ones; ``init_method``
    a store, e.g. ``file://<dir>/store`` in a fresh temporary directory (a
    fixed path is shared by every run that names it) or
    ``tcp://localhost:<port>``."""
    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"name the backend: 'gloo' for CPU tensors, "
                         f"'nccl' for CUDA ones (got {backend!r})")
    axes = tuple(mesh.axis_names)
    if axes not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a (data, model) or (pod, data, model) mesh, got "
                         f"{mesh.axis_names}")
    n_pod, n_data, n_model = (1,) * (3 - len(axes)) + tuple(mesh.sizes)
    if world_size != n_pod * n_data * n_model:
        raise ValueError(f"world size {world_size} against a "
                         f"{' x '.join(map(str, mesh.sizes))} mesh")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)

    def world_rank(p, d, m):
        return (p * n_data + d) * n_model + m
    pd, m = divmod(rank, n_model)
    p, d = divmod(pd, n_data)
    model = [dist.new_group([world_rank(i, j, k) for k in range(n_model)])
             for i in range(n_pod) for j in range(n_data)]
    data = [dist.new_group([world_rank(i, j, k) for j in range(n_data)])
            for i in range(n_pod) for k in range(n_model)]
    pod = [dist.new_group([world_rank(i, j, k) for i in range(n_pod)])
           for j in range(n_data) for k in range(n_model)]
    dp = data[p * n_model + m] if n_pod == 1 else [
        dist.new_group([world_rank(i, j, k) for i in range(n_pod)
                        for j in range(n_data)])
        for k in range(n_model)][m]
    return Groups(model=model[pd], data=data[p * n_model + m],
                  pod=pod[d * n_model + m], dp=dp, model_rank=m, data_rank=d, pod_rank=p,
                  model_size=n_model, data_size=n_data, pod_size=n_pod)
