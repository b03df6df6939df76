"""Mesh factory, as ``repro.launch.mesh``.

A ``Mesh`` is only the axes' names and sizes that ``build_model`` and the
train steps take; making one touches no device.  The port lays a mesh out
two ways (``distributed/context.py``):

* every rank on one device: the ``model`` axis is the rank axis R
  (``build_model(..., tp=)``) and the data-parallel axes (``pod`` x
  ``data``, pod outer) fold into the data rank axis D
  (``build_model(..., ep=)``);
* one process per rank (``init_groups``): a ``(data, model)`` mesh of
  ``torch.distributed`` processes, world rank = data index · tp + model
  index (the device order of the reference's ``make_mesh``), with a
  group over each row (``model``) and each column (``data``); the
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
    """Join the process group of a ``(data, model)`` mesh as world rank
    ``rank`` and make its groups: ``dist.init_process_group``, then
    ``dist.new_group`` for every model group (one per data index) and
    every data group (one per model index), in that order in every
    process.  ``backend`` is the caller's: ``"gloo"`` for CPU tensors,
    ``"nccl"`` for CUDA ones; ``init_method`` a store, e.g.
    ``file://<dir>/store`` in a fresh temporary directory (a fixed path
    is shared by every run that names it) or ``tcp://localhost:<port>``."""
    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"name the backend: 'gloo' for CPU tensors, "
                         f"'nccl' for CUDA ones (got {backend!r})")
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"a (data, model) mesh, got {mesh.axis_names}")
    n_data, n_model = mesh.sizes
    if world_size != n_data * n_model:
        raise ValueError(f"world size {world_size} against a "
                         f"{n_data} x {n_model} mesh")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    d, m = divmod(rank, n_model)
    model = [dist.new_group([i * n_model + j for j in range(n_model)])
             for i in range(n_data)]
    data = [dist.new_group([i * n_model + j for i in range(n_data)])
            for j in range(n_model)]
    return Groups(model=model[d], data=data[m], model_rank=m, data_rank=d,
                  model_size=n_model, data_size=n_data)
