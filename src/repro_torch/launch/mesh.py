"""Mesh factory, as ``repro.launch.mesh``.

The port holds every rank of a mesh on one device: the ``model`` axis is
the rank axis R (``build_model(..., tp=)``) and the data-parallel axes
(``pod`` x ``data``, pod outer) fold into the data rank axis D
(``build_model(..., ep=)``; ``distributed/context.py``).  A ``Mesh`` is
only the axes' names and sizes that ``build_model`` and the train steps
take; making one touches no device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


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
