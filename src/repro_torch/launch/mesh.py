"""Meshes (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a frozen description -- axis names and sizes -- that
the sharding rules and the step bundles read; building one touches no
device and starts no process. The production meshes (256 and 512
devices) exist only as descriptions, for specs and per-device shapes.
:func:`device_mesh` turns a description into a live
``torch.distributed`` ``DeviceMesh`` over the default process group, and
:func:`axis_group` gives the process group of one or more of its axes.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence, Tuple

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh", "device_mesh",
           "axis_group"]


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` and ``axis_sizes``, outermost first; ``shape`` is
    the {name: size} mapping (jax's ``Mesh.shape``), ``size`` the product."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """A 1-D "data" mesh over the default process group's ranks (1
    without a group)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return Mesh(("data",), (n,))


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The live ``DeviceMesh`` of ``mesh`` over the default process group,
    ranks laid out row-major. Raises unless a group of exactly
    ``mesh.size`` ranks is initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 0
    if world != mesh.size:
        raise RuntimeError(f"mesh {dict(mesh.shape)} needs a process group "
                           f"of {mesh.size} ranks; the default group has "
                           f"{world or 'none'}")
    # made on the host, outside the fake tensors of a dry run's trace
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return init_device_mesh(device_type, mesh.axis_sizes,
                                mesh_dim_names=mesh.axis_names)


def axis_group(dmesh, axes: Sequence[str]):
    """The process group of ``axes`` of a live ``DeviceMesh`` (their
    product for several, ranks in row-major order over them); None for no
    axes."""
    from torch.utils._python_dispatch import _disable_current_modes
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return dmesh.get_group(axes[0])
    with _disable_current_modes():
        return dmesh[axes]._flatten().get_group()
