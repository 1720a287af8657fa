"""Mesh shapes: the device level of the paper's dimension lifting
(``repro.core.mesh``).

The paper's Definition 3.1 partitions a shape component so that "each
partitioned shape is used to identify an architectural resource".  The
schedule subsystem lifts onto on-chip resources (proc / vector / sigma
block); a ``MeshShape`` stacks one more level, named device axes, on top
of a ``HardwareShape``, so the same ``lift_loop`` rewrite can split any
logical axis ``size -> (mesh, proc, vector, block)``.

A mesh-lifted loop is tagged with the resource ``"mesh:<axis>"``.  Such a
loop has no single-chip schedule (``derive_schedule`` rejects it); instead
``distributed.plan.derive_plan`` reads the mesh-tagged Access
coefficients back out as per-dim spec entries and a collective schedule,
and derives the per-shard schedule from the local (mesh-divided) extents.

Pure Python: importing this module touches no device and no process
group.  ``from_device_mesh`` reads a ``torch.distributed`` ``DeviceMesh``
duck-typed (``mesh_dim_names`` and its shape only).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.moa import pi
from repro_torch.core.onf import Onf, lift_loop
from repro_torch.core.schedule import MESH_RESOURCE_PREFIX, is_mesh_resource
from repro_torch.hardware import HardwareShape

__all__ = ["MESH_RESOURCE_PREFIX", "MeshShape", "from_device_mesh",
           "is_mesh_resource", "mesh_axis_of", "mesh_lift", "mesh_resource"]


def mesh_resource(axis_name: str) -> str:
    return MESH_RESOURCE_PREFIX + axis_name


def mesh_axis_of(resource: str) -> str:
    """Inverse of ``mesh_resource``: the device axis a lifted loop indexes."""
    if not is_mesh_resource(resource):
        raise ValueError(f"{resource!r} is not a mesh resource tag")
    return resource[len(MESH_RESOURCE_PREFIX):]


@dataclass(frozen=True)
class MeshShape:
    """Named device axes, the outermost hardware level of the lifting
    hierarchy: ordered (name, size) pairs, the shape a ``DeviceMesh`` has
    without its ranks, so plans derive (and are tested) with no process
    group."""
    axes: tuple[tuple[str, int], ...]

    def __post_init__(self):
        names = [n for n, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis in {names}")
        for n, s in self.axes:
            if int(s) < 1:
                raise ValueError(f"mesh axis {n!r} has non-positive size {s}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def n_devices(self) -> int:
        return pi(self.shape)

    def axis_size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(f"unknown mesh axis {name!r}; have {self.axis_names}")

    @staticmethod
    def from_hardware(hardware: HardwareShape) -> "MeshShape":
        """The tables already declare their mesh axes (paper Table 1's
        outermost rows); this instantiates them."""
        return MeshShape(tuple(hardware.mesh_axes))


def from_device_mesh(mesh) -> MeshShape:
    """MeshShape of a ``torch.distributed.device_mesh.DeviceMesh``
    (duck-typed: ``mesh_dim_names`` and ``shape`` or ``mesh.shape``); a
    ``MeshShape`` passes through."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    shape = getattr(mesh, "shape", None)
    if shape is None:
        shape = mesh.mesh.shape
    return MeshShape(tuple(zip(names, (int(s) for s in shape))))


def mesh_lift(o: Onf, index: str, mesh: MeshShape, axis_name: str) -> Onf:
    """One more dimension lift: split loop ``index`` over device axis
    ``axis_name``, ``i -> (i_o over mesh:<axis>, i_i)``, with the same
    affine Access rewrite every other lift uses."""
    return lift_loop(o, index, mesh.axis_size(axis_name),
                     mesh_resource(axis_name))
