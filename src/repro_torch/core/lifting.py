"""Dimension lifting (a copy of the part of ``repro.core.lifting`` the
port uses): split a logical axis into factors, each tagged with the
hardware resource it indexes.

``lift`` splits one axis outer-to-inner; a ``LiftedShape`` reads back the
grid extents, the innermost (fast-memory) block and the per-chip local
shape.  The hardware tables (``HardwareShape``, ``MemoryLevel``) are the
port's own, in ``repro_torch.hardware``.  The reference's
``partition_spec`` emits a ``jax.sharding.PartitionSpec`` and comes with
the distributed slice.  ``batch_lifting`` and ``model_lifting`` are the
canonical liftings of activations (the batch over the data-parallel mesh
axes) and of a feature axis (over the model axis).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.moa import pi
from repro_torch.hardware import HardwareShape


@dataclass(frozen=True)
class LiftedAxis:
    """One logical axis after lifting: ordered (outer..inner) factors, each
    tagged with the resource it indexes (``None``: a plain loop axis)."""
    name: str
    size: int
    factors: tuple[tuple[Optional[str], int], ...]

    def __post_init__(self):
        if pi([e for _, e in self.factors]) != self.size:
            raise ValueError(
                f"lifting of {self.name}: factors {self.factors} do not "
                f"multiply to {self.size}")

    def resource_extent(self, resource: str) -> int:
        for r, e in self.factors:
            if r == resource:
                return e
        return 1

    @property
    def innermost(self) -> int:
        return self.factors[-1][1]


@dataclass(frozen=True)
class LiftedShape:
    """A full lifted operand / loop-nest shape."""
    axes: tuple[LiftedAxis, ...]
    hardware: HardwareShape

    def grid(self) -> tuple[int, ...]:
        """Grid extents: every 'grid'-tagged factor above 1, per axis."""
        g = []
        for ax in self.axes:
            e = ax.resource_extent("grid")
            if e > 1:
                g.append(e)
        return tuple(g)

    def block_shape(self) -> tuple[int, ...]:
        """Per-axis innermost (fast-memory resident) extents."""
        return tuple(ax.innermost for ax in self.axes)

    def local_shape(self) -> tuple[int, ...]:
        """Shape of the per-chip shard (mesh factors removed)."""
        mesh_names = set(self.hardware.mesh_axis_names())
        out = []
        for ax in self.axes:
            s = ax.size
            for r, e in ax.factors:
                if r in mesh_names:
                    s //= e
            out.append(s)
        return tuple(out)


def lift(axis_name: str, size: int,
         splits: Sequence[tuple[Optional[str], int]]) -> LiftedAxis:
    """Lift one axis: ``splits`` lists (resource, extent) outer-to-inner for
    every factor but the innermost remainder, which is computed.

    lift("i", 4096, [("pod", 2), ("data", 16)]) ->
        factors (("pod", 2), ("data", 16), (None, 128))
    """
    rem = size
    for r, e in splits:
        if rem % e:
            raise ValueError(
                f"cannot lift axis {axis_name}={size}: factor {r}={e} does not "
                f"divide remaining extent {rem}")
        rem //= e
    return LiftedAxis(axis_name, size, tuple(splits) + ((None, rem),))


def lift_shape(hardware: HardwareShape,
               axes: Sequence[tuple[str, int,
                                    Sequence[tuple[Optional[str], int]]]]
               ) -> LiftedShape:
    return LiftedShape(tuple(lift(n, s, sp) for n, s, sp in axes), hardware)


def batch_lifting(hardware: HardwareShape, batch: int, *rest: tuple[str, int]
                  ) -> LiftedShape:
    """Lift the batch axis over every data-parallel mesh axis (pod, data);
    the other axes stay unlifted: the activation sharding rule."""
    dp_axes = [(n, s) for n, s in hardware.mesh_axes if n in ("pod", "data")]
    axes = [("batch", batch, [(n, s) for n, s in dp_axes])]
    axes += [(n, s, []) for n, s in rest]
    return lift_shape(hardware, axes)


def model_lifting(hardware: HardwareShape, axis_name: str, size: int,
                  *rest: tuple[str, int]) -> LiftedShape:
    """Lift a feature axis over the model mesh axis (tensor parallelism)."""
    tp = dict(hardware.mesh_axes).get("model", 1)
    axes = [(axis_name, size, [("model", tp)] if tp > 1 else [])]
    axes += [(n, s, []) for n, s in rest]
    return lift_shape(hardware, axes)
