"""Hardware shapes for the block solver (a torch-free copy of the
``MemoryLevel``/``HardwareShape`` schema of ``repro.core.lifting``), plus
the H100 the port runs on.

``TPU_V5E``, ``TPU_V5E_2POD``, ``GPU_A100`` and ``V100`` (the paper's
Table 1) are copied unchanged so tests can hold the port's solver and
energy model against the reference's on the same tables.  ``H100``
describes the card the way the reference's ``GPU_A100`` describes an
A100: the SM's shared memory stands in for VMEM, the SMs form the mesh
axis, the tensor-core fragment is the matrix tile and a warp is the
register tile.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import reduce


@dataclass(frozen=True)
class MemoryLevel:
    name: str
    capacity_bytes: int            # per unit
    bandwidth_Bps: float           # bytes/second into the level below
    energy_pJ_per_byte: float      # access energy (model; relative scale)


@dataclass(frozen=True)
class HardwareShape:
    """An array-view of the machine: the resource hierarchy the lifted
    axes index (mesh levels, the on-chip fast memory, device memory) and
    the alignment of the matrix unit and the register tile."""
    name: str
    mesh_axes: tuple[tuple[str, int], ...]
    vmem: MemoryLevel
    hbm: MemoryLevel
    ici_Bps: float
    ici_energy_pJ_per_byte: float
    peak_flops: float                             # per chip, bf16
    flop_energy_pJ: float
    mxu_tile: tuple[int, int] = (128, 128)
    vreg_tile: tuple[int, int] = (8, 128)
    sa_power_W: float = 200.0
    acc_dtypes: tuple = ("float32", "bfloat16", "int32")

    @property
    def n_chips(self) -> int:
        return reduce(lambda a, b: a * b, (s for _, s in self.mesh_axes), 1)

    def mesh_axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.mesh_axes)

    def mesh_shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.mesh_axes)


TPU_V5E = HardwareShape(
    name="tpu_v5e",
    mesh_axes=(("data", 16), ("model", 16)),
    vmem=MemoryLevel("vmem", capacity_bytes=64 * 2**20, bandwidth_Bps=4e12,
                     energy_pJ_per_byte=0.06),
    hbm=MemoryLevel("hbm", capacity_bytes=16 * 2**30, bandwidth_Bps=819e9,
                    energy_pJ_per_byte=5.0),
    ici_Bps=50e9,
    ici_energy_pJ_per_byte=10.0,
    peak_flops=197e12,
    flop_energy_pJ=0.25,
)

TPU_V5E_2POD = dataclasses.replace(
    TPU_V5E, mesh_axes=(("pod", 2), ("data", 16), ("model", 16)))

# the reference's A100 table (the SM's shared memory as VMEM, the
# tensor-core fragment as the matrix tile, a warp as the register tile)
GPU_A100 = HardwareShape(
    name="gpu_a100",
    mesh_axes=(("sm", 108),),
    vmem=MemoryLevel("smem", capacity_bytes=164 * 2**10, bandwidth_Bps=1.9e13,
                     energy_pJ_per_byte=0.09),
    hbm=MemoryLevel("hbm", capacity_bytes=40 * 2**30, bandwidth_Bps=1555e9,
                    energy_pJ_per_byte=4.0),
    ici_Bps=600e9,
    ici_energy_pJ_per_byte=8.0,
    peak_flops=312e12,
    flop_energy_pJ=0.4,
    mxu_tile=(16, 16),
    vreg_tile=(1, 32),
)

# the paper's V100 (its Table 1), as the reference's table gives it
V100 = HardwareShape(
    name="v100",
    mesh_axes=(("sm", 80),),
    vmem=MemoryLevel("l1", capacity_bytes=32 * 2**10, bandwidth_Bps=1.2e13,
                     energy_pJ_per_byte=0.1),
    hbm=MemoryLevel("global", capacity_bytes=16 * 2**30, bandwidth_Bps=900e9,
                    energy_pJ_per_byte=6.0),
    ici_Bps=32e9,
    ici_energy_pJ_per_byte=12.0,
    peak_flops=7.8e12,            # fp64
    flop_energy_pJ=6.0,
    mxu_tile=(1, 1),
    vreg_tile=(1, 8),
    acc_dtypes=("float32",),
)

# NVIDIA H100 SXM (data sheet): 132 SMs, 227 KB of shared memory usable by
# one block (232,448 bytes), 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s dense
# bf16 on the tensor cores, NVLink 900 GB/s.  The tensor cores accumulate
# floating products in f32 and s8 x s8 products in s32 (mma.sync
# ...s32.s8.s8.s32, wgmma ...s32.s8.s8): the table offers those two
# accumulators.  They have no bf16 accumulator, so a bf16 accumulation
# schedule is refused on this table, as on the reference's V100 entry.
# The energy entries are model assumptions, neither measured on the card
# nor fitted to it (core/energy.py charges them; chip_smoke.py's
# [energy_path] holds the model's predictions against the card's own
# energy counter):
#   - flop_energy_pJ 0.4, the shared memory's 0.09 pJ/B, HBM's 4.0 pJ/B
#     and NVLink's 8.0 pJ/B are the reference's GPU_A100 entries, carried
#     over unchanged;
#   - sa_power_W 700 is the card's power limit, which the model charges as
#     static power for the whole modeled time, on top of the dynamic terms.
H100 = HardwareShape(
    name="h100",
    mesh_axes=(("sm", 132),),
    vmem=MemoryLevel("smem", capacity_bytes=232_448, bandwidth_Bps=3.3e13,
                     energy_pJ_per_byte=0.09),
    hbm=MemoryLevel("hbm", capacity_bytes=80 * 10**9, bandwidth_Bps=3.35e12,
                    energy_pJ_per_byte=4.0),
    ici_Bps=900e9,
    ici_energy_pJ_per_byte=8.0,
    peak_flops=989e12,
    flop_energy_pJ=0.4,
    mxu_tile=(16, 16),            # tensor-core m16n16k16 fragment
    vreg_tile=(16, 32),           # an mma fragment's 16 rows; one warp's
                                  # 32 coalesced lanes
    sa_power_W=700.0,
    acc_dtypes=("float32", "int32"),
)

#: peak rates of one H100 SXM at its 700 W limit (data sheet, dense; f32
#: outside the tensor cores): with ``H100.hbm.bandwidth_Bps``, the
#: denominators of the roofline bounds ``chip_smoke.py`` reports
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
