"""The block solvers (a copy of the part of ``repro.core.blocking`` the
port uses).

``solve_blocks`` is the paper's a-priori GEMM block choice: enumerate
hardware-aligned (bm, bk, bn), keep those whose working set (double-
buffered input blocks, the accumulator and, for semirings other than
(mul, add), the materialized combine intermediate) fits the fast-memory
budget, maximize arithmetic intensity.  ``core.schedule`` derives its
contraction blocks with it.  ``solve_recurrence_blocks`` picks the
streamed-axis block of a chunked scan the same way; the port derives its
KV page size with it (``kernels.ops.default_decode_page``), on the
``H100`` table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from repro_torch.hardware import TPU_V5E, HardwareShape

_DTYPE_SIZES = {
    "bfloat16": 2, "float16": 2, "f16": 2, "bf16": 2,
    "float32": 4, "f32": 4, "float64": 8, "f64": 8,
    "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int32": 4, "int16": 2, "int64": 8,
}


def dtype_size(dtype) -> int:
    """Bytes per element of a dtype given by name (``"bfloat16"``) or as a
    ``torch.dtype``."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPE_SIZES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPE_SIZES[name]


def _candidates(limit: int, align: int) -> Iterable[int]:
    """Aligned candidate extents up to limit (powers of two times align,
    and the halfway points 3 * align * 2^i)."""
    c, seen = align, set()
    while c <= limit:
        seen.add(c)
        c *= 2
    c = align * 3
    while c <= limit:
        seen.add(c)
        c *= 2
    return sorted(seen)


def _sublane_multiple(dtype) -> int:
    """Second-minor tiling multiple of the TPU layout by dtype width."""
    return {8: 8, 4: 8, 2: 16, 1: 32}.get(dtype_size(dtype), 8)


@dataclass(frozen=True)
class BlockChoice:
    bm: int
    bk: int
    bn: int
    vmem_bytes: int                 # working set incl. buffering
    arithmetic_intensity: float     # flops / byte moved into fast memory
    utilization: float              # fraction of the matrix tile filled

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.bm, self.bk, self.bn)


def gemm_working_set(bm: int, bk: int, bn: int, esize: int, acc_size: int,
                     buffering: int = 2,
                     materialized_combine: bool = False) -> int:
    """Resident bytes of one (bm, bk, bn) GEMM grid step: double-buffered
    input blocks, the acc-width accumulator, and (non-(mul, add) semirings)
    the materialized f32 combine intermediate."""
    ws = (bm * bk + bk * bn) * esize * buffering + bm * bn * acc_size
    if materialized_combine:
        ws += bm * bn * bk * acc_size
    return ws


def solve_blocks(m: int, k: int, n: int, dtype="bfloat16",
                 hardware: HardwareShape = TPU_V5E,
                 vmem_budget_frac: float = 0.5,
                 buffering: int = 2,
                 acc_dtype="float32",
                 materialized_combine: bool = False) -> BlockChoice:
    """Choose (bm, bk, bn) for C[m, n] += A[m, k] B[k, n]: aligned
    candidates (the matrix tile on the lane axes, the sublane packing on
    k), those whose working set fits the budget, the highest arithmetic
    intensity, then the smaller working set, then the smaller blocks.
    ``materialized_combine`` adds the (bm, bn, bk) f32 intermediate of a
    semiring other than (mul, add), which lands on flatter tiles."""
    esize = dtype_size(dtype)
    acc_size = dtype_size(acc_dtype)
    if str(acc_dtype) not in hardware.acc_dtypes:
        raise ValueError(
            f"hardware {hardware.name!r} has no {acc_dtype!r} accumulation "
            f"path (supports {hardware.acc_dtypes})")
    budget = int(hardware.vmem.capacity_bytes * vmem_budget_frac)
    lane = hardware.mxu_tile[1]
    sub = _sublane_multiple(dtype) if hardware.mxu_tile == (128, 128) else 1
    align_mn = lane if lane > 1 else hardware.vreg_tile[1]
    align_k = sub if sub > 1 else 1

    best: Optional[BlockChoice] = None
    cand_m = _candidates(max(min(m, 4096), align_mn), align_mn)
    cand_n = _candidates(max(min(n, 4096), align_mn), align_mn)
    cand_k = _candidates(max(min(k, 8192), align_k * 8), align_k * 8)
    for bm in cand_m:
        for bn in cand_n:
            for bk in cand_k:
                ws = gemm_working_set(bm, bk, bn, esize, acc_size,
                                      buffering=buffering,
                                      materialized_combine=materialized_combine)
                if ws > budget:
                    continue
                flops = 2.0 * bm * bn * bk
                moved = (bm * bk + bk * bn) * esize + bm * bn * esize
                ai = flops / moved
                util = (min(bm, m) * min(bn, n)) / float(bm * bn)
                cand = BlockChoice(bm, bk, bn, ws, ai, util)
                if best is None or _better(cand, best):
                    best = cand
    if best is None:
        raise ValueError("no feasible block for the given budget")
    return best


def _better(a: BlockChoice, b: BlockChoice) -> bool:
    if abs(a.arithmetic_intensity - b.arithmetic_intensity) > 1e-9:
        return a.arithmetic_intensity > b.arithmetic_intensity
    if a.vmem_bytes != b.vmem_bytes:
        return a.vmem_bytes < b.vmem_bytes
    return (a.bm, a.bn, a.bk) < (b.bm, b.bn, b.bk)


def grid_for(m: int, k: int, n: int, blocks: BlockChoice
             ) -> tuple[int, int, int]:
    """The grid covering the problem (ceil-div per lifted axis)."""
    cdiv = lambda a, b: -(-a // b)
    return (cdiv(m, blocks.bm), cdiv(n, blocks.bn), cdiv(k, blocks.bk))


def recurrence_working_set(bs: int, token_elems: int, state_elems: int,
                           quad_elems: int, lin_elems: int, esize: int,
                           acc_size: int, buffering: int = 2) -> int:
    """Resident bytes of one chunk step of a carried-state scan."""
    ws = token_elems * bs * esize * buffering
    ws += state_elems * acc_size
    ws += (quad_elems * bs * bs + lin_elems * bs) * acc_size
    return ws


@dataclass(frozen=True)
class RecurrenceBlockChoice:
    """The streamed-axis block ``bs`` of a chunked carried-state scan."""
    bs: int
    vmem_bytes: int                 # working set incl. buffering + state
    arithmetic_intensity: float     # flops / byte moved into fast memory
    utilization: float              # fraction of the last chunk filled


def solve_recurrence_blocks(s: int, *, token_elems: int, state_elems: int,
                            quad_elems: int = 0, lin_elems: int = 0,
                            dtype="float32",
                            hardware: HardwareShape = TPU_V5E
                            ) -> RecurrenceBlockChoice:
    """Choose the chunk length ``bs`` for a carried-state chunked scan.

    Per streamed step the residents are the per-token operands
    (``token_elems`` per position, double-buffered), the carried state
    (``state_elems``, chunk-independent) and the in-chunk intermediates
    (``quad_elems * bs^2 + lin_elems * bs`` at f32 accumulator width).
    The largest chunk (up to 1024) whose working set fits a quarter of the
    fast memory wins; when even the smallest aligned chunk does not fit (a GPU
    SM's shared memory against a fat carried state), the smallest aligned
    chunk is returned instead of failing.
    """
    esize, acc_size, buffering = dtype_size(dtype), 4, 2
    budget = int(hardware.vmem.capacity_bytes * 0.25)
    lane = hardware.mxu_tile[1]
    align = lane if lane > 1 else max(hardware.vreg_tile[1], 1)

    best: Optional[RecurrenceBlockChoice] = None
    smallest: Optional[RecurrenceBlockChoice] = None
    for bs in _candidates(max(min(s, 1024), align), align):
        ws = recurrence_working_set(bs, token_elems, state_elems,
                                    quad_elems, lin_elems, esize, acc_size,
                                    buffering=buffering)
        flops = 2.0 * bs * bs * max(quad_elems, 1)
        moved = token_elems * bs * esize
        ai = flops / max(moved, 1)
        util = min(bs, s) / float(bs)
        cand = RecurrenceBlockChoice(bs, ws, ai, util)
        if smallest is None or bs < smallest.bs:
            smallest = cand
        if ws > budget:
            continue
        if best is None or _recurrence_better(cand, best):
            best = cand
    if best is None:
        best = smallest
    if best is None:
        raise ValueError("no candidate chunk at all")
    return best


def _recurrence_better(a: RecurrenceBlockChoice,
                       b: RecurrenceBlockChoice) -> bool:
    if abs(a.arithmetic_intensity - b.arithmetic_intensity) > 1e-9:
        return a.arithmetic_intensity > b.arithmetic_intensity
    if a.vmem_bytes != b.vmem_bytes:
        return a.vmem_bytes < b.vmem_bytes
    return a.bs < b.bs
