"""The block solvers (a copy of the part of ``repro.core.blocking`` the
port uses).

``solve_blocks`` is the paper's a-priori GEMM block choice: enumerate
hardware-aligned (bm, bk, bn), keep those whose working set (double-
buffered input blocks, the accumulator and, for semirings other than
(mul, add), the materialized combine intermediate) fits the fast-memory
budget, maximize arithmetic intensity.  ``core.schedule`` derives its
contraction blocks with it.  ``solve_recurrence_blocks`` picks the
streamed-axis block of a chunked scan the same way; the port derives its
KV page size and the SSD and gated-scan chunks with it
(``kernels.ops.default_decode_page``, ``default_ssd_chunk``,
``default_gated_chunk``), on the ``H100`` table.
``solve_stream_blocks`` is the streamed two-contraction (online softmax)
choice the recurrent schedules derive their (bq, bk) from, and
``solve_blocks_square`` the paper's square-block rule.
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


def stream_working_set(bq: int, bk: int, hd: int, vd: int, esize: int,
                       acc_size: int, buffering: int = 2,
                       q_extra: int = 0, k_extra: int = 0,
                       n_inter: int = 2, n_row_state: int = 2) -> int:
    """Resident bytes of one streamed (bq, bk) step: inputs, output block,
    carried accumulator + per-row state, and the in-block intermediates."""
    ws = (bq * (hd + q_extra) + bk * (hd + vd + k_extra)) * esize * buffering
    ws += bq * vd * esize                           # output block
    ws += (bq * vd + n_row_state * bq) * acc_size   # acc + row state
    ws += n_inter * bq * bk * acc_size              # scores/probs/grads
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

    def as_tuple(self) -> tuple[int]:
        return (self.bs,)


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


@dataclass(frozen=True)
class StreamBlockChoice:
    """Block choice for a streaming (online-softmax) reduction: the query
    block ``bq`` and the streamed key block ``bk``."""
    bq: int
    bk: int
    vmem_bytes: int                 # working set incl. buffering + state
    arithmetic_intensity: float     # flops / byte moved HBM->VMEM
    utilization: float              # fraction of the (bq, bk) tile filled

    def as_tuple(self) -> tuple[int, int]:
        return (self.bq, self.bk)


def solve_stream_blocks(sq: int, sk: int, hd: int, vd: Optional[int] = None,
                        dtype="bfloat16", hardware: HardwareShape = TPU_V5E,
                        vmem_budget_frac: float = 0.5,
                        buffering: int = 2,
                        acc_dtype="float32",
                        q_extra: int = 0, k_extra: int = 0,
                        n_inter: int = 2,
                        n_row_state: int = 2) -> StreamBlockChoice:
    """Choose ``(bq, bk)`` for a streamed two-contraction reduction
    (flash attention): per grid step the VMEM residents are the input
    blocks q ``(bq, hd)``, k ``(bk, hd)``, v ``(bk, vd)`` (double-buffered),
    the output block ``(bq, vd)``, the carried state — f32 accumulator
    ``(bq, vd)``, running max and denominator ``(bq,)`` each — and the two
    in-block f32 intermediates (scores and probabilities, ``(bq, bk)``).

    Same shape as ``solve_blocks``: enumerate hardware-aligned candidates,
    keep those whose working set (inputs + output + carried state +
    intermediates) fits the VMEM budget, maximize arithmetic intensity.
    This is the constraint set that replaces the hand-written fixed-512
    flash-attention default: at large sequence lengths on the v5e table it
    *lands on* (512, 512), and degrades gracefully when head_dim, dtype or
    the budget push the state over.

    The backward recurrence kinds reuse this model with extra terms:
    ``q_extra``/``k_extra`` widen the per-row / per-streamed-element input
    payload (e.g. the saved dO block riding the row axis, V riding the
    stream), ``n_inter`` counts the (bq, bk) f32 in-block intermediates
    (4 for flash backward: s, p, dp, ds) and ``n_row_state`` the f32
    per-row state/statistics vectors (m, l, delta, ...).  The defaults
    reproduce the forward model exactly.
    """
    vd = vd or hd
    esize = dtype_size(dtype)
    acc_size = dtype_size(acc_dtype)
    budget = int(hardware.vmem.capacity_bytes * vmem_budget_frac)
    lane = hardware.mxu_tile[1]
    sub = _sublane_multiple(dtype) if hardware.mxu_tile == (128, 128) else 1
    align_q = sub if sub > 1 else max(hardware.vreg_tile[0], 1)
    align_k = lane if lane > 1 else hardware.vreg_tile[1]

    best: StreamBlockChoice | None = None
    cand_q = _candidates(max(min(sq, 4096), align_q), align_q)
    cand_k = _candidates(max(min(sk, 4096), align_k), align_k)
    for bq in cand_q:
        for bk in cand_k:
            ws = stream_working_set(bq, bk, hd, vd, esize, acc_size,
                                    buffering=buffering, q_extra=q_extra,
                                    k_extra=k_extra, n_inter=n_inter,
                                    n_row_state=n_row_state)
            if ws > budget:
                continue
            flops = 2.0 * bq * bk * (hd + vd)
            moved = (bq * hd + bk * (hd + vd) + bq * vd) * esize
            ai = flops / moved
            util = (min(bq, sq) * min(bk, sk)) / float(bq * bk)
            cand = StreamBlockChoice(bq, bk, ws, ai, util)
            if best is None or _stream_better(cand, best):
                best = cand
    assert best is not None, "no feasible streaming block for the budget"
    return best


def _stream_better(a: StreamBlockChoice, b: StreamBlockChoice) -> bool:
    if abs(a.arithmetic_intensity - b.arithmetic_intensity) > 1e-9:
        return a.arithmetic_intensity > b.arithmetic_intensity
    if a.vmem_bytes != b.vmem_bytes:
        return a.vmem_bytes < b.vmem_bytes
    return (a.bq, a.bk) < (b.bq, b.bk)


def solve_blocks_square(hardware: HardwareShape, dtype="float64",
                        n_arrays: int = 3, buffering: int = 1) -> int:
    """The paper's exact derivation: largest square block b s.t.
    ``n_arrays * b^2 * dtype_size * buffering <= L1/VMEM capacity``, rounded
    down to the vector-register multiple.  With V100 + float64 this returns
    32 (3 x 32x32 doubles = 24 KiB <= 32 KiB), the paper's measured optimum;
    with shared-memory aggregation (capacity x4 = 128 KiB) it returns 64 —
    the paper's second regime.
    """
    esize = dtype_size(dtype)
    cap = hardware.vmem.capacity_bytes
    b = int((cap / (n_arrays * esize * buffering)) ** 0.5)
    align = max(hardware.vreg_tile[1], 1)
    # the paper's observed optima are powers of two (32 -> 64): take the
    # largest power-of-two multiple of the register width that fits
    p = align
    while p * 2 <= b:
        p *= 2
    return p
