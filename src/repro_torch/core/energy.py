"""The paper's energy model (a copy of ``repro.core.energy``), on the
port's hardware tables; the default table is ``H100``.

Model:  E = E_dyn + P_static * T
        E_dyn = flops * pJ_flop + hbm_bytes * pJ_hbm_byte
                + vmem_bytes * pJ_vmem_byte + ici_bytes * pJ_ici_byte
        T     = max(compute_s, memory_s, collective_s)      (overlapped)
        P     = E / T

Every constant comes from the table (``repro_torch.hardware``): on
``H100`` they are model assumptions, stated there, never fitted to the
card.  The model's claims, as the reference states them: energy tracks
time across block sizes (the paper's figs 6-8); power varies far less
than time (§3.6.3); a bandwidth-bound GEMM's energy is linear in the
matrix's size (quadratic in N), cubic once it is compute-bound.
``chip_smoke.py``'s ``[energy_path]`` holds its GEMM predictions against
the H100's own energy counter.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.blocking import (BlockChoice, RecurrenceBlockChoice,
                                       StreamBlockChoice, dtype_size)
from repro_torch.hardware import H100, HardwareShape


@dataclass(frozen=True)
class EnergyReport:
    time_s: float
    energy_J: float
    power_W: float
    flops: float
    hbm_bytes: float
    vmem_bytes: float
    ici_bytes: float
    bound: str                     # "compute" | "memory" | "collective"


def gemm_traffic(m: int, k: int, n: int, blocks: BlockChoice, dtype="bfloat16",
                 acc_dtype="float32") -> tuple[float, float]:
    """HBM and VMEM traffic (bytes) for a blocked GEMM with the given block
    choice.  The blocked-contiguous schedule reads each A block n/bn times and
    each B block m/bm times (round-robin over the lifted k axis, paper fig 2);
    C is written once.  VMEM traffic counts every element touched by the MXU.
    """
    esize = dtype_size(dtype)
    cdiv = lambda a, b: -(-a // b)
    gm, gk, gn = cdiv(m, blocks.bm), cdiv(k, blocks.bk), cdiv(n, blocks.bn)
    hbm = (gn * (m * k) + gm * (k * n)) * esize + (m * n) * esize
    vmem = 2.0 * m * k * n / min(blocks.bk, k) * esize  # operand re-touch per MXU pass
    return float(hbm), float(vmem)


def gemm_unblocked_traffic(m: int, k: int, n: int, dtype="bfloat16",
                           burst_elems: int = 128) -> float:
    """Classical (unblocked) row-of-A x column-of-B HBM traffic.

    For every (i, j) output: A's row i streams contiguously (bursts fully
    used, so useful bytes = moved bytes), but B's column j is walked with
    stride p — each access moves a full burst of which ONE element is used.
    This is the paper's strided-access penalty, the quantity MoA's
    contiguous ONF eliminates.  C is written once.
    """
    esize = dtype_size(dtype)
    a = float(m) * n * k * esize                      # contiguous re-reads
    b = float(m) * n * k * esize * min(burst_elems, n)  # strided burst waste
    c = float(m) * n * esize
    return a + b + c


def _report(flops: float, hbm_b: float, vmem_b: float, ici_b: float,
            hardware: HardwareShape) -> EnergyReport:
    """The shared E = E_dyn + P_static * T model: one implementation for
    every op family."""
    compute_s = flops / hardware.peak_flops
    memory_s = hbm_b / hardware.hbm.bandwidth_Bps
    coll_s = ici_b / hardware.ici_Bps if ici_b else 0.0
    time_s = max(compute_s, memory_s, coll_s)
    bound = {compute_s: "compute", memory_s: "memory",
             coll_s: "collective"}[time_s]
    e_dyn = (flops * hardware.flop_energy_pJ
             + hbm_b * hardware.hbm.energy_pJ_per_byte
             + vmem_b * hardware.vmem.energy_pJ_per_byte
             + ici_b * hardware.ici_energy_pJ_per_byte) * 1e-12
    energy = e_dyn + hardware.sa_power_W * time_s
    return EnergyReport(time_s, energy, energy / max(time_s, 1e-30),
                        flops, hbm_b, vmem_b, ici_b, bound)


def gemm_energy(m: int, k: int, n: int, blocks: BlockChoice,
                dtype="bfloat16", hardware: HardwareShape = H100,
                ici_bytes: float = 0.0) -> EnergyReport:
    flops = 2.0 * m * k * n
    hbm_b, vmem_b = gemm_traffic(m, k, n, blocks, dtype)
    return _report(flops, hbm_b, vmem_b, ici_bytes, hardware)


def attention_traffic(b: int, hq: int, sq: int, sk: int, hd: int,
                      vd: int, blocks: StreamBlockChoice, dtype="bfloat16",
                      causal: bool = True) -> tuple[float, float]:
    """HBM and VMEM traffic (bytes) for the derived streaming attention
    schedule.  Q and the output move once; K and V stream once per
    (q-head, q-block) grid cell (``hq * ceil(sq / bq)`` passes in total —
    the kv-head count cancels against the group factor, so the model needs
    only ``hq``), halved by the causal block skip.  The online-softmax
    state (m, l, acc) never leaves VMEM — that is the schedule's whole
    point, and why its HBM bytes are O(S) per query block instead of the
    O(S^2) score matrix."""
    esize = dtype_size(dtype)
    cdiv = lambda a, b_: -(-a // b_)
    nq = cdiv(sq, blocks.bq)
    frac = 0.5 if causal else 1.0           # causal skips blocks above diag
    hbm = (b * hq * sq * (hd + vd)) * esize                 # q in, out out
    # each kv head's sk*(hd+vd) data re-streams once per (group, q-block)
    # grid cell: hkv * g * nq = hq * nq passes total
    hbm += frac * nq * (b * hq * sk * (hd + vd)) * esize
    steps = frac * (b * hq) * nq * cdiv(sk, blocks.bk)
    vmem = steps * (blocks.bq * hd + blocks.bk * (hd + vd)
                    + blocks.bq * vd) * esize
    return float(hbm), float(vmem)


def attention_energy(b: int, hq: int, sq: int, sk: int, hd: int,
                     blocks: StreamBlockChoice, dtype="bfloat16",
                     vd: int = 0, causal: bool = True,
                     hardware: HardwareShape = H100) -> EnergyReport:
    """Modeled time/energy for flash attention under the derived (bq, bk):
    the streaming analogue of ``gemm_energy`` (same E = E_dyn + P*T model)."""
    vd = vd or hd
    frac = 0.5 if causal else 1.0
    flops = frac * 2.0 * b * hq * sq * sk * (hd + vd)
    hbm_b, vmem_b = attention_traffic(b, hq, sq, sk, hd, vd, blocks,
                                      dtype, causal)
    return _report(flops, hbm_b, vmem_b, 0.0, hardware)


def scan_traffic(b: int, s: int, h: int, p: int, n: int,
                 blocks: RecurrenceBlockChoice, dtype="float32",
                 acc_dtype="float32",
                 materialized: bool = False) -> tuple[float, float]:
    """HBM and VMEM traffic (bytes) for the SSD chunked scan.

    The derived carried-state schedule streams every operand exactly once
    (x, dA, B, C in; y out; the state crosses chunks in VMEM), so its HBM
    bytes are O(S) — independent of the chunk.  With ``materialized`` the
    model instead charges the hand-rolled jnp formulation, which round-trips
    the (b, c, h, q, q) decay mask L and the per-chunk scores through HBM —
    the O(S * q * h) traffic the derived kernel's VMEM residency eliminates
    (the same story as flash attention vs materialized softmax).
    """
    esize = dtype_size(dtype)
    acc = dtype_size(acc_dtype)
    q = blocks.bs
    hbm = b * s * (h * p + h + 2 * n) * esize          # x, dA, B, C in
    hbm += b * s * h * p * acc                         # y out (f32)
    hbm += 2.0 * b * h * p * n * acc                   # state in + out
    if materialized:
        # L (b,c,h,q,q) + scores (b,c,q,q) written then re-read, plus the
        # per-chunk state tensors the lax.scan stages through HBM
        hbm += 2.0 * b * s * q * (h + 1) * acc
        hbm += 2.0 * b * (s / q) * h * p * n * acc
    steps = b * (s / max(q, 1))
    vmem = steps * (q * (h * p + h + 2 * n) * esize
                    + (q * q * (h + 1) + h * p * n) * acc)
    return float(hbm), float(vmem)


def scan_energy(b: int, s: int, h: int, p: int, n: int,
                blocks: RecurrenceBlockChoice, dtype="float32",
                materialized: bool = False,
                hardware: HardwareShape = H100) -> EnergyReport:
    """Modeled time/energy for the SSD chunked scan under the derived chunk:
    the scan analogue of ``gemm_energy``/``attention_energy`` (same
    E = E_dyn + P*T model).  Intra-chunk work is quadratic in the chunk
    (the block-diagonal q x q part) plus the linear state updates."""
    q = blocks.bs
    flops = 2.0 * b * s * (q * (n + h * p) + 2.0 * h * p * n)
    hbm_b, vmem_b = scan_traffic(b, s, h, p, n, blocks, dtype,
                                 materialized=materialized)
    return _report(flops, hbm_b, vmem_b, 0.0, hardware)


def energy_vs_blocksize(n: int, block_sizes, dtype="bfloat16",
                        hardware: HardwareShape = H100):
    """The paper's experiment: square GEMM of size n, sweep square blocks.
    Returns list of (block, EnergyReport)."""
    out = []
    for b in block_sizes:
        bc = BlockChoice(bm=b, bk=b, bn=b,
                         vmem_bytes=3 * b * b * dtype_size(dtype),
                         arithmetic_intensity=2.0 * b / 3.0 / dtype_size(dtype),
                         utilization=1.0)
        out.append((b, gemm_energy(n, n, n, bc, dtype, hardware)))
    return out
