"""The three-term roofline (a copy of ``repro.core.cost``), on the port's
hardware tables; the default table is ``H100``.

    compute    = flops            / (chips * peak_FLOP/s)
    memory     = hbm_bytes        / (chips * HBM_Bps)
    collective = collective_bytes / (chips * link_Bps)

The quantities are per device, as the reference's SPMD accounting takes
them, and ``from_quantities`` multiplies them by ``n_chips``: the two chip
factors cancel into per-chip time.

What has no counterpart here: the reference's ``collective_bytes_from_hlo``
and ``_shape_bytes`` read XLA's post-partitioning HLO text, and the port
runs no XLA program (as with ``jaxpr_lint``).  The distributed slice fills
``CollectiveStats`` from its own ``torch.distributed`` collectives.  Each
``Roofline`` carries its table's peak (``peak_flops``) where the reference
keeps the last ``from_quantities`` call's peak in a module global: the
same values wherever a roofline comes from ``from_quantities``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from repro_torch.hardware import H100, HardwareShape


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)     # opcode -> operand bytes
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def wire_bytes(stats: CollectiveStats, n_chips: int) -> float:
    """Bytes actually crossing links per chip, with per-algorithm multipliers
    (ring algorithms):  all-reduce 2(N-1)/N, all-gather/reduce-scatter
    (N-1)/N, all-to-all (N-1)/N, permute 1.  Used for the *modeled* term;
    the headline spec term uses the raw operand sum."""
    f = (n_chips - 1) / max(n_chips, 1)
    mult = {
        "all-reduce": 2.0 * f,
        "all-gather": f,
        "reduce-scatter": f,
        "all-to-all": f,
        "ragged-all-to-all": f,
        "collective-broadcast": f,
        "collective-permute": 1.0,
    }
    return sum(b * mult.get(op, 1.0) for op, b in stats.bytes_by_op.items())


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    """Three roofline terms (seconds) + provenance."""
    name: str
    n_chips: int
    global_flops: float
    global_hbm_bytes: float
    collective_op_bytes: float          # raw operand sum (spec headline)
    collective_wire_bytes: float        # ring-modeled per-chip wire bytes
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0            # 6*N*D (or 6*N_active*D) if provided
    collectives: dict = field(default_factory=dict)
    #: the table's peak FLOP/s per chip, which roofline_fraction divides by
    peak_flops: float = H100.peak_flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) step time = max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_time_noverlap_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.global_flops if self.global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at the
        (overlapped) modeled time: useful-FLOPs MFU upper bound."""
        if self.step_time_s <= 0:
            return 0.0
        useful = self.model_flops or self.global_flops
        per_chip = useful / self.n_chips
        return per_chip / self.step_time_s / self.peak_flops

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def from_quantities(name: str, *, n_chips: int, per_device_flops: float,
                    per_device_hbm_bytes: float, collective_stats: CollectiveStats,
                    hardware: HardwareShape = H100,
                    model_flops: float = 0.0) -> Roofline:
    """Build roofline terms from per-device quantities (see module
    docstring for the chips-cancellation note)."""
    gflops = per_device_flops * n_chips
    gbytes = per_device_hbm_bytes * n_chips
    op_bytes = collective_stats.total_bytes * n_chips      # global operand sum
    wire = wire_bytes(collective_stats, n_chips)           # per-chip wire bytes
    return Roofline(
        name=name, n_chips=n_chips,
        global_flops=gflops, global_hbm_bytes=gbytes,
        collective_op_bytes=op_bytes,
        collective_wire_bytes=wire,
        compute_s=gflops / (n_chips * hardware.peak_flops),
        memory_s=gbytes / (n_chips * hardware.hbm.bandwidth_Bps),
        # spec formula: raw operand bytes / (chips * link_bw)
        collective_s=op_bytes / (n_chips * hardware.ici_Bps),
        model_flops=model_flops,
        collectives=dict(collective_stats.bytes_by_op),
        peak_flops=hardware.peak_flops,
    )


def model_flops_lm(n_params: int, n_tokens: int, *, active_params: int | None = None,
                   training: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for training (2 fwd + 4 bwd), 2*N*D for inference;
    MoE uses active params."""
    n = active_params if active_params is not None else n_params
    return (6.0 if training else 2.0) * n * n_tokens
