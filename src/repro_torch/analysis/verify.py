"""Static soundness checks for derived schedules and bundles (a copy of
the schedule layer of ``repro.analysis.verify``).

The psi-calculus derivation (``core/schedule.py``) claims every schedule it
emits is correct by construction.  This module *proves* the claims it can
state symbolically, without executing a kernel:

* **coverage / disjointness** — every logical element of every operand and
  of the output is touched by exactly one (non-sigma) grid point: a
  grid-driven dimension's ``block * grid_extent`` must equal the padded
  extent with a zero index-map offset, a resident dimension's block must
  equal its extent, and one logical axis must present one consistent
  extent across all operands;
* **psi bounds** — a psi view's constant slab offset stays inside the
  declared leading dimension;
* **races** — a grid axis that revisits the output (or an exported-state)
  block without declared reduction/carried-state semantics is a
  write-write race; declared revisiting axes must be "arbitrary"
  (sequential), never "parallel";
* **pad guard / pad value** — when a reduce axis is padded, the fill
  element must be inert under the semiring (``combine(pad, pad)`` folds
  into the reduce identity); a recurrent bundle's masking guard must use
  the true logical streamed extent its operands record;
* **resources** — the working set recomputed at the bundle's real
  ``acc_dtype`` width (plus the materialized-combine intermediate) must
  fit the hardware table, and the solver's recorded certificate must not
  understate the formula it was solved with (an undersized scratch
  budget).

Everything here is pure Python over the schedule dataclasses, and results
are LRU-cached on the same normal-form keys as the schedule cache, so a
``verify=False`` path pays nothing and a hot ``verify=True`` path pays one
dict lookup.  ``kernel=True`` adds the checks of the port's launch plan
(``analysis.conformance``).  The reference's ``verify_plan`` and
``verify_sharded`` read a distributed plan, which the port has not yet.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from repro_torch.core import expr as expr_mod
from repro_torch.core import schedule as sched_mod
from repro_torch.core import semiring
from repro_torch.core.blocking import (BlockChoice, RecurrenceBlockChoice,
                                       StreamBlockChoice, dtype_size,
                                       gemm_working_set)
from repro_torch.core.schedule import (PSI_AXIS, OperandSpec,
                                       RecurrentSchedule, Schedule,
                                       ScheduleBundle, bundle_needs_padding,
                                       bundle_pad_value)


@dataclass(frozen=True)
class Finding:
    """One verifier result: a defect class (``rule``), a severity
    (``"error"`` — the schedule is unsound — or ``"warning"``), the
    subject (schedule/operand/plan name) and a human-readable message."""
    rule: str
    level: str
    subject: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.level} {self.subject}: {self.message}"


class VerificationError(ValueError):
    """Raised on strict verification when error findings exist."""

    def __init__(self, findings: tuple[Finding, ...]):
        self.findings = findings
        super().__init__(
            "static verification failed:\n  " +
            "\n  ".join(str(f) for f in findings if f.level == "error"))


def errors(findings) -> tuple[Finding, ...]:
    return tuple(f for f in findings if f.level == "error")


# ---------------------------------------------------------------------------
# coverage / disjointness / psi bounds / races — pure grid x BlockSpec walk
# ---------------------------------------------------------------------------

def _spec_findings(spec: OperandSpec, grid, axis_extent: dict,
                   subject: str) -> list:
    """Coverage proof for one operand: walk each array dimension against
    the grid and record the full logical extent each axis presents."""
    out = []
    offs = spec.offsets or (0,) * len(spec.axes)
    for i, (ax, s, b, gd) in enumerate(zip(spec.axes, spec.shape,
                                           spec.block, spec.grid_dims)):
        off = offs[i] if i < len(offs) else 0
        if ax == PSI_AXIS:
            if b != 1 or gd is not None:
                out.append(Finding(
                    "psi-bounds", "error", subject,
                    f"{spec.array}: psi slab dim must be block 1 and "
                    f"grid-pinned, got block {b}, grid dim {gd}"))
            if off < 0 or off + b > s:
                out.append(Finding(
                    "psi-bounds", "error", subject,
                    f"{spec.array}: psi slab offset {off} outside the "
                    f"declared {s} leading slab(s)"))
            continue
        if off != 0:
            out.append(Finding(
                "coverage", "error", subject,
                f"{spec.array} dim {i} ({ax!r}) carries a constant "
                f"block-index offset {off} on a non-psi dimension — a "
                f"shifted index map: element block 0 is never touched and "
                f"the last grid step reads past extent {s}"))
            continue
        if gd is not None:
            if gd >= len(grid):
                out.append(Finding(
                    "coverage", "error", subject,
                    f"{spec.array} dim {i} ({ax!r}) driven by grid dim "
                    f"{gd}, but the grid has {len(grid)} axes"))
                continue
            table = getattr(spec, "page_table", None)
            if table is not None and i == 0:
                # a paged psi view: dim 0's stored extent is the slab pool,
                # its logical extent is len(table) pages of ``b``.  The
                # per-page slab offsets must stay inside the pool (the
                # paged analogue of psi-bounds) and the table must name one
                # slab per streamed grid step.  A stacked [slot, k] table
                # (``page_slot_dim`` set) adds the slot dimension: one row
                # per slot grid step, every slab of every slot in-pool.
                slot_dim = getattr(spec, "page_slot_dim", None)
                if slot_dim is not None:
                    if slot_dim >= len(grid):
                        out.append(Finding(
                            "page-bounds", "error", subject,
                            f"{spec.array}: stacked page table keyed on "
                            f"grid dim {slot_dim}, but the grid has "
                            f"{len(grid)} axes"))
                    elif len(table) != grid[slot_dim].extent:
                        out.append(Finding(
                            "page-bounds", "error", subject,
                            f"{spec.array}: stacked page table has "
                            f"{len(table)} rows but the slot grid dim "
                            f"{slot_dim} runs {grid[slot_dim].extent} "
                            f"steps"))
                    rows = table
                else:
                    rows = (table,)
                n_cols = {len(row) for row in rows}
                if n_cols != {grid[gd].extent}:
                    out.append(Finding(
                        "page-bounds", "error", subject,
                        f"{spec.array}: page table names {sorted(n_cols)} "
                        f"slabs but the streamed grid dim {gd} runs "
                        f"{grid[gd].extent} steps"))
                for sno, row in enumerate(rows):
                    for pno, slab in enumerate(row):
                        if slab < 0 or (slab + 1) * b > s:
                            where = (f"slot {sno} view page {pno}"
                                     if slot_dim is not None
                                     else f"view page {pno}")
                            out.append(Finding(
                                "page-bounds", "error", subject,
                                f"{spec.array}: {where} maps to slab "
                                f"{slab}, whose block of {b} ends at "
                                f"{(slab + 1) * b} — outside the "
                                f"{s}-element pool"))
                full = len(rows[0]) * b
                prev = axis_extent.get(ax)
                if prev is None:
                    axis_extent[ax] = full
                elif prev != full:
                    out.append(Finding(
                        "coverage", "error", subject,
                        f"axis {ax!r} presents extent {full} on "
                        f"{spec.array} but {prev} elsewhere — operands "
                        f"disagree on the logical iteration space"))
                continue
            covered = b * grid[gd].extent
            if covered != s:
                out.append(Finding(
                    "coverage", "error", subject,
                    f"{spec.array} dim {i} ({ax!r}): blocks of {b} over "
                    f"{grid[gd].extent} grid steps cover {covered} of "
                    f"extent {s}"))
                continue
            full = covered
        else:
            if b != s:
                out.append(Finding(
                    "coverage", "error", subject,
                    f"{spec.array} dim {i} ({ax!r}) is grid-resident with "
                    f"block {b} != extent {s} — elements beyond the block "
                    f"are never touched"))
                continue
            full = s
        prev = axis_extent.get(ax)
        if prev is None:
            axis_extent[ax] = full
        elif prev != full:
            out.append(Finding(
                "coverage", "error", subject,
                f"axis {ax!r} presents extent {full} on {spec.array} but "
                f"{prev} elsewhere — operands disagree on the logical "
                f"iteration space"))
    return out


def _race_findings(sched, spec: OperandSpec, legal_dims: set,
                   subject: str) -> list:
    """A grid axis not driving any dimension of a *written* operand revisits
    its block every step — a write-write race unless that axis is the
    declared reduction / carried-state stream (and sequential)."""
    out = []
    written = {gd for gd in spec.grid_dims if gd is not None}
    for gi, g in enumerate(sched.grid):
        if gi in written:
            continue
        if gi in legal_dims:
            if g.semantics != "arbitrary":
                out.append(Finding(
                    "race", "error", subject,
                    f"grid axis {gi} ({g.base!r}) accumulates into "
                    f"{spec.array} but has {g.semantics!r} semantics — "
                    f"its steps may run concurrently"))
            continue
        out.append(Finding(
            "race", "error", subject,
            f"grid axis {gi} ({g.base!r}, {g.extent} steps) revisits the "
            f"{spec.array} block with no declared reduction or "
            f"carried-state semantics — a write-write race"))
    return out


def verify_schedule(sched) -> tuple[Finding, ...]:
    """Symbolic coverage/disjointness/race proof for a ``Schedule`` or
    ``RecurrentSchedule``.  Returns findings (empty == proven sound)."""
    findings: list = []
    axis_extent: dict = {}
    subject = sched.name
    if isinstance(sched, RecurrentSchedule):
        writes = [sched.out] + list(sched.state_outs)
        legal = ({sched.stream_grid_dim} if sched.state is not None
                 else set())
        for spec in list(sched.ins) + writes:
            findings += _spec_findings(spec, sched.grid, axis_extent,
                                       subject)
        for spec in writes:
            findings += _race_findings(sched, spec, legal, subject)
    else:
        legal = ({sched.reduce_grid_dim}
                 if sched.reduce_grid_dim is not None else set())
        for spec in list(sched.ins) + [sched.out]:
            findings += _spec_findings(spec, sched.grid, axis_extent,
                                       subject)
        findings += _race_findings(sched, sched.out, legal, subject)
    return tuple(findings)


# ---------------------------------------------------------------------------
# pad guard / pad value — the semiring-inertness proof
# ---------------------------------------------------------------------------

def _pad_findings(bundle: ScheduleBundle) -> list:
    sch = bundle.schedule
    subject = sch.name
    out: list = []
    if isinstance(sch, RecurrentSchedule):
        # the emitter masks padded streamed positions with a
        # ``kpos < logical_stream`` guard built from ``bundle.shapes[-1]``;
        # that bound must equal the streamed extent the operands record,
        # else padded keys/tokens silently enter the reduction
        declared = bundle.shapes[-1]
        for spec, logical in zip(sch.ins, bundle.in_shapes):
            if sch.stream_axis in spec.axes and \
                    len(logical) == len(spec.shape):
                true_ls = logical[spec.axes.index(sch.stream_axis)]
                if true_ls != declared:
                    out.append(Finding(
                        "pad-guard", "error", subject,
                        f"the masking guard bounds the streamed axis "
                        f"{sch.stream_axis!r} at {declared}, but operand "
                        f"{spec.array} records logical extent {true_ls} — "
                        f"padded positions are not guarded"))
                break
        return out
    if not bundle_needs_padding(bundle):
        return out
    try:
        pad_val = bundle_pad_value(bundle)
    except ValueError as exc:
        out.append(Finding("pad-guard", "error", subject,
                           f"padding required but unguarded: {exc}"))
        return out
    # inertness only matters where a *reduce* axis is padded — padded
    # output rows/cols are sliced away after the kernel
    n_out = len(bundle.out_shape)
    if bundle.padded[n_out:] == bundle.shapes[n_out:]:
        return out
    cdef = semiring.combine_def(sch.combine)
    rdef = semiring.reduce_def(sch.reduce_op)
    contrib = cdef.np_fn(pad_val, pad_val) if len(sch.ins) > 1 else pad_val
    folded = rdef.np_fn(rdef.identity, contrib)
    if not (folded == rdef.identity or
            (folded != folded and rdef.identity != rdef.identity)):
        out.append(Finding(
            "pad-value", "error", subject,
            f"pad element {pad_val!r} is not inert under "
            f"({sch.combine}, {sch.reduce_op}): combine(pad, pad) folds "
            f"{rdef.identity!r} to {folded!r} — padded reduce positions "
            f"corrupt the result"))
    return out


# ---------------------------------------------------------------------------
# resource certificate — the acc-width working set vs the hardware table
# ---------------------------------------------------------------------------

def _resource_findings(bundle: ScheduleBundle, hw_shape,
                       dtype: str) -> list:
    sch = bundle.schedule
    subject = sch.name
    out: list = []
    ws = sch.working_set_bytes(dtype, bundle.acc_dtype)
    if hw_shape is not None and ws > hw_shape.vmem.capacity_bytes:
        out.append(Finding(
            "resource", "error", subject,
            f"working set {ws} B at acc_dtype={bundle.acc_dtype} exceeds "
            f"{hw_shape.name}'s {hw_shape.vmem.capacity_bytes} B VMEM"))
    blocks = bundle.blocks
    if isinstance(sch, Schedule) and isinstance(blocks, BlockChoice) \
            and blocks.vmem_bytes > 0:
        cert = gemm_working_set(
            blocks.bm, blocks.bk, blocks.bn, dtype_size(dtype),
            dtype_size(bundle.acc_dtype),
            materialized_combine=(sch.combine, sch.reduce_op) != ("mul",
                                                                  "add"))
        if blocks.vmem_bytes < cert:
            out.append(Finding(
                "scratch", "error", subject,
                f"solver certificate records {blocks.vmem_bytes} B but the "
                f"({blocks.bm}, {blocks.bk}, {blocks.bn}) blocks need "
                f"{cert} B at acc_dtype={bundle.acc_dtype} — an undersized "
                f"scratch budget"))
    return out


# ---------------------------------------------------------------------------
# the cached public entry points
# ---------------------------------------------------------------------------

VERIFY_CACHE_SIZE = 512
_cache: "OrderedDict[tuple, tuple[Finding, ...]]" = OrderedDict()
_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0}


def verification_cache_stats() -> dict:
    with _lock:
        return dict(_stats)


def reset_verification_cache() -> None:
    with _lock:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0


def _cached(key, compute: Callable[[], tuple]) -> tuple:
    if key is None:
        return compute()
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return hit
        _stats["misses"] += 1
    findings = compute()
    with _lock:
        _cache[key] = findings
        while len(_cache) > VERIFY_CACHE_SIZE:
            _cache.popitem(last=False)
    return findings


def verify_bundle(bundle: ScheduleBundle, *, hardware=None,
                  dtype: str = "float32", key=None,
                  strict: bool = False, kernel: bool = False,
                  nf=None, dtypes=None,
                  aligned: bool = True) -> tuple[Finding, ...]:
    """Run every static check on a cached derivation.

    ``hardware`` is a ``HardwareShape`` (or None to skip the capacity
    check); ``dtype`` must be the input dtype the bundle was derived at.
    ``key`` enables the LRU result cache (pass the same tuple shape as the
    schedule cache key).  ``kernel=True`` additionally checks the launch
    plan the port makes for the normal form ``nf`` on operands of
    ``dtypes`` (default ``dtype`` for each leaf; ``aligned``: 16-byte
    aligned bases) against the schedule (``analysis.conformance``); its
    results cache under a distinct key.  ``strict=True`` raises
    ``VerificationError`` when any error finding survives.
    """
    hw_shape = getattr(hardware, "shape", hardware)

    def compute():
        findings = list(verify_schedule(bundle.schedule))
        findings += _pad_findings(bundle)
        findings += _resource_findings(bundle, hw_shape, str(dtype))
        if kernel:
            from repro_torch.analysis import conformance
            findings += conformance.kernel_findings(
                bundle, nf, dtypes or (str(dtype),) * len(nf.leaves),
                hardware=hw_shape, acc_dtype=bundle.acc_dtype,
                aligned=aligned)
        return tuple(findings)

    findings = _cached((key, "kernel") if kernel and key is not None
                       else key, compute)
    if strict and errors(findings):
        raise VerificationError(findings)
    return findings


def verify_expr(op, *, dtype: str = "float32", hardware=None, blocks=None,
                acc_dtype: str = "float32", strict: bool = True,
                kernel: bool = False, dtypes=None,
                aligned: bool = True) -> tuple[Finding, ...]:
    """Derive (via the schedule cache) and verify a normalized expression,
    the ``ops.apply(..., verify=True)`` entry.  Results cache on the same
    ``(key(), dtype, hardware, blocks, acc_dtype)`` key as schedules.
    ``kernel=True`` extends the checks to the launch plan (operands of
    ``dtypes``, ``aligned`` bases; the plan's key adds both).

    A chain that K9 contracts pairwise (``kernels.emit.is_chain``) is run
    by the port with no derived schedule (its nest's working set does not
    fit the H100's shared memory from a few dozen elements on, and the
    pairwise stages read no schedule blocks): its checks are its launch
    plan's, for both values of ``kernel``."""
    if hardware is None:
        raise TypeError("verify_expr requires a hardware shape")
    if isinstance(op, (expr_mod.NormalForm, expr_mod.RecurrentForm)):
        nf = op
    else:
        nf = expr_mod.normal_form(op, name=getattr(op, "name", None)
                                  or "expr")
    hw_shape = getattr(hardware, "shape", hardware)
    block_key = tuple(blocks) if isinstance(blocks, (list, tuple)) else blocks
    if isinstance(block_key, (BlockChoice, StreamBlockChoice,
                              RecurrenceBlockChoice)):
        block_key = block_key.as_tuple()
    dtype = str(dtype).removeprefix("torch.")
    acc_dtype = str(acc_dtype).removeprefix("torch.")
    key = (nf.key(), dtype, hw_shape.name, block_key, acc_dtype)
    if kernel:
        dtypes = tuple(dtypes or (dtype,) * len(nf.leaves))
        key += (dtypes, bool(aligned))
    if isinstance(nf, expr_mod.NormalForm):
        from repro_torch.kernels import emit
        if emit.is_chain(nf):
            from repro_torch.analysis import conformance
            chain_dtypes = tuple(dtypes or (dtype,) * len(nf.leaves))
            if not kernel:
                # the plan's findings read the operands' dtypes and bases
                key += (chain_dtypes, bool(aligned))
            findings = _cached(key + ("chain",), lambda: tuple(
                conformance.kernel_findings(
                    None, nf, chain_dtypes, hardware=hw_shape,
                    blocks=blocks, acc_dtype=acc_dtype, aligned=aligned)))
            if strict and errors(findings):
                raise VerificationError(findings)
            return findings
    bundle = sched_mod.get_schedule(nf, dtype=dtype, hardware=hw_shape,
                                    blocks=blocks, acc_dtype=acc_dtype)
    return verify_bundle(bundle, hardware=hw_shape, dtype=dtype, key=key,
                         strict=strict, kernel=kernel, nf=nf, dtypes=dtypes,
                         aligned=aligned)


def verify_plan(plan, *, hardware=None, dtype: str = "float32", key=None,
                strict: bool = False) -> tuple[Finding, ...]:
    """Verify a ``DistributedPlan``: the per-shard bundle (at its real,
    possibly widened, ``acc_dtype``), the collective ordering, and the
    replication fallbacks surfaced as warnings naming the axis."""

    def compute():
        findings = list(verify_bundle(plan.bundle, hardware=hardware,
                                      dtype=dtype))
        mesh_size = dict(plan.mesh.axes)
        for sym, axis in plan.dropped:
            findings.append(Finding(
                "replication-fallback", "warning", plan.name,
                f"axis {sym!r} is not divisible by mesh axis {axis!r} "
                f"(size {mesh_size.get(axis)}) — operand replicated "
                f"instead of sharded"))
        # a gather replicates whatever the shard holds now: a psum or
        # reduce_scatter sequenced after an all_gather reads partial sums
        # another step may still be accumulating
        gathered = None
        for step in plan.collectives:
            if step.kind == "all_gather":
                gathered = step
            elif step.kind in ("psum", "reduce_scatter") and gathered:
                findings.append(Finding(
                    "collective-order", "error", plan.name,
                    f"{step.kind} over {step.mesh_axis!r} is sequenced "
                    f"after all_gather over {gathered.mesh_axis!r} — the "
                    f"gather replicates partial sums before the reduction "
                    f"completes"))
            if step.kind in ("reduce_scatter", "all_gather"):
                if step.out_dim is None or not (
                        0 <= step.out_dim < len(plan.out_shape)):
                    findings.append(Finding(
                        "collective-order", "error", plan.name,
                        f"{step.kind} over {step.mesh_axis!r} targets "
                        f"output dim {step.out_dim} of a rank-"
                        f"{len(plan.out_shape)} result"))
        return tuple(findings)

    findings = _cached(key, compute)
    if strict and errors(findings):
        raise VerificationError(findings)
    return findings


def verify_sharded(op, mesh, shard, *, hardware=None, dtype: str = "float32",
                   replicate_out: bool = False, scatter_axis=None,
                   acc_dtype: str = "float32",
                   strict: bool = True) -> tuple[Finding, ...]:
    """Derive (via the plan cache) and verify a distributed plan, the
    ``ops.apply(mesh=..., verify=True)`` entry; ``mesh`` a ``DeviceMesh``
    or a ``MeshShape``."""
    from repro_torch.core.mesh import from_device_mesh
    from repro_torch.distributed import plan as dplan
    if hardware is None:
        raise TypeError("verify_sharded requires a hardware shape")
    dtype = str(dtype).removeprefix("torch.")
    acc_dtype = str(acc_dtype).removeprefix("torch.")
    plan = dplan.derive_plan(op, mesh, shard=shard, hardware=hardware,
                             dtype=dtype, replicate_out=replicate_out,
                             scatter_axis=scatter_axis, acc_dtype=acc_dtype)
    if isinstance(op, (expr_mod.NormalForm, expr_mod.RecurrentForm)):
        nf = op
    else:
        nf = expr_mod.normal_form(op, name=getattr(op, "name", None)
                                  or "expr")
    hw_shape = getattr(hardware, "shape", hardware)
    key = ("plan", nf.key(), from_device_mesh(mesh).axes,
           tuple(sorted(shard.items())), bool(replicate_out), scatter_axis,
           dtype, hw_shape.name, acc_dtype)
    return verify_plan(plan, hardware=hw_shape, dtype=dtype, key=key,
                       strict=strict)
