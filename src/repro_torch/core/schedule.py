"""Derived schedules for normal forms and recurrences (a copy of
``repro.core.schedule``).

``derive_schedule`` reads a dimension-lifted ``Onf`` and computes the grid
(resource-tagged loops, parallel first, the sigma "block" loop last), each
operand's blocks and grid bindings (recovered from its affine ``Access``,
which must be a dense view of its loop axes through some gamma; a psi
view's constant offset becomes a pinned leading slab), the dimension
semantics and the contracted axes.  ``_build_bundle`` is the lifting
policy (paper fig. 2): leading output axes lift fully onto "proc", the
last two output axes blockwise onto "proc"/"vector", the first contracted
axis onto the sigma "block"; blocks come from ``solve_blocks``.
``get_schedule`` caches the result per normal form (an LRU keyed on
``NormalForm.key()``, the dtype, the hardware table, the blocks and the
accumulator).

On the card the bundle decides the padding policy (``bundle_pad_value``:
which inert element the blocks' padding stands for, or a ``ValueError``
for a semiring without one) and K9 masks past the logical extents in
place of that padding (``kernels/emit.py``).

``derive_recurrent_schedule`` welds the lifted stages of a
``RecurrentForm`` (online softmax, the SSD and gated scans, paged decode)
onto one grid with the streamed axis innermost and the typed carried
state; ``_build_recurrent_bundle`` is its lifting policy (the folding
forms' (bq, bk) from ``solve_stream_blocks``, the chunked scans' chunk
from the form) and ``_page_schedule`` rewrites the paged leaves to read
their pool through the page table.  The port's K2-K8 entries take their
shapes directly; these schedules are what the static verifier
(``repro_torch.analysis``) proves sound and what the derived chunks
(``kernels.ops.default_ssd_chunk``, ``default_gated_chunk``) are held to.
The reference's deprecated string signature is not copied.
"""
from __future__ import annotations

import string
import threading
from collections import OrderedDict
from dataclasses import dataclass, replace as _dc_replace
from typing import Optional, Sequence

from repro_torch.core import expr as expr_mod
from repro_torch.core import onf as onf_mod
from repro_torch.core import semiring
from repro_torch.core.blocking import (BlockChoice, RecurrenceBlockChoice,
                                       StreamBlockChoice, dtype_size,
                                       solve_blocks, solve_stream_blocks)
from repro_torch.core.moa import pi
from repro_torch.hardware import HardwareShape

#: resources whose grid loops are independent ("parallel"); the sigma
#: block loop ("block") carries the accumulator and stays "arbitrary"
PARALLEL_RESOURCES = frozenset({"proc", "vector", "grid", "expert"})

#: synthetic operand axis of a psi view: the flat leading slab a constant
#: Access offset addresses (block extent 1, pinned at the slab)
PSI_AXIS = "_psi"

#: resource-tag prefix of a mesh-lifted loop ("mesh:<axis-name>")
MESH_RESOURCE_PREFIX = "mesh:"


def is_mesh_resource(resource) -> bool:
    return isinstance(resource, str) and resource.startswith(
        MESH_RESOURCE_PREFIX)


def _base(index: str) -> str:
    """Logical axis behind a lifted loop index: i_o / i_i -> i."""
    return index[:-2] if index.endswith(("_o", "_i")) else index


@dataclass(frozen=True)
class GridAxis:
    index: str           # lifted loop index, e.g. "i_o"
    base: str            # logical axis it partitions, e.g. "i"
    extent: int
    semantics: str       # "parallel" | "arbitrary"


@dataclass(frozen=True)
class OperandSpec:
    """One operand's blocking, symbolically: the logical axis each array
    dimension walks, its full (padded) extent, the resident block extent,
    the grid position driving the block index (None: pinned at 0), and a
    constant block offset per dimension (a psi view's slab, on a leading
    ``PSI_AXIS`` dimension of block 1).

    ``page_table`` generalizes the single constant offset to *one constant
    per grid step* of the leading dimension: block index ``k`` of dim 0
    reads block ``page_table[k]`` of the stored pool instead of ``k`` (a
    paged psi view); ``shape[0]`` is then the pool extent.  With
    ``page_slot_dim`` set, the table is stacked ``[slot, k]`` (batched
    decode): ``page_slot_dim`` names the grid axis carrying the slot, and
    dim 0's block index is ``page_table[s][k]``."""
    array: str
    axes: tuple[str, ...]
    shape: tuple[int, ...]
    block: tuple[int, ...]
    grid_dims: tuple[Optional[int], ...]
    offsets: tuple[int, ...] = ()
    page_table: Optional[tuple] = None
    page_slot_dim: Optional[int] = None

    @property
    def is_psi_view(self) -> bool:
        return bool(self.axes) and self.axes[0] == PSI_AXIS


@dataclass(frozen=True)
class Schedule:
    """The derived schedule of one lifted normal form."""
    name: str
    grid: tuple[GridAxis, ...]
    ins: tuple[OperandSpec, ...]
    out: OperandSpec
    contracted: tuple[str, ...]          # logical axes reduced inside a block
    reduce_grid_dim: Optional[int]       # grid axis accumulated across steps
    combine: str = "mul"
    reduce_op: str = "add"

    @property
    def grid_extents(self) -> tuple[int, ...]:
        return tuple(g.extent for g in self.grid)

    @property
    def dimension_semantics(self) -> tuple[str, ...]:
        return tuple(g.semantics for g in self.grid)

    @property
    def needs_scratch(self) -> bool:
        return self.reduce_grid_dim is not None

    def einsum_plan(self) -> tuple[str, tuple[tuple[int, ...], ...]]:
        """The in-block computation as an einsum over non-unit block axes.

        Returns ``(spec, kept_dims_per_input)``: each input ref is reshaped to
        its kept (block extent > 1) dims, contracted per ``spec``, and the
        result reshaped back to the output block.  Unit axes (e.g. the lifted
        expert axis, block extent 1) drop out of the contraction — summing a
        one-element axis is the identity — which keeps the emitted body
        bit-identical to a hand-written 2-D ``jnp.dot``.
        """
        letters: dict[str, str] = {}
        pool = iter(string.ascii_lowercase)
        for spec_ in (self.out,) + self.ins:
            for ax in spec_.axes:
                if ax not in letters:
                    letters[ax] = next(pool)
        in_specs, in_keep = [], []
        for opn in self.ins:
            keep = tuple(i for i, b in enumerate(opn.block) if b > 1)
            in_keep.append(keep)
            in_specs.append("".join(letters[opn.axes[i]] for i in keep))
        out_spec = "".join(letters[self.out.axes[i]]
                           for i, b in enumerate(self.out.block) if b > 1)
        return ",".join(in_specs) + "->" + out_spec, tuple(in_keep)

    def vmem_bytes(self, dtype, buffering: int = 2, acc_bytes: int = 4) -> int:
        """Modeled resident working set: double-buffered input blocks, the
        output block and (if reducing) the accumulator."""
        esize = dtype_size(dtype)
        ws = sum(pi(opn.block) for opn in self.ins) * esize * buffering
        ws += pi(self.out.block) * esize
        if self.needs_scratch:
            ws += pi(self.out.block) * acc_bytes
        return ws

    def working_set_bytes(self, dtype, acc_dtype: str = "float32",
                          buffering: int = 2) -> int:
        """``vmem_bytes`` with the accumulator at its ``acc_dtype`` width,
        plus the materialized f32 combine intermediate of a semiring other
        than (mul, add) over the joint out x contracted block."""
        ws = self.vmem_bytes(dtype, buffering,
                             acc_bytes=dtype_size(acc_dtype))
        if (self.combine, self.reduce_op) != ("mul", "add"):
            inter = pi(self.out.block)
            for ax in self.contracted:
                for opn in self.ins:
                    if ax in opn.axes:
                        inter *= opn.block[opn.axes.index(ax)]
                        break
            ws += inter * 4
        return ws


def derive_schedule(o: "onf_mod.Onf",
                    hardware: Optional[HardwareShape] = None,
                    dtype="float32", acc_dtype: str = "float32") -> Schedule:
    """Derive the schedule of a lifted ONF.

    Raises ``ValueError`` if the nest is not lifted, if an access is not a
    dense view of its loop axes, or if the derived working set exceeds the
    hardware's fast memory (when ``hardware`` is given)."""
    if any(is_mesh_resource(l.resource) for l in o.loops):
        raise ValueError(
            f"Onf {o.name!r} has mesh-lifted loops — a single-chip schedule "
            "cannot honor a device axis")
    grid_loops = [l for l in o.loops if l.resource is not None]
    inner_loops = [l for l in o.loops if l.resource is None]
    if not grid_loops:
        raise ValueError(
            f"Onf {o.name!r} has no resource-tagged loops — lift it first "
            "(lift_loop)")
    reduce_bases = {_base(i) for i in o.reduce_indices}

    full_extent: dict[str, int] = {}
    inner_extent: dict[str, int] = {}
    for l in o.loops:
        b = _base(l.index)
        full_extent[b] = full_extent.get(b, 1) * l.extent
        if l.resource is None:
            inner_extent[b] = inner_extent.get(b, 1) * l.extent

    # grid order: parallel loops first, reduce loops last, each group in
    # the order their base axes appear in the remaining inner nest
    inner_order: list[str] = []
    for l in inner_loops:
        b = _base(l.index)
        if b not in inner_order:
            inner_order.append(b)

    def _position(loop) -> int:
        b = _base(loop.index)
        return inner_order.index(b) if b in inner_order else len(inner_order)

    def _semantics(loop) -> str:
        if loop.resource in PARALLEL_RESOURCES and \
                _base(loop.index) not in reduce_bases:
            return "parallel"
        return "arbitrary"

    ordered = (sorted([l for l in grid_loops if _semantics(l) == "parallel"],
                      key=_position)
               + sorted([l for l in grid_loops
                         if _semantics(l) == "arbitrary"], key=_position))
    grid = tuple(GridAxis(l.index, _base(l.index), l.extent, _semantics(l))
                 for l in ordered)
    grid_pos: dict[str, int] = {}
    for i, g in enumerate(grid):
        if g.base in grid_pos:
            raise ValueError(f"axis {g.base!r} lifted onto two grid resources")
        grid_pos[g.base] = i

    def _operand(a: "onf_mod.Access") -> OperandSpec:
        strides: dict[str, int] = {}
        for idx, c in a.coeffs.items():
            if c == 0:
                continue
            b = _base(idx)
            strides[b] = min(strides.get(b, c), c)
        # a lifted pair must stay one blocked axis: coeff(x_o) ==
        # coeff(x_i) * |x_i| (the lift_loop rewrite, and nothing else)
        for idx, c in a.coeffs.items():
            b = _base(idx)
            if idx.endswith("_o") and c != strides[b] * inner_extent.get(b, 1):
                raise ValueError(
                    f"{a.array}: {idx} coefficient {c} inconsistent with a "
                    f"row-major lift of {b!r}")
        # descending stride; ties (only with an extent-1 axis) by
        # descending extent, so the extent-1 axis sits inner
        axes = sorted(strides, key=lambda b: (-strides[b], -full_extent[b]))
        expected = 1
        for b in reversed(axes):
            if strides[b] != expected:
                raise ValueError(
                    f"{a.array} is not a dense row-major view: axis {b!r} "
                    f"stride {strides[b]}, expected {expected}")
            expected *= full_extent[b]
        axes_t = tuple(axes)
        shape = tuple(full_extent[b] for b in axes)
        block = tuple(inner_extent.get(b, 1) for b in axes)
        gdims = tuple(grid_pos.get(b) for b in axes)
        offs = (0,) * len(axes)
        if a.const:
            # a psi view: the constant offset must address whole leading
            # slabs of the dense view; one leading block-1 dimension pinned
            # at the viewed slab
            if a.const % expected:
                raise ValueError(
                    f"{a.array}: constant offset {a.const} (a psi view) is "
                    f"not a multiple of the slab size {expected} — no "
                    "BlockSpec lowering; materialize the view first")
            slab = a.const // expected
            axes_t = (PSI_AXIS,) + axes_t
            shape = (slab + 1,) + shape
            block = (1,) + block
            gdims = (None,) + gdims
            offs = (slab,) + offs
        return OperandSpec(a.array, axes_t, shape, block, gdims, offs)

    out_spec = _operand(o.out)
    in_specs = tuple(_operand(a) for a in o.ins)

    in_bases = {b for s in in_specs for b in s.axes}
    contracted = tuple(b for b in inner_order
                       if b in reduce_bases and b in in_bases
                       and b not in out_spec.axes)
    reduce_dims = [i for i, g in enumerate(grid) if g.base in reduce_bases]
    if len(reduce_dims) > 1:
        raise ValueError("more than one lifted reduction axis is unsupported")
    reduce_grid_dim = reduce_dims[0] if reduce_dims else None

    sched = Schedule(o.name, grid, in_specs, out_spec, contracted,
                     reduce_grid_dim, o.combine, o.reduce_op)
    if hardware is not None:
        ws = sched.working_set_bytes(dtype, acc_dtype)
        if ws > hardware.vmem.capacity_bytes:
            raise ValueError(
                f"derived blocks need {ws} B VMEM, over {hardware.name}'s "
                f"{hardware.vmem.capacity_bytes} B capacity")
    return sched


# ---------------------------------------------------------------------------
# recurrent schedules: carried-state recurrences (online softmax, SSD scan,
# gated scan) — the sigma accumulator generalized to a typed monoid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StagePlan:
    """One welded stage's in-block contraction, symbolically: its operand
    blocks (including the VMEM-only carrier), output block and in-block
    contracted axes.  ``einsum_plan`` is the derived block body."""
    ins: tuple[OperandSpec, ...]
    out: OperandSpec
    contracted: tuple[str, ...]

    def einsum_plan(self) -> tuple[str, tuple[tuple[int, ...], ...]]:
        return Schedule("stage", (), self.ins, self.out, self.contracted,
                        None).einsum_plan()


@dataclass(frozen=True)
class RecurrentSchedule:
    """A derived schedule for a *carried-state recurrence*: N chained
    contractions whose shared streamed axis is lifted onto the sigma
    "block" resource with a typed monoid (``expr.StateSpec``) instead of a
    plain accumulator.

    Derived — like ``Schedule`` — entirely from lifted ONFs: the grid, the
    operand BlockSpecs (including the GQA q-head -> kv-head index map, which
    falls out of the kv operands' zero coefficient on the group axis; and
    the SSD head broadcast, which falls out the same way) and the streamed
    dimension all come from the affine Access coefficients.  The carried
    state the emitter materializes per grid cell is declared by ``state``
    (online softmax's (m, l, acc); SSD's inter-chunk (h, p, n); RG-LRU's
    channel vector) — it joins the block solvers' working-set models
    (``solve_stream_blocks`` / ``solve_recurrence_blocks``), which is where
    the blocks come from.  ``state_outs`` are the exported-final-state
    outputs (the scan decode caches); ``stages`` carry each weld's derived
    in-block einsum plan; ``window``/``prefix_len`` are the streamed-axis
    masking metadata the emitter derives block-skip from.

    The two-stage online-softmax instance is the old ``StreamingSchedule``
    (that name is a one-release alias of this class).
    """
    name: str
    grid: tuple[GridAxis, ...]
    ins: tuple[OperandSpec, ...]         # stage inputs (carriers excluded)
    out: OperandSpec                     # then the aux (state) operands
    inters: tuple[OperandSpec, ...]      # the VMEM-only intermediate blocks
    state_outs: tuple[OperandSpec, ...]  # exported final state (may be ())
    stages: tuple[StagePlan, ...]
    contracted: tuple[str, ...]          # first contraction's in-block axes
    stream_grid_dim: int                 # grid axis carrying the state
    row_axis: str                        # per-row state axis ("" if chunked)
    stream_axis: str                     # the streamed logical axis
    state: "expr_mod.StateSpec" = None   # the carried monoid declaration
    window: int = 0
    prefix_len: int = 0

    @property
    def grid_extents(self) -> tuple[int, ...]:
        return tuple(g.extent for g in self.grid)

    @property
    def dimension_semantics(self) -> tuple[str, ...]:
        return tuple(g.semantics for g in self.grid)

    @property
    def inter(self) -> OperandSpec:
        """The first VMEM-only intermediate (THE intermediate for the
        two-stage streaming instance)."""
        return self.inters[0]

    @property
    def row_block(self) -> int:
        """bq — the block extent of the per-row state axis."""
        return self.out.block[self.out.axes.index(self.row_axis)]

    @property
    def stream_block(self) -> int:
        """bk — the block extent of the streamed axis in the intermediate
        (1 for chunked scans: the chunk index streams whole steps)."""
        return self.inter.block[self.inter.axes.index(self.stream_axis)]

    @property
    def value_axes(self) -> tuple[str, ...]:
        """Output axes NOT shared with the intermediate — the second
        contraction's value dims (head_dim for attention)."""
        return tuple(ax for ax in self.out.axes if ax not in self.inter.axes)

    @property
    def acc_block(self) -> tuple[int, ...]:
        """The accumulator scratch shape: (row block, value block) — chosen
        by axis, not by dropping unit dims, so a size-1 value axis still
        yields a rank-2 accumulator the emitter can rescale per row."""
        return (self.row_block,) + tuple(
            self.out.block[self.out.axes.index(ax)]
            for ax in self.value_axes)

    def state_blocks(self) -> tuple[tuple[int, ...], ...]:
        """Per exported state array, its in-kernel scratch shape: the
        state-out block with the grid-pinned unit dims dropped (blockwise
        grid-driven dims — a blocked per-row axis — keep their extent)."""
        out = []
        for so in self.state_outs:
            blk = tuple(b for b, d in zip(so.block, so.grid_dims)
                        if d is None or b > 1)
            out.append(blk if len(blk) >= 2 else (1,) * (2 - len(blk)) + blk)
        return tuple(out)

    def vmem_bytes(self, dtype, buffering: int = 2, acc_bytes: int = 4) -> int:
        """Modeled resident working set: double-buffered input blocks, the
        output block, the carried state and the in-block f32 intermediates
        (each counted twice: pre- and post-nonlinearity)."""
        esize = dtype_size(dtype)
        ws = sum(pi(opn.block) for opn in self.ins) * esize * buffering
        ws += pi(self.out.block) * esize
        if self.row_axis:
            ws += (pi(self.out.block) + 2 * self.row_block) * acc_bytes
        for so in self.state_outs:
            ws += pi(so.block) * acc_bytes
        for inter in self.inters:
            ws += 2 * pi(inter.block) * acc_bytes
        return ws

    def working_set_bytes(self, dtype, acc_dtype: str = "float32",
                          buffering: int = 2) -> int:
        """``vmem_bytes`` with the carried state and accumulators at their
        real ``acc_dtype`` width — the certified working set derivation
        checks and ``repro.analysis`` re-certifies."""
        return self.vmem_bytes(dtype, buffering,
                               acc_bytes=dtype_size(acc_dtype))


#: one-release alias: the streaming (online-softmax) schedule is the
#: two-stage instance of the recurrence subsystem
StreamingSchedule = RecurrentSchedule


def _aux_operand(leaf: "expr_mod.LeafSpec", grid_pos: dict[str, int],
                 grid_block: Optional[dict[str, int]] = None) -> OperandSpec:
    """BlockSpec for a state-monoid operand (SSD's dA, the initial state,
    the saved softmax statistics a derived backward re-reads): a dense
    row-major view of its declared axes — grid-lifted axes get their grid
    dimension's block extent (1 for fully-lifted axes, the derived row/
    stream block for blockwise-lifted axes) driven by their grid position,
    the rest stay resident whole."""
    grid_block = grid_block or {}
    axes = tuple(t for t, _ in leaf.dims)
    shape = tuple(e for _, e in leaf.dims)
    block = tuple(grid_block.get(ax, 1) if ax in grid_pos else e
                  for ax, e in leaf.dims)
    gdims = tuple(grid_pos.get(ax) for ax in axes)
    return OperandSpec(leaf.array, axes, shape, block, gdims,
                       (0,) * len(axes))


def derive_recurrent_schedule(stages: Sequence["onf_mod.Onf"],
                              stream_axis: str,
                              state: "expr_mod.StateSpec",
                              aux: Sequence["expr_mod.LeafSpec"] = (),
                              window: int = 0, prefix_len: int = 0,
                              hardware: Optional[HardwareShape] = None,
                              dtype="float32",
                              acc_dtype: str = "float32") -> RecurrentSchedule:
    """Derive a ``RecurrentSchedule`` from the lifted ONFs of a recurrence
    chain (``expr.RecurrentForm`` lifted per axis).

    Every nest must lift onto the *same* grid, with the streamed axis on
    the innermost grid dimension with "arbitrary" semantics (the carried
    state is initialized at step 0 and flushed/exported at the last step —
    anything else would share state across cells mid-recurrence); each
    stage's first leaf after the first stage is the VMEM-only carrier of
    the previous output (extra broadcast axes allowed — SSD's per-head
    decay weighting).  Each stage is derived by the ordinary
    ``derive_schedule`` — this function only welds them and verifies the
    weld.
    """
    scheds = [derive_schedule(o, None, dtype) for o in stages]
    for s in scheds[1:]:
        if s.grid != scheds[0].grid:
            raise ValueError(
                f"recurrence stages derived different grids: "
                f"{scheds[0].grid} vs {s.grid}")
    grid = scheds[0].grid
    stream_dims = [i for i, g in enumerate(grid) if g.base == stream_axis]
    if not stream_dims:
        raise ValueError(f"stream axis {stream_axis!r} is not a grid axis — "
                         "lift it onto 'block' first")
    stream_dim = stream_dims[0]
    if grid[stream_dim].semantics != "arbitrary":
        raise ValueError(
            f"streamed axis {stream_axis!r} derived 'parallel' semantics — "
            "the carried state needs a sequential grid dimension")
    if stream_dim != len(grid) - 1:
        raise ValueError(
            f"streamed axis {stream_axis!r} lifted onto grid dim "
            f"{stream_dim}, but the carried state requires it innermost "
            f"(dim {len(grid) - 1})")
    grid_pos = {g.base: i for i, g in enumerate(grid)}

    inters, plans = [], []
    plans.append(StagePlan(scheds[0].ins, scheds[0].out,
                           scheds[0].contracted))
    for prev, nxt in zip(scheds, scheds[1:]):
        inter, carrier = prev.out, nxt.ins[0]
        shared = set(inter.axes)
        if not shared <= set(carrier.axes):
            raise ValueError(
                f"stage output axes {inter.axes} are not covered by the "
                f"carrier {carrier.axes} — the intermediate cannot stay in "
                "VMEM")
        for ax in inter.axes:
            ia, ca = inter.axes.index(ax), carrier.axes.index(ax)
            if (inter.shape[ia], inter.block[ia], inter.grid_dims[ia]) != \
                    (carrier.shape[ca], carrier.block[ca],
                     carrier.grid_dims[ca]):
                raise ValueError(
                    f"carrier axis {ax!r} block disagrees with the stage "
                    f"output ({carrier} vs {inter}) — the intermediate "
                    "cannot stay in VMEM")
        inters.append(carrier)
        plans.append(StagePlan((carrier,) + nxt.ins[1:], nxt.out,
                               nxt.contracted))

    last = scheds[-1]
    folding = stream_axis not in last.out.axes
    row_axis = ""
    if folding:
        if last.reduce_grid_dim != stream_dim:
            raise ValueError(
                f"the last stage's lifted reduction axis is not the stream "
                f"axis {stream_axis!r}")
        row_candidates = [ax for ax, blk in zip(last.out.axes,
                                                last.out.block)
                          if blk > 1 and ax in inters[0].axes]
        if len(row_candidates) != 1:
            raise ValueError(
                f"expected exactly one blocked per-row state axis shared by "
                f"the output and the intermediate, got {row_candidates}")
        row_axis = row_candidates[0]

    # each grid axis's per-step block extent, recovered from the stage
    # operands it drives (1 for fully-lifted axes, bq/bk for the blockwise
    # row/stream lifts)
    grid_block: dict[str, int] = {}
    for spec in tuple(plans[0].ins) + tuple(p.out for p in plans) \
            + tuple(s for p in plans[1:] for s in p.ins):
        for ax, blk, gd in zip(spec.axes, spec.block, spec.grid_dims):
            if gd is not None and blk > 1:
                grid_block[ax] = blk

    ins = tuple(plans[0].ins)
    for plan in plans[1:]:
        ins += plan.ins[1:]
    ins += tuple(_aux_operand(l, grid_pos, grid_block) for l in aux)

    state_outs: list[OperandSpec] = []
    if state.exports:
        full_extent: dict[str, int] = {}
        for spec in ins + tuple(p.out for p in plans):
            for ax, e in zip(spec.axes, spec.shape):
                full_extent.setdefault(ax, e)
        par = tuple(g.base for g in grid if g.semantics == "parallel")
        for name, axes in state.exported():
            lead = tuple(ax for ax in par if ax not in axes)
            all_axes = lead + tuple(axes)
            if name in state.per_step:
                # per-step export: the streamed axis joins the operand,
                # grid-indexed so each streamed step writes its own slab
                all_axes = lead + (stream_axis,) + tuple(axes)
            shape = tuple(full_extent[ax] for ax in all_axes)
            block, gdims = [], []
            for ax in all_axes:
                if ax in grid_pos:
                    # grid-lifted axes — the leading parallel cells, a
                    # per-step streamed slab, or a carried axis that is
                    # itself blockwise-lifted (the blocked per-row axis of
                    # a folding form's saved statistics) — are written
                    # block by block, driven by their grid position
                    block.append(grid_block.get(ax, 1))
                    gdims.append(grid_pos[ax])
                else:
                    block.append(full_extent[ax])
                    gdims.append(None)
            state_outs.append(OperandSpec(name, all_axes, shape,
                                          tuple(block), tuple(gdims),
                                          (0,) * len(all_axes)))

    sched = RecurrentSchedule(
        stages[0].name, grid, ins, last.out, tuple(inters),
        tuple(state_outs), tuple(plans), scheds[0].contracted, stream_dim,
        row_axis, stream_axis, state, int(window), int(prefix_len))
    if hardware is not None:
        ws = sched.working_set_bytes(dtype, acc_dtype)
        if ws > hardware.vmem.capacity_bytes:
            raise ValueError(
                f"derived recurrent blocks need {ws} B VMEM, over "
                f"{hardware.name}'s {hardware.vmem.capacity_bytes} B capacity")
    return sched


def derive_streaming_schedule(scores: "onf_mod.Onf", context: "onf_mod.Onf",
                              stream_axis: str,
                              hardware: Optional[HardwareShape] = None,
                              dtype="float32") -> RecurrentSchedule:
    """.. deprecated:: the two-stage online-softmax weld is now
    ``derive_recurrent_schedule`` with the ``SOFTMAX_STATE`` monoid; this
    wrapper is kept for one release."""
    return derive_recurrent_schedule((scores, context), stream_axis,
                                     expr_mod.SOFTMAX_STATE,
                                     hardware=hardware, dtype=dtype)


def default_gemm_blocks(m: int, k: int, n: int, dtype,
                        hardware: HardwareShape,
                        acc_dtype: str = "float32") -> BlockChoice:
    """Solver defaults for kernel use: a quarter of the fast memory keeps
    double-buffering headroom; caps keep the grid at a few cells."""
    return solve_blocks(min(m, 512), min(k, 2048), min(n, 512), dtype,
                        hardware=hardware, vmem_budget_frac=0.25,
                        acc_dtype=acc_dtype)


def default_stream_blocks(sq: int, sk: int, hd: int, vd: int, dtype,
                          hardware: HardwareShape,
                          q_extra: int = 0, k_extra: int = 0,
                          n_inter: int = 2,
                          n_row_state: int = 2) -> StreamBlockChoice:
    """Streaming (bq, bk) policy: same quarter-VMEM budget and the same
    512 grid-coverage cap as the GEMM policy — on the v5e table this lands
    on the (512, 512) tiles the hand-written flash kernel used to fix, but
    *derived* from the carried-state working-set model, so fatter head dims
    or narrower budgets shrink the blocks instead of overflowing VMEM.
    The extra terms widen the model for the backward recurrence kinds
    (saved dO/V payloads, four in-block grad intermediates, saved-stat row
    vectors); the defaults are the forward model exactly."""
    return solve_stream_blocks(min(sq, 512), min(sk, 512), hd, vd, dtype,
                               hardware=hardware, vmem_budget_frac=0.25,
                               q_extra=q_extra, k_extra=k_extra,
                               n_inter=n_inter, n_row_state=n_row_state)


def _pad(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclass(frozen=True)
class ScheduleBundle:
    """A cached derivation: the schedule, the block choice and the shapes.
    ``schedule.ins[i].shape`` is the padded storage shape of operand ``i``;
    ``in_shapes`` the logical storage shapes callers bind (a col-layout
    leaf's reversed); ``out_shape`` the logical result shape."""
    op: str
    schedule: Schedule
    blocks: Optional[BlockChoice]    # or Stream- / RecurrenceBlockChoice
    shapes: tuple[int, ...]          # logical loop extents (out + reduce)
    padded: tuple[int, ...]          # the same, padded to block multiples
    out_shape: tuple[int, ...] = ()
    in_shapes: tuple[tuple[int, ...], ...] = ()
    acc_dtype: str = "float32"


def bundle_needs_padding(bundle: ScheduleBundle) -> bool:
    """Whether any logical operand falls short of its schedule's (padded)
    storage shape."""
    sch = bundle.schedule
    for spec, logical in zip(sch.ins, bundle.in_shapes):
        sym_rank = len(spec.shape) - (1 if spec.is_psi_view else 0)
        tail = tuple(logical[len(logical) - sym_rank:])
        if tail != (spec.shape[1:] if spec.is_psi_view else spec.shape):
            return True
    return False


def bundle_pad_value(bundle: ScheduleBundle) -> float:
    """The inert element the padding stands for: nothing padded -> 0.0; a
    single operand pads with the reduce identity (no pairing happens);
    several operands with the semiring's registered inert element (a
    ``ValueError`` when the table has none)."""
    sch = bundle.schedule
    if not bundle_needs_padding(bundle):
        return 0.0
    if len(sch.ins) == 1:
        return semiring.reduce_def(sch.reduce_op).identity
    return semiring.pad_value(sch.combine, sch.reduce_op)


SCHEDULE_CACHE_SIZE = 256
_cache: "OrderedDict[tuple, ScheduleBundle]" = OrderedDict()
_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0, "solves": 0}


def schedule_cache_stats() -> dict[str, int]:
    """Cache hits and misses, and how many times the block search ran."""
    with _lock:
        return dict(_stats)


def reset_schedule_cache() -> None:
    with _lock:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0


#: alignment of the last (lane) and second-minor axes when no solver
#: applies (elementwise nests)
_LANE, _SUBLANE = 128, 8


def _shrink(blocks: tuple[int, ...], floors: tuple[int, ...]
            ) -> Optional[tuple[int, ...]]:
    """Halve the largest block still above its floor (rounded down to the
    floor's multiple); None when every block is at its floor."""
    i = max(range(len(blocks)),
            key=lambda d: (blocks[d] > floors[d], blocks[d]))
    if blocks[i] <= floors[i]:
        return None
    half = max(floors[i], blocks[i] // 2 // floors[i] * floors[i])
    return blocks[:i] + (half,) + blocks[i + 1:]


def _build_bundle(nf: "expr_mod.NormalForm", dtype, hw_shape: HardwareShape,
                  blocks, acc_dtype: str = "float32") -> ScheduleBundle:
    """Pad, lift and derive a schedule for any normal form.

    Leading output axes lift fully onto "proc", the last two output axes
    blockwise onto "proc" / "vector", the first contracted axis onto the
    sigma "block".  Contraction blocks come from ``solve_blocks`` (with the
    materialized combine intermediate for a semiring other than (mul,
    add)); elementwise nests take (8, 128)-aligned blocks up to 256.

    Unlike the reference, a default block choice whose derived working set
    exceeds the table's fast memory (operand blocks the solver's model does
    not see: an un-lifted second contracted axis, an operand walking out
    and contracted axes at once, the elementwise policy on a small memory
    like the H100's 227 KB of shared memory) is halved, largest block
    first, until it fits; the reference raises there instead.  Blocks the
    caller pins, and every derivation that fits the first time (all of the
    reference's on its own tables), are unchanged.
    """
    ext = nf.extent_map
    out_syms, red_syms = nf.out_axes, nf.reduce_axes
    msym = out_syms[-2] if len(out_syms) >= 2 else None
    nsym = out_syms[-1] if out_syms else None
    pinned = blocks is not None
    if red_syms:
        ksym = red_syms[0]
        m = ext[msym] if msym else 1
        n = ext[nsym] if nsym else 1
        k = ext[ksym]
        if blocks is None:
            _stats["solves"] += 1
            if nf.combine == "mul" and nf.reduce_op == "add":
                blocks = default_gemm_blocks(m, k, n, dtype, hw_shape,
                                             acc_dtype=acc_dtype)
            else:
                blocks = solve_blocks(min(m, 512), min(k, 2048), min(n, 512),
                                      dtype, hardware=hw_shape,
                                      vmem_budget_frac=0.25,
                                      materialized_combine=True)
        elif not isinstance(blocks, BlockChoice):
            bm, bk, bn = blocks
            blocks = BlockChoice(bm, bk, bn, 0, 0.0, 1.0)
        tiles = blocks.as_tuple()                  # (bm, bk, bn)
        lane = hw_shape.mxu_tile[1]
        align = lane if lane > 1 else hw_shape.vreg_tile[1]
        floors = (align, 8, align)
    else:
        tiles = tuple(blocks) if blocks is not None else (
            min(_pad(ext[msym], _SUBLANE), 256) if msym else 1,
            min(_pad(ext[nsym], _LANE), 256) if nsym else 1)
        floors = (_SUBLANE if msym else 1, _LANE if nsym else 1)
        blocks = None

    while True:
        if red_syms:
            bm, bk, bn = tiles
        else:
            bm, bn = tiles
        pads: dict[str, int] = {}
        if msym:
            pads[msym] = _pad(ext[msym], bm)
        if nsym:
            pads[nsym] = _pad(ext[nsym], bn)
        if red_syms:
            pads[red_syms[0]] = _pad(ext[red_syms[0]], bk)
        lifted = nf.onf(pads)
        for s in out_syms[:-2]:
            lifted = onf_mod.lift_loop(lifted, s, ext[s], "proc")
        if msym:
            lifted = onf_mod.lift_loop(lifted, msym, pads[msym] // bm, "proc")
        if nsym:
            lifted = onf_mod.lift_loop(lifted, nsym, pads[nsym] // bn,
                                       "vector")
        if red_syms:
            lifted = onf_mod.lift_loop(lifted, red_syms[0],
                                       pads[red_syms[0]] // bk, "block")
        sched = derive_schedule(lifted, None, dtype, acc_dtype)
        smaller = None if pinned or sched.working_set_bytes(
            dtype, acc_dtype) <= hw_shape.vmem.capacity_bytes \
            else _shrink(tiles, floors)
        if smaller is None:
            break
        tiles = smaller
    if red_syms and tiles != blocks.as_tuple():
        blocks = BlockChoice(*tiles, 0, 0.0, 1.0)

    order = out_syms + red_syms
    logical = tuple(ext[s] for s in order)
    padded = tuple(pads.get(s, ext[s]) for s in order)
    return ScheduleBundle(nf.name,
                          derive_schedule(lifted, hw_shape, dtype, acc_dtype),
                          blocks, logical, padded,
                          nf.out_shape(), nf.leaf_storage_shapes(),
                          acc_dtype=acc_dtype)


def _build_recurrent_bundle(rf: "expr_mod.RecurrentForm", dtype, hw_shape,
                            blocks,
                            acc_dtype: str = "float32") -> ScheduleBundle:
    """Pad, lift and derive a ``RecurrentSchedule`` for a recurrent form.

    Two lifting policies, chosen by the weld's shape:

    * **folding** (online softmax): every scores output axis before the
      last two lifts fully onto "proc" (batch, kv-head and group cells are
      independent), the per-row axis lifts blockwise onto "proc" with
      ``bq``, and the streamed axis (last scores output == the last stage's
      reduction) lifts blockwise onto the sigma "block" resource with
      ``bk``.  ``(bq, bk)`` come from ``solve_stream_blocks`` — the carried
      state is in its working-set model — unless pinned via ``blocks``.
    * **chunked scan** (SSD, RG-LRU): the form arrives already chunk-split
      (``S -> (c, q)`` — ``q`` chosen by ``solve_recurrence_blocks`` in the
      ops layer, where the leaf shapes are known); every last-stage output
      axis before the streamed chunk axis lifts fully onto "proc", and the
      chunk axis lifts *fully* onto "block" (inner extent 1 — each streamed
      step is one whole chunk).

    All stages are lifted with the same pads and factors so they derive one
    grid; ``derive_recurrent_schedule`` welds and verifies them.
    """
    ext = rf.extent_map()
    stream_sym = rf.stream_axis

    if rf.folding:
        s_nf, c_nf = rf.stages[0], rf.stages[-1]
        row_sym = s_nf.out_axes[-2]
        if s_nf.out_axes[-1] != stream_sym:
            raise ValueError(
                f"streaming lift expects the stream axis {stream_sym!r} as "
                f"the trailing first-stage output axis, got {s_nf.out_axes}")
        sq, sk = ext[row_sym], ext[stream_sym]
        hd = ext[s_nf.reduce_axes[0]] if s_nf.reduce_axes else 1
        vd = ext[c_nf.out_axes[-1]]
        lead = s_nf.out_axes[:-2]
        if blocks is None:
            _stats["solves"] += 1
            # backward folding kinds carry wider per-cell payloads than the
            # forward: aux leaves riding the row axis (dO) widen the q-side
            # working set, leaves riding the stream (V, saved stats) the
            # k-side, and the grad chain needs four (bq, bk) intermediates
            q_extra = k_extra = 0
            n_inter, n_rows = 2, 2
            if rf.state.kind != "online_softmax":
                n_inter = 4
                for leaf in rf.aux:
                    syms = tuple(t for t, _ in leaf.dims if isinstance(t, str))
                    per = 1
                    for t, e in leaf.dims:
                        if not isinstance(t, str) or t not in (
                                (row_sym, stream_sym) + lead):
                            per *= e
                    if row_sym in syms:
                        if per > 1:
                            q_extra += per
                        else:
                            n_rows += 1
                    elif stream_sym in syms:
                        k_extra += per
            blocks = default_stream_blocks(sq, sk, hd, vd, dtype, hw_shape,
                                           q_extra=q_extra, k_extra=k_extra,
                                           n_inter=n_inter,
                                           n_row_state=n_rows)
        elif not isinstance(blocks, StreamBlockChoice):
            bq, bk = blocks
            blocks = StreamBlockChoice(min(bq, sq), min(bk, sk), 0, 0.0, 1.0)
        bq, bk = blocks.as_tuple()
        pads = {row_sym: _pad(sq, bq), stream_sym: _pad(sk, bk)}
        factors = {row_sym: (pads[row_sym] // bq, "proc"),
                   stream_sym: (pads[stream_sym] // bk, "block")}
        order = lead + (row_sym, stream_sym)
    else:
        out_axes = rf.stages[-1].out_axes
        lead = out_axes[:out_axes.index(stream_sym)]
        pads = {}
        factors = {stream_sym: (ext[stream_sym], "block")}
        if blocks is None:
            # the chunk IS the inner extent of the split sequence axes; the
            # solver already ran in the ops layer that built the chunked
            # form — record the choice for the bundle's consumers
            blocks = RecurrenceBlockChoice(
                ext.get(rf.stages[0].out_axes[-1], 1), 0, 0.0, 1.0)
        elif not isinstance(blocks, RecurrenceBlockChoice):
            blocks = RecurrenceBlockChoice(int(blocks[0]) if
                                           isinstance(blocks, (tuple, list))
                                           else int(blocks), 0, 0.0, 1.0)
        order = lead + (stream_sym,)

    def lift_stage(nf: "expr_mod.NormalForm") -> "onf_mod.Onf":
        lifted = nf.onf({s: p for s, p in pads.items()
                         if s in nf.extent_map})
        for s in lead:
            if s in nf.extent_map:
                lifted = onf_mod.lift_loop(lifted, s, ext[s], "proc")
        for s, (f, res) in factors.items():
            if s in nf.extent_map:
                lifted = onf_mod.lift_loop(lifted, s, f, res)
        return lifted

    # aux leaves bypass the per-stage onf(pads) lift — re-declare them with
    # padded extents so their derived BlockSpecs match the padded grid
    # (the saved statistics of a folding backward ride the padded row axis)
    aux = tuple(
        expr_mod.LeafSpec(
            l.array,
            tuple((t, pads.get(t, e) if isinstance(t, str) else e)
                  for t, e in l.dims),
            l.layout)
        for l in rf.aux)
    sched = derive_recurrent_schedule(
        tuple(lift_stage(nf) for nf in rf.stages), stream_sym, rf.state,
        aux, rf.window, rf.prefix_len, hw_shape, dtype, acc_dtype)
    if rf.page_table:
        sched = _page_schedule(sched, rf, ext, pads, stream_sym)
    logical = tuple(ext[s] for s in order)
    padded = tuple(pads.get(s, ext[s]) for s in order)
    in_shapes = rf.stages[0].leaf_storage_shapes()
    for nf in rf.stages[1:]:
        in_shapes += nf.leaf_storage_shapes()[1:]
    in_shapes += tuple(l.storage_shape() for l in rf.aux)
    return ScheduleBundle(rf.name, sched, blocks, logical, padded,
                          rf.stages[-1].out_shape(), in_shapes,
                          acc_dtype=acc_dtype)


def _page_schedule(sched: RecurrentSchedule, rf: "expr_mod.RecurrentForm",
                   ext: dict, pads: dict, stream_sym: str
                   ) -> RecurrentSchedule:
    """Rewrite the paged leaves' operands to read pool storage through the
    page table: the streamed leading dimension's block index becomes a
    static table lookup (block ``k`` -> pool slab ``page_table[k]``), and
    the operand's declared shape[0] becomes the *pool* extent.  Derivation
    refuses any weld the table cannot drive: a padded stream axis (the
    table would run past its last entry), a non-leading or non-streamed
    leading dim, or a block that is not exactly the page size."""
    if pads.get(stream_sym, ext[stream_sym]) != ext[stream_sym]:
        raise ValueError(
            f"paged stream axis {stream_sym!r} must not pad — the view "
            f"extent {ext[stream_sym]} is not a multiple of the derived "
            "stream block; choose page-aligned blocks")
    page = sched.stream_block
    n_steps = sched.grid[sched.stream_grid_dim].extent
    slot_dim = None
    if rf.slot_axis:
        # stacked [slot, k] table: find the grid axis carrying the lifted
        # slot index — it must exist (a lead output axis lifts block-1 onto
        # the grid) and hold exactly one table row per slot
        dims = [i for i, g in enumerate(sched.grid)
                if g.base == rf.slot_axis]
        if len(dims) != 1:
            raise ValueError(
                f"slot axis {rf.slot_axis!r} does not map to exactly one "
                f"grid axis ({dims}) — no stacked-table index map")
        slot_dim = dims[0]
        if sched.grid[slot_dim].extent != len(rf.page_table):
            raise ValueError(
                f"stacked page table has {len(rf.page_table)} rows but the "
                f"slot grid axis takes {sched.grid[slot_dim].extent} steps")
        rows_bad = [row for row in rf.page_table if len(row) != n_steps]
        if rows_bad:
            raise ValueError(
                f"stacked page-table rows {rows_bad} do not name "
                f"{n_steps} slabs (streamed block {page})")
    elif len(rf.page_table) != n_steps:
        raise ValueError(
            f"page table has {len(rf.page_table)} entries but the streamed "
            f"grid axis takes {n_steps} steps (block {page})")
    new_ins = []
    for spec in sched.ins:
        if spec.array not in rf.paged:
            new_ins.append(spec)
            continue
        if not spec.axes or spec.axes[0] != stream_sym:
            raise ValueError(
                f"paged operand {spec.array!r} does not keep the streamed "
                f"axis leading ({spec.axes}) — no table-driven index map")
        if spec.grid_dims[0] != sched.stream_grid_dim \
                or spec.block[0] != page:
            raise ValueError(
                f"paged operand {spec.array!r} dim 0 is not the streamed "
                f"page block (block {spec.block[0]}, grid dim "
                f"{spec.grid_dims[0]})")
        if spec.offsets[0]:
            raise ValueError(
                f"paged operand {spec.array!r} mixes a constant psi offset "
                "with a page table")
        pool = rf.pool_pages * page
        new_ins.append(_dc_replace(spec, shape=(pool,) + spec.shape[1:],
                                   page_table=rf.page_table,
                                   page_slot_dim=slot_dim))
    return _dc_replace(sched, ins=tuple(new_ins))


def get_schedule(expr, dtype="float32",
                 hardware: Optional[HardwareShape] = None, blocks=None,
                 acc_dtype: str = "float32") -> ScheduleBundle:
    """LRU-cached schedule derivation keyed on the expression's normal
    form: ``(normal_form(expr).key(), dtype, hardware.name, blocks,
    acc_dtype)``.  Two expressions that psi-reduce to the same nest (e.g.
    ``transpose(arr(..., "row"))`` and ``arr(..., "col")``) share one
    derivation.  ``expr`` may be an ``Expr``, a ``NormalForm`` or a
    ``RecurrentForm`` (``expr.attention_form`` ... ``batched_decode_form``:
    the bundle then carries a ``RecurrentSchedule``, its blocks from
    ``solve_stream_blocks`` or the chunk the form was built with, on the
    same cache under the composite recurrent key); ``hardware`` is a
    ``HardwareShape`` (``repro_torch.hardware``)."""
    if hardware is None:
        raise TypeError("get_schedule requires a hardware shape")
    if isinstance(expr, (expr_mod.NormalForm, expr_mod.RecurrentForm)):
        nf = expr
    else:
        nf = expr_mod.normal_form(expr,
                                  name=getattr(expr, "name", None) or "expr")
    dtype_key = str(dtype).removeprefix("torch.")
    acc_dtype = str(acc_dtype).removeprefix("torch.")
    if acc_dtype != "float32":
        # the registry is the legality oracle, the hardware table the
        # availability oracle
        if isinstance(nf, expr_mod.RecurrentForm):
            # recurrent monoids are exponential-reweighting folds (softmax
            # rescaling, SSD / gated decay): an integer accumulator cannot
            # represent the carried state
            if "float" not in acc_dtype and \
                    acc_dtype not in ("bf16", "f16", "f32", "f64"):
                raise ValueError(
                    f"recurrent form {nf.name!r} requires a floating "
                    f"accumulator (exp-reweighted carried state), got "
                    f"acc_dtype={acc_dtype!r}")
            last = nf.stages[-1]
            semiring.check_accum(acc_dtype, dtype_key, last.combine,
                                 last.reduce_op)
        else:
            semiring.check_accum(acc_dtype, dtype_key, nf.combine,
                                 nf.reduce_op)
        if acc_dtype not in hardware.acc_dtypes:
            raise ValueError(
                f"hardware {hardware.name!r} has no {acc_dtype!r} "
                f"accumulation path (supports {hardware.acc_dtypes})")
    block_key = blocks.as_tuple() if isinstance(blocks, (
        BlockChoice, StreamBlockChoice, RecurrenceBlockChoice)) else (
        tuple(blocks) if isinstance(blocks, (list, tuple)) else blocks)
    key = (nf.key(), dtype_key, hardware.name, block_key, acc_dtype)
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return hit
        _stats["misses"] += 1
        if isinstance(nf, expr_mod.RecurrentForm):
            bundle = _build_recurrent_bundle(nf, dtype_key, hardware, blocks,
                                             acc_dtype=acc_dtype)
        else:
            bundle = _build_bundle(nf, dtype_key, hardware, blocks,
                                   acc_dtype=acc_dtype)
        _cache[key] = bundle
        while len(_cache) > SCHEDULE_CACHE_SIZE:
            _cache.popitem(last=False)
        return bundle
