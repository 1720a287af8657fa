"""Derived schedules for normal forms (a copy of the contraction part of
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
place of that padding (``kernels/emit.py``).  The reference's recurrent,
streaming and paged schedules and its deprecated string signature are
not copied: the port's K2-K8 entries take their shapes directly.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import expr as expr_mod
from repro_torch.core import onf as onf_mod
from repro_torch.core import semiring
from repro_torch.core.blocking import (BlockChoice, dtype_size,
                                       solve_blocks)
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
    ``PSI_AXIS`` dimension of block 1)."""
    array: str
    axes: tuple[str, ...]
    shape: tuple[int, ...]
    block: tuple[int, ...]
    grid_dims: tuple[Optional[int], ...]
    offsets: tuple[int, ...] = ()

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


def default_gemm_blocks(m: int, k: int, n: int, dtype,
                        hardware: HardwareShape,
                        acc_dtype: str = "float32") -> BlockChoice:
    """Solver defaults for kernel use: a quarter of the fast memory keeps
    double-buffering headroom; caps keep the grid at a few cells."""
    return solve_blocks(min(m, 512), min(k, 2048), min(n, 512), dtype,
                        hardware=hardware, vmem_budget_frac=0.25,
                        acc_dtype=acc_dtype)


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
    blocks: Optional[BlockChoice]
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


def get_schedule(expr, dtype="float32",
                 hardware: Optional[HardwareShape] = None, blocks=None,
                 acc_dtype: str = "float32") -> ScheduleBundle:
    """LRU-cached schedule derivation keyed on the expression's normal
    form: ``(normal_form(expr).key(), dtype, hardware.name, blocks,
    acc_dtype)``.  Two expressions that psi-reduce to the same nest (e.g.
    ``transpose(arr(..., "row"))`` and ``arr(..., "col")``) share one
    derivation.  ``expr`` may be an ``Expr`` or a ``NormalForm``;
    ``hardware`` is a ``HardwareShape`` (``repro_torch.hardware``)."""
    if hardware is None:
        raise TypeError("get_schedule requires a hardware shape")
    if isinstance(expr, expr_mod.NormalForm):
        nf = expr
    else:
        nf = expr_mod.normal_form(expr,
                                  name=getattr(expr, "name", None) or "expr")
    dtype_key = str(dtype).removeprefix("torch.")
    acc_dtype = str(acc_dtype).removeprefix("torch.")
    if acc_dtype != "float32":
        # the registry is the legality oracle, the hardware table the
        # availability oracle
        semiring.check_accum(acc_dtype, dtype_key, nf.combine, nf.reduce_op)
        if acc_dtype not in hardware.acc_dtypes:
            raise ValueError(
                f"hardware {hardware.name!r} has no {acc_dtype!r} "
                f"accumulation path (supports {hardware.acc_dtypes})")
    block_key = blocks.as_tuple() if isinstance(blocks, BlockChoice) else (
        tuple(blocks) if isinstance(blocks, (list, tuple)) else blocks)
    key = (nf.key(), dtype_key, hardware.name, block_key, acc_dtype)
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return hit
        _stats["misses"] += 1
        bundle = _build_bundle(nf, dtype_key, hardware, blocks,
                               acc_dtype=acc_dtype)
        _cache[key] = bundle
        while len(_cache) > SCHEDULE_CACHE_SIZE:
            _cache.popitem(last=False)
        return bundle
