"""K9's launch descriptor: a cached ``ScheduleBundle`` made into what the
hand-written general-semiring kernel (``csrc/semiring.cu``) reads.

This replaces the reference's ``emit_bundle`` (``repro.kernels.emit``),
which pads every operand to the schedule's block multiples with the
semiring's inert element, runs ``emit_pallas`` on the padded copies and
slices the logical result back out.  Here the descriptor names the
normal form's logical extents, out axes first, then the contracted axes
(``nf.out_axes`` / ``nf.reduce_axes``), and for each operand the flat
affine access that ``LeafSpec.access`` computes at those extents: a
gamma coefficient (an element stride) per axis and a constant base
offset (a psi view's slab).  So a col-layout leaf, a transposed leaf and a
psi slab are all read in place, with no transpose copy and no pad copy,
and the padding becomes masking past the logical extents, which is what
padding with the inert element means.  The padding policy itself is the
reference's: ``bundle_pad_value`` runs on the bundle, so a semiring with
no inert element (e.g. (max, mul)) raises the same ``ValueError`` exactly
where its schedule needs padding.

Every launch decision is made here, on the host, where the CPU tests can
hold it: the merge of contracted axes that one flattened index walks
(``merge_contracted``), the path (``_mode``: TILE, MAP, REDUCE, CHAIN or
THREAD, and THREAD's warp or thread form), TILE's
K split and REDUCE's variant and split (shapes only, in ``describe``),
and each operand's orientation and copy width (``vector_ok``, at the
launch's pointers, in ``Launch.c_descs``).  A chain becomes two TILE
stages whose operands are the chain's leaves and the f32 scratch T.

``run_descriptor`` is a plain PyTorch executor of a descriptor through
``torch.as_strided``: it reads exactly the strides, base offsets and
extents that K9 is given (the CPU tests drive it).

``emit_shard_map`` runs a distributed plan (``distributed.plan``) on a
``DeviceMesh``: each rank the per-shard normal form on K1 or K9, then
the plan's collectives (``distributed.comm``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core import expr as E
from repro_torch.core import schedule as sched_mod
from repro_torch.core import semiring

#: K9's limits: out axes, contracted axes, operands
MAX_OUT, MAX_RED, MAX_IN = 4, 3, 3
#: K9's op codes (csrc/semiring.cu)
COMBINE_CODE = {"mul": 0, "add": 1}
REDUCE_CODE = {"add": 0, "max": 1, "min": 2}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
#: K9's paths (``Launch.mode``, chosen by :func:`_mode`):
#: TILE    two operands, one contracted axis, the M side free of the N
#:         axis and the N side free of M: 128x128 output tiles, K staged
#:         through a two-stage ring, split over blocks where the tiles
#:         alone do not fill the card;
#: THREAD  every nest no other path takes: a warp per output where the
#:         contracted volume is at least a warp's (``Launch.rows``), its
#:         lanes walking the flattened contracted index, else a thread;
#: REDUCE  one contracted axis: a warp per output where it is contiguous
#:         in every operand that walks it (``Launch.rows``), else column
#:         strips, split over blocks where they do not fill the card;
#: MAP     no contracted axis, or only contracted extents of 1: runs of 4
#:         outputs along the last out axis;
#: CHAIN   three operands contracted pairwise, as two TILE stages
#:         (``Launch.stages``) through an f32 scratch buffer.
TILE, THREAD, REDUCE, MAP, CHAIN = 0, 1, 2, 3, 4
#: TILE's output tile (rows and columns) and slab depth
TILE_M, TILE_K = 128, 16
#: a REDUCE column strip (32 lanes of 4) and the warps of a block
REDUCE_STRIP, REDUCE_WARPS = 128, 8
#: MAP and REDUCE read and write runs of this many elements
RUN = 4
#: the H100's SMs: a grid below this many blocks leaves SMs idle
NUM_SM = 132
#: the contracted volume from which THREAD takes a warp an output
THREAD_WARP_MIN = 32
#: the fewest contracted elements a split of TILE (REDUCE) takes
TILE_SPLIT_MIN, REDUCE_SPLIT_MIN = 64, 256
#: the CUDA grid's y and z limit (tile rows, leading out cells, splits)
GRID_YZ = 65535
#: (combine, reduce) pairs whose chains contract pairwise: the combine
#: distributes over the reduce
CHAIN_PAIRS = {("mul", "add"), ("add", "max"), ("add", "min")}


class K9Desc(ctypes.Structure):
    """The fixed-size descriptor ``csrc/semiring.cu`` takes by value (its
    ``Desc``, field for field): out axes right-aligned into 4 slots and
    contracted axes into 3 (extent 1, stride 0 before them, so the last
    contracted axis is the kernel's innermost loop); per operand a stride
    per slot (out slots 0-3, contracted 4-6) and a base offset, all int64
    elements; then what the host decided for the launch: the contracted
    elements of a split and the number of splits, per operand whether
    TILE reads it along K (``k_fast``) and whether it is read by vectors
    (``vec``), whether the output is stored by vectors, REDUCE's variant,
    and which buffer each operand reads (``src``: 0-2 the inputs, 3 the
    chain's scratch) and the descriptor writes (``dst``: 0 the output, 1
    the scratch)."""
    _fields_ = [("out_ext", ctypes.c_longlong * MAX_OUT),
                ("red_ext", ctypes.c_longlong * MAX_RED),
                ("stride", (ctypes.c_longlong * (MAX_OUT + MAX_RED)) * MAX_IN),
                ("base", ctypes.c_longlong * MAX_IN),
                ("out_stride", ctypes.c_longlong * MAX_OUT),
                ("k_split", ctypes.c_longlong),
                ("in_dtype", ctypes.c_int * MAX_IN),
                ("k_fast", ctypes.c_int * MAX_IN),
                ("vec", ctypes.c_int * MAX_IN),
                ("src", ctypes.c_int * MAX_IN),
                ("n_in", ctypes.c_int),
                ("n_red", ctypes.c_int),
                ("out_dtype", ctypes.c_int),
                ("mode", ctypes.c_int),
                ("a_op", ctypes.c_int),
                ("b_op", ctypes.c_int),
                ("splits", ctypes.c_int),
                ("rows", ctypes.c_int),
                ("vec_out", ctypes.c_int),
                ("dst", ctypes.c_int)]


@dataclass(frozen=True)
class Operand:
    """One leaf as K9 reads it: ``strides`` per axis of ``out_axes +
    red_axes`` (0 where the leaf does not walk the axis) and ``base``."""
    array: str
    storage_shape: tuple[int, ...]
    strides: tuple[int, ...]
    base: int


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= x
    return p


def _row_major(ext) -> tuple[int, ...]:
    st, acc = [], 1
    for e in reversed(ext):
        st.append(acc)
        acc *= e
    return tuple(reversed(st))


def vector_ok(fast_stride: int, other_strides, base: int, ptr: int,
              elems: int, elem_bytes: int) -> bool:
    """Whether an operand can be read in vectors of ``elems`` elements
    along its fast axis: the fast stride is 1 and every vector's first
    element (``base`` plus any multiple of the other strides, at a fast
    index that is a multiple of ``elems``) lies a multiple of ``elems``
    elements from a pointer aligned to the vector's bytes."""
    return (fast_stride == 1 and ptr % (elems * elem_bytes) == 0
            and base % elems == 0
            and all(s % elems == 0 for s in other_strides))


def tile_k_fast(s_row: int, s_k: int) -> bool:
    """TILE reads an operand along whichever of its row and contracted
    strides is smaller (the contracted one on a tie), so row-major,
    col-layout and transposed leaves are all read coalesced."""
    return abs(s_k) <= abs(s_row)


def tile_splits(lead: int, m: int, n: int, k: int) -> tuple[int, int]:
    """``(splits, k_split)``: TILE splits K over blocks only where its
    128x128 tiles do not fill the SMs, into at most one split per
    ``TILE_SPLIT_MIN`` contracted elements, each a multiple of the slab."""
    tiles = lead * -(-m // TILE_M) * -(-n // TILE_M)
    s = 1
    if tiles < NUM_SM:
        s = max(1, min(-(-NUM_SM // tiles), k // TILE_SPLIT_MIN,
                       GRID_YZ // max(lead, 1)))
    if s == 1:
        return 1, max(k, 1)
    k_split = -(-k // s)
    k_split = -(-k_split // TILE_K) * TILE_K
    return -(-k // k_split), k_split


def reduce_splits(lead: int, x: int, k: int) -> tuple[int, int]:
    """``(splits, k_split)`` of REDUCE's column strips: split the
    contracted axis over blocks where the strips do not fill 4 blocks a
    SM, into as many splits as still fit in one such wave and at most one
    per ``REDUCE_SPLIT_MIN`` elements."""
    strips = lead * -(-x // REDUCE_STRIP)
    want = 4 * NUM_SM
    s = 1
    if strips < want:
        s = max(1, min(want // strips, k // REDUCE_SPLIT_MIN, GRID_YZ))
    if s == 1:
        return 1, max(k, 1)
    k_split = -(-k // s)
    return -(-k // k_split), k_split


@dataclass(frozen=True)
class Launch:
    """K9's launch descriptor for one normal form (``nf``; None for a
    chain's stage)."""
    nf: Optional["E.NormalForm"]
    out_axes: tuple[str, ...]
    out_ext: tuple[int, ...]
    red_axes: tuple[str, ...]
    red_ext: tuple[int, ...]
    operands: tuple[Operand, ...]
    combine: str
    reduce_op: str
    pad_value: float             # the inert element the masking stands for
    mode: int
    roles: tuple[int, int] = (0, 1)     # TILE: the M-side and N-side operand
    splits: int = 1              # TILE / REDUCE columns: blocks along K
    k_split: int = 0             # contracted elements a split
    rows: bool = False           # REDUCE / THREAD: a warp per output
    stages: tuple["Launch", ...] = ()   # CHAIN: T = op0 (x) op1, T (x) op2
    _descs: dict = field(default_factory=dict, compare=False, hash=False,
                         repr=False)

    @property
    def out_strides(self) -> tuple[int, ...]:
        """Row-major strides of the (contiguous) logical output."""
        return _row_major(self.out_ext)

    @property
    def tmp_elems(self) -> int:
        """f32 elements of the chain's scratch buffer T (0: none)."""
        return _prod(self.stages[0].out_ext) if self.stages else 0

    @property
    def work_elems(self) -> int:
        """f32 elements of the split partials (0: no split)."""
        runs = self.stages or (self,)
        return max((r.splits * _prod(r.out_ext) for r in runs
                    if r.splits > 1), default=0)

    def _vectors(self, in_dtypes, ptrs) -> tuple[list[int], list[int]]:
        """Per operand: TILE's orientation (k_fast) and whether the path
        reads it in vectors (16 bytes for TILE; runs of ``RUN`` for MAP and
        REDUCE), by :func:`vector_ok` at this launch's pointers."""
        nout = len(self.out_ext)
        k_fast, vec = [0] * MAX_IN, [0] * MAX_IN
        for i, (opn, dt) in enumerate(zip(self.operands, in_dtypes)):
            size = ELEM_BYTES[dt]
            st = opn.strides
            if self.mode == TILE:
                row = nout - 2 if i == self.roles[0] else nout - 1
                kf = tile_k_fast(st[row], st[nout])
                k_fast[i] = int(kf)
                fast = nout if kf else row
                elems = 16 // size
            elif self.mode == MAP:
                fast, elems = nout - 1, RUN
                st = st[:nout]
            elif self.mode == REDUCE:
                fast, elems = (nout if self.rows else nout - 1), RUN
            else:
                continue
            if not st:
                continue
            others = [s for a, s in enumerate(st) if a != fast]
            vec[i] = int(vector_ok(st[fast], others, opn.base, ptrs[i],
                                   elems, size))
        return k_fast, vec

    def c_struct(self, in_dtypes, out_dtype, ptrs) -> K9Desc:
        """Pack for the kernel; raises for what K9 cannot take.  ``ptrs``
        are the operands' data pointers, which the vector rule reads."""
        nout, nred, nin = (len(self.out_ext), len(self.red_ext),
                           len(self.operands))
        if nout > MAX_OUT or nred > MAX_RED or not 1 <= nin <= MAX_IN:
            raise ValueError(
                f"K9 takes at most {MAX_OUT} out axes, {MAX_RED} contracted "
                f"axes and 1-{MAX_IN} operands; got {nout}, {nred}, {nin}")
        for dt in tuple(in_dtypes) + (out_dtype,):
            if dt not in DTYPE_CODE:
                raise TypeError(f"K9 takes float32 or bfloat16 operands and "
                                f"output, got {dt}")
        ptrs = tuple(ptrs)
        d = K9Desc()
        lead, rlead = MAX_OUT - nout, MAX_RED - nred
        out_strides = self.out_strides
        for s in range(MAX_OUT):
            d.out_ext[s] = self.out_ext[s - lead] if s >= lead else 1
            d.out_stride[s] = out_strides[s - lead] if s >= lead else 0
        for s in range(MAX_RED):
            d.red_ext[s] = self.red_ext[s - rlead] if s >= rlead else 1
        k_fast, vec = self._vectors(in_dtypes, ptrs)
        for i, (opn, dt) in enumerate(zip(self.operands, in_dtypes)):
            for s in range(MAX_OUT):
                d.stride[i][s] = opn.strides[s - lead] if s >= lead else 0
            for s in range(nred):
                d.stride[i][MAX_OUT + rlead + s] = opn.strides[nout + s]
            d.base[i] = opn.base
            d.in_dtype[i] = DTYPE_CODE[dt]
            d.k_fast[i], d.vec[i], d.src[i] = k_fast[i], vec[i], i
        d.n_in, d.n_red = nin, nred
        d.out_dtype = DTYPE_CODE[out_dtype]
        d.mode = self.mode
        d.a_op, d.b_op = self.roles
        d.splits = self.splits
        d.k_split = self.k_split or max(self.red_ext[-1:] or (1,))
        d.rows = int(self.rows)
        d.vec_out = int(bool(self.out_ext) and self.out_ext[-1] % RUN == 0)
        d.dst = 0
        return d

    def c_descs(self, in_dtypes, out_dtype, ptrs, tmp_ptr: int = 0):
        """The descriptors one ``repro_semiring`` call runs, in order: this
        launch's own, or a chain's two stages (T = op0 (x) op1 into the f32
        scratch at ``tmp_ptr``, 0 for a launch with none, then T (x) op2
        into the output).  ``ptrs``: the operands' data pointers.  Memoised
        by dtypes and the pointers' alignment (all the vector rule reads
        of them)."""
        ptrs = tuple(ptrs)
        key = (tuple(in_dtypes), out_dtype, tuple(p % 16 for p in ptrs),
               tmp_ptr % 16)
        descs = self._descs.get(key)
        if descs is None:
            descs = self._descs[key] = self._build_descs(in_dtypes, out_dtype,
                                                         ptrs, tmp_ptr)
        return descs

    def _build_descs(self, in_dtypes, out_dtype, ptrs, tmp_ptr):
        if not self.stages:
            return (K9Desc * 1)(self.c_struct(in_dtypes, out_dtype, ptrs))
        first, second = self.stages
        d1 = first.c_struct(in_dtypes[:2], torch.float32, ptrs[:2])
        d2 = second.c_struct((torch.float32, in_dtypes[2]), out_dtype,
                             (tmp_ptr, ptrs[2]))
        d1.dst = 1
        d2.src[0], d2.src[1] = 3, 2
        return (K9Desc * 2)(d1, d2)


def _tile_roles(out_ext, red_ext, operands) -> Optional[tuple[int, int]]:
    """TILE's (M-side, N-side) operands, or None where TILE cannot take
    the nest (or its grid would pass the CUDA limits)."""
    nout = len(out_ext)
    if len(operands) != 2 or len(red_ext) != 1 or nout < 2:
        return None
    lead = _prod(out_ext[:-2])
    if lead > GRID_YZ or -(-out_ext[-2] // TILE_M) > GRID_YZ:
        return None
    m_ax, n_ax = nout - 2, nout - 1
    for a, b in ((0, 1), (1, 0)):
        if operands[a].strides[n_ax] == 0 and operands[b].strides[m_ax] == 0:
            return a, b
    return None


def _chain_stages(out_ext, red_ext, operands, combine, reduce_op, pad):
    """CHAIN's two TILE stages, or None where the nest is no chain: three
    operands, two contracted axes j and k, the first operand walking j and
    not k, the middle both, the last k and not j; of the last two out
    axes the first operand walks one, the last operand the other and the
    middle neither.  Stage 1 contracts j into T (leading out axes, the
    first operand's out axis, k), row-major f32; stage 2 contracts k of T
    and the last operand into the output."""
    nout = len(out_ext)
    if (len(operands) != 3 or len(red_ext) != 2 or nout < 2
            or (combine, reduce_op) not in CHAIN_PAIRS):
        return None
    a, b, c = operands
    walks = lambda o, ax: o.strides[ax] != 0
    for j, k in ((nout, nout + 1), (nout + 1, nout)):
        if (walks(a, j) and not walks(a, k) and walks(b, j) and walks(b, k)
                and walks(c, k) and not walks(c, j)):
            break
    else:
        return None
    last = (nout - 2, nout - 1)
    xa = [x for x in last if walks(a, x)]
    xc = [x for x in last if walks(c, x)]
    if len(xa) != 1 or len(xc) != 1 or xa == xc or \
            any(walks(b, x) for x in last):
        return None
    xa = xa[0]
    lead = range(nout - 2)
    kx = red_ext[k - nout]
    t_ext = tuple(out_ext[i] for i in lead) + (out_ext[xa], kx)
    t_str = _row_major(t_ext)
    s1_ops = (Operand(a.array, a.storage_shape,
                      tuple(a.strides[i] for i in lead)
                      + (a.strides[xa], 0, a.strides[j]), a.base),
              Operand(b.array, b.storage_shape,
                      tuple(b.strides[i] for i in lead)
                      + (0, b.strides[k], b.strides[j]), b.base))
    s1_out = tuple(f"o{i}" for i in range(len(t_ext) - 1)) + ("k",)
    t_strides = [0] * (nout + 1)
    for i in lead:
        t_strides[i] = t_str[i]
    t_strides[xa], t_strides[nout] = t_str[-2], t_str[-1]
    s2_ops = (Operand("T", t_ext, tuple(t_strides), 0),
              Operand(c.array, c.storage_shape,
                      tuple(c.strides[:nout]) + (c.strides[k],), c.base))
    r1 = _tile_roles(t_ext, (red_ext[j - nout],), s1_ops)
    r2 = _tile_roles(out_ext, (kx,), s2_ops)
    if r1 is None or r2 is None:
        return None
    s1 = _tile_launch(s1_out, t_ext, ("j",), (red_ext[j - nout],), s1_ops,
                      combine, reduce_op, pad, r1)
    s2 = _tile_launch(tuple(f"o{i}" for i in range(nout)), out_ext, ("k",),
                      (kx,), s2_ops, combine, reduce_op, pad, r2)
    return s1, s2


def _tile_launch(out_axes, out_ext, red_axes, red_ext, operands, combine,
                 reduce_op, pad, roles, nf=None) -> Launch:
    splits, k_split = tile_splits(_prod(out_ext[:-2]), out_ext[-2],
                                  out_ext[-1], red_ext[0])
    return Launch(nf, out_axes, out_ext, red_axes, red_ext, operands,
                  combine, reduce_op, pad, TILE, roles, splits, k_split)


def merge_contracted(red_axes, red_ext, operands, nout: int):
    """Merge adjacent contracted axes whose strides chain in every operand
    (the outer's stride is the inner's extent times the inner's stride,
    both 0 included) into one axis, outermost first, as one flattened
    index walks them.  Returns ``(red_axes, red_ext, operands)``; a merged
    axis is named by its parts joined with ``*``.  The fold visits the same
    elements in the same order, so the nest's value is unchanged (bit for
    bit for max and min)."""
    axes, ext = list(red_axes), list(red_ext)
    strides = [list(o.strides) for o in operands]
    r = len(ext) - 1
    while r > 0:
        outer, inner = nout + r - 1, nout + r
        if all(st[outer] == ext[r] * st[inner] for st in strides):
            axes[r - 1:r + 1] = [f"{axes[r - 1]}*{axes[r]}"]
            ext[r - 1:r + 1] = [ext[r - 1] * ext[r]]
            for st in strides:
                del st[outer]
        r -= 1
    if len(ext) == len(red_ext):
        return tuple(red_axes), tuple(red_ext), tuple(operands)
    return tuple(axes), tuple(ext), tuple(
        Operand(o.array, o.storage_shape, tuple(st), o.base)
        for o, st in zip(operands, strides))


def _mode(out_ext, red_ext, operands, combine: str = "mul",
          reduce_op: str = "add") -> tuple[int, tuple[int, int]]:
    """Which of K9's paths takes this nest (see ``TILE`` ... ``CHAIN``),
    and for TILE which operand feeds the M side: MAP where every
    contracted extent is 1, then TILE, CHAIN, REDUCE (one contracted
    axis), THREAD for the rest."""
    if all(e == 1 for e in red_ext):
        return MAP, (0, 1)
    roles = _tile_roles(out_ext, red_ext, operands)
    if roles is not None:
        return TILE, roles
    if _chain_stages(out_ext, red_ext, operands, combine, reduce_op,
                     0.0) is not None:
        return CHAIN, (0, 1)
    if len(red_ext) == 1 and _prod(out_ext[:-1]) <= GRID_YZ:
        return REDUCE, (0, 1)
    return THREAD, (0, 1)


def reduce_rows(out_ext, red_ext, operands) -> bool:
    """REDUCE's variant: a warp per output where the contracted axis has
    stride 0 or 1 in every operand and at least a warp's worth of
    elements; else column strips along the last out axis."""
    nout = len(out_ext)
    return red_ext[0] >= 32 and all(abs(o.strides[nout]) <= 1
                                    for o in operands)


def _operands(nf: "E.NormalForm") -> tuple[Operand, ...]:
    ext = nf.extent_map
    axes = tuple(nf.out_axes) + tuple(nf.reduce_axes)
    operands = []
    for leaf in nf.leaves:
        acc = leaf.access(ext)
        operands.append(Operand(leaf.array, leaf.storage_shape(),
                                tuple(acc.coeffs.get(a, 0) for a in axes),
                                acc.const))
    return tuple(operands)


def _nest(nf: "E.NormalForm"):
    """``(out_ext, red_axes, red_ext, operands)`` of a normal form, its
    chaining contracted axes merged (:func:`merge_contracted`)."""
    ext = nf.extent_map
    out_ext = tuple(ext[a] for a in nf.out_axes)
    red_axes, red_ext, operands = merge_contracted(
        tuple(nf.reduce_axes), tuple(ext[a] for a in nf.reduce_axes),
        _operands(nf), len(out_ext))
    return out_ext, red_axes, red_ext, operands


def is_chain(nf: "E.NormalForm") -> bool:
    """Whether K9 contracts this normal form pairwise (CHAIN)."""
    out_ext, _, red_ext, operands = _nest(nf)
    return _mode(out_ext, red_ext, operands, nf.combine,
                 nf.reduce_op)[0] == CHAIN


def describe(bundle: Optional["sched_mod.ScheduleBundle"],
             nf: "E.NormalForm") -> Launch:
    """K9's descriptor for a normal form and its cached bundle.  Applies
    the bundle's padding policy (``bundle_pad_value``: raises for a
    semiring without an inert element where the schedule pads); without a
    bundle (a chain, which reads no schedule blocks), the semiring's inert
    element."""
    pad = sched_mod.bundle_pad_value(bundle) if bundle is not None else \
        semiring.pad_value(nf.combine, nf.reduce_op)
    out_ext, red_axes, red_ext, operands = _nest(nf)
    mode, roles = _mode(out_ext, red_ext, operands, nf.combine, nf.reduce_op)
    common = (nf, tuple(nf.out_axes), out_ext, red_axes, red_ext, operands,
              nf.combine, nf.reduce_op, pad)
    if mode == TILE:
        return _tile_launch(*common[1:], roles, nf=nf)
    if mode == CHAIN:
        stages = _chain_stages(out_ext, red_ext, operands, nf.combine,
                               nf.reduce_op, pad)
        return Launch(*common, CHAIN, stages=stages)
    if mode == REDUCE:
        rows = reduce_rows(out_ext, red_ext, operands)
        splits, k_split = (1, red_ext[0]) if rows else reduce_splits(
            _prod(out_ext[:-1]), out_ext[-1] if out_ext else 1, red_ext[0])
        return Launch(*common, REDUCE, roles, splits, k_split, rows)
    if mode == THREAD:
        return Launch(*common, THREAD, roles,
                      rows=_prod(red_ext) >= THREAD_WARP_MIN)
    return Launch(*common, mode, roles)


def run_descriptor(launch: Launch, *arrays: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Execute a descriptor in plain PyTorch through ``torch.as_strided``
    views of the bound (contiguous) buffers: each operand is read at
    ``base + sum(stride * index)`` over exactly the logical (out +
    contracted) extents, cast to f32, paired left to right with the
    combine op and folded over the contracted axes with the reduce op.
    Materializes the whole nest: small shapes only."""
    if len(arrays) != len(launch.operands):
        raise ValueError(f"descriptor has {len(launch.operands)} operands, "
                         f"got {len(arrays)}")
    size = launch.out_ext + launch.red_ext
    views = []
    for opn, x in zip(launch.operands, arrays):
        if tuple(x.shape) != opn.storage_shape or not x.is_contiguous():
            raise ValueError(f"operand {opn.array!r} expects a contiguous "
                             f"{opn.storage_shape}, got {tuple(x.shape)}")
        views.append(torch.as_strided(x, size, opn.strides,
                                      x.storage_offset() + opn.base).float())
    v = functools.reduce(semiring.combine_def(launch.combine).torch_fn, views)
    if launch.red_ext:
        v = semiring.reduce_def(launch.reduce_op).torch_reducer(
            v, dim=tuple(range(len(launch.out_ext), len(size))))
    return v.to(out_dtype or arrays[0].dtype)


# ---------------------------------------------------------------------------
# the mesh level: the same plan per shard, then the plan's collectives
# ---------------------------------------------------------------------------

def _same_placements(got, want, mesh) -> bool:
    """Placements equal dim for dim, a shard over a mesh dim of size 1
    being a replica."""
    norm = lambda p, s: "R" if s == 1 or p.is_replicate() else p
    return len(got) == len(want) and all(
        norm(a, s) == norm(b, s) for a, b, s in zip(got, want, mesh.shape))


def _local_operand(x: torch.Tensor, entries, want, mesh) -> torch.Tensor:
    """This rank's shard of an operand placed by ``entries``: a DTensor
    already so placed gives its local tensor; a plain tensor is the whole
    operand, as every rank holds it (``shard_map``'s global array), and
    gives its chunk along each sharded dim (:func:`comm.shard_local`,
    whose gradient gathers the chunks again)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import spec_axes
    if isinstance(x, DTensor):
        if not _same_placements(x.placements, want, mesh):
            raise ValueError(f"operand placed {tuple(x.placements)}, the "
                             f"plan reads it as {tuple(want)}: redistribute "
                             f"it first")
        return x.to_local()
    for d, entry in enumerate(entries):
        for axis in spec_axes(entry):
            x = comm.shard_local(x, mesh.get_group(axis), d)
    return x


def emit_shard_map(plan, mesh, local_fn=None, *, out_dtype=None,
                   defer: tuple = ()):
    """Run a ``DistributedPlan`` (``repro.kernels.emit.emit_shard_map``):
    per rank, the plan's per-shard product on this rank's operand shards,
    then the plan's collective schedule on the groups of ``mesh``'s axes.

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` whose axis names and
    sizes are the plan's.  ``local_fn(*shards)`` computes one shard's
    result in f32; by default the per-shard normal form through the route
    ``ops.apply`` takes at those local extents (K1 or K9 on CUDA tensors,
    their plain versions on CPU tensors).  Returns ``fn(*operands) ->
    DTensor`` placed as ``plan.out_placements(mesh)``, in ``out_dtype``
    (default f32).  Operands bind by storage shape as in ``ops.apply``:
    DTensors placed as ``plan.in_placements(mesh)``, or whole tensors
    every rank holds.

    Differentiable where ``local_fn`` is: an operand replicated over a
    mesh axis that the plan shards the work over gets the sum of the
    ranks' partial gradients over that axis, except over the axes named
    in ``defer``, where each rank keeps its own share (a data-parallel
    step reduces those once, over all its parameters)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import spec_axes
    plan.check_mesh(mesh)
    if local_fn is None:
        from repro_torch.kernels import ops
        local_fn = functools.partial(ops.apply_normal_form, plan.local_nf,
                                     out_dtype=torch.float32)
    in_pl, out_pl = plan.in_placements(mesh), plan.out_placements(mesh)
    worked = {axis for _, axis in plan.applied} - set(defer)
    groups = {name: mesh.get_group(name) for name in mesh.mesh_dim_names}

    def call(*operands):
        shards = []
        for x, entries, want in zip(operands, plan.in_entries, in_pl):
            x = _local_operand(x, entries, want, mesh)
            held = {a for e in entries for a in spec_axes(e)}
            for axis in sorted(worked - held):
                x = comm.replicated_in(x, groups[axis])
            shards.append(x.contiguous())
        y = local_fn(*shards)
        for step in plan.collectives:
            group = groups[step.mesh_axis]
            if step.kind == "psum":
                y = comm.psum(y, group)
            elif step.kind == "reduce_scatter":
                y = comm.psum_scatter(y, group, step.out_dim)
            elif step.kind == "all_gather":
                y = comm.gather(y, group, step.out_dim)
            else:
                raise ValueError(f"unknown collective kind {step.kind!r}")
        if out_dtype is not None:
            y = y.to(out_dtype)
        return DTensor.from_local(y, mesh, out_pl, run_check=False)

    return call
