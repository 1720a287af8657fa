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

``run_descriptor`` is a plain PyTorch executor of a descriptor through
``torch.as_strided``: it reads exactly the strides, base offsets and
extents that K9 is given (the CPU tests drive it).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
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
#: K9's modes: a 64x64 output tile per block with the contraction staged
#: through shared memory (two operands, one contracted axis, the M side
#: free of the N axis and the N side free of the M axis); a thread per
#: output; a warp per output (one contracted axis, contiguous in every
#: operand that walks it)
TILE, THREAD, WARP = 0, 1, 2
TILE_M = 64
#: the CUDA grid's y and z limit (tile rows, leading out cells)
GRID_YZ = 65535


class K9Desc(ctypes.Structure):
    """The fixed-size descriptor ``csrc/semiring.cu`` takes by value (its
    ``Desc``): out axes right-aligned into 4 slots and contracted axes
    into 3 (extent 1, stride 0 before them, so the last contracted axis is
    the kernel's innermost loop); per operand a stride per slot (out slots
    0-3, contracted 4-6) and a base offset, all int64 elements."""
    _fields_ = [("out_ext", ctypes.c_longlong * MAX_OUT),
                ("red_ext", ctypes.c_longlong * MAX_RED),
                ("stride", (ctypes.c_longlong * (MAX_OUT + MAX_RED)) * MAX_IN),
                ("base", ctypes.c_longlong * MAX_IN),
                ("out_stride", ctypes.c_longlong * MAX_OUT),
                ("in_dtype", ctypes.c_int * MAX_IN),
                ("n_in", ctypes.c_int),
                ("n_red", ctypes.c_int),
                ("out_dtype", ctypes.c_int),
                ("mode", ctypes.c_int),
                ("a_op", ctypes.c_int),
                ("b_op", ctypes.c_int)]


@dataclass(frozen=True)
class Operand:
    """One leaf as K9 reads it: ``strides`` per axis of ``out_axes +
    red_axes`` (0 where the leaf does not walk the axis) and ``base``."""
    array: str
    storage_shape: tuple[int, ...]
    strides: tuple[int, ...]
    base: int


@dataclass(frozen=True)
class Launch:
    """K9's launch descriptor for one normal form."""
    nf: "E.NormalForm"
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

    @property
    def out_strides(self) -> tuple[int, ...]:
        """Row-major strides of the (contiguous) logical output."""
        st, acc = [], 1
        for e in reversed(self.out_ext):
            st.append(acc)
            acc *= e
        return tuple(reversed(st))

    def c_struct(self, in_dtypes, out_dtype) -> K9Desc:
        """Pack for the kernel; raises for what K9 cannot take."""
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
        d = K9Desc()
        lead, rlead = MAX_OUT - nout, MAX_RED - nred
        for s in range(MAX_OUT):
            d.out_ext[s] = self.out_ext[s - lead] if s >= lead else 1
            d.out_stride[s] = self.out_strides[s - lead] if s >= lead else 0
        for s in range(MAX_RED):
            d.red_ext[s] = self.red_ext[s - rlead] if s >= rlead else 1
        for i, (opn, dt) in enumerate(zip(self.operands, in_dtypes)):
            for s in range(MAX_OUT):
                d.stride[i][s] = opn.strides[s - lead] if s >= lead else 0
            for s in range(nred):
                d.stride[i][MAX_OUT + rlead + s] = opn.strides[nout + s]
            d.base[i] = opn.base
            d.in_dtype[i] = DTYPE_CODE[dt]
        d.n_in, d.n_red = nin, nred
        d.out_dtype = DTYPE_CODE[out_dtype]
        d.mode = self.mode
        d.a_op, d.b_op = self.roles
        return d


def _mode(out_ext, red_ext, operands) -> tuple[int, tuple[int, int]]:
    """Which of K9's paths takes this nest (see ``TILE``, ``THREAD``,
    ``WARP``), and for TILE which operand feeds the M side."""
    nout = len(out_ext)
    if len(operands) == 2 and len(red_ext) == 1 and nout >= 2:
        lead = 1
        for e in out_ext[:-2]:
            lead *= e
        if lead <= GRID_YZ and -(-out_ext[-2] // TILE_M) <= GRID_YZ:
            m_ax, n_ax = nout - 2, nout - 1
            for a, b in ((0, 1), (1, 0)):
                if operands[a].strides[n_ax] == 0 and \
                        operands[b].strides[m_ax] == 0:
                    return TILE, (a, b)
    if len(red_ext) == 1 and red_ext[0] >= 32 and all(
            abs(o.strides[nout]) <= 1 for o in operands):
        return WARP, (0, 1)
    return THREAD, (0, 1)


def describe(bundle: "sched_mod.ScheduleBundle",
             nf: "E.NormalForm") -> Launch:
    """K9's descriptor for a normal form and its cached bundle.  Applies
    the bundle's padding policy (``bundle_pad_value``: raises for a
    semiring without an inert element where the schedule pads)."""
    pad = sched_mod.bundle_pad_value(bundle)
    ext = nf.extent_map
    axes = tuple(nf.out_axes) + tuple(nf.reduce_axes)
    operands = []
    for leaf in nf.leaves:
        acc = leaf.access(ext)
        operands.append(Operand(leaf.array, leaf.storage_shape(),
                                tuple(acc.coeffs.get(a, 0) for a in axes),
                                acc.const))
    out_ext = tuple(ext[a] for a in nf.out_axes)
    red_ext = tuple(ext[a] for a in nf.reduce_axes)
    mode, roles = _mode(out_ext, red_ext, operands)
    return Launch(nf, tuple(nf.out_axes), out_ext, tuple(nf.reduce_axes),
                  red_ext, tuple(operands), nf.combine, nf.reduce_op, pad,
                  mode, roles)


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
