"""MoA shapes, gamma layouts and psi indexing (a copy of the part of
``repro.core.moa`` that the port's derivation uses).

An array is a shape and a flat row-major buffer; ``psi`` is the one
indexing primitive (a partial index selects a subarray); ``gamma_*`` map a
full Cartesian index to a flat offset under a layout (row-major,
column-major, blocked) and ``gamma_*_inverse`` map it back; ``iota(shape)``
enumerates every index, so ``psi(iota(rho x), x) == x``.  Pure Python and
numpy: ``lifting``, ``onf`` and ``schedule`` use these symbolically.
"""
from __future__ import annotations

from functools import reduce
from typing import Sequence, Tuple

import numpy as np

Shape = Tuple[int, ...]
Index = Tuple[int, ...]


def pi(shape: Sequence[int]) -> int:
    """Total component count: the product of the shape vector."""
    return int(reduce(lambda a, b: a * b, (int(s) for s in shape), 1))


def check_index(idx: Sequence[int], shape: Sequence[int]) -> None:
    """Validate a (partial) index ``0 <=* idx <* shape``."""
    if len(idx) > len(shape):
        raise IndexError(f"index {tuple(idx)} longer than shape {tuple(shape)}")
    for axis, (i, s) in enumerate(zip(idx, shape)):
        if not 0 <= i < s:
            raise IndexError(f"index {tuple(idx)} invalid at axis {axis} "
                             f"for shape {tuple(shape)}")


def gamma_row(idx: Sequence[int], shape: Sequence[int]) -> int:
    """Row-major offset: gamma_row(<i,j>; <m,n>) = i*n + j (Horner form)."""
    check_index(idx, shape)
    if len(idx) != len(shape):
        raise IndexError("gamma requires a full index")
    off = 0
    for i, s in zip(idx, shape):
        off = off * s + i
    return off


def gamma_col(idx: Sequence[int], shape: Sequence[int]) -> int:
    """Column-major offset (Fortran layout)."""
    check_index(idx, shape)
    if len(idx) != len(shape):
        raise IndexError("gamma requires a full index")
    off = 0
    for i, s in zip(reversed(tuple(idx)), reversed(tuple(shape))):
        off = off * s + i
    return off


def gamma_row_inverse(offset: int, shape: Sequence[int]) -> Index:
    """Inverse of gamma_row: flat offset -> Cartesian index."""
    n = pi(shape)
    if not 0 <= offset < max(n, 1):
        raise IndexError(f"offset {offset} out of range for shape {tuple(shape)}")
    idx = []
    for s in reversed(tuple(shape)):
        idx.append(offset % s)
        offset //= s
    return tuple(reversed(idx))


def gamma_col_inverse(offset: int, shape: Sequence[int]) -> Index:
    """Inverse of gamma_col: flat offset -> Cartesian index (axis 0 varies
    fastest).  ``gamma_col(i; s) == gamma_row(reverse(i); reverse(s))``: a
    stored row-major (n, k) array read through its transpose is a
    column-major (k, n) view."""
    n = pi(shape)
    if not 0 <= offset < max(n, 1):
        raise IndexError(f"offset {offset} out of range for shape {tuple(shape)}")
    idx = []
    for s in tuple(shape):
        idx.append(offset % s)
        offset //= s
    return tuple(idx)


def gamma_blocked(idx: Sequence[int], shape: Sequence[int],
                  block: Sequence[int]) -> int:
    """Blocked (tiled) layout: each axis dimension-lifted ``d -> (d // b,
    b)``, blocks laid out row-major, each block row-major inside; every
    axis must be divisible by its block."""
    check_index(idx, shape)
    if len(idx) != len(shape) or len(block) != len(shape):
        raise IndexError("gamma_blocked requires full index and block per axis")
    for s, b in zip(shape, block):
        if s % b:
            raise ValueError(f"shape {tuple(shape)} not divisible by block "
                             f"{tuple(block)}")
    outer = [i // b for i, b in zip(idx, block)]
    inner = [i % b for i, b in zip(idx, block)]
    outer_shape = [s // b for s, b in zip(shape, block)]
    return gamma_row(outer, outer_shape) * pi(block) + gamma_row(inner, block)


def rav(x) -> np.ndarray:
    """Flatten row-major (MoA's ``rav``)."""
    return np.reshape(np.asarray(x), (-1,))


def iota(shape: Sequence[int]) -> np.ndarray:
    """All valid indices of ``shape`` in row-major order: an array of shape
    ``(*shape, len(shape))``; ``iota(())`` is the empty index."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return np.zeros((0,), dtype=np.int64)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return np.stack(grids, axis=-1).astype(np.int64)


def psi(idx: Sequence[int], x) -> np.ndarray:
    """The psi indexing function: ``psi(<>, x) == x``, ``psi(<i>, x) ==
    x[i]``, a full index gives a 0-d array."""
    x = np.asarray(x)
    idx = tuple(int(i) for i in idx)
    check_index(idx, x.shape)
    return x[idx]
