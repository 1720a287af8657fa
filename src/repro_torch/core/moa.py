"""MoA shapes, gamma layouts and psi indexing (a copy of the part of
``repro.core.moa`` that the port's derivation uses).

An array is a shape and a flat row-major buffer; ``psi`` is the one
indexing primitive (a partial index selects a subarray); ``gamma_*`` map a
full Cartesian index to a flat offset under a layout (row-major,
column-major, blocked) and ``gamma_*_inverse`` map it back; ``iota(shape)``
enumerates every index, so ``psi(iota(rho x), x) == x``.  Pure Python and
numpy: ``lifting``, ``onf`` and ``schedule`` use these symbolically.

Below them, the numpy oracles of the unified operators (Hadamard, outer
and inner product, reduction, Kronecker), the paper's ONF GEMM and its
classical row-by-column baseline over flat buffers, and the symbolic
access-pattern analysis (``AccessTrace``, ``cacheline_traffic``) that the
energy model's classical traffic stands on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import reduce
from typing import Sequence, Tuple

import numpy as np

Shape = Tuple[int, ...]
Index = Tuple[int, ...]


def rho(x) -> Shape:
    """The MoA shape of an array (``rho`` in the paper)."""
    return tuple(int(d) for d in np.shape(x))


def pi(shape: Sequence[int]) -> int:
    """Total component count: the product of the shape vector."""
    return int(reduce(lambda a, b: a * b, (int(s) for s in shape), 1))


def dim(x) -> int:
    """Dimensionality: the length of the shape vector."""
    return len(rho(x))


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


def psi_flat(idx: Sequence[int], x, gamma=gamma_row) -> np.ndarray:
    """ONF form of psi: rav(psi(i, x)) == rav(x)[gamma(i; rho x) ...] —
    resolve a *full* index through the flat layout.  Used by tests to check
    DNF/ONF agreement."""
    x = np.asarray(x)
    return rav(x)[gamma(idx, x.shape)]


# ---------------------------------------------------------------------------
# the four unified operators (DNF semantics, numpy oracle level)
# ---------------------------------------------------------------------------

def hadamard(a, b) -> np.ndarray:
    """Hadamard product: psi distributes over scalar ops (loop fusion)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"hadamard shape mismatch {a.shape} vs {b.shape}")
    return a * b


def outer_product(a, b, op=np.multiply) -> np.ndarray:
    """MoA outer product: shape is catenation of shapes; degenerate form is
    scalar extension."""
    a, b = np.asarray(a), np.asarray(b)
    ar = a.reshape(a.shape + (1,) * b.ndim)
    return op(ar, b)


def reduce_add(x, axis: int = 0) -> np.ndarray:
    """Reduction/contraction along one axis."""
    return np.add.reduce(np.asarray(x), axis=axis)


def inner_product(a, b) -> np.ndarray:
    """MoA inner product (+ over ×): for 2-d this *is* GEMM (paper eq. 5).

    Defined the MoA way: outer product over the contraction pairing followed
    by reduction — for matrices, sum_k of (column k of A) outer (row k of B),
    i.e. the contiguous scalar×row accumulation of paper fig. 1.
    """
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.shape[-1] != b.shape[0]:
        raise ValueError(f"inner product contraction mismatch {a.shape} vs {b.shape}")
    # sum_k outer(a[..., k], b[k, ...]) — evaluated via tensordot for the oracle
    return np.tensordot(a, b, axes=(-1, 0))


def kron(a, b) -> np.ndarray:
    """Kronecker product of matrices via MoA: an outer product followed by a
    dimension-lowering interleave (the (m,p,n,q) -> (m*p, n*q) reshape)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("kron oracle defined for matrices")
    m, n = a.shape
    p, q = b.shape
    op = outer_product(a, b)            # (m, n, p, q)
    return op.transpose(0, 2, 1, 3).reshape(m * p, n * q)


# ---------------------------------------------------------------------------
# ONF GEMM — the paper's eq. (3), executed literally over flat buffers.
# This is the *semantic reference* for the derived GEMM kernels (slow, exact).
# ---------------------------------------------------------------------------

def onf_gemm(a_flat: np.ndarray, b_flat: np.ndarray, m: int, n: int, p: int) -> np.ndarray:
    """C[(i*p)+j] := sum_k A[(i*n)+k] * B[(k*p)+j], all buffers flat row-major.

    Loop order (i, k, j): for each i, walk A's row contiguously (k), and for
    each scalar A[i,k] stream B's row k contiguously (j) into C's row i —
    every access in the inner loop is stride-1 (paper fig. 1).
    """
    a_flat = np.asarray(a_flat).reshape(-1)
    b_flat = np.asarray(b_flat).reshape(-1)
    if a_flat.size != m * n or b_flat.size != n * p:
        raise ValueError("flat buffer sizes disagree with (m, n, p)")
    c = np.zeros(m * p, dtype=np.result_type(a_flat.dtype, b_flat.dtype))
    for i in range(m):
        for k in range(n):
            aik = a_flat[i * n + k]
            c[i * p:(i + 1) * p] += aik * b_flat[k * p:(k + 1) * p]
    return c


def classical_gemm(a_flat: np.ndarray, b_flat: np.ndarray, m: int, n: int, p: int) -> np.ndarray:
    """The row(A)·column(B) formulation — strided access into B (the baseline
    the paper outperforms).  Same result, different memory-access pattern."""
    a_flat = np.asarray(a_flat).reshape(-1)
    b_flat = np.asarray(b_flat).reshape(-1)
    c = np.zeros(m * p, dtype=np.result_type(a_flat.dtype, b_flat.dtype))
    for i in range(m):
        for j in range(p):
            acc = c.dtype.type(0)
            for k in range(n):
                acc += a_flat[i * n + k] * b_flat[k * p + j]   # stride-p walk of B
            c[i * p + j] = acc
    return c


# ---------------------------------------------------------------------------
# symbolic access-pattern analysis (used by cost/energy models + benchmarks)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AccessTrace:
    """Stride summary of the innermost loop of a GEMM formulation."""
    name: str
    a_stride: int
    b_stride: int
    c_stride: int

    @property
    def contiguous(self) -> bool:
        return max(abs(self.a_stride), abs(self.b_stride), abs(self.c_stride)) <= 1


def moa_access_trace(m: int, n: int, p: int) -> AccessTrace:
    """MoA ONF inner loop (over j): A held scalar, B stride 1, C stride 1."""
    return AccessTrace("moa", 0, 1, 1)


def classical_access_trace(m: int, n: int, p: int) -> AccessTrace:
    """Classical inner loop (over k): A stride 1, B stride p, C held scalar."""
    return AccessTrace("classical", 1, p, 0)


def cacheline_traffic(trace: AccessTrace, m: int, n: int, p: int,
                      line_elems: int = 8) -> int:
    """Distinct cache-line (or DMA burst) fetches issued by the innermost
    loops over a full GEMM, for a line of ``line_elems`` elements.  This is
    the quantity the paper's contiguity argument minimizes."""
    def lines(total_iters: int, stride: int) -> int:
        if stride == 0:                 # operand held in a register all loop
            return 0
        return total_iters * min(abs(stride), line_elems) // line_elems
    inner = m * n * p
    return (lines(inner, trace.a_stride)
            + lines(inner, trace.b_stride)
            + lines(inner, trace.c_stride))


def divisors_pairs(total: int) -> list[tuple[int, int]]:
    """All (outer, inner) factorizations of ``total`` — candidate liftings."""
    out = []
    for b in range(1, int(math.isqrt(total)) + 1):
        if total % b == 0:
            out.append((total // b, b))
            if b != total // b:
                out.append((b, total // b))
    return sorted(out)
