"""A lazy MoA expression algebra: compose, then normalize (DNF -> ONF).

A copy of the expression part of ``repro.core.expr`` (the reference's
``RecurrentForm`` families stay there: the port's K2-K8 entries take their
shapes directly).  Callers *compose* an expression --

    inner("add", "mul", arr("A", (m, k)), arr("B", (k, n)))          # GEMM
    inner("add", "mul", arr("A", (m, k)), transpose(arr("B", (n, k))))
                                                     # x @ w.T, no relayout
    inner("min", "add", arr("D", (n, n)), arr("D", (n, n)))
                                                     # min-plus shortest path

-- and ``normal_form`` psi-reduces the composed Cartesian indexing into
per-leaf storage indexing (``LeafSpec``), whose ``access`` gives the flat
affine coefficients of the ONF loop nest (paper eq. 3/4): transposes and
psi views rewrite the index mapping, each leaf's gamma layout (row- or
column-major) turns Cartesian indices into flat strides, and the semiring
(combine/reduce names in ``core.semiring``) rides along symbolically.  The
``NormalForm`` is everything downstream: its ``onf().execute`` is the
numpy oracle, its ``key()`` the schedule-cache key, and its leaves'
accesses are what K9 reads in place (``kernels/emit.py``).

The language is exactly as big as ONF: one combine op, one reduce op,
affine indexing; anything larger is rejected at ``normal_form`` time.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core import semiring
from repro_torch.core.onf import Access, Loop, Onf

Shape = Tuple[int, ...]

#: index terms flowing through psi reduction: a loop symbol or a fixed int
_Sym = str
_Term = Union[_Sym, int]

#: (combine, reduce) pairs where combine distributes over reduce -- the
#: semiring law that makes hoisting a nested reduction out of a combine
#: operand sound (normal_form rejects hoists outside this set)
_DISTRIBUTIVE = frozenset({("mul", "add"), ("add", "max"), ("add", "min")})


class Expr:
    """Base class.  ``shape`` is defined per node; operators give sugar:
    ``a @ b`` is the (add, mul) inner product, ``a * b`` / ``a + b`` the
    pointwise combines, ``a.T`` the matrix transpose."""

    shape: Shape = ()

    def __matmul__(self, other: "Expr") -> "Expr":
        return inner("add", "mul", self, other)

    def __mul__(self, other: "Expr") -> "Expr":
        return combine("mul", self, other)

    def __add__(self, other: "Expr") -> "Expr":
        return combine("add", self, other)

    @property
    def T(self) -> "Expr":
        return transpose(self)


@dataclass(frozen=True)
class Arr(Expr):
    """A leaf: named array of a shape, stored through a gamma layout."""
    name: str
    shape: Shape
    layout: str = "row"                    # "row" (gamma_row) | "col" (gamma_col)

    def __post_init__(self):
        if self.layout not in ("row", "col"):
            raise ValueError(f"unknown layout {self.layout!r} (row|col)")
        if any(int(s) <= 0 for s in self.shape):
            raise ValueError(f"non-positive extent in shape {self.shape}")


@dataclass(frozen=True)
class Transpose(Expr):
    """Axis permutation — a pure index rewrite, never a data movement."""
    x: Expr
    perm: Tuple[int, ...]

    def __post_init__(self):
        if sorted(self.perm) != list(range(len(self.x.shape))):
            raise ValueError(
                f"perm {self.perm} is not a permutation of rank "
                f"{len(self.x.shape)}")

    @property
    def shape(self) -> Shape:                        # type: ignore[override]
        return tuple(self.x.shape[p] for p in self.perm)


@dataclass(frozen=True)
class Psi(Expr):
    """A psi view: leading Cartesian indices fixed to constants (MoA's sole
    indexing primitive).  Lowers to a constant term in the flat Access."""
    idx: Tuple[int, ...]
    x: Expr

    def __post_init__(self):
        if len(self.idx) > len(self.x.shape):
            raise IndexError(f"psi index {self.idx} longer than shape "
                             f"{self.x.shape}")
        for axis, (i, s) in enumerate(zip(self.idx, self.x.shape)):
            if not 0 <= i < s:
                raise IndexError(f"psi index {self.idx} invalid at axis "
                                 f"{axis} for shape {self.x.shape}")

    @property
    def shape(self) -> Shape:                        # type: ignore[override]
        return self.x.shape[len(self.idx):]


@dataclass(frozen=True)
class Combine(Expr):
    """Pointwise pairing of two same-shape expressions."""
    op: str
    a: Expr
    b: Expr

    def __post_init__(self):
        semiring.combine_def(self.op)                # fail fast on typos
        if self.a.shape != self.b.shape:
            raise ValueError(f"combine({self.op}) shape mismatch "
                             f"{self.a.shape} vs {self.b.shape}")

    @property
    def shape(self) -> Shape:                        # type: ignore[override]
        return self.a.shape


@dataclass(frozen=True)
class Reduce(Expr):
    """Fold one axis with a reduce op."""
    op: str
    x: Expr
    axis: int

    def __post_init__(self):
        semiring.reduce_def(self.op)
        if not 0 <= self.axis < len(self.x.shape):
            raise ValueError(f"reduce axis {self.axis} out of range for "
                             f"shape {self.x.shape}")

    @property
    def shape(self) -> Shape:                        # type: ignore[override]
        s = self.x.shape
        return s[:self.axis] + s[self.axis + 1:]


@dataclass(frozen=True)
class Inner(Expr):
    """Generalized inner product (Mullin & Raynolds, arXiv:0907.0792):
    ``reduce(plus)`` over the pairing ``times`` of a's last axis with b's
    first (after ``batch`` shared leading axes — the lifted expert axis)."""
    plus: str
    times: str
    a: Expr
    b: Expr
    batch: int = 0

    def __post_init__(self):
        semiring.reduce_def(self.plus)
        semiring.combine_def(self.times)
        sa, sb = self.a.shape, self.b.shape
        nb = self.batch
        if nb < 0 or len(sa) < nb + 1 or len(sb) < nb + 1:
            raise ValueError(f"inner: ranks {sa} x {sb} too small for "
                             f"batch={nb}")
        if sa[:nb] != sb[:nb]:
            raise ValueError(f"inner: batch axes differ {sa[:nb]} vs {sb[:nb]}")
        if sa[-1] != sb[nb]:
            raise ValueError(f"inner: contraction mismatch {sa} . {sb}")

    @property
    def shape(self) -> Shape:                        # type: ignore[override]
        sa, sb = self.a.shape, self.b.shape
        return sa[:-1] + sb[self.batch + 1:]


# ---------------------------------------------------------------------------
# public constructors (the API surface named by the redesign)
# ---------------------------------------------------------------------------

def arr(name: str, shape: Sequence[int], layout: str = "row") -> Arr:
    return Arr(name, tuple(int(s) for s in shape), layout)


def transpose(x: Expr, perm: Optional[Sequence[int]] = None) -> Transpose:
    if perm is None:
        perm = tuple(reversed(range(len(x.shape))))
    return Transpose(x, tuple(int(p) for p in perm))


def psi(idx: Sequence[int], x: Expr) -> Expr:
    idx = tuple(int(i) for i in idx)
    return x if not idx else Psi(idx, x)


def combine(op: str, a: Expr, b: Expr) -> Combine:
    return Combine(op, a, b)


def reduce(op: str, x: Expr, axis: int = 0) -> Reduce:
    return Reduce(op, x, int(axis))


def inner(plus: str, times: str, a: Expr, b: Expr, batch: int = 0) -> Inner:
    return Inner(plus, times, a, b, int(batch))


def matmul_expr(m: int, k: int, n: int, transpose_b: bool = False,
                a_name: str = "A", b_name: str = "B") -> Inner:
    """The canonical 2-D matmul expressions the kernel layer dispatches on.

    With ``transpose_b`` the second operand is the *stored* (n, k) array read
    through its transpose — normalize turns that into column-gamma
    coefficients on B, i.e. a transposed-operand schedule with no relayout
    copy."""
    b = transpose(arr(b_name, (n, k))) if transpose_b else arr(b_name, (k, n))
    return inner("add", "mul", arr(a_name, (m, k)), b)


def expert_gemm_expr(e: int, cap: int, d: int, f: int) -> Inner:
    """The capacity-padded expert GEMM: a batch-1 generalized inner
    product (the MoE slice's ``expert_gemm`` binds it)."""
    return inner("add", "mul", arr("X", (e, cap, d)), arr("W", (e, d, f)),
                 batch=1)


def hadamard_expr(m: int, n: int) -> Combine:
    """Elementwise product — the contraction-degenerate circuit member."""
    return combine("mul", arr("A", (m, n)), arr("B", (m, n)))


def head_gemm_expr(h: int, m: int, k: int, n: int,
                   transpose_b: bool = False) -> Inner:
    """Per-head batched GEMM over a head-MIDDLE weight — the MLA decode
    contractions (``bshr,rhn->bshn`` and its transposed dual).

    Both leaves are read in *stored* layout through transposed views (pure
    index rewrites): X binds its stored ``(m, h, k)`` activation block, W
    the stored ``(k, h, n)`` table (``(n, h, k)`` when ``transpose_b``).
    normalize turns the permutations into strided-but-dense coefficients,
    so the derived schedule blocks both buffers in place.  Result shape
    ``(h, m, n)``.
    """
    x = transpose(arr("X", (m, h, k)), (1, 0, 2))
    w = transpose(arr("W", (n, h, k)), (1, 2, 0)) if transpose_b \
        else transpose(arr("W", (k, h, n)), (1, 0, 2))
    return inner("add", "mul", x, w, batch=1)


def attention_expr(b: int, hkv: int, g: int, sq: int, sk: int, hd: int,
                   vd: Optional[int] = None) -> tuple[Inner, Inner]:
    """The two chained contractions of (grouped-query) attention.

    ``scores = Q · Kᵀ`` and ``context = P · V``, over the loop axes
    ``(b, h, g, i, j)`` — batch, kv-head, group, query position, key
    position.  Every leaf binds its *stored* model layout — Q
    ``(b, sq, hkv, g, hd)`` (the grouped view of the ``(b, sq, hq, hd)``
    projection, a pure reshape with ``hq = hkv * g``), K/V their
    un-repeated ``(b, sk, hkv, hd)`` — and the logical ``(b, h, g, i, ...)``
    views are transposes, i.e. pure index rewrites: the derived BlockSpecs
    walk the stored buffers in place, no relayout copy before the kernel
    (the same property as ``matmul(transpose_b=True)``).  The GQA head
    grouping is nothing but an Access coefficient pattern: K/V carry a
    *zero* coefficient on the group axis ``g``, which is exactly what lets
    ``derive_schedule`` recover the q-head -> kv-head index map instead of
    hand-coding the ``(h % hq) // g`` arithmetic.

    The middle operand ``P`` (the softmax probabilities) is never
    materialized: K2 carries it between the two contractions on chip.
    """
    vd = vd or hd
    q = transpose(arr("Q", (b, sq, hkv, g, hd)), (0, 2, 3, 1, 4))
    kt = transpose(arr("K", (b, sk, hkv, hd)), (0, 2, 3, 1))
    v = transpose(arr("V", (b, sk, hkv, vd)), (0, 2, 1, 3))
    p = arr("P", (b, hkv, g, sq, sk))
    scores = inner("add", "mul", q, kt, batch=2)
    context = inner("add", "mul", p, v, batch=2)
    return scores, context


# ---------------------------------------------------------------------------
# psi reduction: expression -> NormalForm -> Onf
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSpec:
    """One leaf's resolved indexing: per *storage* dimension, the loop symbol
    (or fixed constant) indexing it, plus that dimension's logical extent and
    the leaf's gamma layout.  Enough to rebuild flat affine coefficients at
    any (padded) axis extents."""
    array: str
    dims: Tuple[Tuple[_Term, int], ...]        # ((sym | const, extent), ...)
    layout: str

    def shape(self) -> Shape:
        return tuple(e for _, e in self.dims)

    def storage_shape(self) -> Shape:
        """The physical buffer's row-major shape: a column-major array of
        logical shape s occupies the same flat buffer as a row-major array
        of shape reverse(s) — this is what executors bind operands by."""
        s = self.shape()
        return s if self.layout == "row" else tuple(reversed(s))

    def access(self, extents: dict[str, int]) -> Access:
        """Materialize the flat affine Access under (possibly padded) axis
        extents: gamma_row / gamma_col strides over the storage dims."""
        sizes = [extents.get(t, e) if isinstance(t, str) else e
                 for t, e in self.dims]
        nd = len(sizes)
        strides = []
        for d in range(nd):
            if self.layout == "row":
                s = 1
                for e in sizes[d + 1:]:
                    s *= e
            else:
                s = 1
                for e in sizes[:d]:
                    s *= e
            strides.append(s)
        coeffs: dict[str, int] = {}
        const = 0
        for (t, _), s in zip(self.dims, strides):
            if isinstance(t, str):
                coeffs[t] = coeffs.get(t, 0) + s
            else:
                const += t * s
        return Access(self.array, coeffs, const)


@dataclass(frozen=True)
class NormalForm:
    """The DNF->ONF artifact: loop axes (out + reduce), the semiring, and
    every leaf's resolved storage indexing.  ``onf()`` materializes the
    concrete loop nest — optionally under padded axis extents, which is how
    the schedule builder pads without re-walking the expression."""
    name: str
    out_axes: Tuple[str, ...]
    reduce_axes: Tuple[str, ...]
    extents: Tuple[Tuple[str, int], ...]       # logical extent per loop symbol
    leaves: Tuple[LeafSpec, ...]
    combine: str
    reduce_op: str

    @property
    def extent_map(self) -> dict[str, int]:
        return dict(self.extents)

    def out_shape(self) -> Shape:
        e = self.extent_map
        return tuple(e[s] for s in self.out_axes)

    def leaf_shapes(self) -> Tuple[Shape, ...]:
        return tuple(l.shape() for l in self.leaves)

    def leaf_storage_shapes(self) -> Tuple[Shape, ...]:
        """Physical (row-major buffer) shape per leaf — what callers bind;
        differs from ``leaf_shapes`` only for column-major leaves."""
        return tuple(l.storage_shape() for l in self.leaves)

    def loop_order(self) -> Tuple[str, ...]:
        """The MoA ONF loop order: reduce loops nest just inside the last
        output loop (paper eq. 3's (i, k, j)), so the innermost loop streams
        the output contiguously."""
        if not self.out_axes:
            return self.reduce_axes
        return (self.out_axes[:-1] + self.reduce_axes + self.out_axes[-1:])

    def onf(self, pads: Optional[dict[str, int]] = None,
            name: Optional[str] = None) -> Onf:
        ext = self.extent_map
        for sym, padded in (pads or {}).items():
            if sym not in ext:
                raise KeyError(f"pad for unknown axis {sym!r}")
            if padded < ext[sym]:
                raise ValueError(f"pad {padded} below logical extent "
                                 f"{ext[sym]} of {sym!r}")
            ext[sym] = int(padded)
        out_spec = LeafSpec("C", tuple((s, ext[s]) for s in self.out_axes),
                            "row")
        loops = tuple(Loop(s, ext[s]) for s in self.loop_order())
        return Onf(name or self.name, loops, out_spec.access(ext),
                   tuple(l.access(ext) for l in self.leaves),
                   frozenset(self.reduce_axes), self.combine, self.reduce_op)

    def key(self) -> tuple:
        """The cache key: the *logical* normal form's canonical tuple.

        Memoized on the instance (hot dispatch paths recompute it per call;
        direct ``__dict__`` write keeps the dataclass frozen)."""
        k = self.__dict__.get("_key")
        if k is None:
            k = self.onf().key()
            self.__dict__["_key"] = k
        return k


def _default_axis_names(n: int) -> Tuple[str, ...]:
    pool = ("i", "j", "l", "m", "p", "q", "r", "s")
    if n <= len(pool):
        return pool[:n]
    return tuple(f"i{d}" for d in range(n))


def normal_form(expr: Expr, *, name: str = "expr",
                out_axes: Optional[Sequence[str]] = None,
                reduce_axes: Optional[Sequence[str]] = None) -> NormalForm:
    """Psi-reduce a composed expression to its ONF normal form.

    Walks the tree once, pushing the output's Cartesian index symbols down
    through transposes (permute), psi views (prepend constants) and inner
    products (insert fresh contraction symbols) until they hit leaves, where
    the leaf's gamma layout resolves them to flat affine coefficients.

    Memoized: nodes are frozen (hashable) dataclasses, so hot dispatch paths
    that rebuild the same expression per call get the cached NormalForm (and
    its cached ``key()``) back in O(1).

    Raises ``ValueError`` if the expression mixes combine ops or reduce ops —
    an ONF has exactly one of each.
    """
    return _normal_form_cached(
        expr, name,
        tuple(out_axes) if out_axes is not None else None,
        tuple(reduce_axes) if reduce_axes is not None else None)


@functools.lru_cache(maxsize=1024)
def _normal_form_cached(expr: Expr, name: str,
                        out_axes: Optional[Tuple[str, ...]],
                        reduce_axes: Optional[Tuple[str, ...]]) -> NormalForm:
    nd = len(expr.shape)
    out_syms = tuple(out_axes) if out_axes is not None else _default_axis_names(nd)
    if len(out_syms) != nd:
        raise ValueError(f"{len(out_syms)} axis names for a rank-{nd} result")

    extents: dict[str, int] = dict(zip(out_syms, (int(s) for s in expr.shape)))
    red_names = list(reduce_axes) if reduce_axes is not None else None
    leaves: list[LeafSpec] = []
    red_syms: list[str] = []
    combine_ops: set[str] = set()
    reduce_ops: set[str] = set()
    hoisted = False                # a reduce nested under some combine's operand

    def fresh_reduce(extent: int, op: str) -> str:
        if red_names is not None:
            if len(red_syms) >= len(red_names):
                raise ValueError("fewer reduce_axes names than contractions")
            sym = red_names[len(red_syms)]
        else:
            sym = "k" if not red_syms else f"k{len(red_syms)}"
        if sym in extents:
            raise ValueError(f"duplicate axis name {sym!r}")
        extents[sym] = extent
        red_syms.append(sym)
        reduce_ops.add(op)
        return sym

    def visit(e: Expr, idx: Tuple[_Term, ...], inside: bool) -> None:
        nonlocal hoisted
        if isinstance(e, Arr):
            leaves.append(LeafSpec(
                e.name,
                tuple((t, int(s)) for t, s in zip(idx, e.shape)),
                e.layout))
        elif isinstance(e, Transpose):
            sub: list[_Term] = [0] * len(idx)
            for out_d, t in enumerate(idx):
                sub[e.perm[out_d]] = t
            visit(e.x, tuple(sub), inside)
        elif isinstance(e, Psi):
            visit(e.x, e.idx + idx, inside)
        elif isinstance(e, Combine):
            combine_ops.add(e.op)
            visit(e.a, idx, True)
            visit(e.b, idx, True)
        elif isinstance(e, Reduce):
            hoisted = hoisted or inside
            k = fresh_reduce(e.x.shape[e.axis], e.op)
            visit(e.x, idx[:e.axis] + (k,) + idx[e.axis:], inside)
        elif isinstance(e, Inner):
            hoisted = hoisted or inside
            k = fresh_reduce(e.a.shape[-1], e.plus)
            combine_ops.add(e.times)
            na = len(e.a.shape)
            visit(e.a, idx[:na - 1] + (k,), True)
            visit(e.b, idx[:e.batch] + (k,) + idx[na - 1:], True)
        else:
            raise TypeError(f"not an Expr node: {e!r}")

    visit(expr, tuple(out_syms), False)

    if len(combine_ops) > 1:
        raise ValueError(f"expression mixes combine ops {sorted(combine_ops)} "
                         "— not a single ONF")
    if len(reduce_ops) > 1:
        raise ValueError(f"expression mixes reduce ops {sorted(reduce_ops)} "
                         "— not a single ONF")
    # A reduce nested under a combine's operand gets hoisted to the single
    # loop-nest reduction — sound only when the combine distributes over the
    # reduce (the semiring law): mul over add, add over max/min.  Reject the
    # rest instead of mis-compiling (the root Inner/Reduce needs no law:
    # its reduce is already outermost in the ONF).
    if (hoisted and combine_ops
            and (next(iter(combine_ops)), next(iter(reduce_ops)))
            not in _DISTRIBUTIVE):
        raise ValueError(
            f"reduce op {sorted(reduce_ops)} is nested under combine op "
            f"{sorted(combine_ops)}, which does not distribute over it — "
            "not expressible as a single ONF")

    return NormalForm(
        name=name,
        out_axes=out_syms,
        reduce_axes=tuple(red_syms),
        extents=tuple(extents.items()),
        leaves=tuple(leaves),
        combine=next(iter(combine_ops), "mul"),
        reduce_op=next(iter(reduce_ops), "add"),
    )


def normalize(expr: Expr, *, name: str = "expr",
              out_axes: Optional[Sequence[str]] = None,
              reduce_axes: Optional[Sequence[str]] = None) -> Onf:
    """``normal_form(...).onf()`` in one call — expression to loop nest."""
    return normal_form(expr, name=name, out_axes=out_axes,
                       reduce_axes=reduce_axes).onf()
