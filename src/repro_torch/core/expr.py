"""A lazy MoA expression algebra: compose, then normalize (DNF -> ONF).

A copy of ``repro.core.expr``.  Callers *compose* an expression --

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

A carried-state recurrence (online softmax, the SSD and gated scans,
paged decode) is a ``RecurrentForm``: N such normal forms welded through
one streamed axis, with the typed state monoid (``StateSpec``) the stream
carries.  The eleven forms, ``attention_form`` through
``batched_decode_form``, are the reference's K2-K8 computations; the port's
kernels take their shapes directly, and ``core.schedule`` derives their
schedules and blocks on the port's tables (the static verifier and the
derived chunks read them).
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


# ---------------------------------------------------------------------------
# carried-state recurrences: N welded stages and the typed state monoid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StateSpec:
    """The typed carried-state monoid of a recurrence: ``kind`` names a
    registered init/step/flush body (``kernels.emit`` resolves it — the
    nonlinearity is the kind's business exactly as a semiring name resolves
    to a combine), ``carried`` declares each scratch array as (name, logical
    axes), ``rescale`` marks that every step multiplies the carried state by
    a data-dependent factor (online softmax's ``exp(m_prev - m_new)``,
    SSD's chunk decay, RG-LRU's gate product), and ``exports`` makes the
    final state a kernel output (the SSM/LRU decode caches).

    ``export_names`` restricts *which* carried arrays export (empty = all);
    ``per_step`` names carried arrays exported once **per streamed step**
    rather than once at the end — their output operands gain the streamed
    axis, block-1 and grid-indexed, so each step writes its own slab (the
    forward-pass statistics and per-chunk checkpoints the derived backward
    kernels consume)."""
    kind: str
    carried: Tuple[Tuple[str, Tuple[str, ...]], ...]
    rescale: bool = True
    exports: bool = False
    export_names: Tuple[str, ...] = ()
    per_step: Tuple[str, ...] = ()

    def key(self) -> tuple:
        return (self.kind, self.carried, self.rescale, self.exports,
                self.export_names, self.per_step)

    def exported(self) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
        """The carried entries that become kernel outputs, in carried
        order (``export_names`` filters; empty means all)."""
        if not self.exports:
            return ()
        if not self.export_names:
            return self.carried
        return tuple(c for c in self.carried if c[0] in self.export_names)


#: the online-softmax monoid: running max + denominator per output row, plus
#: the rescaled accumulator — flash attention's carried state
SOFTMAX_STATE = StateSpec("online_softmax",
                          (("m", ("row",)), ("l", ("row",)),
                           ("acc", ("row", "val"))))

#: the SSD (Mamba-2) monoid: one inter-chunk state h per (head, head_dim,
#: state_dim), stepped ``h' = chunk_decay * h + B'(decay . x)`` and exported
#: as the decode cache
SSD_STATE = StateSpec("ssd", (("h", ("h", "p", "n")),), exports=True)

#: the RG-LRU gated monoid: one state per channel, ``h' = a h + b``
GATED_STATE = StateSpec("gated", (("h", ("w",)),), exports=True)


@dataclass(frozen=True)
class RecurrentForm:
    """The composite normal form of a *carried-state recurrence*: N
    single-ONF stages welded through one streamed axis, plus the typed
    monoid the stream carries (``StateSpec``).

    Two shapes of weld, both instances of the same contract:

    * **folding** (online softmax): the streamed axis is an *output* axis of
      the first stage and the sole *reduction* of the last — each streamed
      step computes one block of the intermediate and folds it into the
      carried (m, l, acc) state.  The intermediate (the first leaf of the
      next stage) never leaves VMEM.
    * **chunked scan** (SSD, RG-LRU): the streamed axis is an *output* axis
      of every stage — the sequence axis dimension-lifted ``S -> (chunks,
      chunk_len)`` with the chunk index streamed.  Each step emits its own
      output block and steps the carried state (the inter-chunk ``h``
      recurrence); the state is optionally exported as a final output.

    ``aux`` declares extra operands consumed only by the state monoid (the
    SSD decay inputs ``dA``, the initial state) — they get derived
    BlockSpecs like any stage leaf.  ``window``/``prefix_len`` are
    streamed-axis masking metadata: the emitter derives its block-skip and
    in-block masks from them, so windowed / prefix-LM attention schedules
    are derived rather than falling back to the chunked jnp path.

    ``page_table``/``paged``/``pool_pages`` make the streamed axis a *psi
    view over paged storage*: each leaf named in ``paged`` binds one pool
    buffer of ``pool_pages`` fixed-size slabs (slab length = the streamed
    block), and streamed step ``k`` reads slab ``page_table[k]`` — the
    per-page ``Access.const`` offsets of an index-0 psi view, lowered as a
    static table lookup in the operand's BlockSpec index map instead of a
    gather-copy.  The table is static metadata (it changes only when the
    serving engine allocates a page, never per token) and rides ``key()``.

    This is the artifact ``core.schedule.get_schedule`` accepts alongside a
    plain ``NormalForm``; its ``key()`` keys the same LRU cache.
    """
    name: str
    stages: Tuple[NormalForm, ...]
    stream_axis: str
    state: StateSpec
    aux: Tuple[LeafSpec, ...] = ()
    window: int = 0
    prefix_len: int = 0
    page_table: Tuple[int, ...] = ()
    paged: Tuple[str, ...] = ()
    pool_pages: int = 0
    slot_axis: str = ""

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a RecurrentForm needs at least one stage")
        ext: dict[str, int] = {}
        for nf in self.stages:
            for sym, e in nf.extent_map.items():
                if ext.setdefault(sym, e) != e:
                    raise ValueError(
                        f"axis {sym!r} disagrees between stages "
                        f"({ext[sym]} vs {e})")
        if self.stream_axis not in self.stages[0].out_axes:
            raise ValueError(
                f"stream axis {self.stream_axis!r} is not an output axis of "
                f"the first stage {self.stages[0].out_axes}")
        if self.folding:
            if len(self.stages) < 2:
                raise ValueError("a folding recurrence chains >= 2 stages")
            if self.stages[-1].reduce_axes != (self.stream_axis,):
                raise ValueError(
                    f"the last stage must reduce exactly the stream axis "
                    f"{self.stream_axis!r}, got {self.stages[-1].reduce_axes}")
        else:
            for nf in self.stages:
                if self.stream_axis not in nf.out_axes:
                    raise ValueError(
                        f"chunked-scan stream axis {self.stream_axis!r} must "
                        f"be an output axis of every stage, missing from "
                        f"{nf.out_axes}")
        for prev, nxt in zip(self.stages, self.stages[1:]):
            carrier = nxt.leaves[0]
            c_syms = tuple(t for t, _ in carrier.dims if isinstance(t, str))
            missing = [s for s in prev.out_axes if s not in c_syms]
            if missing:
                raise ValueError(
                    f"stage {nxt.name!r}'s carrier leaf {c_syms} does not "
                    f"cover the previous output axes (missing {missing}) — "
                    "not a welded chain")
            c_ext = dict((t, e) for t, e in carrier.dims
                         if isinstance(t, str))
            for s in prev.out_axes:
                if c_ext[s] != ext[s]:
                    raise ValueError(
                        f"carrier extent of {s!r} ({c_ext[s]}) disagrees "
                        f"with the stage extent ({ext[s]})")
        if (self.window or self.prefix_len) and self.window < 0:
            raise ValueError(f"negative window {self.window}")
        if self.page_table or self.paged or self.pool_pages:
            if not (self.page_table and self.paged and self.pool_pages > 0):
                raise ValueError(
                    "paged streaming needs all three of page_table / paged "
                    "leaf names / pool_pages")
            stacked = bool(self.page_table) and isinstance(
                self.page_table[0], tuple)
            if stacked != bool(self.slot_axis):
                raise ValueError(
                    "a stacked [slot, k] page table and slot_axis come "
                    "together: got "
                    f"slot_axis={self.slot_axis!r}, stacked={stacked}")
            if stacked:
                widths = {len(row) for row in self.page_table}
                if len(widths) != 1:
                    raise ValueError(
                        f"stacked page table is ragged: row lengths {widths}")
                if self.slot_axis == self.stream_axis:
                    raise ValueError(
                        f"slot axis {self.slot_axis!r} cannot be the "
                        "streamed axis")
                for nf in self.stages:
                    if self.slot_axis not in nf.out_axes:
                        raise ValueError(
                            f"slot axis {self.slot_axis!r} must be a lifted "
                            f"output axis of every stage, missing from "
                            f"{nf.out_axes}")
                if len(self.page_table) != ext.get(self.slot_axis):
                    raise ValueError(
                        f"stacked page table names {len(self.page_table)} "
                        f"slots but axis {self.slot_axis!r} has extent "
                        f"{ext.get(self.slot_axis)}")
                entries = [t for row in self.page_table for t in row]
            else:
                entries = list(self.page_table)
            bad = [t for t in entries
                   if not 0 <= int(t) < self.pool_pages]
            if bad:
                raise ValueError(
                    f"page-table entries {bad} outside the pool "
                    f"[0, {self.pool_pages})")
            leaf_names = {l.array for nf in self.stages for l in nf.leaves}
            missing = [a for a in self.paged if a not in leaf_names]
            if missing:
                raise ValueError(
                    f"paged leaves {missing} are not stage leaves")
            for nf in self.stages:
                for l in nf.leaves:
                    if l.array not in self.paged:
                        continue
                    if not l.dims or l.dims[0][0] != self.stream_axis:
                        raise ValueError(
                            f"paged leaf {l.array!r} must store the streamed "
                            f"axis {self.stream_axis!r} as its leading dim, "
                            f"got {l.dims}")
                    if self.slot_axis and any(
                            t == self.slot_axis for t, _ in l.dims):
                        raise ValueError(
                            f"paged leaf {l.array!r} must not carry the slot "
                            f"axis {self.slot_axis!r}: the pool is shared "
                            "storage, slots address it through the stacked "
                            "table")

    @property
    def folding(self) -> bool:
        """True for the online-softmax shape (stream axis folded by the last
        stage); False for the chunked-scan shape (stream axis an output)."""
        return self.stream_axis in self.stages[-1].reduce_axes

    # compat accessors for the two-stage streaming (attention) instance
    @property
    def scores(self) -> NormalForm:
        return self.stages[0]

    @property
    def context(self) -> NormalForm:
        return self.stages[-1]

    def extent_map(self) -> dict[str, int]:
        ext: dict[str, int] = {}
        for nf in self.stages:
            ext.update(nf.extent_map)
        for leaf in self.aux:
            for t, e in leaf.dims:
                if isinstance(t, str):
                    ext.setdefault(t, e)
        return ext

    def key(self) -> tuple:
        """Cache key: every stage's canonical key, the stream axis's
        structural position, the state monoid and the masking metadata."""
        return ("recurrent", tuple(nf.key() for nf in self.stages),
                self.stages[0].out_axes.index(self.stream_axis),
                self.state.key(),
                tuple((l.array, l.dims, l.layout) for l in self.aux),
                self.window, self.prefix_len,
                self.page_table, self.paged, self.pool_pages,
                self.slot_axis)


def StreamingForm(name: str, scores: NormalForm, context: NormalForm,
                  stream_axis: str) -> RecurrentForm:
    """.. deprecated:: the streaming (online-softmax) form is now the
    two-stage folding instance of ``RecurrentForm``; this factory is kept
    for one release."""
    import warnings
    warnings.warn("StreamingForm is deprecated; construct a RecurrentForm "
                  "(or use attention_form)", DeprecationWarning, stacklevel=2)
    return RecurrentForm(name, (scores, context), stream_axis, SOFTMAX_STATE)


def attention_form(b: int, hkv: int, g: int, sq: int, sk: int, hd: int,
                   vd: Optional[int] = None, *, window: int = 0,
                   prefix_len: int = 0) -> RecurrentForm:
    """Normalize the attention expression pair into the online-softmax
    ``RecurrentForm`` instance.

    Axis names: ``(b, h, g, i, j)`` + the score contraction ``c`` (head_dim)
    and the context value axis ``d`` — ``j`` (key position) is the streamed
    axis, an *output* of scores and the *reduction* of context.
    ``window``/``prefix_len`` ride as streamed-axis masking metadata so the
    emitter derives the windowed / prefix-LM block-skip.
    """
    scores, context = attention_expr(b, hkv, g, sq, sk, hd, vd)
    scores_nf = normal_form(scores, name="attn_scores",
                            out_axes=("b", "h", "g", "i", "j"),
                            reduce_axes=("c",))
    context_nf = normal_form(context, name="attn_context",
                             out_axes=("b", "h", "g", "i", "d"),
                             reduce_axes=("j",))
    return RecurrentForm("flash_attention", (scores_nf, context_nf), "j",
                         SOFTMAX_STATE, window=int(window),
                         prefix_len=int(prefix_len))


def ssd_form(b: int, nc: int, q: int, h: int, p: int, n: int) -> RecurrentForm:
    """The Mamba-2 SSD chunked scan as a carried-state recurrence.

    The sequence axis arrives already dimension-lifted ``S -> (c, q)``
    (chunk index x chunk length — ``q`` comes from
    ``solve_recurrence_blocks``, the same a-priori derivation as every other
    block in the repo); the chunk index ``c`` is the streamed axis.  Two
    welded stages, both ordinary ONFs over the *stored* (B, S, ...) model
    buffers read through the chunked view (a pure reshape):

    * ``ssd_scores``:   G[b,c,i,j] = sum_n C[b,c,i,n] * B[b,c,j,n]
    * ``ssd_context``:  y[b,c,i,h,p] = sum_j P[b,c,h,i,j] * X[b,c,j,h,p]

    The intermediate P is the segsum-decay-weighted score block ``G . L`` —
    the SSD monoid's nonlinearity, exactly as softmax's ``exp`` sits between
    attention's two stages; it broadcasts the head axis (L depends on the
    per-head decay), which is why the carrier leaf carries ``h`` while the
    scores output does not.  ``aux`` declares the decay input ``dA``
    (b,c,j,h) and the initial state ``H0`` (b,h,p,n); the carried state
    ``h`` (head, head_dim, state) steps ``h' = chunk_decay * h + B'(decay
    . x)`` across chunks and is exported as the decode cache.
    """
    C = LeafSpec("C", (("b", b), ("c", nc), ("i", q), ("n", n)), "row")
    B = LeafSpec("B", (("b", b), ("c", nc), ("j", q), ("n", n)), "row")
    scores = NormalForm(
        name="ssd_scores", out_axes=("b", "c", "i", "j"), reduce_axes=("n",),
        extents=(("b", b), ("c", nc), ("i", q), ("j", q), ("n", n)),
        leaves=(C, B), combine="mul", reduce_op="add")
    P = LeafSpec("P", (("b", b), ("c", nc), ("h", h), ("i", q), ("j", q)),
                 "row")
    X = LeafSpec("X", (("b", b), ("c", nc), ("j", q), ("h", h), ("p", p)),
                 "row")
    context = NormalForm(
        name="ssd_context", out_axes=("b", "c", "i", "h", "p"),
        reduce_axes=("j",),
        extents=(("b", b), ("c", nc), ("i", q), ("h", h), ("p", p),
                 ("j", q)),
        leaves=(P, X), combine="mul", reduce_op="add")
    dA = LeafSpec("dA", (("b", b), ("c", nc), ("j", q), ("h", h)), "row")
    H0 = LeafSpec("H0", (("b", b), ("h", h), ("p", p), ("n", n)), "row")
    return RecurrentForm("ssd_scan", (scores, context), "c", SSD_STATE,
                         aux=(dA, H0))


#: the forward online-softmax monoid *with exported statistics*: identical
#: body (kind "online_softmax" — same derived blocks, same kernel math),
#: but the carried (m, l) flush as per-row kernel outputs so a derived
#: backward can reconstruct p = exp(s - lse) without re-running the stream
SOFTMAX_STATS_STATE = StateSpec("online_softmax",
                                (("m", ("i",)), ("l", ("i",)),
                                 ("acc", ("i", "d"))),
                                exports=True, export_names=("m", "l"))

#: flash backward dQ: the carried per-row gradient accumulator, streamed
#: over keys exactly as the forward (no rescale — the softmax statistics
#: are already final)
FLASH_DQ_STATE = StateSpec("flash_dq", (("dq", ("i", "c")),), rescale=False)

#: flash backward dK/dV: the transposed weld — rows are key positions, the
#: stream is query positions; dV rides as carried state exported per row
#: block (dK is the main output)
FLASH_DKV_STATE = StateSpec("flash_dkv", (("dv", ("j", "d")),),
                            rescale=False, exports=True,
                            export_names=("dv",))

#: the SSD monoid with per-chunk state checkpoints: same ``ssd`` body, but
#: each streamed step also exports the state *entering* that chunk — the
#: recomputation anchor the derived backward consumes
SSD_CHK_STATE = StateSpec("ssd", (("h", ("h", "p", "n")),
                                  ("h_in", ("h", "p", "n"))),
                          exports=True, per_step=("h_in",))

#: the SSD backward monoid: the inter-chunk state cotangent ``dh`` carried
#: across (reversed) chunks, with the per-chunk projection/decay cotangents
#: exported per streamed step
SSD_BWD_STATE = StateSpec("ssd_backward",
                          (("dh", ("h", "p", "n")), ("dB", ("j", "n")),
                           ("dC", ("i", "n")), ("ddA", ("j", "h"))),
                          rescale=False, exports=True,
                          per_step=("dB", "dC", "ddA"))

#: the gated backward monoid: the reversed recurrence ``z_k = a'_k z_{k-1}
#: + b'_k`` is *itself* a gated scan on flipped operands — degenerate case
GATED_BWD_STATE = StateSpec("gated_backward", (("h", ("w",)),),
                            exports=True)


def attention_stats_form(b: int, hkv: int, g: int, sq: int, sk: int, hd: int,
                         vd: Optional[int] = None, *, window: int = 0,
                         prefix_len: int = 0) -> RecurrentForm:
    """``attention_form`` with the (m, l) statistics exported: the same two
    welded stages and the same ``online_softmax`` kind (so the solver
    derives the *same* (bq, bk) as the plain forward), but the carried
    running max and denominator flush as per-row f32 outputs — the saved
    activations the derived backward kernels reconstruct ``p`` from."""
    scores, context = attention_expr(b, hkv, g, sq, sk, hd, vd)
    scores_nf = normal_form(scores, name="attn_scores",
                            out_axes=("b", "h", "g", "i", "j"),
                            reduce_axes=("c",))
    context_nf = normal_form(context, name="attn_context",
                             out_axes=("b", "h", "g", "i", "d"),
                             reduce_axes=("j",))
    return RecurrentForm("flash_attention_stats", (scores_nf, context_nf),
                         "j", SOFTMAX_STATS_STATE, window=int(window),
                         prefix_len=int(prefix_len))


def attention_dq_form(b: int, hkv: int, g: int, sq: int, sk: int, hd: int,
                      vd: Optional[int] = None, *, window: int = 0,
                      prefix_len: int = 0) -> RecurrentForm:
    """Flash backward dQ as a carried-state recurrence: the same weld shape
    as the forward (rows = query positions, stream = key positions), with
    the recomputed score block as stage 1 and the ``dS . K`` contraction as
    stage 2.  The saved statistics (M, L) and the precomputed row dot
    ``D = rowsum(dO * O)`` ride as aux operands; the monoid's body turns
    the streamed score block into ``dS = p * (dO.Vᵀ - D)`` and folds
    ``dS . K`` into the carried dq accumulator.  K binds twice (stage 1
    recompute and stage 2 contraction) — same buffer, two derived
    BlockSpecs."""
    vd = vd or hd
    Q = LeafSpec("Q", (("b", b), ("i", sq), ("h", hkv), ("g", g),
                       ("c", hd)), "row")
    K = LeafSpec("K", (("b", b), ("j", sk), ("h", hkv), ("c", hd)), "row")
    scores = NormalForm(
        name="dq_scores", out_axes=("b", "h", "g", "i", "j"),
        reduce_axes=("c",),
        extents=(("b", b), ("h", hkv), ("g", g), ("i", sq), ("j", sk),
                 ("c", hd)),
        leaves=(Q, K), combine="mul", reduce_op="add")
    dS = LeafSpec("dS", (("b", b), ("h", hkv), ("g", g), ("i", sq),
                         ("j", sk)), "row")
    out = NormalForm(
        name="dq_out", out_axes=("b", "h", "g", "i", "c"),
        reduce_axes=("j",),
        extents=(("b", b), ("h", hkv), ("g", g), ("i", sq), ("c", hd),
                 ("j", sk)),
        leaves=(dS, K), combine="mul", reduce_op="add")
    dO = LeafSpec("dO", (("b", b), ("i", sq), ("h", hkv), ("g", g),
                         ("d", vd)), "row")
    V = LeafSpec("V", (("b", b), ("j", sk), ("h", hkv), ("d", vd)), "row")
    M = LeafSpec("M", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    L = LeafSpec("L", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    D = LeafSpec("D", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    return RecurrentForm("flash_dq", (scores, out), "j", FLASH_DQ_STATE,
                         aux=(dO, V, M, L, D), window=int(window),
                         prefix_len=int(prefix_len))


def attention_dkv_form(b: int, hkv: int, g: int, sq: int, sk: int, hd: int,
                       vd: Optional[int] = None, *, window: int = 0,
                       prefix_len: int = 0) -> RecurrentForm:
    """Flash backward dK/dV as the *transposed* weld: rows are key
    positions ``j``, the streamed axis is query positions ``i``.  Stage 1
    recomputes the transposed score block ``K . Qᵀ``; stage 2 contracts
    ``dSᵀ . Q`` into the dK output while the monoid folds ``pᵀ . dO`` into
    the carried dV, exported per row block.  Q binds twice; the per-group
    dK/dV land on a ``(b, h, g, j, ...)`` layout the ops layer sums over
    ``g`` (the GQA head-group reduction stays outside the kernel)."""
    vd = vd or hd
    K = LeafSpec("K", (("b", b), ("j", sk), ("h", hkv), ("c", hd)), "row")
    Q = LeafSpec("Q", (("b", b), ("i", sq), ("h", hkv), ("g", g),
                       ("c", hd)), "row")
    scores = NormalForm(
        name="dkv_scores", out_axes=("b", "h", "g", "j", "i"),
        reduce_axes=("c",),
        extents=(("b", b), ("h", hkv), ("g", g), ("j", sk), ("i", sq),
                 ("c", hd)),
        leaves=(K, Q), combine="mul", reduce_op="add")
    dS = LeafSpec("dS", (("b", b), ("h", hkv), ("g", g), ("j", sk),
                         ("i", sq)), "row")
    out = NormalForm(
        name="dkv_out", out_axes=("b", "h", "g", "j", "c"),
        reduce_axes=("i",),
        extents=(("b", b), ("h", hkv), ("g", g), ("j", sk), ("c", hd),
                 ("i", sq)),
        leaves=(dS, Q), combine="mul", reduce_op="add")
    dO = LeafSpec("dO", (("b", b), ("i", sq), ("h", hkv), ("g", g),
                         ("d", vd)), "row")
    V = LeafSpec("V", (("b", b), ("j", sk), ("h", hkv), ("d", vd)), "row")
    M = LeafSpec("M", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    L = LeafSpec("L", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    D = LeafSpec("D", (("b", b), ("h", hkv), ("g", g), ("i", sq)), "row")
    return RecurrentForm("flash_dkv", (scores, out), "i", FLASH_DKV_STATE,
                         aux=(dO, V, M, L, D), window=int(window),
                         prefix_len=int(prefix_len))


def ssd_chk_form(b: int, nc: int, q: int, h: int, p: int,
                 n: int) -> RecurrentForm:
    """``ssd_form`` with per-chunk state checkpoints: the same two welded
    stages and the same ``ssd`` kind, but each streamed step additionally
    exports the inter-chunk state *entering* that chunk (``h_in``,
    (b, nc, h, p, n)) — the recomputation anchors the derived SSD backward
    streams instead of re-scanning the whole sequence."""
    fwd = ssd_form(b, nc, q, h, p, n)
    return RecurrentForm("ssd_scan_chk", fwd.stages, fwd.stream_axis,
                         SSD_CHK_STATE, aux=fwd.aux)


def ssd_bwd_form(b: int, nc: int, q: int, h: int, p: int,
                 n: int) -> RecurrentForm:
    """The SSD backward as a carried-state recurrence over *reversed*
    chunks: stage 1 recomputes the score block ``G = C . Bᵀ``, stage 2 is
    the ``dX`` contraction ``Pᵀ . dY``; the monoid's body replays the
    forward chunk factoring from the saved per-chunk state checkpoints
    (aux ``Hin``) and chains every cotangent — ``dh`` carried across
    chunks (seeded by aux ``dHf``), ``dB``/``dC``/``ddA`` exported per
    streamed step, ``dh0`` flushed at the end."""
    C = LeafSpec("C", (("b", b), ("c", nc), ("i", q), ("n", n)), "row")
    B = LeafSpec("B", (("b", b), ("c", nc), ("j", q), ("n", n)), "row")
    scores = NormalForm(
        name="ssd_bwd_scores", out_axes=("b", "c", "i", "j"),
        reduce_axes=("n",),
        extents=(("b", b), ("c", nc), ("i", q), ("j", q), ("n", n)),
        leaves=(C, B), combine="mul", reduce_op="add")
    P = LeafSpec("P", (("b", b), ("c", nc), ("h", h), ("i", q), ("j", q)),
                 "row")
    dY = LeafSpec("dY", (("b", b), ("c", nc), ("i", q), ("h", h), ("p", p)),
                  "row")
    out = NormalForm(
        name="ssd_bwd_out", out_axes=("b", "c", "j", "h", "p"),
        reduce_axes=("i",),
        extents=(("b", b), ("c", nc), ("j", q), ("h", h), ("p", p),
                 ("i", q)),
        leaves=(P, dY), combine="mul", reduce_op="add")
    X = LeafSpec("X", (("b", b), ("c", nc), ("j", q), ("h", h), ("p", p)),
                 "row")
    dA = LeafSpec("dA", (("b", b), ("c", nc), ("j", q), ("h", h)), "row")
    Hin = LeafSpec("Hin", (("b", b), ("c", nc), ("h", h), ("p", p),
                           ("n", n)), "row")
    dHf = LeafSpec("dHf", (("b", b), ("h", h), ("p", p), ("n", n)), "row")
    return RecurrentForm("ssd_backward", (scores, out), "c", SSD_BWD_STATE,
                         aux=(X, dA, Hin, dHf))


def rglru_bwd_form(b: int, nc: int, q: int, w: int) -> RecurrentForm:
    """The RG-LRU backward recurrence: the reversed cotangent scan
    ``z_k = a'_k z_{k-1} + b'_k`` is *itself* a gated scan on flipped,
    shifted operands — the degenerate (N=1) backward kind shares the
    forward's body verbatim, only the ``StateSpec.kind`` registration
    differs (the ops layer does the flip/shift/unflip)."""
    A = LeafSpec("A", (("b", b), ("c", nc), ("i", q), ("w", w)), "row")
    Bv = LeafSpec("Bv", (("b", b), ("c", nc), ("i", q), ("w", w)), "row")
    stage = NormalForm(
        name="rglru_bwd_stage", out_axes=("b", "c", "i", "w"),
        reduce_axes=(),
        extents=(("b", b), ("c", nc), ("i", q), ("w", w)),
        leaves=(A, Bv), combine="mul", reduce_op="add")
    H0 = LeafSpec("H0", (("b", b), ("w", w)), "row")
    return RecurrentForm("rglru_backward", (stage,), "c", GATED_BWD_STATE,
                         aux=(H0,))


def rglru_form(b: int, nc: int, q: int, w: int) -> RecurrentForm:
    """The RG-LRU gated scan as the degenerate (N=1, contraction-free)
    carried-state recurrence: one elementwise stage over the chunked
    sequence view, streamed over the chunk index, with the per-channel
    state ``h' = a h + b`` carried across chunks and exported.  The stage
    pairs the gate log ``A`` (log-space for the stable in-chunk cumsum) and
    the gated input ``Bv`` — the recurrence itself is the ``gated`` monoid's
    body, exactly as softmax is not part of attention's ONF pair."""
    A = LeafSpec("A", (("b", b), ("c", nc), ("i", q), ("w", w)), "row")
    Bv = LeafSpec("Bv", (("b", b), ("c", nc), ("i", q), ("w", w)), "row")
    stage = NormalForm(
        name="rglru_stage", out_axes=("b", "c", "i", "w"), reduce_axes=(),
        extents=(("b", b), ("c", nc), ("i", q), ("w", w)),
        leaves=(A, Bv), combine="mul", reduce_op="add")
    H0 = LeafSpec("H0", (("b", b), ("w", w)), "row")
    return RecurrentForm("rglru_scan", (stage,), "c", GATED_STATE, aux=(H0,))


#: the windowed-decode monoid: the online-softmax carried state over the
#: *query-group* row axis (decode has one query token; the GQA group axis
#: is the blocked per-row axis), masked dynamically from the runtime
#: position aux instead of statically from the grid step
DECODE_STATE = StateSpec("windowed_decode",
                         (("m", ("g",)), ("l", ("g",)),
                          ("acc", ("g", "d"))))


def windowed_decode_form(hkv: int, g: int, hd: int,
                         vd: Optional[int] = None, *, page: int,
                         view_pages: int, pool_pages: int,
                         page_table: Tuple[int, ...],
                         window: int = 0) -> RecurrentForm:
    """One decode step over a *paged* KV cache as a folding recurrence.

    The single query token's GQA group axis ``g`` is the blocked row axis
    (it must be >= 2 — pure-MHA decode has no blocked per-row axis to fold
    over and the derivation refuses); key positions ``j`` stream with block
    = ``page``, so each streamed step is exactly one page and the K/V
    BlockSpec index maps read ``page_table[k]`` — the per-page psi slab
    offsets — straight from pool storage:

    * ``decode_scores``:  s[h,g,j] = sum_c Q[h,g,c] * K[j,h,c]
    * ``decode_context``: o[h,g,d] = sum_j P[h,g,j] * V[j,h,d]

    K/V carry no ``g`` dim (the GQA zero-coefficient recovery) and store
    the streamed axis leading, as the pools do.  The aux ``POS`` operand
    carries the runtime view-relative query position — masking is dynamic
    (position is data, the table is static), which is what keeps one
    executor per table instead of one per token.  ``window`` > 0 masks
    keys older than ``window`` positions; the engine then only binds the
    ceil(window/page)+1 live pages, making decode O(window) regardless of
    sequence length.
    """
    if g < 2:
        raise ValueError(
            f"windowed_decode folds over the GQA group axis; g={g} leaves "
            "no blocked per-row axis (use the dense decode path)")
    if len(page_table) != view_pages:
        raise ValueError(
            f"page table length {len(page_table)} != view_pages {view_pages}")
    vd = vd or hd
    sk = view_pages * page
    Q = LeafSpec("Q", (("h", hkv), ("g", g), ("c", hd)), "row")
    K = LeafSpec("K", (("j", sk), ("h", hkv), ("c", hd)), "row")
    scores = NormalForm(
        name="decode_scores", out_axes=("h", "g", "j"), reduce_axes=("c",),
        extents=(("h", hkv), ("g", g), ("j", sk), ("c", hd)),
        leaves=(Q, K), combine="mul", reduce_op="add")
    P = LeafSpec("P", (("h", hkv), ("g", g), ("j", sk)), "row")
    V = LeafSpec("V", (("j", sk), ("h", hkv), ("d", vd)), "row")
    context = NormalForm(
        name="decode_context", out_axes=("h", "g", "d"), reduce_axes=("j",),
        extents=(("h", hkv), ("g", g), ("d", vd), ("j", sk)),
        leaves=(P, V), combine="mul", reduce_op="add")
    POS = LeafSpec("POS", (("_pr", 1), ("_pc", 2)), "row")
    return RecurrentForm("windowed_decode", (scores, context), "j",
                         DECODE_STATE, aux=(POS,), window=int(window),
                         page_table=tuple(int(t) for t in page_table),
                         paged=("K", "V"), pool_pages=int(pool_pages))


def batched_decode_form(slots: int, hkv: int, g: int, hd: int,
                        vd: Optional[int] = None, *, page: int,
                        view_pages: int, pool_pages: int,
                        page_tables: Tuple[Tuple[int, ...], ...],
                        window: int = 0) -> RecurrentForm:
    """One decode step for *every* active serving slot as a single folding
    recurrence — ``windowed_decode`` with the slot axis dimension-lifted.

    The slot axis ``s`` is an ordinary lifted output axis on both stages
    (MoA's lifted inner product: the batched product is the same ONF with
    one more lead dimension), so the derivation, the state monoid and the
    kernel body are all ``windowed_decode``'s unchanged — each (s, h) grid
    cell folds exactly the float ops the per-slot kernel folds, which is
    what makes the batched launch bit-identical to N sequential launches.

    What *does* change is addressing: the page table stacks to 2-D
    ``[slot, k]`` static metadata, lowered in the K/V BlockSpec index maps
    as ``(s, k) -> table[s][k]`` — the select-fold now keyed on two grid
    axes.  K/V still bind the one shared pool (no slot dim: slots address
    it only through their table rows), and POS promotes to one int32 row
    per slot, so masking stays runtime data and the executor re-jits only
    when the stacked table changes, never per token.  Engine-side, a dead
    slot is just POS = -1 (every block-skip guard ``k*page <= pos`` is
    then false, so no entry its row names ever folds), which is why
    slot-count changes re-key nothing and a retirement merely reverts the
    table to a previously-seen key.
    """
    if g < 2:
        raise ValueError(
            f"windowed_decode folds over the GQA group axis; g={g} leaves "
            "no blocked per-row axis (use the dense decode path)")
    page_tables = tuple(tuple(int(t) for t in row) for row in page_tables)
    if len(page_tables) != slots:
        raise ValueError(
            f"stacked page table has {len(page_tables)} rows for "
            f"{slots} slots")
    for row in page_tables:
        if len(row) != view_pages:
            raise ValueError(
                f"page table length {len(row)} != view_pages {view_pages}")
    vd = vd or hd
    sk = view_pages * page
    Q = LeafSpec("Q", (("s", slots), ("h", hkv), ("g", g), ("c", hd)),
                 "row")
    K = LeafSpec("K", (("j", sk), ("h", hkv), ("c", hd)), "row")
    scores = NormalForm(
        name="batched_decode_scores", out_axes=("s", "h", "g", "j"),
        reduce_axes=("c",),
        extents=(("s", slots), ("h", hkv), ("g", g), ("j", sk), ("c", hd)),
        leaves=(Q, K), combine="mul", reduce_op="add")
    P = LeafSpec("P", (("s", slots), ("h", hkv), ("g", g), ("j", sk)),
                 "row")
    V = LeafSpec("V", (("j", sk), ("h", hkv), ("d", vd)), "row")
    context = NormalForm(
        name="batched_decode_context", out_axes=("s", "h", "g", "d"),
        reduce_axes=("j",),
        extents=(("s", slots), ("h", hkv), ("g", g), ("d", vd), ("j", sk)),
        leaves=(P, V), combine="mul", reduce_op="add")
    POS = LeafSpec("POS", (("s", slots), ("_pc", 2)), "row")
    return RecurrentForm("batched_decode", (scores, context), "j",
                         DECODE_STATE, aux=(POS,), window=int(window),
                         page_table=page_tables, paged=("K", "V"),
                         pool_pages=int(pool_pages), slot_axis="s")
