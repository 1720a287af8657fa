"""Symbolic loop nests in the paper's operational normal form (ONF): a copy
of the part of ``repro.core.onf`` the port uses.

An ``Onf`` is a loop nest (extents and, after dimension lifting, resource
tags) with one flat affine ``Access`` per operand and for the output
(paper eq. 3/4: ``C[(i*p)+j] += A[(i*n)+k] * B[(k*p)+j]``), and the
semiring's combine/reduce names.  ``execute`` is the numpy oracle,
``key()`` the schedule-cache key, ``lift_loop`` the dimension lift.
The paper's liftings of the GEMM (figs 2, 4, 5), the classical baseline,
the expert GEMM and the blocked Hadamard are built from these.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import semiring


@dataclass(frozen=True)
class Loop:
    """One loop of the nest; ``resource`` tags a lifted loop (None:
    sequential; "proc"/"vector"/"block"/...)."""
    index: str
    extent: int
    resource: Optional[str] = None


@dataclass(frozen=True)
class Access:
    """Flat affine access ``base[const + sum_i coeff[index_i] * index_i]``;
    ``const`` carries psi views (leading indices fixed to constants)."""
    array: str
    coeffs: dict[str, int]
    const: int = 0

    def offset(self, env: dict[str, int]) -> int:
        return self.const + sum(c * env[i] for i, c in self.coeffs.items())

    def stride_in(self, index: str) -> int:
        return self.coeffs.get(index, 0)

    def render(self) -> str:
        terms = [f"({c}*{i})" if c != 1 else i
                 for i, c in self.coeffs.items() if c != 0]
        if self.const:
            terms.append(str(self.const))
        return f"{self.array}[{' + '.join(terms) if terms else '0'}]"


@dataclass(frozen=True)
class Onf:
    """out[...] (reduce)= combine(in_0[...], in_1[...], ...) over the nest;
    ``combine`` / ``reduce_op`` are names in ``core.semiring``."""
    name: str
    loops: tuple[Loop, ...]
    out: Access
    ins: tuple[Access, ...]
    reduce_indices: frozenset[str] = frozenset()
    combine: str = "mul"
    reduce_op: str = "add"

    @property
    def identity(self) -> float:
        """The reduce op's unit: what the output accumulator starts at."""
        return semiring.reduce_def(self.reduce_op).identity

    def init_out(self, n: int, dtype=np.float32) -> np.ndarray:
        """A fresh accumulator buffer for ``execute`` (identity-filled)."""
        return np.full(n, self.identity if self.reduce_indices else 0.0,
                       dtype=dtype)

    def key(self) -> tuple:
        """Canonical hashable key: loops, accesses, semiring, with loop
        names canonicalized positionally (``L0, L1, ...``); ``name`` is
        display-only and excluded."""
        ren = {l.index: f"L{i}" for i, l in enumerate(self.loops)}

        def acc(a: Access) -> tuple:
            return (a.array,
                    tuple(sorted((ren[s], c) for s, c in a.coeffs.items())),
                    a.const)

        return (tuple((ren[l.index], l.extent, l.resource)
                      for l in self.loops),
                acc(self.out), tuple(acc(a) for a in self.ins),
                tuple(sorted(ren[s] for s in self.reduce_indices)),
                self.combine, self.reduce_op)

    def execute(self, out_flat: np.ndarray, *in_flats: np.ndarray
                ) -> np.ndarray:
        """The oracle: walk every point of the nest over flat buffers."""
        comb = semiring.combine_def(self.combine).np_fn
        red = semiring.reduce_def(self.reduce_op).np_fn
        out = np.array(out_flat, copy=True)
        extents = [l.extent for l in self.loops]
        names = [l.index for l in self.loops]
        for flat in np.ndindex(*extents):
            env = dict(zip(names, flat))
            vals = [f[a.offset(env)] for f, a in zip(in_flats, self.ins)]
            v = functools.reduce(comb, vals)
            o = self.out.offset(env)
            if self.reduce_indices:
                out[o] = red(out[o], v)
            else:
                out[o] = v
        return out

    def innermost_strides(self) -> dict[str, int]:
        inner = self.loops[-1].index
        d = {a.array: a.stride_in(inner) for a in self.ins}
        d[self.out.array] = self.out.stride_in(inner)
        return d

    def render_c(self) -> str:
        """The paper's C-like rendering of the nest."""
        lines = []
        indent = ""
        for l in self.loops:
            tag = f"  /* lifted: {l.resource} */" if l.resource else ""
            lines.append(f"{indent}for ({l.index}=0; {l.index}<{l.extent}; "
                         f"{l.index}++){tag}")
            indent += "  "
        if not self.reduce_indices:
            op = "="
        else:
            op = "+=" if self.reduce_op == "add" else f"{self.reduce_op}="
        glyph = {"mul": " * ", "add": " + "}.get(self.combine,
                                                  f" {self.combine} ")
        rhs = glyph.join(a.render() for a in self.ins)
        lines.append(f"{indent}{self.out.render()} {op} {rhs};")
        return "\n".join(lines)


def gemm_onf(m: int, n: int, p: int) -> Onf:
    """Paper eq. (3): loops (i, k, j), so the innermost loop streams B and
    C contiguously."""
    from repro_torch.core import expr as E
    return E.normalize(E.inner("add", "mul", E.arr("A", (m, n)),
                               E.arr("B", (n, p))),
                       name="moa_gemm", out_axes=("i", "j"),
                       reduce_axes=("k",))


def gemm_classical_onf(m: int, n: int, p: int) -> Onf:
    """The row-by-column baseline: ``gemm_onf``'s normal form with the
    sigma loop rotated innermost, loops (i, j, k), so the innermost loop
    strides B by p."""
    import dataclasses
    return reorder_loops(
        dataclasses.replace(gemm_onf(m, n, p), name="classical_gemm"),
        ("i", "j", "k"))


def hadamard_onf(m: int, n: int) -> Onf:
    """Elementwise product: the same nest shape, an empty reduce set."""
    from repro_torch.core import expr as E
    return E.normalize(E.hadamard_expr(m, n), name="hadamard",
                       out_axes=("i", "j"))


def lift_loop(onf: Onf, index: str, factor: int, resource: str,
              outer_first: bool = True) -> Onf:
    """Dimension-lift one loop: i -> (i_o, i_i) with i = i_o*inner + i_i,
    the outer loop tagged with ``resource`` and hoisted to the front.
    Accesses rewrite affinely: coeff(i_o) = coeff(i)*inner, coeff(i_i) =
    coeff(i)."""
    loops, lifted_out, lifted_in = [], None, None
    for l in onf.loops:
        if l.index != index:
            loops.append(l)
            continue
        if l.extent % factor:
            raise ValueError(f"{factor} does not divide extent {l.extent} "
                             f"of {index}")
        inner = l.extent // factor
        lifted_out = Loop(index + "_o", factor, resource)
        lifted_in = Loop(index + "_i", inner, l.resource)
        loops.append(lifted_in)
    if lifted_out is None:
        raise KeyError(index)
    loops = ([lifted_out] + loops) if outer_first else (loops + [lifted_out])
    inner_extent = lifted_in.extent

    def rewrite(a: Access) -> Access:
        if index not in a.coeffs:
            return a
        c = dict(a.coeffs)
        k = c.pop(index)
        c[index + "_o"] = k * inner_extent
        c[index + "_i"] = k
        return Access(a.array, c, a.const)

    red = set(onf.reduce_indices)
    if index in red:
        red.discard(index)
        red |= {index + "_o", index + "_i"}
    return Onf(onf.name + f"+lift({index},{resource})", tuple(loops),
               rewrite(onf.out), tuple(rewrite(a) for a in onf.ins),
               frozenset(red), onf.combine, onf.reduce_op)


def reorder_loops(onf: Onf, order: Sequence[str]) -> Onf:
    """Permute the (sequential) loop nest: accesses are order-independent;
    only the streaming pattern (innermost strides) changes."""
    by_name = {l.index: l for l in onf.loops}
    if sorted(order) != sorted(by_name):
        raise ValueError(f"order {tuple(order)} does not permute "
                         f"{tuple(by_name)}")
    return Onf(onf.name, tuple(by_name[i] for i in order), onf.out, onf.ins,
               onf.reduce_indices, onf.combine, onf.reduce_op)


def gemm_lifted_rows(m: int, n: int, p: int, np_procs: int) -> Onf:
    """Paper fig 4 (ip_rows.c): lift i over processors."""
    return lift_loop(gemm_onf(m, n, p), "i", np_procs, "proc")


def gemm_lifted_cols(m: int, n: int, p: int, rsize: int) -> Onf:
    """Paper fig 5 (ip_cols.c): lift j into groups of ``rsize`` (vector
    registers / thread groups)."""
    if p % rsize:
        raise ValueError(f"rsize {rsize} does not divide p = {p}")
    return lift_loop(gemm_onf(m, n, p), "j", p // rsize, "vector")


def gemm_fully_lifted(m: int, n: int, p: int, *, procs: int, bk: int,
                      bn: int) -> Onf:
    """The paper's full schedule (fig 2): rows over processors, k into
    sigma-blocks (the extra addition loop over blocks), j into register
    groups: a 6-deep nest from the 3-deep ONF."""
    o = gemm_onf(m, n, p)
    o = lift_loop(o, "i", procs, "proc")
    o = lift_loop(o, "k", max(n // bk, 1), "block")
    o = lift_loop(o, "j", max(p // bn, 1), "vector")
    return o


def expert_gemm_onf(e: int, cap: int, d: int, f: int) -> Onf:
    """The capacity-padded MoE expert GEMM,
    ``C[(ee*cap + i)*f + j] += X[(ee*cap + i)*d + k] * W[(ee*d + k)*f + j]``:
    the expert axis batches ``e`` MoA GEMMs over flat row-major buffers."""
    from repro_torch.core import expr as E
    return E.normalize(E.expert_gemm_expr(e, cap, d, f),
                       name="expert_gemm", out_axes=("e", "i", "j"),
                       reduce_axes=("k",))


def expert_gemm_fully_lifted(e: int, cap: int, d: int, f: int, *, bm: int,
                             bk: int, bn: int) -> Onf:
    """One more dimension lift of fig 2: the expert axis lifts fully onto a
    processor resource, then rows, sigma-blocks and register groups."""
    o = expert_gemm_onf(e, cap, d, f)
    o = lift_loop(o, "e", e, "proc")
    o = lift_loop(o, "i", max(cap // bm, 1), "proc")
    o = lift_loop(o, "k", max(d // bk, 1), "block")
    o = lift_loop(o, "j", max(f // bn, 1), "vector")
    return o


def hadamard_lifted(m: int, n: int, *, bm: int, bn: int) -> Onf:
    """Blocked Hadamard: both axes lifted, no sigma loop."""
    o = hadamard_onf(m, n)
    o = lift_loop(o, "i", max(m // bm, 1), "proc")
    o = lift_loop(o, "j", max(n // bn, 1), "vector")
    return o
