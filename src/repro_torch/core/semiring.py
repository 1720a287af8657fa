"""The combine/reduce registry of the normal forms (a copy of
``repro.core.semiring`` with torch callables where the reference names
jnp functions).

A normal form's body is a semiring: a pairing ("combine") op applied
across the operands and an accumulation ("reduce") op folding the
contracted axes.  ``(mul, add)`` is the linear inner product; ``(add,
max)`` / ``(add, min)`` are the tropical semirings.  ``core.onf.Onf.execute``
(the numpy oracle) resolves names through ``np_fn``; ``kernels/ref.py``
through ``torch_fn`` / ``torch_reducer``; K9 (``kernels/emit.py``) through
its own op codes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class CombineDef:
    """A pairing operator: applied between operand elements."""
    name: str
    np_fn: Callable
    torch_fn: Callable             # elementwise torch binary


@dataclass(frozen=True)
class ReduceDef:
    """An accumulation operator: folds a contracted axis from ``identity``
    (0 for add, -inf for max); ``torch_fn`` is the elementwise binary,
    ``torch_reducer`` the axis fold (``dim=`` a tuple of axes)."""
    name: str
    np_fn: Callable
    identity: float
    torch_fn: Callable             # torch.add / torch.maximum / torch.minimum
    torch_reducer: Callable        # torch.sum / torch.amax / torch.amin


_COMBINES: dict[str, CombineDef] = {}
_REDUCES: dict[str, ReduceDef] = {}


def register_combine(d: CombineDef) -> CombineDef:
    _COMBINES[d.name] = d
    return d


def register_reduce(d: ReduceDef) -> ReduceDef:
    _REDUCES[d.name] = d
    return d


def combine_def(name: str) -> CombineDef:
    try:
        return _COMBINES[name]
    except KeyError:
        raise ValueError(
            f"unknown combine op {name!r}; registered: {sorted(_COMBINES)}"
        ) from None


def reduce_def(name: str) -> ReduceDef:
    try:
        return _REDUCES[name]
    except KeyError:
        raise ValueError(
            f"unknown reduce op {name!r}; registered: {sorted(_REDUCES)}"
        ) from None


register_combine(CombineDef("mul", np.multiply, torch.mul))
register_combine(CombineDef("add", np.add, torch.add))

register_reduce(ReduceDef("add", np.add, 0.0, torch.add, torch.sum))
register_reduce(ReduceDef("max", np.maximum, float("-inf"), torch.maximum,
                          torch.amax))
register_reduce(ReduceDef("min", np.minimum, float("inf"), torch.minimum,
                          torch.amin))


#: inert padding per (combine, reduce): padding both operands of a
#: contracted axis with ``v`` contributes the reduce identity,
#: combine(v, v) == identity(reduce)
_PAD_VALUES = {
    ("mul", "add"): 0.0,
    ("add", "add"): 0.0,
    ("add", "max"): float("-inf"),
    ("add", "min"): float("inf"),
}


def pad_value(combine: str, reduce_op: str) -> float:
    """The element to pad contracted axes with so padded blocks are inert."""
    try:
        return _PAD_VALUES[(combine, reduce_op)]
    except KeyError:
        raise ValueError(
            f"no inert padding element known for semiring "
            f"({combine!r}, {reduce_op!r}); pad operands to block multiples "
            "by hand") from None


@dataclass(frozen=True)
class AccumDef:
    """An accumulation dtype entry: which accumulators are legal for which
    input dtypes (and semirings); ``flops_scale`` is the throughput
    multiplier relative to f32 accumulation on the same unit."""
    name: str
    itemsize: int
    inputs: tuple
    flops_scale: float = 1.0


_ACCUMS: dict[str, AccumDef] = {}


def register_accum(d: AccumDef) -> AccumDef:
    _ACCUMS[d.name] = d
    return d


def accum_def(name: str) -> AccumDef:
    try:
        return _ACCUMS[name]
    except KeyError:
        raise ValueError(
            f"unknown accumulation dtype {name!r}; registered: "
            f"{sorted(_ACCUMS)}") from None


def registered_accums() -> tuple:
    return tuple(sorted(_ACCUMS))


register_accum(AccumDef("float32", 4, ("float32", "bfloat16", "float16"), 1.0))
register_accum(AccumDef("bfloat16", 2, ("bfloat16",), 2.0))
register_accum(AccumDef("int32", 4, ("int8",), 4.0))


def check_accum(acc_dtype: str, in_dtype: str, combine: str,
                reduce_op: str) -> AccumDef:
    """Validate an (input dtype, accumulator, semiring) triple: only the
    linear (mul, add) semiring has non-f32 accumulation paths."""
    d = accum_def(acc_dtype)
    if acc_dtype != "float32" and (combine, reduce_op) != ("mul", "add"):
        raise ValueError(
            f"acc_dtype={acc_dtype!r} is only defined for the (mul, add) "
            f"semiring, not ({combine!r}, {reduce_op!r})")
    if in_dtype not in d.inputs:
        raise ValueError(
            f"acc_dtype={acc_dtype!r} does not accept {in_dtype!r} inputs "
            f"(accepts {d.inputs})")
    return d
