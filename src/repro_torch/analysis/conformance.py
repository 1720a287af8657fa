"""Launch-plan conformance: prove, on the host, that what the port launches
for a normal form obeys the derived schedule.

The reference traces its emitted Pallas kernel body into a jaxpr and
checks the body's effects against the schedule (``repro.analysis.
conformance``, behind ``verify="kernel"``).  The port's kernels are
written by hand, so there is no body to trace; what the host decides for
a launch is its plan: ``kernels.ops._plan`` picks K1 (with its transpose
and batching flags) or K9, and for K9 ``kernels.emit.describe`` builds the
descriptor the kernel reads (logical extents, an element stride per axis
and a base offset per operand, the path, its split of the contracted axis
and the masking value).  This module checks that plan against the bundle
with typed ``Finding``s in five rule classes:

* ``coverage`` -- every element of the output is written exactly once and
  the contracted extent is folded exactly once: the descriptor's extents
  are the normal form's, TILE's and REDUCE's splits (``emit.tile_splits``,
  ``reduce_splits``) cover the contracted axis with no empty split and no
  16-deep TILE slab staged by two splits, a path that folds no splits has
  none, MAP folds nothing, a chain's two stages meet through a scratch
  of the first stage's extent, and a factored nest's two stages fold the
  contracted volume between them; K1's own split of k (``ops.fma_splits``,
  ``gemv_splits``) covers its k units once;
* ``bounds`` -- every operand's strides times (extent - 1) plus its base
  stays inside its storage buffer (a psi slab's base inside its pool, the
  chain's scratch inside its allocation), and the split partials inside
  the workspace;
* ``pad-value`` -- where the bundle pads, the masking value is the
  bundle's inert element (``bundle_pad_value``);
* ``acc-dtype`` -- the route's accumulator is the bundle's ``acc_dtype``:
  K9 accumulates in f32, or exactly in int32 on int8 operands under
  (mul, add) (its integer accumulator, ``emit.k9_acc``); K1 in f32, or
  exactly in int32 on its int8 form;
* ``route`` -- a K1 plan's transposes and batching are ``ops._k1_form`` of
  the normal form, and the form's route rule gives K1 that route; a K9
  TILE plan's M- and N-side operands are the nest's.

``kernel_findings`` is what ``analysis.verify_bundle(..., kernel=True)``
and ``kernels.ops.apply(..., verify="kernel")`` run; ``plan_findings``
checks a given (possibly mutated) plan.
"""
from __future__ import annotations

import math

import torch

from repro_torch.analysis.verify import Finding
from repro_torch.core import schedule as sched_mod
from repro_torch.core import semiring
from repro_torch.hardware import H100
from repro_torch.kernels import emit, ops


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= x
    return p


def _same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _split_findings(subject, what, extent, splits, k_split, slab=0):
    """The ranges ``[s k_split, min(extent, (s + 1) k_split))`` of
    ``splits`` splits (the kernels' own rule) must cover ``[0, extent)``
    once, none empty; with ``slab``, no slab of that depth may straddle
    two splits (both would stage it)."""
    out = []
    if splits < 1 or (splits > 1 and k_split < 1):
        return [Finding("coverage", "error", subject,
                        f"{what}: {splits} splits of {k_split} elements")]
    if splits == 1:
        return out
    if splits * k_split < extent:
        out.append(Finding(
            "coverage", "error", subject,
            f"{what}: {splits} splits of {k_split} cover {splits * k_split} "
            f"of {extent} contracted elements; [{splits * k_split}, "
            f"{extent}) is folded by none"))
    if (splits - 1) * k_split >= extent:
        out.append(Finding(
            "coverage", "error", subject,
            f"{what}: split {splits - 1} starts at {(splits - 1) * k_split}, "
            f"past the {extent} contracted elements: it covers none, and "
            f"its partial is folded all the same"))
    if slab and k_split % slab:
        out.append(Finding(
            "coverage", "error", subject,
            f"{what}: splits of {k_split} elements end inside a {slab}-deep "
            f"slab, which two splits then both stage and fold"))
    return out


def _bounds_findings(subject, operands, red_ext, out_ext, sizes):
    """Each operand's last element (base plus stride times extent - 1 over
    every axis) inside its buffer of ``sizes[i]`` elements."""
    out = []
    ext = tuple(out_ext) + tuple(red_ext)
    for opn, size in zip(operands, sizes):
        lo = opn.base + sum(s * (e - 1) for s, e in zip(opn.strides, ext)
                            if s < 0)
        hi = opn.base + sum(s * (e - 1) for s, e in zip(opn.strides, ext)
                            if s > 0)
        if lo < 0 or hi >= size:
            out.append(Finding(
                "bounds", "error", subject,
                f"operand {opn.array!r} reads elements [{lo}, {hi}] of its "
                f"{size}-element buffer (base {opn.base}, strides "
                f"{opn.strides})"))
    return out


def _launch_findings(launch, subject, out_ext, red_volume, sizes):
    """Coverage and bounds of one K9 descriptor (a chain's stage too)."""
    out = []
    if tuple(launch.out_ext) != tuple(out_ext):
        short = _prod(launch.out_ext) < _prod(out_ext)
        out.append(Finding(
            "coverage" if short else "bounds", "error", subject,
            f"the descriptor writes an output of {tuple(launch.out_ext)}, "
            f"the normal form's is {tuple(out_ext)}"))
    if _prod(launch.red_ext) != red_volume:
        out.append(Finding(
            "coverage", "error", subject,
            f"the descriptor folds {_prod(launch.red_ext)} contracted "
            f"elements an output, the normal form {red_volume}"))
    if len(launch.operands) != len(sizes):
        out.append(Finding(
            "coverage", "error", subject,
            f"{len(launch.operands)} operands for {len(sizes)} leaves"))
    mode = launch.mode
    if mode == emit.FACTOR:
        first, second = launch.stages
        if launch.tmp_elems < _prod(first.out_ext):
            out.append(Finding(
                "bounds", "error", subject,
                f"the scratch holds {launch.tmp_elems} elements, the first "
                f"stage writes {_prod(first.out_ext)}"))
        folded = _prod(first.red_ext)
        if red_volume % folded:
            out.append(Finding(
                "coverage", "error", subject,
                f"the first stage folds {folded} contracted elements, which "
                f"do not divide the normal form's {red_volume}"))
        out += _launch_findings(first, subject + " (stage 1)",
                                first.out_ext, folded, sizes[:emit.MAX_IN])
        out += _launch_findings(second, subject + " (stage 2)", out_ext,
                                red_volume // folded, (launch.tmp_elems,)
                                + tuple(sizes[emit.MAX_IN:]))
        return out
    if mode == emit.CHAIN:
        first, second = launch.stages
        t_elems = _prod(first.out_ext)
        if launch.tmp_elems < t_elems:
            out.append(Finding(
                "bounds", "error", subject,
                f"the chain's scratch holds {launch.tmp_elems} elements, its "
                f"first stage writes {t_elems}"))
        if first.out_ext[-1] != _prod(second.red_ext):
            out.append(Finding(
                "coverage", "error", subject,
                f"the chain's first stage writes {first.out_ext[-1]} of the "
                f"second stage's {_prod(second.red_ext)} contracted "
                f"elements"))
        out += _launch_findings(first, subject + " (stage 1)",
                                first.out_ext, _prod(first.red_ext),
                                sizes[:2])
        out += _launch_findings(second, subject + " (stage 2)", out_ext,
                                _prod(second.red_ext),
                                (launch.tmp_elems, sizes[2]))
        return out
    out += _bounds_findings(subject, launch.operands, launch.red_ext,
                            launch.out_ext, sizes)
    folds = mode == emit.TILE or (mode == emit.REDUCE and not launch.rows)
    if folds:
        depth = launch.red_ext[-1] if launch.red_ext else 1
        out += _split_findings(
            subject, "K9's split of the contracted axis", depth,
            launch.splits, launch.k_split or depth,
            emit.TILE_K if mode == emit.TILE else 0)
        need = launch.splits * _prod(launch.out_ext)
        if launch.splits > 1 and launch.work_elems < need:
            out.append(Finding(
                "bounds", "error", subject,
                f"{launch.splits} split partials need {need} workspace "
                f"elements, the launch allocates {launch.work_elems}"))
    elif launch.splits != 1:
        out.append(Finding(
            "coverage", "error", subject,
            f"{launch.splits} splits on a path that folds none: each "
            f"output would be written {launch.splits} times"))
    if mode == emit.MAP and any(e != 1 for e in launch.red_ext):
        out.append(Finding(
            "coverage", "error", subject,
            f"MAP folds no contracted axis, but the nest contracts "
            f"{tuple(launch.red_ext)}"))
    if mode == emit.TILE:
        want = emit._tile_roles(launch.out_ext, launch.red_ext,
                                launch.operands)
        if want is not None and tuple(launch.roles) != tuple(want):
            out.append(Finding(
                "route", "error", subject,
                f"TILE's M- and N-side operands {tuple(launch.roles)} are "
                f"not the nest's {tuple(want)}"))
    return out


def _k1_findings(plan, nf, dtypes, subject):
    """Route and coverage of a K1 plan ``("K1", transpose_a, transpose_b,
    batched)``."""
    out = []
    want = ops._k1_form(nf)
    if want is None or tuple(plan[1:]) != tuple(want):
        out.append(Finding(
            "route", "error", subject,
            f"K1 plan (transpose_a, transpose_b, batched) = "
            f"{tuple(plan[1:])}, the normal form's is {want}"))
        return out
    ta, tb, batched = want
    dts = tuple(getattr(torch, d) for d in dtypes[:2])
    shapes = nf.leaf_storage_shapes()
    if batched == "head":
        (m, h, k), w = shapes
        n = w[0] if tb else w[2]
        route = ops.head_route(h, m, k, n, *dts, tb)
        e = h
    elif batched:
        (e, m, k), (_, _, n) = shapes
        route = ops.expert_route(e, m, k, n, *dts)
    else:
        e = 1
        k, m = shapes[0] if ta else shapes[0][::-1]
        n = shapes[1][0] if tb else shapes[1][1]
        try:
            route = ops.gemm_route(m, n, k, *dts, ta, tb)
        except TypeError as exc:
            route = f"refused ({exc})"
    if route not in ops.K1_ROUTES:
        out.append(Finding(
            "route", "error", subject,
            f"K1's route rule gives {route!r} for {dtypes[:2]} at "
            f"{tuple(shapes)}"))
        return out
    if route == "fma":
        f32 = dts[0] == dts[1] == torch.float32
        form = ops.fma_form(m, n, ta, f32)
        nsplit = ops.fma_splits(m, n, k, ta, tb, f32)
        unit = 1 if form == ops.FMA_ROWS else ops.FMA_K
        units = -(-k // unit)
        out += _split_findings(subject, "K1's split of k", units, nsplit,
                               -(-units // nsplit))
    elif route == "gemv":
        units = k // ops.K1_GEMV_UNIT
        nsplit = ops.gemv_splits(m, n, k, e)
        out += _split_findings(subject, "K1's split of k", units, nsplit,
                               -(-units // nsplit))
    return out


def plan_findings(plan, bundle, nf, dtypes,
                  acc_dtype: str = "float32") -> tuple[Finding, ...]:
    """Check one launch plan (``ops._plan``'s ``("K1", ...)`` or ``("K9",
    launch)``) of the normal form ``nf`` on operands of ``dtypes`` against
    its ``bundle`` (None for a chain, which the port runs without a
    derived schedule: then ``acc_dtype`` is the requested accumulator and
    the semiring's inert element the expected pad)."""
    subject = f"{nf.name} ({plan[0]})"
    acc = bundle.acc_dtype if bundle is not None else str(acc_dtype)
    out: list = []
    if plan[0] == "K1":
        route_acc = "int32" if "int8" in dtypes[:2] else "float32"
        if route_acc != acc:
            out.append(Finding(
                "acc-dtype", "error", subject,
                f"K1's route accumulates in {route_acc}, the bundle "
                f"in {acc}"))
        out += _k1_findings(plan, nf, dtypes, subject)
        return tuple(out)
    launch = plan[1]
    try:
        route_acc = str(emit.k9_acc(dtypes, launch.combine,
                                    launch.reduce_op)).removeprefix("torch.")
    except TypeError as exc:
        route_acc = f"none ({exc})"
    if acc != route_acc:
        out.append(Finding(
            "acc-dtype", "error", subject,
            f"K9 accumulates {tuple(dtypes)} under ({launch.combine}, "
            f"{launch.reduce_op}) in {route_acc}; the bundle asks for "
            f"{acc}"))
    try:
        if bundle is None:
            pad, padded = semiring.pad_value(nf.combine, nf.reduce_op), True
        else:
            padded = sched_mod.bundle_needs_padding(bundle)
            pad = sched_mod.bundle_pad_value(bundle) if padded else 0.0
    except ValueError as exc:
        out.append(Finding("pad-value", "error", subject,
                           f"padding without an inert element: {exc}"))
        padded = False
    if padded and not _same(launch.pad_value, pad):
        out.append(Finding(
            "pad-value", "error", subject,
            f"K9 masks with {launch.pad_value!r}, the bundle pads with "
            f"{pad!r}"))
    ext = nf.extent_map
    sizes = tuple(_prod(s) for s in nf.leaf_storage_shapes())
    # the nest's out extents, composing axes merged as K9 reads them
    out += _launch_findings(launch, subject, emit._nest(nf)[1],
                            _prod(ext[a] for a in nf.reduce_axes), sizes)
    return tuple(out)


def kernel_findings(bundle, nf, dtypes, *, hardware=None, blocks=None,
                    acc_dtype: str = "float32",
                    aligned: bool = True) -> tuple[Finding, ...]:
    """The plan ``ops._plan`` makes for ``nf`` on operands of ``dtypes``
    (16-byte aligned bases where ``aligned``), checked against ``bundle``
    (``plan_findings``)."""
    plan = ops._plan(nf, tuple(dtypes), None, hardware or H100, blocks,
                     str(acc_dtype), aligned)
    return plan_findings(plan, bundle, nf, dtypes, acc_dtype)
