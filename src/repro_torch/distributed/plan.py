"""Distributed planning (``repro.distributed.plan``): per-shard plans
derived from the same lifted normal form that drives the kernels.

The paper's dimension lifting stops being a single-chip story here: a
``MeshShape`` (``core/mesh.py``) stacks named device axes on top of the
``HardwareShape``, and :func:`derive_plan` lifts the requested axes of a
normal form one more level, ``size -> (mesh, proc, vector, block)``, then
reads everything a multi-rank execution needs back out of the lifted
normal form:

* **spec entries**: recovered from the lifted Access coefficients.  Each
  operand's storage-dim order is the descending-stride order of its
  affine coefficients (how ``derive_schedule`` recovers its block specs),
  and a storage dim is sharded iff its base axis was mesh-lifted, so a
  transposed operand gets its entry on the right stored dim with no
  special casing;
* **the collective schedule**: a mesh-lifted sigma (reduce) axis makes
  per-rank partial results, so the plan emits a ``psum`` (or a
  ``reduce_scatter`` when a scattered output is asked for); a mesh-lifted
  output axis with ``replicate_out`` emits an ``all_gather``; anything
  else needs no collective;
* **the per-shard schedule**: ``get_schedule`` on the local
  (mesh-divided) extents, in the process-wide schedule cache.

Plans are cached next to schedules, keyed on ``(key(), mesh shape,
sharding request, dtype, hardware)``.  Deriving a plan touches no device
and no process group; :meth:`DistributedPlan.in_placements` /
:meth:`~DistributedPlan.out_placements` give the ``torch.distributed.tensor``
placements, and ``kernels.emit.emit_shard_map`` runs a plan.

Non-divisible axes fall back to replication (recorded in ``dropped`` and
warned) instead of failing, the policy of ``distributed/sharding.py``'s
rule table, derived per expression.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.core import expr as expr_mod
from repro_torch.core import onf as onf_mod
from repro_torch.core import schedule as sched
from repro_torch.core.blocking import dtype_size as _dtype_size
from repro_torch.core.mesh import MeshShape, from_device_mesh, mesh_resource
from repro_torch.core.moa import pi
from repro_torch.core.schedule import ScheduleBundle, _base
from repro_torch.hardware import H100


class ReplicationFallbackWarning(UserWarning):
    """A requested shard axis was not divisible by its mesh axis; the
    operand was replicated instead.  Warned at derivation and reported by
    ``repro_torch.analysis.verify_plan``."""


@dataclass(frozen=True)
class CollectiveStep:
    """One derived collective: ``kind`` over device axis ``mesh_axis``;
    ``out_dim`` is the output storage dim gathered/scattered (None for a
    full psum)."""
    kind: str                       # "psum" | "reduce_scatter" | "all_gather"
    mesh_axis: str
    out_dim: Optional[int] = None


@dataclass(frozen=True)
class DistributedPlan:
    """Everything a per-rank execution needs, derived from one normal form.

    ``in_entries`` / ``out_entries`` are spec entries per *storage*
    dim (None = replicated), matching the binding convention of
    ``ops.apply``; ``out_entries`` describes the output AFTER the collective
    schedule ran.  ``bundle`` is the per-shard ``ScheduleBundle`` (derived on
    local extents, resident in the schedule cache); ``local_nf`` the local
    normal form the plain versions evaluate.
    """
    name: str
    mesh: MeshShape
    applied: tuple[tuple[str, str], ...]       # (axis sym, mesh axis) sharded
    dropped: tuple[tuple[str, str], ...]       # non-divisible -> replicated
    in_entries: tuple[tuple[Optional[str], ...], ...]
    out_entries: tuple[Optional[str], ...]
    collectives: tuple[CollectiveStep, ...]
    local_nf: "expr_mod.NormalForm"
    bundle: ScheduleBundle
    out_shape: tuple[int, ...]                 # global logical result shape

    @property
    def collective(self) -> str:
        """The derived collective choice, as an assertable summary."""
        kinds = tuple(s.kind for s in self.collectives)
        return "+".join(kinds) if kinds else "none"

    def local_extent(self, sym: str) -> int:
        return self.local_nf.extent_map[sym]

    # ---- torch.distributed.tensor placements (one a mesh dim) -----------
    def in_placements(self, mesh=None) -> tuple:
        """Each operand's placements on ``mesh`` (default the plan's)."""
        from repro_torch.distributed.sharding import placements
        mesh = self.mesh if mesh is None else mesh
        return tuple(placements(e, mesh) for e in self.in_entries)

    def out_placements(self, mesh=None) -> tuple:
        """The result's placements after the collective schedule."""
        from repro_torch.distributed.sharding import placements
        return placements(self.out_entries,
                          self.mesh if mesh is None else mesh)

    def check_mesh(self, mesh) -> None:
        got = from_device_mesh(mesh)
        if got.axes != self.mesh.axes:
            raise ValueError(
                f"plan {self.name!r} was derived for mesh {self.mesh.axes}, "
                f"got {got.axes}")

    # ---- modeled per-device traffic (benchmarks / capacity planning) -----
    def local_out_shape(self) -> tuple[int, ...]:
        """Per-device result shape AFTER the collective schedule ran (an
        all-gather leaves the full output resident on every device)."""
        out = list(self.out_shape)
        for d, entry in enumerate(self.out_entries):
            if entry is not None:
                out[d] //= self.mesh.axis_size(entry)
        return tuple(out)

    def hbm_bytes_per_device(self, dtype="float32") -> int:
        """Resident bytes per device: local operand shards + the result as
        the collective schedule leaves it."""
        esize = _dtype_size(dtype)
        ws = sum(pi(s) for s in self.local_nf.leaf_storage_shapes())
        ws += max(pi(self.local_nf.out_shape()), pi(self.local_out_shape()))
        return ws * esize

    def ici_bytes_per_device(self, dtype="float32", acc_bytes: int = 4) -> int:
        """Interconnect bytes per device for the derived collective schedule
        (ring algorithms; partial sums travel at accumulator width)."""
        return int(sum(self.ici_bytes_by_kind(dtype, acc_bytes).values()))

    def ici_bytes_by_kind(self, dtype="float32",
                          acc_bytes: int = 4) -> dict[str, float]:
        """:meth:`ici_bytes_per_device` by collective kind (``"psum"``,
        ``"reduce_scatter"``, ``"all_gather"``)."""
        esize = _dtype_size(dtype)
        out_elems = pi(self.out_shape)
        out: dict[str, float] = {}
        for step in self.collectives:
            p = self.mesh.axis_size(step.mesh_axis)
            if p <= 1:
                continue
            if step.kind == "psum":                   # ring all-reduce
                b = 2.0 * (p - 1) / p * out_elems * acc_bytes
            elif step.kind == "reduce_scatter":
                b = (p - 1) / p * out_elems * acc_bytes
            elif step.kind == "all_gather":
                b = (p - 1) / p * out_elems * esize
            else:
                continue
            out[step.kind] = out.get(step.kind, 0.0) + b
        return out


# ---------------------------------------------------------------------------
# the plan cache — keyed next to the schedule cache, on normal forms
# ---------------------------------------------------------------------------

PLAN_CACHE_SIZE = 128
_cache: "OrderedDict[tuple, DistributedPlan]" = OrderedDict()
_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0}


def plan_cache_stats() -> dict[str, int]:
    with _lock:
        return dict(_stats)


def reset_plan_cache() -> None:
    with _lock:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0


def _spec_entries(a: "onf_mod.Access", shard_axes: dict[str, str],
                  leaf: Optional["expr_mod.LeafSpec"] = None
                  ) -> tuple[Optional[str], ...]:
    """Spec entries recovered from lifted Access coefficients: the
    operand's storage dims are its base axes in descending-stride order (the
    BlockSpec recovery rule), and a dim is sharded iff its axis was
    mesh-lifted.

    ``leaf`` disambiguates psi views: a view fixes dims to constants, which
    contribute NO coefficient — only a constant term ``Access.const`` — so
    the entry sequence must interleave None at each fixed *storage* dim
    (leading for row layout, trailing once a col layout's reversal is
    applied).  Detection is structural (which leaf dims carry a symbol),
    never by ``Access.const`` truthiness: a view at index 0 has
    ``const == 0`` yet still binds its full slab storage.  Fixed dims are
    never sharded.  The constant itself needs no spec plumbing here — the
    per-shard schedule re-derives it at local extents as a BlockSpec
    index-map offset (``OperandSpec.offsets``)."""
    strides: dict[str, int] = {}
    for idx, c in a.coeffs.items():
        if c == 0:
            continue
        b = _base(idx)
        strides[b] = min(strides.get(b, c), c)
    order = sorted(strides, key=lambda b: -strides[b])
    entries = tuple(shard_axes.get(b) for b in order)
    if leaf is None:
        return entries
    dims = leaf.dims if leaf.layout == "row" else tuple(reversed(leaf.dims))
    it = iter(entries)
    return tuple(next(it) if isinstance(t, str) else None for t, _ in dims)


def _local_normal_form(nf: "expr_mod.NormalForm",
                       local_ext: dict[str, int]) -> "expr_mod.NormalForm":
    """The per-shard normal form: every mesh-lifted axis at its local
    extent, leaves included — ready for the existing schedule derivation."""
    leaves = tuple(
        expr_mod.LeafSpec(
            l.array,
            tuple((t, local_ext.get(t, e) if isinstance(t, str) else e)
                  for t, e in l.dims),
            l.layout)
        for l in nf.leaves)
    return expr_mod.NormalForm(
        name=nf.name + "@shard",
        out_axes=nf.out_axes,
        reduce_axes=nf.reduce_axes,
        extents=tuple((s, local_ext.get(s, e)) for s, e in nf.extents),
        leaves=leaves,
        combine=nf.combine,
        reduce_op=nf.reduce_op)


def derive_plan(expr: Union["expr_mod.Expr", "expr_mod.NormalForm"],
                mesh, *, shard: dict[str, str],
                hardware=None, dtype="float32",
                replicate_out: bool = False,
                scatter_axis: Optional[str] = None,
                acc_dtype: str = "float32",
                name: Optional[str] = None) -> DistributedPlan:
    """Derive the full multi-device plan for a normalizable expression.

    ``shard`` maps normal-form axis symbols to mesh axis names (use
    ``matmul_plan``/``expert_plan`` for role-named fronts).  A requested
    axis whose extent the mesh axis does not divide falls back to
    replication (recorded in ``plan.dropped`` and surfaced as a
    ``ReplicationFallbackWarning`` naming the axis).  ``replicate_out``
    asks for a replicated result (mesh-lifted output axes then emit
    all-gathers); ``scatter_axis`` names an output axis to scatter a sigma
    reduction over (reduce-scatter instead of psum).  ``acc_dtype``
    threads through to the per-shard schedule — the local accumulator is
    widened exactly as on the single-chip path, and legality against the
    hardware table is checked at derivation.
    """
    nf = expr if isinstance(expr, expr_mod.NormalForm) else \
        expr_mod.normal_form(expr, name=name or getattr(expr, "name", None)
                             or "expr")
    mesh = from_device_mesh(mesh)
    hw = getattr(hardware or H100, "shape", hardware or H100)
    hw_name = hw.name
    key = (nf.key(), mesh.axes, tuple(sorted(shard.items())),
           bool(replicate_out), scatter_axis, str(dtype), hw_name,
           str(acc_dtype))
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return hit
        _stats["misses"] += 1

    ext = nf.extent_map
    applied, dropped, used_axes = [], [], set()
    for sym in sorted(shard):
        axis = shard[sym]
        if sym not in ext:
            raise KeyError(f"unknown axis {sym!r}; normal form has "
                           f"{tuple(ext)}")
        p = mesh.axis_size(axis)                 # raises on unknown mesh axis
        if axis in used_axes:
            raise ValueError(f"mesh axis {axis!r} assigned to two axes")
        if ext[sym] % p:
            dropped.append((sym, axis))          # replication fallback
            warnings.warn(
                f"{nf.name}: axis {sym!r} (extent {ext[sym]}) is not "
                f"divisible by mesh axis {axis!r} (size {p}) — operand "
                f"replicated instead of sharded",
                ReplicationFallbackWarning, stacklevel=2)
            continue
        used_axes.add(axis)
        applied.append((sym, axis))
    applied, dropped = tuple(applied), tuple(dropped)
    shard_axes = dict(applied)

    # one more dimension lift: the mesh level, ahead of proc/vector/block
    o = nf.onf()
    for sym, axis in applied:
        o = onf_mod.lift_loop(o, sym, mesh.axis_size(axis),
                              mesh_resource(axis))

    in_entries = tuple(
        _spec_entries(a, shard_axes, leaf=leaf)
        for a, leaf in zip(o.ins, nf.leaves))
    out_entries = list(_spec_entries(o.out, shard_axes))

    # the collective schedule, from which axes were lifted where
    if scatter_axis is not None:
        if scatter_axis not in nf.out_axes:
            raise ValueError(f"scatter_axis {scatter_axis!r} is not an "
                             f"output axis of {nf.out_axes}")
        if not any(sym in nf.reduce_axes for sym, _ in applied):
            raise ValueError(
                "scatter_axis requires a mesh-lifted reduction axis — no "
                "sigma axis is sharded (or it fell back to replication), so "
                "there is nothing to reduce-scatter")
    steps: list[CollectiveStep] = []
    for sym, axis in applied:
        if sym not in nf.reduce_axes:
            continue
        if nf.reduce_op != "add":
            # psum/reduce-scatter ADD partials across devices; summing
            # per-device partial maxes/mins would silently corrupt any
            # other semiring — refuse instead of mis-reducing
            raise ValueError(
                f"mesh-lifting the sigma axis {sym!r} of a "
                f"(combine={nf.combine!r}, reduce={nf.reduce_op!r}) normal "
                "form needs a matching cross-device reduction; only 'add' "
                "(psum / reduce-scatter) is derivable today — shard an "
                "output axis instead")
        if scatter_axis is not None:
            d = nf.out_axes.index(scatter_axis)
            if out_entries[d] is not None:
                raise ValueError(f"scatter_axis {scatter_axis!r} is already "
                                 "mesh-sharded")
            steps.append(CollectiveStep("reduce_scatter", axis, d))
            out_entries[d] = axis
        else:
            steps.append(CollectiveStep("psum", axis))
    if replicate_out:
        for d, entry in enumerate(out_entries):
            if entry is not None and (nf.out_axes[d], entry) in applied:
                steps.append(CollectiveStep("all_gather", entry, d))
                out_entries[d] = None

    local_ext = {sym: ext[sym] // mesh.axis_size(axis)
                 for sym, axis in applied}
    local_nf = _local_normal_form(nf, local_ext)
    bundle = sched.get_schedule(local_nf, dtype=dtype, hardware=hw,
                                acc_dtype=acc_dtype)

    plan = DistributedPlan(
        name=nf.name, mesh=mesh, applied=applied, dropped=dropped,
        in_entries=in_entries, out_entries=tuple(out_entries),
        collectives=tuple(steps), local_nf=local_nf, bundle=bundle,
        out_shape=nf.out_shape())
    with _lock:
        plan = _cache.setdefault(key, plan)
        _cache.move_to_end(key)
        while len(_cache) > PLAN_CACHE_SIZE:
            _cache.popitem(last=False)
        return plan


# ---------------------------------------------------------------------------
# role-named fronts for the canonical expressions
# ---------------------------------------------------------------------------

#: matmul_expr's normal form names its axes (i, j) out + (k) reduce
MATMUL_ROLES = {"m": "i", "n": "j", "k": "k"}
#: expert_gemm_expr's normal form names its axes (i, j, l) out + (k) reduce
EXPERT_ROLES = {"e": "i", "m": "j", "n": "l", "k": "k"}


def _translate(shard: dict[str, str], roles: dict[str, str]) -> dict[str, str]:
    out = {}
    for role, axis in shard.items():
        if axis is None:
            continue
        if role not in roles:
            raise KeyError(f"unknown role {role!r}; valid: {sorted(roles)}")
        out[roles[role]] = axis
    return out


def matmul_plan(m: int, k: int, n: int, mesh, *, shard: dict[str, str],
                transpose_b: bool = False, **kw) -> DistributedPlan:
    """Plan a (possibly transposed-operand) matmul; ``shard`` uses roles
    {"m", "n", "k"} — k is the sigma axis, so sharding it derives the
    psum/reduce-scatter schedule."""
    kw.setdefault("name", "matmul")
    if "scatter_axis" in kw and kw["scatter_axis"] is not None:
        kw["scatter_axis"] = MATMUL_ROLES[kw["scatter_axis"]]
    return derive_plan(expr_mod.matmul_expr(m, k, n, transpose_b=transpose_b),
                       mesh, shard=_translate(shard, MATMUL_ROLES), **kw)


def expert_plan(e: int, cap: int, d: int, f: int, mesh, *,
                shard: dict[str, str], **kw) -> DistributedPlan:
    """Plan the capacity-padded expert GEMM; roles {"e", "m", "n", "k"} —
    sharding "e" is expert parallelism (each device a slice of experts)."""
    kw.setdefault("name", "expert_gemm")
    return derive_plan(expr_mod.expert_gemm_expr(e, cap, d, f), mesh,
                       shard=_translate(shard, EXPERT_ROLES), **kw)


# ---------------------------------------------------------------------------
# the planned-mesh context: models route their matmuls through derived
# plans when one is active (train/serve opt in; bare CPU runs unaffected)
# ---------------------------------------------------------------------------

#: the active ``(mesh, deferred axes)``, innermost last.  Process-wide,
#: not per thread: one process is one rank, and a checkpointed layer's
#: recompute, which autograd runs in a thread of its own on the card,
#: must take the same planned path as its forward
_PLANNED_MESH: list = []


@contextlib.contextmanager
def planned_mesh(mesh, defer: tuple = ()):
    """Scoped opt-in: inside this context ``models/layers.py`` and
    ``models/moe.py`` (anything consulting :func:`current_planned_mesh`)
    route their products through derived plans on ``mesh`` (a
    ``DeviceMesh``), each rank computing its shard.

    The activations a layer receives are this rank's: its rows of the
    batch over the data axes, replicated over the others.  ``defer``
    names mesh axes over which a replicated operand's gradient is left
    partial (this rank's share) for the caller to reduce, as the sharded
    train step reduces every parameter's gradient over the data axes
    once; over any other axis it is summed inside the backward, so the
    gradient each rank holds is the whole one.  The backward runs inside
    the block (a checkpointed layer's recompute re-runs the planned
    layers)."""
    _PLANNED_MESH.append((mesh, tuple(defer)))
    try:
        yield mesh
    finally:
        _PLANNED_MESH.pop()


def current_planned_mesh():
    return _PLANNED_MESH[-1][0] if _PLANNED_MESH else None


def deferred_axes(mesh) -> tuple:
    """The axes :func:`planned_mesh` defers for ``mesh`` (none unless
    ``mesh`` is the active planned mesh)."""
    if _PLANNED_MESH and _PLANNED_MESH[-1][0] is mesh:
        return _PLANNED_MESH[-1][1]
    return ()


def tp_matmul_shard(mesh, kind: str) -> dict[str, str]:
    """Megatron-style role assignment by mesh axis name, divisibility
    handled by the plan's replication fallback: rows ("m") over "data",
    and — per ``kind`` — the output columns ("col") or the contraction
    ("sigma", deriving the TP psum) over "model"."""
    if kind not in ("row", "col", "sigma"):
        raise ValueError(f"unknown kind {kind!r} (row|col|sigma)")
    names = from_device_mesh(mesh).axis_names
    shard: dict[str, str] = {}
    if "data" in names:
        shard["m"] = "data"
    if "model" in names:
        if kind == "col":
            shard["n"] = "model"
        elif kind == "sigma":
            shard["k"] = "model"
    if not shard:
        # silence here would mean every device redundantly computes the
        # full GEMM while the caller believes TP is active — fail loudly
        raise ValueError(
            f"planned-mesh routing expects mesh axes named 'data'/'model'; "
            f"got {names} — pass explicit shard= roles instead")
    return shard
