"""Mesh-level dimension lifting: logical axis names -> mesh axes
(``repro.distributed.sharding``).

The paper's Definition 3.1 applied at the outermost hardware level: every
tensor axis is (conceptually) split ``size -> (mesh_extent, local)`` and
the outer factor given to a mesh resource.  The table below is the single
source of truth: model code names logical axes only; the sharded train
state, checkpoint resharding and the elastic re-mesh derive from here.

Lifting rules (mesh ("pod", "data", "model")):

    batch        -> ("pod", "data")     data parallelism (+ pod DP)
    seq_sp       -> "model"             sequence parallelism at layer edges
    d_model      -> ("pod", "data")     FSDP: params / optimizer sharded
    d_ff/heads/
    vocab/experts/
    d_inner/lru  -> "model"             tensor / expert parallelism
    everything else -> replicated

A mesh axis is used at most once per spec (first logical axis wins), and
an axis is only assigned if it divides the dimension, else the dim stays
replicated (e.g. 40 heads on a 16-way model axis).

A spec is a plain tuple, one entry a dim: None, a mesh-axis name or a
tuple of names (sharded over them together, the first outermost).
:func:`placements` turns it into ``torch.distributed.tensor`` placements,
one a mesh dim.  The port has no SPMD partitioner to hint, so
:func:`constrain` is a checked identity.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

from repro_torch.core.mesh import from_device_mesh
from repro_torch.core.moa import pi

# logical axis -> candidate mesh axes, in preference order.  Tuple entries
# mean "all together" (e.g. batch over pod AND data).
PARAM_RULES: dict[str, tuple] = {
    "d_ff": ("model",),
    "moe_ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "lru": ("model",),
    "d_model": (("pod", "data"),),          # FSDP axis for parameters
}

ACT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"),),
    "seq_sp": ("model",),
    "kv_seq": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "lru": ("model",),
    "ssm_heads": ("model",),
}


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(from_device_mesh(mesh).axes)


def _resolve(rules: dict, axes: Optional[Sequence[Optional[str]]],
             shape: Sequence[int], mesh) -> tuple:
    if axes is None:
        axes = (None,) * len(shape)
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} logical axes {tuple(axes)} for a "
                         f"rank-{len(shape)} shape {tuple(shape)}")
    sizes = _mesh_axis_sizes(mesh)
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, axes):
        assigned = None
        for cand in rules.get(name or "", ()):
            group = cand if isinstance(cand, tuple) else (cand,)
            group = tuple(g for g in group if g in sizes)
            if not group or any(g in used for g in group):
                continue
            extent = pi([sizes[g] for g in group])
            if extent > 1 and dim % extent == 0:
                assigned = group if len(group) > 1 else group[0]
                used.update(group)
                break
        entries.append(assigned)
    return tuple(entries)


def param_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
               mesh) -> tuple:
    return _resolve(PARAM_RULES, axes, shape, mesh)


def act_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh) -> tuple:
    return _resolve(ACT_RULES, axes, shape, mesh)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (outermost first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec``, one a mesh dim
    in the mesh's order: ``Shard(d)`` where the spec puts the mesh axis on
    tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = from_device_mesh(mesh).axis_names
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            if a not in names:
                raise KeyError(f"spec {tuple(spec)} names mesh axis {a!r}; "
                               f"the mesh has {names}")
            dim_of[a] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def _flat(tree, prefix: str = ""):
    """``(name, leaf)`` of a ``{group: {name: leaf}}`` dict (or a flat
    ``{name: leaf}``), joined by "."."""
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def param_specs(shapes: dict, axes: dict, mesh) -> dict:
    """``{name: spec}`` for ``{name: shape}`` and ``{name: logical
    axes}`` (flat or nested alike)."""
    flat_axes = dict(_flat(axes))
    return {name: param_spec(flat_axes[name], tuple(shape), mesh)
            for name, shape in _flat(shapes)}


def param_placements(tree, axes_tree, mesh) -> dict:
    """``{name: placements}`` (one ``Shard`` / ``Replicate`` a mesh dim)
    of a parameter tree (an ``nn.Module``, or ``{name: tensor or
    shape}``) and its logical axes (``{name: axes}``, nested or flat):
    the port's ``param_shardings``."""
    import torch
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in _flat(tree)}
    return {k: placements(s, mesh)
            for k, s in param_specs(shapes, axes_tree, mesh).items()}


#: the GQA attention leaves read at their chunk over "model" (its heads)
_HEAD_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def heads_keep_groups(heads: int, kv_heads: int, tp: int) -> bool:
    """Whether ``heads`` query heads over ``tp`` ranks give each rank whole
    K/V groups (``heads / kv_heads`` query heads a K/V head): ``heads`` a
    multiple of ``tp``, and either ``kv_heads`` too (each rank its stored
    K/V chunk) or a rank's heads a multiple or a divisor of a group."""
    if heads % tp:
        return False
    if kv_heads % tp == 0:
        return True
    local, group = heads // tp, heads // kv_heads
    return local % group == 0 or group % local == 0


def reads_model_chunk(group: str, leaf: str, shapes: dict, tp: int) -> bool:
    """Whether the sharded train step's layers read parameter ``leaf`` of
    ``group`` (the last part of the group's name as the layer's slice
    names it: ``"attn"``, ``"mlp"``, ``"moe"``, ``"rec"``, ``"mixer"``,
    ...) at its stored chunk over ``"model"`` (``tp`` ranks) rather than
    whole: an MLP's ``wi`` / ``bi`` / ``wo``, the routed and shared
    experts, GQA attention's projections and biases but ``bo`` where each
    rank's query heads read whole K/V groups (:func:`heads_keep_groups` of
    ``shapes``, the group's leaves' shapes, read from their last dims),
    MLA's head-wise ``wq_b`` / ``wkv_b`` / ``wo`` (its latents' leaves
    whole), every RG-LRU leaf (its channels; ``wa`` / ``wi`` their
    columns), Mamba-2's ``norm_scale`` and ``w_out`` where its SSD heads
    divide over ``tp`` (``w_in`` and the conv straddle the ``[z | x | B |
    C | dt]`` split and stay whole), the embedding table and the untied
    head.  The router is read whole.  A leaf the rule table stores
    replicated over ``"model"`` is whole whatever this says."""
    if group.endswith("mlp"):
        return leaf in ("wi", "bi", "wo")
    if group == "moe":
        return leaf in ("wi", "wo", "shared_wi", "shared_wo")
    if group in ("attn", "self_attn", "cross_attn") and "wq_b" in shapes:
        return leaf in ("wq_b", "wkv_b", "wo")
    if group in ("attn", "self_attn", "cross_attn") and "wq" in shapes:
        return leaf in _HEAD_LEAVES and heads_keep_groups(
            shapes["wq"][-2], shapes["wk"][-2], tp)
    if group == "rec":
        return True
    if group == "mixer":
        return leaf in ("norm_scale", "w_out") and \
            shapes["A_log"][-1] % tp == 0
    return (group, leaf) in (("embed", "table"), ("unembed", "w"))


# ---------------------------------------------------------------------------
# the current mesh: activation constraints are checked against it
# ---------------------------------------------------------------------------

class _MeshStack(threading.local):
    def __init__(self):
        self.stack: list = []


_MESH = _MeshStack()


@contextlib.contextmanager
def use_mesh(mesh):
    """Within this block :func:`current_mesh` is ``mesh`` (per thread)."""
    _MESH.stack.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.stack.pop()


def current_mesh():
    return _MESH.stack[-1] if _MESH.stack else None


def constrain(x, *axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names.  The
    port runs one process a rank with no SPMD partitioner to hint, so this
    returns ``x``: with a mesh active it checks that the names fit ``x``'s
    rank and resolves them (divisibility decides, as the rules say)."""
    mesh = current_mesh()
    if mesh is not None:
        act_spec(axes, tuple(x.shape), mesh)
    return x
