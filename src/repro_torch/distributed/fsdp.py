"""The sharded train step's parameter gathers: each leaf is held at its
stored chunk and gathered where a layer reads it (the reference's pjit
step, whose XLA gathers each scanned layer's weights inside the layer).

The step's parameter tree holds the ``DTensor`` of each stored chunk
(``distributed.sharding.param_placements``).  :func:`gather` turns one
into what the layer reads: its chunks all-gathered over the data axes
(``("pod", "data")``, the FSDP dim of ``d_model``), the inner axis
first; over ``"model"`` the stored chunk where a tensor-parallel layer
reads it (``keep_model``; a ``DTensor`` then, replicated over the data
axes), else the whole tensor gathered there too.  Its backward
reduce-scatters the gradient onto the stored chunk, summed in the
gradient's dtype, the outer axis first; over ``"model"`` it takes this
rank's chunk of a gradient every rank holds whole.  A tensor that is not
a ``DTensor`` (serving, one device, the whole-weight planned step) is
returned as it is.

:func:`gather_layer` gathers one layer's slices at the top of its block,
inside the block's ``checkpoint``, so that a remat rerun gathers again;
:func:`regather_saved` (remat off) turns every gathered tensor that
autograd saves for the backward into a regather when it is unpacked.
Either way one layer's gathered weights are alive at a time.

``GATHERED`` counts the bytes of the gathers' outputs alive (a
``weakref.finalize`` on each output's storage) and keeps their
high-water mark; it reads the same on the CPU as on the card.  A copy
made from a gathered weight (the TP MLP's interleave of its gated
columns, :func:`derived`) is regathered like one but not counted.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import reads_model_chunk

#: the mesh axes a batch is split over (data parallelism) and the
#: parameters' FSDP dim is sharded over
DATA_AXES = ("pod", "data")


class Gauge:
    """Bytes alive and their high-water mark since :meth:`reset`."""

    def __init__(self):
        self.alive = 0
        self.high = 0

    def reset(self) -> None:
        self.high = self.alive

    def add(self, n: int) -> None:
        self.alive += n
        self.high = max(self.high, self.alive)

    def sub(self, n: int) -> None:
        self.alive -= n


#: the gathered parameter bytes alive in this process
GATHERED = Gauge()

#: the storage (its data pointer) of each gathered tensor alive, and the
#: function that gathers it again
_REMAKE: dict[int, Callable[[], torch.Tensor]] = {}


def _release(ptr: int, nbytes: int) -> None:
    _REMAKE.pop(ptr, None)
    GATHERED.sub(nbytes)


def _track(t: torch.Tensor, remake, count: bool = True) -> None:
    """Register ``t``'s storage: ``remake()`` gives its values again in
    the same layout; ``count`` adds its bytes to ``GATHERED`` while the
    storage lives."""
    storage = t.untyped_storage()
    nbytes = storage.nbytes() if count else 0
    ptr = storage.data_ptr()
    if not ptr:
        return
    _REMAKE[ptr] = remake
    GATHERED.add(nbytes)
    weakref.finalize(storage, _release, ptr, nbytes)


def _remake_of(t: torch.Tensor) -> Optional[Callable[[], torch.Tensor]]:
    """The regather of a tensor whose storage is a gathered one (``t`` the
    tensor or any view of it), else None."""
    if not _REMAKE or type(t) is not torch.Tensor:
        return None
    remake = _REMAKE.get(t.untyped_storage().data_ptr())
    if remake is None:
        return None
    size, stride, offset = t.size(), t.stride(), t.storage_offset()
    return lambda: remake().as_strided(size, stride, offset)


class _GatherData(torch.autograd.Function):
    """All-gather over ``steps`` (``(group, dim)``, the inner axis first);
    the backward reduce-scatters onto the stored chunk, the outer axis
    first, in the gradient's dtype."""

    @staticmethod
    def forward(ctx, local, steps):
        ctx.steps = steps
        return _gather_raw(local, steps)

    @staticmethod
    def backward(ctx, g):
        for group, dim in reversed(ctx.steps):
            g = comm.reduce_scatter(g, group, dim)
        return g, None


def _gather_raw(local: torch.Tensor, steps) -> torch.Tensor:
    for group, dim in steps:
        local = comm.all_gather(local, group, dim)
    return local


def read_placements(stored, names, keep_model: bool) -> tuple:
    """The placements a layer reads a parameter stored at ``stored`` in
    (one a mesh dim of ``names``): replicated over the data axes; over
    ``"model"`` its stored one where ``keep_model``, else replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(pl if a not in DATA_AXES and (keep_model or a != "model")
                 else Replicate() for a, pl in zip(names, stored))


def _steps(t) -> tuple[list, Optional[tuple]]:
    """``(data steps, model step or None)`` of a ``DTensor`` parameter:
    the ``(group, dim)`` of each data axis it is sharded over (inner
    first), and of its shard over ``"model"``."""
    mesh = t.device_mesh
    steps, model = [], None
    for i, (a, pl) in enumerate(zip(mesh.mesh_dim_names, t.placements)):
        if not pl.is_shard() or mesh.size(i) == 1:
            continue
        if a in DATA_AXES:
            steps.append((mesh.get_group(a), pl.dim))
        elif a == "model":
            model = (mesh.get_group(a), pl.dim)
    return steps[::-1], model


def gather(t: torch.Tensor, keep_model: bool = False) -> torch.Tensor:
    """Parameter ``t`` as a layer reads it (the module docstring): ``t``
    itself unless it is a ``DTensor``; gathered over the data axes; over
    ``"model"`` the ``DTensor`` of its stored chunk where ``keep_model``,
    else gathered whole.  Differentiable: the gradient lands on the
    stored chunk."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    steps, model = _steps(t)
    keep = keep_model and model is not None
    x = t.to_local()
    stored = x.detach()
    if steps:
        x = _GatherData.apply(x, tuple(steps))
    if model is not None and not keep:
        x = comm.gather(x, *model)
    if steps or (model is not None and not keep):
        mstep = None if keep else model

        def remake():
            with torch.no_grad():
                y = _gather_raw(stored, steps)
                return y if mstep is None else comm.all_gather(y, *mstep)
        _track(x, remake)
    if keep:
        return DTensor.from_local(
            x, t.device_mesh, read_placements(
                t.placements, t.device_mesh.mesh_dim_names, True),
            run_check=False)
    return x


def gather_group(group: str, p) -> dict:
    """Every leaf of parameter group ``group`` (the last part of its name:
    ``"attn"``, ``"mlp"``, ``"ln1"``, ...) gathered as its layer reads it
    (``sharding.reads_model_chunk``)."""
    from torch.distributed.tensor import DTensor
    shapes = {k: tuple(v.shape) for k, v in p.items()}
    return {k: gather(v, isinstance(v, DTensor) and reads_model_chunk(
        group, k, shapes, _model_size(v.device_mesh)))
        for k, v in p.items()}


def _model_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def gather_layer(lp: dict) -> dict:
    """One layer's ``{group: {leaf: slice}}`` gathered
    (:func:`gather_group`)."""
    return {g: gather_group(g, p) for g, p in lp.items()}


def gathering(block):
    """``block(lp, ...)`` with ``lp`` gathered at its top
    (:func:`gather_layer`): put inside a ``checkpoint``, the rerun
    gathers again."""
    def run(lp, *args, **kw):
        return block(gather_layer(lp), *args, **kw)
    return run


def derived(fn, *srcs) -> torch.Tensor:
    """``fn(*srcs)``; where a source is a gathered tensor, the result is
    registered to be made again from their regathers when autograd
    unpacks it (:func:`regather_saved`), not counted in ``GATHERED``."""
    out = fn(*srcs)
    remakes = [_remake_of(s) for s in srcs]
    if any(r is not None for r in remakes):
        keep = [None if r is not None else s for r, s in zip(remakes, srcs)]

        def remake():
            with torch.no_grad():
                return fn(*(r() if r is not None else s
                            for r, s in zip(remakes, keep)))
        _track(out, remake, count=False)
    return out


def saved_regathers(leaf: str, dtype: torch.dtype, conv_width: int) -> int:
    """How often the backward regathers a gathered leaf ``leaf`` (of
    ``dtype``) of a layer with remat off (:func:`regather_saved`: one
    regather each time autograd unpacks a saved view of it), by how the
    port's layers read their leaves: a bias only by an add, which saves
    nothing; a norm scale by an f32 product, which saves the leaf itself
    in f32 and, below f32, its f32 copy instead; a depthwise conv's
    weight a tap at a time (``conv_width`` saved slices); any other leaf
    by one product that saves it once."""
    if leaf == "conv_w":
        return conv_width
    if leaf == "scale":
        return int(dtype == torch.float32)
    if leaf in ("bias", "conv_b", "bo", "bi", "bq", "bk", "bv", "ba"):
        return 0
    return 1


def _pack(t: torch.Tensor):
    remake = _remake_of(t)
    return t if remake is None else remake


def _unpack(saved):
    return saved if isinstance(saved, torch.Tensor) else saved()


def regather_saved():
    """A context in which every tensor autograd saves whose storage is a
    gathered parameter's is kept as its regather, not its values (the
    layer's gathered weights are not held for the backward)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
