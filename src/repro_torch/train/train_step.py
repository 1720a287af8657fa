"""The training step (``repro.train.train_step``): loss and gradients
through the port's kernels, gradient accumulation over microbatches, and
AdamW.

``make_train_step`` has the reference's semantics (with a planned mesh,
its products run through derived plans, ``distributed.plan``): the
forward rematerializes each layer when ``cfg.remat`` is set
(``remat_policy`` "full" or "dots"), every product runs on K1 (its VJP
forms for the gradients), attention on K2 with its (m, l) export and the
K3/K4 backward; the gradients pass through the int8 compression with
error feedback (``distributed.compression``) when it is enabled, then
AdamW. The state is updated IN PLACE (parameters, masters, m, v, the
error state): the returned state holds the same tensors. Metrics stay
device tensors.

    state = init_state(cfg, params, device, comp)
    step = make_train_step(cfg, opt_cfg, comp, microbatches=...)
    state, metrics = step(state, batch)      # batch: {"tokens", "targets"}
                                             # (+ "patches" / "frames")

The sharded step (the counterpart of the reference launcher's
``param_shardings`` + ``jit``) runs one process a rank on a
``DeviceMesh`` with axes ``("data", "model")`` (or ``("pod", "data",
"model")``).  Its state holds ``DTensor``s placed by the rule table
(``distributed.sharding.param_placements`` on ``param_axes``): each
rank stores its chunk of every parameter, f32 master, m, v and error
state.  A step redistributes every parameter to its compute placement:
replicated over the data axes (an all-gather along the FSDP dim); over
``"model"`` the stored chunk where a tensor-parallel layer reads it
(the MLP, the embedding and the head: ``models.layers.
takes_model_chunk``), else whole.  It runs the loss on this rank's rows
under ``planned_mesh`` with the data axes' gradient reduction deferred,
then reduces each gradient over the data axes onto the stored chunk (a
reduce-scatter along the FSDP dim, else an all-reduce; the data-parallel
mean; a leaf computed whole over ``"model"`` then takes its chunk),
compresses it with the whole leaf's blocks, and updates the chunks with
AdamW clipped by the norm over every shard (a replicated leaf counted
once):

    state = init_sharded_state(cfg, params, mesh, comp)
    step = make_sharded_train_step(cfg, mesh, opt_cfg, comp)
    state, metrics = step(state, batch)      # this rank's rows
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.models import registry, transformer
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: object              # the parameter tree (nn.ModuleDict)
    opt: adamw.AdamWState
    err_fb: Optional[dict]      # gradient-compression error feedback
    step: torch.Tensor          # () int32


def init_state(cfg: ArchConfig, params, device="cuda",
               comp: compression.CompressionConfig =
               compression.CompressionConfig()) -> TrainState:
    """The train state around ``params`` (made trainable in place), with a
    fresh AdamW state and, when ``comp`` is enabled, a zero error state,
    on ``device`` (default the card; raises without one unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    for name, p in params.named_parameters():
        if p.device.type != device.type:
            raise ValueError(f"parameter {name} lives on {p.device}, not "
                             f"{device}")
        p.requires_grad_(True)
    named = dict(params.named_parameters())
    err = compression.init_error_state(named) if comp.enabled else None
    return TrainState(params, adamw.init(named), err,
                      torch.zeros((), dtype=torch.int32, device=device))


def state_logical_axes(state: TrainState, param_axes: dict) -> TrainState:
    """The logical axes of the whole state (the optimizer's and the error
    state's leaves mirror the parameters'), ``{name: axes}`` per tree
    with the parameters' dotted names; ``param_axes`` nested
    (``registry.param_axes``) or flat."""
    from repro_torch.distributed.sharding import _flat
    axes = dict(_flat(param_axes))
    return TrainState(params=axes,
                      opt=adamw.AdamWState(step=None, master=axes, m=axes,
                                           v=axes),
                      err_fb=axes if state.err_fb is not None else None,
                      step=None)


def loss_and_grads(params, cfg: ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, metrics, {name: gradient})`` of the family's loss
    (``registry.loss``) on one batch; each gradient in its parameter's
    dtype."""
    names, leaves = zip(*params.named_parameters())
    loss, metrics = registry.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


def make_train_step(cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    comp: compression.CompressionConfig =
                    compression.CompressionConfig(),
                    microbatches: int = 1, planned_mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With ``microbatches > 1`` the batch splits along its first axis and
    the gradients of the microbatches are summed into f32 accumulators
    and averaged; the loss and metrics are the microbatches' means.
    ``planned_mesh`` (a ``DeviceMesh``): the model's products run through
    derived plans on it (``distributed.plan.planned_mesh``).  Every rank
    holds the whole state and batch and computes on its rows of the
    batch over the data axes; the gradients and metrics are then summed
    over those axes (the data-parallel mean), so every rank takes the
    same update."""

    def train_step(state: TrainState, batch: dict):
        if comp.enabled and state.err_fb is None:
            raise ValueError("gradient compression is enabled but the state "
                             "has no error feedback; make it with "
                             "init_state(..., comp=comp)")
        if planned_mesh is None:
            loss, metrics, grads = _accumulate(state.params, cfg, batch,
                                               microbatches)
        else:
            loss, metrics, grads = _planned_grads(
                planned_mesh, state.params, cfg, batch, microbatches)
        grads, err = compression.compress_grads(comp, grads, state.err_fb)
        _, opt, opt_m = adamw.update(opt_cfg, grads, state.opt,
                                     dict(state.params.named_parameters()))
        metrics = dict(metrics, loss=loss, **opt_m)
        return TrainState(state.params, opt, err, state.step + 1), metrics

    return train_step


def _data_axes(mesh) -> tuple[tuple, int]:
    """The mesh's data-parallel axes (outer first) and their ranks."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in DATA_AXES if a in names)
    dp = 1
    for a in axes:
        dp *= mesh.size(names.index(a))
    return axes, dp


def _planned_grads(mesh, params, cfg: ArchConfig, batch: dict,
                   microbatches: int):
    """:func:`_accumulate` on this rank's rows under ``planned_mesh``,
    its gradients' data-parallel reduction deferred to one all-reduce
    each, then the means over the data axes."""
    from repro_torch.distributed import comm
    from repro_torch.distributed import plan as dplan
    data_axes, dp = _data_axes(mesh)
    for a in data_axes:
        batch = {k: comm.chunk_of(v, mesh.get_group(a), 0)
                 for k, v in batch.items()}
    with dplan.planned_mesh(mesh, data_axes):
        loss, metrics, grads = _accumulate(params, cfg, batch, microbatches)
    mean = lambda t: _data_mean(t, mesh, data_axes, dp)
    grads = {k: mean(g).to(g.dtype) for k, g in grads.items()}
    return mean(loss), {k: mean(v) for k, v in metrics.items()}, grads


def _accumulate(params, cfg: ArchConfig, batch: dict, microbatches: int):
    """``(loss, metrics, grads)`` over ``batch`` in ``microbatches``: one
    batch, or the microbatches' gradients summed in f32 and averaged, the
    loss and metrics their means."""
    if microbatches == 1:
        return loss_and_grads(params, cfg, batch)
    for name, t in batch.items():
        if t.shape[0] % microbatches:
            raise ValueError(
                f"batch[{name!r}] has {t.shape[0]} rows, which "
                f"{microbatches} microbatches do not divide")
    mbs = [dict(zip(batch, parts)) for parts in zip(
        *(t.chunk(microbatches, dim=0) for t in batch.values()))]
    grads, losses, ms = None, [], []
    for mb in mbs:
        loss, m, g = loss_and_grads(params, cfg, mb)
        if grads is None:
            grads = {k: t.float() for k, t in g.items()}
        else:
            for k, t in g.items():
                grads[k].add_(t)
        losses.append(loss)
        ms.append(m)
    grads = {k: t / microbatches for k, t in grads.items()}
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return torch.stack(losses).mean(), metrics, grads


# ---------------------------------------------------------------------------
# the sharded step: DTensor state placed by the rule table
# ---------------------------------------------------------------------------

#: the mesh axes a batch is split over (data parallelism)
DATA_AXES = ("pod", "data")


def _placed(cfg: ArchConfig, mesh, shapes: dict) -> dict:
    """``{name: placements}`` of every parameter on ``mesh``."""
    from repro_torch.distributed.sharding import param_placements
    return param_placements(shapes, registry.param_axes(cfg), mesh)


def init_sharded_state(cfg: ArchConfig, params, mesh,
                       comp: compression.CompressionConfig =
                       compression.CompressionConfig()) -> TrainState:
    """The sharded train state of whole ``params`` (the same on every
    rank, e.g. drawn from one seed): each leaf a DTensor holding this
    rank's chunk under the rule table's placements, the f32 masters
    copied from the chunks, m, v (and the error state) zero chunks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import comm
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else dict(params)
    pls = _placed(cfg, mesh, {k: tuple(t.shape) for k, t in named.items()})

    def dt(local, name):
        return DTensor.from_local(local, mesh, pls[name], run_check=False)

    chunks = {k: comm.local_chunk(t.detach(), mesh, pls[k]).clone()
              for k, t in named.items()}
    zeros = lambda: {k: dt(torch.zeros(c.shape, dtype=torch.float32,
                                       device=c.device), k)
                     for k, c in chunks.items()}
    dev = next(iter(chunks.values())).device
    opt = adamw.AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        {k: dt(c.float(), k) for k, c in chunks.items()}, zeros(), zeros())
    return TrainState({k: dt(c, k) for k, c in chunks.items()}, opt,
                      zeros() if comp.enabled else None,
                      torch.zeros((), dtype=torch.int32, device=dev))


def _compute_placements(name: str, stored, mesh, data_axes) -> tuple:
    """The placements a step computes parameter ``name`` in: replicated
    over the data axes; over the others its stored shard where a
    tensor-parallel layer reads that chunk, else replicated."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.layers import takes_model_chunk
    keep = takes_model_chunk(name)
    return tuple(Replicate() if a in data_axes or not keep else pl
                 for a, pl in zip(mesh.mesh_dim_names, stored))


def _to_compute(t, want, mesh):
    """A sharded parameter ``t`` at placements ``want`` (each a
    ``Replicate()`` or ``t``'s own shard): its chunks gathered over the
    mesh dims ``want`` replicates, the inner first; a DTensor where
    ``want`` keeps a shard, else the whole tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import comm
    local, names = t.to_local(), mesh.mesh_dim_names
    for i in reversed(range(len(want))):
        if t.placements[i].is_shard() and not want[i].is_shard():
            local = comm.all_gather(local, mesh.get_group(names[i]),
                                    t.placements[i].dim)
    if any(pl.is_shard() for pl in want):
        return DTensor.from_local(local, mesh, want, run_check=False)
    return local


def _grouped(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        group, leaf = name.rsplit(".", 1)
        out.setdefault(group, {})[leaf] = t
    return out


def _sharded_norm(grads: dict, placements: dict, mesh) -> torch.Tensor:
    """The global norm over every rank's chunks, a chunk replicated over
    some mesh axes counted once."""
    from repro_torch.distributed import comm
    total = None
    for name, g in grads.items():
        copies = 1
        for i, pl in enumerate(placements[name]):
            if not pl.is_shard():
                copies *= mesh.size(i)
        sq = adamw.global_norm({name: g}).square() / copies
        total = sq if total is None else total + sq
    for axis in mesh.mesh_dim_names:
        total = comm.all_reduce(total, mesh.get_group(axis))
    return torch.sqrt(total)


def make_sharded_train_step(cfg: ArchConfig, mesh,
                            opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                            comp: compression.CompressionConfig =
                            compression.CompressionConfig(),
                            microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a
    state from :func:`init_sharded_state`; ``batch`` is this rank's rows
    (its chunk of the global batch over the data axes, the same on every
    rank of ``"model"``).  The metrics are the data-parallel means (the
    global batch's) and AdamW's; the state is updated in place."""
    from repro_torch.distributed import comm
    from repro_torch.distributed import plan as dplan
    names = tuple(mesh.mesh_dim_names)
    data_axes, dp = _data_axes(mesh)

    def reduce_grad(g: torch.Tensor, pl, want) -> torch.Tensor:
        """The data-parallel mean of ``g`` (this rank's share, at the
        compute placements ``want``) on the stored chunk under ``pl``,
        summed in the gradient's dtype (as the reference's reduce-scatter
        of its gradients), divided in f32."""
        for a in data_axes:
            i = names.index(a)
            group = mesh.get_group(a)
            g = comm.reduce_scatter(g, group, pl[i].dim) if \
                pl[i].is_shard() else comm.all_reduce(g, group)
        g = g.float() / dp
        for i, a in enumerate(names):
            if a not in data_axes and pl[i].is_shard() and \
                    not want[i].is_shard():
                g = comm.chunk_of(g, mesh.get_group(a), pl[i].dim)
        return g.contiguous()

    def train_step(state: TrainState, batch: dict):
        if comp.enabled and state.err_fb is None:
            raise ValueError("gradient compression is enabled but the state "
                             "has no error feedback; make it with "
                             "init_sharded_state(..., comp=comp)")
        pls = {k: t.placements for k, t in state.params.items()}
        shapes = {k: tuple(t.shape) for k, t in state.params.items()}
        want = {k: _compute_placements(k, pl, mesh, data_axes)
                for k, pl in pls.items()}
        compute = transformer.build_params(_grouped(
            {k: _to_compute(t, want[k], mesh)
             for k, t in state.params.items()}), trainable=True)
        with dplan.planned_mesh(mesh, data_axes):
            loss, metrics, grads = _accumulate(compute, cfg, batch,
                                               microbatches)
        del compute
        local = {k: t.to_local() for k, t in state.params.items()}
        grads = {k: reduce_grad(_local_of(g), pls[k], want[k])
                 .to(local[k].dtype) for k, g in grads.items()}
        err = None if state.err_fb is None else \
            {k: t.to_local() for k, t in state.err_fb.items()}
        grads, _ = compression.compress_sharded(comp, grads, err, shapes,
                                                pls, mesh)
        opt_local = adamw.AdamWState(
            state.opt.step,
            *({k: t.to_local() for k, t in tree.items()}
              for tree in (state.opt.master, state.opt.m, state.opt.v)))
        _, opt_local, opt_m = adamw.update(
            opt_cfg, grads, opt_local, local,
            gnorm=_sharded_norm(grads, pls, mesh))
        mean = lambda t: _data_mean(t, mesh, data_axes, dp)
        metrics = {k: mean(v) for k, v in dict(metrics, loss=loss).items()}
        opt = adamw.AdamWState(opt_local.step, state.opt.master,
                               state.opt.m, state.opt.v)
        return (TrainState(state.params, opt, state.err_fb, state.step + 1),
                dict(metrics, **opt_m))

    return train_step


def _local_of(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _data_mean(t: torch.Tensor, mesh, data_axes, dp: int) -> torch.Tensor:
    from repro_torch.distributed import comm
    t = t.detach().float()
    for a in data_axes:
        t = comm.all_reduce(t, mesh.get_group(a))
    return t / dp
