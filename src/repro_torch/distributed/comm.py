"""The collectives a plan runs, on ``torch.distributed`` process groups,
and their autograd rules.

One rank a device (SPMD by process).  A plan's steps map onto the group
of one mesh axis (``DeviceMesh.get_group(axis)``):

=================  ==========================  ===========================
plan step          forward                     backward
=================  ==========================  ===========================
``psum``           ``all_reduce``              identity
``reduce_scatter`` ``reduce_scatter_tensor``   ``all_gather_into_tensor``
``all_gather``     ``all_gather_into_tensor``  this rank's slice
=================  ==========================  ===========================

The backward rules follow ``torch.distributed.tensor``'s convention: the
gradient of a replicated tensor is replicated (the one loss every rank
holds), that of a sharded tensor is this rank's shard.  Two more rules
carry an operand into a per-rank product: :func:`shard_local` (a
replicated tensor's slice; backward all-gathers the slices) and
:func:`replicated_in` (identity; backward sums the partial gradients of a
replicated operand that the ranks of an axis used on different shards of
the work).  :func:`gather_partial` is the all-gather whose backward
reduce-scatters: each rank reads the whole gathered tensor with its own
shard of the work (its columns of a weight), so its gradient is a part
of the whole one.

``SENT`` counts the bytes each op moves from this rank, by op name
(``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"`` and, for the
rings' point-to-point steps, ``"send"``), in the per-device ring
convention of ``plan.DistributedPlan.ici_bytes_by_kind``: an
all-reduce 2 (p - 1) / p of its tensor, a reduce-scatter (p - 1) / p of
its input, an all-gather (p - 1) / p of its output, a send the tensor
sent.  Every collective of the port counts there, whatever its backend.
Each layer kind lists beside its forward the ``"model"`` collectives it
sends in the sharded train step as :class:`Traffic` (its module's
``train_traffic``), which the dry-run's model of the step adds up.

``torch``'s collectives concatenate along dim 0, so a scatter or gather
along another dim moves it there and back.  gloo takes CUDA tensors for
the collectives above (it stages them itself); its point-to-point sends
do not (the ring of ``collectives.ag_matmul``), and
:func:`stages_through_host` names the one case this module copies through
the host.  NCCL takes everything on the card.  An op a backend refuses
raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist


#: the bytes this process's collectives moved, by op (module docstring);
#: ``SENT.clear()`` starts a count
SENT: dict[str, float] = {}


def count(op: str, p: int, nbytes: int) -> None:
    """Add one collective of ``op`` over ``p`` ranks on a tensor of
    ``nbytes`` (the all-reduce's tensor, the reduce-scatter's input, the
    all-gather's output, the bytes sent) to :data:`SENT`."""
    if p <= 1:
        return
    share = {"all-reduce": 2.0 * (p - 1) / p, "send": 1.0}.get(
        op, (p - 1) / p)
    SENT[op] = SENT.get(op, 0.0) + share * nbytes


class Traffic(NamedTuple):
    """One collective over ``"model"`` that a layer sends a microbatch
    of the sharded train step: ``op`` a :data:`SENT` key, ``nbytes`` the
    tensor :func:`count` takes, and ``when`` it runs: ``"fwd"`` in the
    forward (again in the remat rerun, but a layer's last, where the
    rerun stops), ``"bwd"`` once in the backward, or ``"weight"`` a
    weight gathered in the forward (again in the remat rerun or, with
    remat off, where autograd unpacks it: ``fsdp.regather_saved``)."""
    op: str
    nbytes: int
    when: str


def nbytes(t) -> int:
    """The bytes of ``t``, a tensor or anything with its ``shape`` and
    ``dtype``."""
    return math.prod(t.shape) * t.dtype.itemsize


def stages_through_host(group, t: torch.Tensor) -> bool:
    """True where this module copies ``t`` to the host around a
    point-to-point send: a CUDA tensor on a gloo group, which gloo's
    transport writes from the device pointer and fails (its collectives
    take CUDA tensors)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_size(group) -> int:
    return dist.get_world_size(group)


@torch.no_grad()
def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``t`` over ``group`` (a new
    tensor; these raw forms carry no gradient, the rules below do)."""
    out = t.detach().contiguous().clone()
    if group_size(group) > 1:
        count("all-reduce", group_size(group), nbytes(out))
        dist.all_reduce(out, group=group, op={
            "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return out


def _to_front(t: torch.Tensor, dim: int) -> torch.Tensor:
    t = t.detach()
    return t.movedim(dim, 0).contiguous() if dim else t.contiguous()


@torch.no_grad()
def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's chunk of ``dim``."""
    p = group_size(group)
    if p == 1:
        return t.detach().contiguous().clone()
    if t.shape[dim] % p:
        raise ValueError(f"reduce_scatter of dim {dim} ({t.shape[dim]}) "
                         f"over {p} ranks")
    src = _to_front(t, dim)
    out = src.new_empty((src.shape[0] // p,) + tuple(src.shape[1:]))
    count("reduce-scatter", p, nbytes(src))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


@torch.no_grad()
def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The chunks of ``t`` over ``group``, concatenated along ``dim`` in
    rank order."""
    p = group_size(group)
    if p == 1:
        return t.detach().contiguous().clone()
    src = _to_front(t, dim)
    out = src.new_empty((src.shape[0] * p,) + tuple(src.shape[1:]))
    count("all-gather", p, nbytes(out))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def chunk_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (a view)."""
    p = group_size(group)
    if t.shape[dim] % p:
        raise ValueError(f"dim {dim} ({t.shape[dim]}) over {p} ranks")
    c = t.shape[dim] // p
    return t.narrow(dim, group_rank(group) * c, c)


def start_exchange(t: torch.Tensor, group, dst: int, src: int):
    """Start sending ``t`` to group rank ``dst`` and receiving a tensor of
    its shape from group rank ``src`` (one step around a ring); returns
    the wait that yields the received tensor."""
    staged = stages_through_host(group, t)
    out = t.cpu() if staged else t.contiguous()
    buf = torch.empty_like(out)
    count("send", group_size(group), nbytes(out))
    glob = lambda r: dist.get_global_rank(group, r)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, glob(dst), group=group),
        dist.P2POp(dist.irecv, buf, glob(src), group=group)])

    def wait():
        for r in reqs:
            r.wait()
        return buf.to(t.device) if staged else buf
    return wait


# ---------------------------------------------------------------------------
# the autograd rules
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.group, ctx.dim).contiguous(), None, None


class _AllGatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ShardLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk_of(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group)


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ReduceScatter.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _AllGather.apply(x, group, dim)


def gather_partial(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The chunks of ``x`` over ``group`` concatenated along ``dim`` in
    rank order, for ranks that each read the whole with their own shard
    of the work: its gradient, a part on each rank, is summed over
    ``group`` and scattered back onto the chunks (a reduce-scatter)."""
    return _AllGatherPartial.apply(x, group, dim)


def shard_local(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim``, contiguous;
    its gradient all-gathers the chunks' gradients (replicated again)."""
    return _ShardLocal.apply(x, group, dim)


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``, whose ranks
    each used ``x`` on their own shard of the work."""
    return _ReplicatedIn.apply(x, group)


# ---------------------------------------------------------------------------
# whole tensors and their shards under DTensor placements
# ---------------------------------------------------------------------------

def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``placements`` (one a mesh dim,
    ``Shard(d)`` or ``Replicate()``): the chunk along ``d`` at this rank's
    coordinate, taken mesh dim by mesh dim (the outer first, as DTensor
    nests two shardings of one dim).  A view; no collective."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            p = mesh.size(i)
            if full.shape[pl.dim] % p:
                raise ValueError(f"dim {pl.dim} ({full.shape[pl.dim]}) over "
                                 f"{p} ranks")
            c = full.shape[pl.dim] // p
            full = full.narrow(pl.dim, coord[i] * c, c)
    return full


def gather_full(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` chunk under
    ``placements``: an all-gather over each sharded mesh dim, the inner
    first (:func:`gather`, so its gradient is this rank's chunk).  Every
    rank of the mesh calls it and gets the whole tensor."""
    names = mesh.mesh_dim_names
    for i in reversed(range(len(placements))):
        pl = placements[i]
        if pl.is_shard():
            local = gather(local, mesh.get_group(names[i]), pl.dim)
    return local
