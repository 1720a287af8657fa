"""Collective matmuls that overlap the products with the transfers
(``repro.distributed.collectives``).

Two schedules, each a ring over one mesh axis, run per rank on its local
shards (one process a rank):

* ``ag_matmul(x_shard, w, mesh, axis)``: ``y = all_gather(x) @ w``
  without materialising the gathered ``x``: at ring step t each rank
  multiplies the chunk it holds into the matching output rows while the
  chunk moves on to the next rank (``dist.batch_isend_irecv``, posted
  before the product).  The reference's ``ppermute`` ring.
* ``psum_matmul(x, w_shard, mesh, axis)``: the full ``y = sum_p x_p @
  w_p`` on every rank, chunked over rows: each chunk's all-reduce is
  started asynchronously while the next chunk's product runs.

Both read their collective choice and shard extents from the derived
plan of the mesh-lifted matmul (``distributed.plan.matmul_plan``),
asserted, not assumed.  Each product is K1 (``ops.matmul``).  The
``reference_*`` forms are the plain gather-then-multiply and
multiply-then-reduce the tests hold them to.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.mesh import MeshShape
from repro_torch.distributed import comm
from repro_torch.distributed import plan as dplan
from repro_torch.kernels import ops


def ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str
              ) -> torch.Tensor:
    """x (m_shard, k), this rank's rows over ``axis``; w (k, n)
    replicated.  Returns ``all_gather(x) @ w``, (m_shard * p, n), in
    ``x.dtype``, as a ring of p products (no gathered ``x`` is held)."""
    group = mesh.get_group(axis)
    p, idx = comm.group_size(group), comm.group_rank(group)
    m_shard, kdim = x.shape
    n = w.shape[1]
    plan = dplan.matmul_plan(m_shard * p, kdim, n, MeshShape(((axis, p),)),
                             shard={"m": axis}, replicate_out=True,
                             dtype=str(x.dtype).removeprefix("torch."))
    assert plan.collective == "all_gather", plan.collective
    rows = plan.local_extent("i")                 # == m_shard, derived
    y = x.new_empty((rows * p, n))
    chunk = x.contiguous()
    for t in range(p):
        src = (idx - t) % p                       # whose rows we now hold
        if t + 1 < p:                             # post the move first
            nxt = comm.start_exchange(chunk, group, (idx + 1) % p,
                                      (idx - 1) % p)
        y[src * rows:(src + 1) * rows] = ops.matmul(chunk, w,
                                                    out_dtype=x.dtype)
        if t + 1 < p:
            chunk = nxt()
    return y


def psum_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str
                ) -> torch.Tensor:
    """x (m, k_shard) column-sharded, w (k_shard, n) row-sharded over
    ``axis``.  Returns the full ``sum_p x_p @ w_p`` on every rank in
    ``x.dtype``, its all-reduce pipelined over row chunks so the
    transfers overlap the remaining chunks' products."""
    group = mesh.get_group(axis)
    p = comm.group_size(group)
    m, k_shard = x.shape
    plan = dplan.matmul_plan(m, k_shard * p, w.shape[1],
                             MeshShape(((axis, p),)), shard={"k": axis},
                             dtype=str(x.dtype).removeprefix("torch."))
    assert plan.collective == "psum", plan.collective
    assert plan.local_extent("k") == k_shard
    chunks = min(p, max(m // 8, 1))
    bounds = [(i * (m // chunks), (i + 1) * (m // chunks))
              for i in range(chunks)]
    if m % chunks:
        bounds.append((chunks * (m // chunks), m))
    parts, works = [], []
    for lo, hi in bounds:
        part = ops.matmul(x[lo:hi], w, out_dtype=torch.float32).contiguous()
        works.append(dist.all_reduce(part, group=group, async_op=True)
                     if p > 1 else None)
        parts.append(part)
    for wk in works:
        if wk is not None:
            wk.wait()
    return torch.cat(parts).to(x.dtype)


def reference_ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                        axis: str) -> torch.Tensor:
    full = comm.all_gather(x, mesh.get_group(axis), 0)
    return (full.float() @ w.float()).to(x.dtype)


def reference_psum_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                          axis: str) -> torch.Tensor:
    return comm.all_reduce(x.float() @ w.float(),
                           mesh.get_group(axis)).to(x.dtype)
