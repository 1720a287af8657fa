"""Mixture-of-Experts FFN (``repro.models.moe``): shared plus fine-grained
routed experts (DeepSeekMoE) with sort-based capacity-padded dispatch.

Dispatch lifts the token axis to ``(experts, capacity)``: each token's
top-k assignments are sorted by expert (stably, so a token keeps its place
within its expert), the first ``cap`` of each expert are kept, and the
expert FFN runs as two capacity-padded expert GEMMs over every expert
(``ops.expert_matmul``, K1's expert form).  This is the reference's global
path (``_apply_moe_global``), taken with no planned mesh.  Under a planned
mesh with a ``"model"`` axis wider than one, :func:`apply_moe` takes the
shard-local path (``_apply_moe_shardmap``): each rank routes its own
tokens, keeps the assignments to its slice of the experts, runs their
FFNs on K1's expert form and sums the ranks' contributions with one psum
over ``"model"``.

The reference scatters with ``.at[].add``; on the card a scatter-add sums
in an order that changes from run to run, so here dispatch and combine are
gathers only: each expert slot reads its token through a slot -> token map
(a zero row for an empty slot), and each token sums its k contributions in
expert order, the order of the reference's scatter, in ``x.dtype``.  Their
backwards are gathers too (:class:`_GatherRows`; autograd through
``index_select`` would sum by ``index_add_``, atomics on the card): a
token sums its kept slots' gradients in expert order, and a slot reads
the gradient of the one assignment it holds.  A rerun, forward and
backward, gives the same bits, and no step reads anything back to the
host (``cap`` comes from shapes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.distributed import comm
from repro_torch.distributed import plan as dplan
from repro_torch.kernels import ops
from repro_torch.models.layers import (_gate_act, _model_chunk, _tp_mlp,
                                       mlp_traffic)


def moe_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    """``{name: (shape, init scale[, dtype])}`` of one MoE FFN, stacked on
    ``lead``: the f32 router ``(d, e)``, the experts' ``wi (e, d, 2f)`` and
    ``wo (e, f, d)``, and the shared experts' fused ``shared_wi (d, 2 f
    n_shared)`` and ``shared_wo`` (the reference's ``init_moe``)."""
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    shapes = {"router": (lead + (d, e), d ** -0.5, "float32"),
              "wi": (lead + (e, d, 2 * f), d ** -0.5),
              "wo": (lead + (e, f, d), f ** -0.5)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes["shared_wi"] = (lead + (d, 2 * fs), d ** -0.5)
        shapes["shared_wo"] = (lead + (fs, d), fs ** -0.5)
    return shapes


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped_frac: torch.Tensor


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``capacity_factor t k / e`` (at
    least 1), rounded up to a multiple of 8."""
    cap = int(max(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts, 1))
    return -(-cap // 8) * 8


def route(p, xt: torch.Tensor, cfg: ArchConfig):
    """The f32 router on ``xt (t, d)``: ``(logits (t, e), probs, gates (t,
    k), idx (t, k))``.  ``idx`` is the top k of the softmax in descending
    order, ties to the lower expert (``jax.lax.top_k``'s order, from a
    stable sort), and the gates are renormalised over the k."""
    logits = ops.matmul(xt.float(), p["router"], out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gates, idx


class _GatherRows(torch.autograd.Function):
    """``out[i] = src[fwd[i]]``, a zero row where ``fwd[i] == len(src)``
    (``pad``), whose backward is a gather as well: ``bwd (n, c)`` lists,
    for each row ``j`` of ``src``, the rows of ``out`` that read it (``len
    (out)`` for none), and its gradient is theirs summed in that column
    order, in the gradient's dtype.  No atomic adds either way."""

    @staticmethod
    def forward(ctx, src, fwd, bwd, pad: bool):
        ctx.save_for_backward(bwd)
        if pad:
            src = torch.cat([src, src.new_zeros(1, src.shape[1])])
        return src.index_select(0, fwd)

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(1, g.shape[1])])
        out = g.index_select(0, bwd[:, 0])
        for c in range(1, bwd.shape[1]):
            out = out + g.index_select(0, bwd[:, c])
        return out, None, None, None


def slot_maps(idx: torch.Tensor, e: int, cap: int):
    """The dispatch's maps of the top-k experts ``idx (t, k)``, with the
    ``t k`` assignments sorted by expert (stably: a token keeps its place
    within its expert's run): ``counts (e,)``, each expert's assignments;
    ``slot_asg (e cap,)``, the assignment that slot c of expert j holds
    (the c-th of its run; ``t k`` for an empty slot); ``slot (t k,)``,
    each assignment's slot (clamped to ``cap - 1`` past capacity) and
    ``keep``, whether it is below capacity; ``tok_slots (t, k)``, a
    token's kept slots in expert order (``e cap`` where dropped); and
    ``by_expert (t, k)``, that order."""
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    experts = torch.arange(e, device=dev)
    sorted_e = flat_e.index_select(0, order)
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    pos = torch.arange(cap, device=dev)
    run = (starts[:, None] + pos).clamp_max(t * k - 1)
    slot_asg = torch.where(pos < counts[:, None],
                           order.index_select(0, run.reshape(-1)).reshape(
                               e, cap), t * k).reshape(-1)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    at = rank - starts.index_select(0, flat_e)
    keep = at < cap
    slot = flat_e * cap + at.clamp_max(cap - 1)
    by_expert = torch.argsort(idx, dim=-1)
    tok_slots = torch.where(keep, slot, e * cap).reshape(t, k).gather(
        1, by_expert)
    return counts, slot_asg, slot, keep, tok_slots, by_expert


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, MoEStats]:
    """``x (B, S, d) -> (B, S, d)`` and its stats: the load-balance loss
    ``e sum(mean prob x assigned share)``, the router z-loss ``mean
    (logsumexp^2)`` and the share of assignments dropped past capacity,
    each a device tensor.  Shard-local (``_apply_moe_shardmap``) under a
    planned mesh whose ``"model"`` axis is wider than one, else global."""
    mesh = dplan.current_planned_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names and \
            mesh.size(mesh.mesh_dim_names.index("model")) > 1:
        return _apply_moe_shardmap(p, x, cfg, mesh)
    return _apply_moe_global(p, x, cfg)


def _combine(ye: torch.Tensor, slot: torch.Tensor, slot_asg: torch.Tensor,
             weights: torch.Tensor, by_expert: torch.Tensor, t: int,
             pad: bool) -> torch.Tensor:
    """Each assignment's slot of ``ye (slots, d)`` (the zero row past the
    end where ``pad``), times its weight, and a token's k contributions
    summed in expert order: ``(t, d)`` in ``ye``'s dtype."""
    k = by_expert.shape[1]
    d = ye.shape[-1]
    contrib = _GatherRows.apply(ye.reshape(-1, d), slot, slot_asg[:, None],
                                pad)
    contrib = (contrib * weights.to(ye.dtype)[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + contrib.gather(1, by_expert[:, j, None, None].expand(
            t, 1, d))[:, 0]
    return y


def _experts(xe: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
             cfg: ArchConfig, dtype) -> torch.Tensor:
    """The routed experts' gated FFNs on ``xe (e, cap, d)`` (K1's expert
    form for both products)."""
    h = ops.expert_matmul(xe, wi, out_dtype=torch.float32)
    u, v = h.chunk(2, dim=-1)
    h = (_gate_act(cfg, u) * v).to(dtype)
    return ops.expert_matmul(h, wo, out_dtype=dtype)


def _shared(p, x: torch.Tensor, y: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """``y`` plus the shared experts' gated FFN of ``x``: tensor-parallel
    (``layers._tp_mlp``) where they arrive as their stored chunks over
    ``"model"``."""
    if cfg.n_shared_experts and _model_chunk(p["shared_wi"])[1] is not None:
        # the experts are gated whatever cfg.mlp says: gelu's is geglu
        gated = cfg.with_(use_bias=False, mlp="swiglu" if cfg.mlp ==
                          "swiglu" else "geglu")
        return y + _tp_mlp({"wi": p["shared_wi"], "wo": p["shared_wo"]}, x,
                           gated, p["shared_wi"].device_mesh)
    if cfg.n_shared_experts:
        hs = ops.matmul(x, p["shared_wi"], out_dtype=torch.float32)
        us, vs = hs.chunk(2, dim=-1)
        hs = (_gate_act(cfg, us) * vs).to(x.dtype)
        y = y + ops.matmul(hs, p["shared_wo"], out_dtype=x.dtype)
    return y


def _apply_moe_global(p, x: torch.Tensor, cfg: ArchConfig
                      ) -> tuple[torch.Tensor, MoEStats]:
    """The dispatch over every expert on one device."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    logits, probs, gates, idx = route(p, xt, cfg)
    dev = x.device
    cap = capacity(cfg, t)
    counts, slot_asg, slot, keep, tok_slots, by_expert = slot_maps(idx, e,
                                                                   cap)
    aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    z = torch.logsumexp(logits, dim=-1).square().mean()

    # dispatch: each slot reads its token (the zero row t for an empty one)
    xe = _GatherRows.apply(xt, slot_asg.div(k, rounding_mode="floor"),
                           tok_slots, True).reshape(e, cap, d)

    ye = _experts(xe, p["wi"], p["wo"], cfg, x.dtype)

    # combine: each assignment's slot, its gate (0 past capacity), and the
    # k contributions of a token summed in expert order
    y = _combine(ye, slot, slot_asg, gates.reshape(-1) * keep, by_expert, t,
                 False).reshape(b, s, d)
    dropped = 1.0 - keep.sum() / (t * k)
    return _shared(p, x, y, cfg), MoEStats(aux, z, dropped)


def train_traffic(p, cfg: ArchConfig, rows: int, tp: int, esz: int) -> list:
    """The ``"model"`` collectives (``comm.Traffic``) of one MoE layer
    (:func:`_apply_moe_shardmap`, ``p`` its leaves' shapes and dtypes) in
    the sharded train step on ``rows`` rows of ``esz``-byte activations
    over ``tp`` ranks: the dispatched tokens' and the f32 gates' gradient
    sums, the output's psum, then the shared experts' tensor-parallel
    MLP's (``layers.mlp_traffic``)."""
    if cfg.n_experts % tp:
        return []
    d = cfg.d_model
    out = [comm.Traffic("all-reduce", rows * d * esz, "bwd"),
           comm.Traffic("all-reduce", rows * cfg.top_k * 4, "bwd"),
           comm.Traffic("all-reduce", rows * d * esz, "fwd")]
    if cfg.n_shared_experts:
        out += mlp_traffic(p["shared_wi"], cfg, rows, tp, esz, True)
    return out


def _apply_moe_shardmap(p, x: torch.Tensor, cfg: ArchConfig, mesh
                        ) -> tuple[torch.Tensor, MoEStats]:
    """Token-local routing with the experts sharded over ``"model"``
    (expert parallelism), one process a rank.

    ``x`` is this rank's rows of the batch (its data shard), the same on
    every rank of ``"model"``; the parameters are whole on every rank, or
    (the sharded train step) the expert weights arrive as the
    ``DTensor`` of their stored chunk over ``"model"``, this rank's
    experts, and the router whole.  Each rank routes its tokens with the
    whole router, keeps the
    assignments to its ``e / tp`` experts (the rest go to a drop bucket
    it never runs), dispatches them at the capacity of its tokens, runs
    its experts' FFNs on K1's expert form and combines; one psum over
    ``"model"`` then sums each token's contributions.  Under remat the
    local function is checkpointed, the psum is not.

    Gradients of whole weights are whole on every rank of ``"model"``:
    the expert weights' slices gather back (``comm.shard_local``); those
    of stored chunks stay this rank's experts'.  The
    dispatched tokens' and the gates' partial gradients are summed over
    the axis (``comm.replicated_in``).  The stats are this rank's tokens'
    (the data-parallel mean is the caller's, as for the loss), but
    ``dropped``, the share over all ranks' assignments."""
    from torch.utils.checkpoint import checkpoint
    names = tuple(mesh.mesh_dim_names)
    mg = mesh.get_group("model")
    tp, r = comm.group_size(mg), comm.group_rank(mg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if e % tp:
        raise ValueError(f"{e} experts over a model axis of {tp}")
    e_loc, e0 = e // tp, r * (e // tp)
    t = b * s
    xt = x.reshape(t, d)
    wi, wo = (w if dim is not None else comm.shard_local(w, mg, 0)
              for w, dim in map(_model_chunk, (p["wi"], p["wo"])))
    dtype = x.dtype

    # reads no tensor but its arguments: a checkpoint keeps this function
    # until its backward, and with it whatever it closes over
    def local(xt, gates_in, idx, wi, wo):
        cap = capacity(cfg, t)
        mine = (idx >= e0) & (idx < e0 + e_loc)
        idx_l = torch.where(mine, idx - e0, e_loc)        # e_loc: drop bucket
        counts, slot_asg, slot, keep, _, by_expert = slot_maps(
            idx_l, e_loc + 1, cap)
        keep = keep & mine.reshape(-1)
        tok_slots = torch.where(keep, slot, e_loc * cap).reshape(
            t, k).gather(1, by_expert)
        slot_asg = slot_asg[:e_loc * cap]
        xe = _GatherRows.apply(comm.replicated_in(xt, mg),
                               slot_asg.div(k, rounding_mode="floor"),
                               tok_slots, True).reshape(e_loc, cap, d)
        ye = _experts(xe, wi, wo, cfg, dtype)
        gates = comm.replicated_in(gates_in, mg).reshape(-1) * keep
        y = _combine(ye, torch.where(keep, slot, e_loc * cap), slot_asg,
                     gates, by_expert, t, True)
        lost = (mine.reshape(-1) & ~keep).sum()
        return y, lost

    logits, probs, gates, idx = route(p, xt, cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    z = torch.logsumexp(logits, dim=-1).square().mean()
    if cfg.remat and torch.is_grad_enabled():
        y, lost = checkpoint(local, xt, gates, idx, wi, wo,
                             use_reentrant=False)
    else:
        y, lost = local(xt, gates, idx, wi, wo)
    y = comm.psum(y, mg).reshape(b, s, d)
    # drops among every rank's assignments over every rank's tokens
    lost = lost.float()
    for a in names:
        lost = comm.all_reduce(lost, mesh.get_group(a))
    ranks = 1
    for a in names:
        ranks *= mesh.size(names.index(a))
    dropped = lost / (t * k * (ranks // tp))
    return _shared(p, x, y, cfg), MoEStats(aux, z, dropped)
