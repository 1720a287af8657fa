"""Mixture-of-Experts FFN (``repro.models.moe``): shared plus fine-grained
routed experts (DeepSeekMoE) with sort-based capacity-padded dispatch.

Dispatch lifts the token axis to ``(experts, capacity)``: each token's
top-k assignments are sorted by expert (stably, so a token keeps its place
within its expert), the first ``cap`` of each expert are kept, and the
expert FFN runs as two capacity-padded expert GEMMs over every expert
(``ops.expert_matmul``, K1's expert form).  This is the reference's global
path (``_apply_moe_global``), which it also takes with no mesh; its
shard-local path waits for the distributed slice.

The reference scatters with ``.at[].add``; on the card a scatter-add sums
in an order that changes from run to run, so here dispatch and combine are
gathers only: each expert slot reads its token through a slot -> token map
(a zero row for an empty slot), and each token sums its k contributions in
expert order, the order of the reference's scatter, in ``x.dtype``.  A
rerun gives the same bits, and no step reads anything back to the host
(``cap`` comes from shapes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _gate_act


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


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, MoEStats]:
    """``x (B, S, d) -> (B, S, d)`` and its stats: the load-balance loss
    ``e sum(mean prob x assigned share)``, the router z-loss ``mean
    (logsumexp^2)`` and the share of assignments dropped past capacity,
    each a device tensor."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    logits, probs, gates, idx = route(p, xt, cfg)
    dev = x.device

    # sort the t k assignments by expert; each expert's run is contiguous
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    experts = torch.arange(e, device=dev)
    sorted_e = flat_e.index_select(0, order)
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts

    aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    z = torch.logsumexp(logits, dim=-1).square().mean()

    # dispatch: slot c of expert j holds the c-th assignment of its run
    cap = capacity(cfg, t)
    pos = torch.arange(cap, device=dev)
    run = (starts[:, None] + pos).clamp_max(t * k - 1)
    slot_tok = torch.where(pos < counts[:, None],
                           order.index_select(0, run.reshape(-1)).reshape(
                               e, cap).div(k, rounding_mode="floor"), t)
    xe = torch.cat([xt, xt.new_zeros(1, d)]).index_select(
        0, slot_tok.reshape(-1)).reshape(e, cap, d)

    h = ops.expert_matmul(xe, p["wi"], out_dtype=torch.float32)
    u, v = h.chunk(2, dim=-1)
    h = (_gate_act(cfg, u) * v).to(x.dtype)
    ye = ops.expert_matmul(h, p["wo"], out_dtype=x.dtype)

    # combine: each assignment's slot, its gate (0 past capacity), and the
    # k contributions of a token summed in expert order
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    at = rank - starts.index_select(0, flat_e)
    keep = at < cap
    slot = flat_e * cap + at.clamp_max(cap - 1)
    contrib = ye.reshape(e * cap, d).index_select(0, slot)
    contrib = (contrib * (gates.reshape(-1) * keep).to(x.dtype)[:, None]
               ).reshape(t, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib.gather(1, by_expert[:, j, None, None].expand(
            t, 1, d))[:, 0]
    y = y.reshape(b, s, d)

    if cfg.n_shared_experts:
        hs = ops.matmul(x, p["shared_wi"], out_dtype=torch.float32)
        us, vs = hs.chunk(2, dim=-1)
        hs = (_gate_act(cfg, us) * vs).to(x.dtype)
        y = y + ops.matmul(hs, p["shared_wo"], out_dtype=x.dtype)
    dropped = 1.0 - keep.sum() / (t * k)
    return y, MoEStats(aux, z, dropped)
