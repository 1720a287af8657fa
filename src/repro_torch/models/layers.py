"""Building-block layers: norms, the gated MLP, rotary and sinusoidal
position embeddings, the embedding and the vocab head
(``repro.models.layers``).

Plain functions over parameter dicts (``nn.ParameterDict`` or any mapping
of tensors): RMSNorm or LayerNorm, the MLP with or without its biases.
Norms and softmax run in f32; every product goes through ``ops.matmul``
(f32 accumulate), with the reference's casts at the same places.

Under a planned mesh (``distributed.plan.planned_mesh``) the MLP and the
vocab head run tensor-parallel through derived plans, one process a
rank: the activations are this rank's rows of the batch.  ``wi`` is
column-sharded over ``"model"`` with no collective (a gated MLP's two
halves sharded alike, so each rank holds matching gate and value
columns), ``wo`` sigma-sharded with the TP psum, and the head
column-sharded over the vocabulary, then gathered, so every rank holds
the whole logits of its rows; the loss alone keeps its rows' logits on
this rank's vocabulary columns (``vocab_shard``) and takes a
vocabulary-parallel log-softmax over them (:func:`token_nll`).  A weight
arrives whole on every rank (a plain tensor, sliced here), or as the
``DTensor`` of its stored chunk over ``"model"`` (the sharded train
step's, ``distributed.sharding.reads_model_chunk``), which the plans
read as it is; the embedding then looks up each rank's vocabulary rows
and sums them over ``"model"``.  The sharded step's embedding table
and head arrive at their stored chunks and are gathered over the data
axes at their use (``distributed.fsdp.gather``).  Without a mesh the
path is the single-device one, unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import plan as dplan
from repro_torch.kernels import ops


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype.  RMSNorm: ``x * rsqrt(mean(x^2) +
    eps) * scale`` (no ``1 + scale``).  LayerNorm: ``(x - mean) *
    rsqrt(var + eps) * scale (+ bias)``, the population variance, and the
    bias only where the leaf exists (``use_bias``)."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        if "bias" in p:
            out = out + p["bias"].float()
        return out.to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


def _gate_act(cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return F.silu(u)
    return F.gelu(u, approximate="tanh")        # geglu and gelu


class _GatedColumns(torch.autograd.Function):
    """Rank r's columns of a gated weight's two halves, side by side:
    ``[w[..., r c:(r+1) c], w[..., f + r c:f + (r+1) c]]`` with ``f`` half
    the last dim and ``c = f / p`` over the ``p`` ranks of ``group``.  Its
    backward gathers every rank's slice gradient back into the whole
    weight's layout (replicated, as the weight is)."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        p, r = comm.group_size(group), comm.group_rank(group)
        f = w.shape[-1] // 2
        c = f // p
        return torch.cat([w[..., r * c:(r + 1) * c],
                          w[..., f + r * c:f + (r + 1) * c]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        p = comm.group_size(ctx.group)
        full = comm.all_gather(g.contiguous(), ctx.group, g.dim() - 1)
        lead, c2 = full.shape[:-1], g.shape[-1]
        # (.., p, 2, c) -> (.., 2, p, c): the ranks' [u_r, v_r] -> [u, v]
        full = full.reshape(*lead, p, 2, c2 // 2).transpose(-3, -2)
        return full.reshape(*lead, p * c2), None


def _model_chunk(w: torch.Tensor):
    """``(tensor, dim)``: a ``DTensor`` weight's chunk over ``"model"`` and
    the dim it is sharded along there (None: ``w`` whole, a plain tensor
    or a DTensor replicated over ``"model"``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return w, None
    names = w.device_mesh.mesh_dim_names
    pl = w.placements[names.index("model")] if "model" in names else None
    return w.to_local(), pl.dim if pl is not None and pl.is_shard() else None


def _gated_chunk(w: torch.Tensor, group) -> torch.Tensor:
    """:class:`_GatedColumns` of a gated weight from this rank's stored
    chunk of its last dim: the chunks gathered whole (for this layer only),
    then sliced; the gradient lands on the stored chunk."""
    return _GatedColumns.apply(comm.gather(w, group, w.dim() - 1), group)


def _rows(x2: torch.Tensor, mesh, placements):
    """This rank's ``x2`` as the DTensor the plan reads (no copy)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x2, mesh, placements, run_check=False)


def _global_rows(x2: torch.Tensor, mesh) -> int:
    """The rows of the whole batch: this rank's times the data ranks."""
    names = mesh.mesh_dim_names
    return x2.shape[0] * (mesh.size(names.index("data"))
                          if "data" in names else 1)


def _tp_mlp(p, x: torch.Tensor, cfg: ArchConfig, mesh) -> torch.Tensor:
    """The MLP tensor-parallel over ``"model"``: ``wi``'s plan (roles
    ``tp_matmul_shard(mesh, "col")``) leaves each rank its columns of the
    pre-activation, ``wo``'s (``"sigma"``) sums the ranks' partial outputs
    with the derived psum."""
    x2 = x.reshape(-1, x.shape[-1])
    m, d = _global_rows(x2, mesh), x2.shape[1]
    gated = cfg.mlp in ("swiglu", "geglu")
    wi, bi = p["wi"], p["bi"] if cfg.use_bias else None
    shard = dplan.tp_matmul_shard(mesh, "col")
    plan = dplan.matmul_plan(m, d, wi.shape[-1], mesh, shard=shard,
                             dtype=str(x.dtype).removeprefix("torch."))
    w_pl = plan.in_placements(mesh)[1]
    wi_local, wi_dim = _model_chunk(wi)
    if wi_dim is None:
        wi = wi_local
    bi, bi_dim = (None, None) if bi is None else _model_chunk(bi)
    axis = plan.in_entries[1][1]
    if gated and axis is not None:
        # the plan shards the columns: each rank takes matching gate and
        # value columns, the weight its plan reads being their interleave
        mg = mesh.get_group(axis)
        if comm.group_size(mg) > 1:
            wi = _rows(fsdp.derived(lambda w: _gated_chunk(w, mg), wi_local)
                       if wi_dim is not None
                       else _GatedColumns.apply(wi_local, mg), mesh, w_pl)
            if bi is not None:
                bi = _gated_chunk(bi, mg) if bi_dim is not None else \
                    _GatedColumns.apply(bi, mg)
    elif bi is not None and axis is not None and bi_dim is None:
        bi = comm.shard_local(bi, mesh.get_group(axis), 0)
    h = col_matmul(x2, wi, mesh, torch.float32)
    if bi is not None:
        h = h + bi.float()
    if gated:
        u, v = h.chunk(2, dim=-1)
        h = _gate_act(cfg, u) * v
    else:
        h = _gate_act(cfg, h)
    wo = p["wo"]
    if _model_chunk(wo)[1] is None:
        wo = _model_chunk(wo)[0]
    out = sigma_matmul(h.to(x.dtype), wo, mesh, m)
    out = out.reshape(*x.shape[:-1], out.shape[-1])
    if cfg.use_bias:
        out = out + p["bo"].to(x.dtype)
    return out


def mlp_traffic(wi, cfg: ArchConfig, rows: int, tp: int, esz: int,
                gated: bool) -> list:
    """The ``"model"`` collectives (``comm.Traffic``) of one
    tensor-parallel MLP (:func:`_tp_mlp`, ``wi`` its leaf's shape and
    dtype) in the sharded train step on ``rows`` rows of ``esz``-byte
    activations over ``tp`` ranks: the input's gradient sum, a gated
    ``wi`` gathered whole for its interleave (:class:`_GatedColumns`) and
    its gradient gathered back, and the output's f32 psum."""
    if wi.shape[-1] % tp:
        return []
    out = [comm.Traffic("all-reduce", rows * cfg.d_model * esz, "bwd")]
    if gated:
        out += [comm.Traffic("all-gather", comm.nbytes(wi), "weight"),
                comm.Traffic("all-gather", comm.nbytes(wi), "bwd")]
    return out + [comm.Traffic("all-reduce", rows * cfg.d_model * 4, "fwd")]


def col_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
               out_dtype) -> torch.Tensor:
    """This rank's columns of ``x (..., k) @ w (k, n)`` with ``n`` over
    ``"model"``: the ``"col"`` plan on ``w`` the ``DTensor`` of its stored
    column chunk (or whole, which the plan slices), ``x`` this rank's rows
    of the batch; ``x``'s gradient is summed over ``"model"`` (the plan
    works the columns over it).  In ``out_dtype`` from its f32 sums."""
    x2 = x.reshape(-1, x.shape[-1])
    shard = dplan.tp_matmul_shard(mesh, "col")
    plan = dplan.matmul_plan(_global_rows(x2, mesh), x2.shape[1],
                             w.shape[-1], mesh, shard=shard,
                             dtype=str(x.dtype).removeprefix("torch."))
    y = ops.matmul(_rows(x2, mesh, plan.in_placements(mesh)[0]), w,
                   out_dtype=out_dtype, mesh=mesh, shard=shard).to_local()
    return y.reshape(*x.shape[:-1], y.shape[-1])


def sigma_matmul(h: torch.Tensor, wo: torch.Tensor, mesh, m: int,
                 chunk: bool = False) -> torch.Tensor:
    """``h (rows, k) @ wo (k, n)`` with ``k`` over ``"model"``: the
    ``"sigma"`` plan, each rank's partial product summed by its psum in
    f32 and cast to ``h``'s dtype; ``m`` the whole batch's rows.  ``h`` is
    this rank's columns of ``k`` where ``wo`` is its chunk of ``k`` (a
    ``DTensor``, or with ``chunk`` the plain local tensor), else the whole
    ``k`` that the plan slices."""
    shard = dplan.tp_matmul_shard(mesh, "sigma")
    k = wo.shape[0] * (comm.group_size(mesh.get_group("model")) if chunk
                       else 1)
    plan = dplan.matmul_plan(m, k, wo.shape[1], mesh, shard=shard,
                             dtype=str(h.dtype).removeprefix("torch."))
    x_pl, w_pl = plan.in_placements(mesh)
    if chunk:
        wo = _rows(wo, mesh, w_pl)
    return ops.matmul(_rows(h, mesh, x_pl), wo, out_dtype=h.dtype,
                      mesh=mesh, shard=shard).to_local()


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    mesh = dplan.current_planned_mesh()
    if mesh is not None:
        return _tp_mlp(p, x, cfg, mesh)
    # the first product stays f32 through the activation; the biases
    # (use_bias) join the f32 pre-activation and the output in x's dtype
    h = ops.matmul(x, p["wi"], out_dtype=torch.float32)
    if cfg.use_bias:
        h = h + p["bi"].float()
    if cfg.mlp in ("swiglu", "geglu"):
        u, v = h.chunk(2, dim=-1)
        h = _gate_act(cfg, u) * v
    else:
        h = _gate_act(cfg, h)
    out = ops.matmul(h.to(x.dtype), p["wo"], out_dtype=x.dtype)
    if cfg.use_bias:
        out = out + p["bo"].to(x.dtype)
    return out


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for integer positions (any leading shape) x dim/2."""
    half = dim // 2
    freqs = torch.pow(1.0 / theta, torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rope_pct: float = 1.0) -> torch.Tensor:
    """Half-split rotary embedding.  x: (..., seq, heads, head_dim);
    sin/cos: (..., seq, rot/2) broadcast over heads; partial rotary rotates
    the leading ``rope_pct`` of each head."""
    hd = x.shape[-1]
    rot = int(hd * rope_pct)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    s = sin[..., None, :rot // 2]
    c = cos[..., None, :rot // 2]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def sinusoid_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position encodings ``(..., d)`` f32
    of integer ``positions`` (any shape): ``[sin(p f), cos(p f)]`` with
    ``f_i = exp(-i log(10000) / (d/2 - 1))``, every step in f32 as the
    reference's."""
    half = d // 2
    # a CPU scalar tensor: no host-to-device copy (and no stream sync)
    step = torch.log(torch.tensor(10000.0)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _EmbedRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose backward sums each token's
    rows in a fixed order, so that a training run repeats bit for bit on
    the card: ``index_add_`` of the rows themselves adds a repeated token
    with float atomics there, in an order that changes between runs.  The
    rows are sorted by token (a stable sort), summed as a running f64 sum,
    and each token's total, taken at its last row, is the only nonzero
    row ``index_add_`` puts into its table row (adding exact zeros
    commutes).  Nothing is read back to the host."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        order = torch.argsort(idx, stable=True)
        st = idx.index_select(0, order)
        run = g.index_select(0, order).double().cumsum(0)
        last = torch.ones_like(st, dtype=torch.bool)
        last[:-1] = st[1:] != st[:-1]
        # the running sum up to the previous token's last row (none: 0)
        pos = torch.arange(st.numel(), device=st.device)
        ends = torch.where(last, pos, -1).cummax(0).values
        prev = torch.cat([ends.new_full((1,), -1), ends[:-1]])
        base = run.index_select(0, prev.clamp(min=0)) * (prev >= 0)[:, None]
        total = ((run - base) * last[:, None]).to(g.dtype)
        grad = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        return grad.index_add_(0, st, total), None


def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    # index_select, and under autograd its deterministic backward
    # (:class:`_EmbedRows`); neither reads anything back to the host
    stored = fsdp.gather(params["embed"]["table"], keep_model=True)
    table, dim = _model_chunk(stored)
    idx = tokens.reshape(-1)
    if dim is not None:
        # the table's vocabulary rows over "model": each rank looks up the
        # tokens in its rows, zeros elsewhere, and the ranks' rows summed
        # are the whole lookup (one nonzero a row: exact)
        group = stored.device_mesh.get_group("model")
        lo = comm.group_rank(group) * table.shape[0]
        inside = (idx >= lo) & (idx < lo + table.shape[0])
        idx = torch.where(inside, idx - lo, 0)
    if torch.is_grad_enabled() and table.requires_grad:
        rows = _EmbedRows.apply(table, idx)
    else:
        rows = table.index_select(0, idx)
    if dim is not None:
        rows = comm.psum(rows * inside[:, None].to(rows.dtype), group)
    x = rows.reshape(*tokens.shape, table.shape[-1])
    if cfg.tie_embeddings:
        # gemma convention, the factor rounded to x's dtype; a CPU scalar
        # tensor, so no host-to-device copy (and no stream sync) per call
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


class VocabShard(NamedTuple):
    """A rank's logits on its columns of the vocabulary: ``logits (...,
    V / tp)`` f32, its ``"model"`` ``group`` and its first column
    ``start``."""
    logits: torch.Tensor
    group: object
    start: int


def _tp_logits(w: torch.Tensor, x: torch.Tensor, mesh, transpose_b: bool,
               vocab_shard: bool):
    """The vocab head column-sharded over ``"model"`` (the tied table's
    spec lands on its stored vocab dim; no collective in the plan), its
    columns then gathered over that axis, so every rank holds its rows'
    whole logits in f32; with ``vocab_shard`` they stay this rank's
    columns, a :class:`VocabShard`."""
    x2 = x.reshape(-1, x.shape[-1])
    n = w.shape[0] if transpose_b else w.shape[1]
    shard = dplan.tp_matmul_shard(mesh, "col")
    plan = dplan.matmul_plan(_global_rows(x2, mesh), x2.shape[1], n, mesh,
                             shard=shard, transpose_b=transpose_b,
                             dtype=str(x.dtype).removeprefix("torch."))
    y = ops.matmul(_rows(x2, mesh, plan.in_placements(mesh)[0]), w,
                   transpose_b=transpose_b, out_dtype=torch.float32,
                   mesh=mesh, shard=shard).to_local()
    if plan.out_entries[1] is not None:
        group = mesh.get_group(plan.out_entries[1])
        if vocab_shard:
            return VocabShard(y.reshape(*x.shape[:-1], y.shape[-1]), group,
                              comm.group_rank(group) * y.shape[-1])
        y = comm.gather(y, group, 1)
    return y.reshape(*x.shape[:-1], n)


def logits_from_hidden(params, x: torch.Tensor, cfg: ArchConfig,
                       vocab_shard: bool = False):
    """The f32 logits of ``x`` (softcapped where ``cfg.logit_softcap``);
    under a planned mesh with ``vocab_shard`` (the loss) a
    :class:`VocabShard` where the plan shards the vocabulary over
    ``"model"``, else the whole logits."""
    mesh = dplan.current_planned_mesh()
    if mesh is not None:
        w = fsdp.gather(params["embed"]["table"] if cfg.tie_embeddings
                        else params["unembed"]["w"], keep_model=True)
        if _model_chunk(w)[1] is None:
            w = _model_chunk(w)[0]
        logits = _tp_logits(w, x, mesh, cfg.tie_embeddings, vocab_shard)
        if isinstance(logits, VocabShard):
            return logits._replace(logits=_softcap(logits.logits, cfg))
    elif cfg.tie_embeddings:
        # the (vocab, d) table in its stored layout: never copied transposed
        logits = ops.matmul(x, params["embed"]["table"], transpose_b=True,
                            out_dtype=torch.float32)
    else:
        logits = ops.matmul(x, params["unembed"]["w"],
                            out_dtype=torch.float32)
    return _softcap(logits, cfg)


def _softcap(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


class _VocabParallelNLL(torch.autograd.Function):
    """Each row's NLL of its target from this rank's columns of the
    logits: the row max and the sum of exponentials all-reduced over the
    vocabulary's group in f32, the target's logit taken on the rank that
    holds its column and summed.  The backward is ``softmax - onehot`` on
    the local columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, group, start):
        n = logits.shape[-1]
        m = comm.all_reduce(logits.amax(-1), group, op="max")
        s = comm.all_reduce((logits - m[..., None]).exp().sum(-1), group)
        lse = m + s.log()
        t = targets.long() - start
        inside = (t >= 0) & (t < n)
        t = torch.where(inside, t, 0)
        picked = logits.gather(-1, t[..., None])[..., 0]
        picked = comm.all_reduce(torch.where(inside, picked, 0.0), group)
        ctx.save_for_backward(logits, lse, t, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, t, inside = ctx.saved_tensors
        p = (logits - lse[..., None]).exp()
        p.scatter_add_(-1, t[..., None], -inside[..., None].to(p.dtype))
        return p.mul_(g[..., None]), None, None, None


def token_nll(logits, targets: torch.Tensor) -> torch.Tensor:
    """Each position's NLL of its target: the f32 ``log_softmax`` of whole
    ``logits`` (the reference's), or the vocabulary-parallel one of a
    :class:`VocabShard`."""
    if isinstance(logits, VocabShard):
        return _VocabParallelNLL.apply(logits.logits.float(), targets,
                                       logits.group, logits.start)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
