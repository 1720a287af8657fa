"""Building-block layers: norms, the gated MLP, rotary and sinusoidal
position embeddings, the embedding and the vocab head
(``repro.models.layers``).

Plain functions over parameter dicts (``nn.ParameterDict`` or any mapping
of tensors): RMSNorm or LayerNorm, the MLP with or without its biases.
Norms and softmax run in f32; every product goes through ``ops.matmul``
(f32 accumulate), with the reference's casts at the same places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
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


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
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
    table = params["embed"]["table"]
    idx = tokens.reshape(-1)
    if torch.is_grad_enabled() and table.requires_grad:
        rows = _EmbedRows.apply(table, idx)
    else:
        rows = table.index_select(0, idx)
    x = rows.reshape(*tokens.shape, table.shape[-1])
    if cfg.tie_embeddings:
        # gemma convention, the factor rounded to x's dtype; a CPU scalar
        # tensor, so no host-to-device copy (and no stream sync) per call
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_from_hidden(params, x: torch.Tensor,
                       cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        # the (vocab, d) table in its stored layout: never copied transposed
        logits = ops.matmul(x, params["embed"]["table"], transpose_b=True,
                            out_dtype=torch.float32)
    else:
        logits = ops.matmul(x, params["unembed"]["w"],
                            out_dtype=torch.float32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
