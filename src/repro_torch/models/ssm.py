"""The Mamba-2 block (``repro.models.ssm``): the chunked SSD for prefill
and training, the recurrent form for decode.  [arXiv:2405.21060]

The scan is ``ops.scan_ssd`` (K6, its backward K7), at the config's
``ssm_chunk`` or, for ``ssm_chunk = 0``, at the chunk derived on the H100
table (``ops.default_ssd_chunk``, as the reference derives it on its
own); the projections are ``ops.matmul`` (K1).  The causal conv, the gates, softplus and the gated
RMSNorm, and the one-token decode step's state update stay plain
PyTorch, as the reference computes them outside any Pallas kernel.

In the sharded train step (``norm_scale`` / ``w_out`` the ``DTensor``
of their stored chunk of ``d_inner`` over ``"model"``, whole SSD heads a
rank) each rank computes ``w_in``'s product and the conv whole (their
columns' chunks straddle the ``[z | x | B | C | dt]`` split), sums the
gradients of ``z``, the conv's output and ``dt`` over ``"model"`` (each
rank reads them on its heads), then runs K6 / K7 on its heads, the gated
RMSNorm with its sum of squares psummed over ``"model"`` in f32, and
``w_out``'s rows on the ``"sigma"`` plan with its psum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.device import cache_device
from repro_torch.distributed import comm
from repro_torch.kernels import ops
from repro_torch.models.layers import _global_rows, _model_chunk, sigma_matmul


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssd_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg: ArchConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state


def param_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    """``{name: (shape, init scale, "ones" or "zeros")}`` of one mixer
    stack (``repro.models.ssm.init_mamba2``), in its order; ``w_in``
    projects to ``[z, x, B, C, dt]``."""
    d = cfg.d_model
    din, h, n = d_inner(cfg), n_ssd_heads(cfg), cfg.ssm_state
    return {
        "w_in": (lead + (d, 2 * din + 2 * n + h), d ** -0.5),
        "conv_w": (lead + (cfg.conv_width, conv_dim(cfg)),
                   cfg.conv_width ** -0.5),
        "conv_b": (lead + (conv_dim(cfg),), "zeros"),
        "A_log": (lead + (h,), "zeros"),
        "D": (lead + (h,), "ones"),
        "dt_bias": (lead + (h,), "zeros"),
        "norm_scale": (lead + (din,), "ones"),
        "w_out": (lead + (din, d), din ** -0.5),
    }


class SSMCache(NamedTuple):
    conv: torch.Tensor        # (B, conv_width-1, conv_dim): trailing inputs
    state: torch.Tensor       # (B, H, p, N) f32


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device="cuda") -> SSMCache:
    """A zero cache on the card (``device="cpu"`` asks for the host)."""
    device = cache_device(device)
    h, p, n = n_ssd_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim(cfg)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, h, p, n), dtype=torch.float32,
                          device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: (B, S, C), w: (W, C)."""
    wwidth = w.shape[0]
    out = x * w[-1]
    for i in range(1, wwidth):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[wwidth - 1 - i]
    return out + b


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int | None = None,
                init_state: torch.Tensor | None = None):
    """SSD over a full sequence.  x: (b, s, h, p), dt: (b, s, h)
    (post-softplus), A: (h,) negative, B, C: (b, s, n).  Folds dt into the
    input and the log decay and runs ``ops.scan_ssd``; returns ``(y (b, s,
    h, p), final state (b, h, p, n))`` f32."""
    xf = (x * dt[..., None]).float()
    dA = (dt * A).float()
    return ops.scan_ssd(xf, dA, B.float(), C.float(), init_state=init_state,
                        chunk=chunk)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   dtype, group=None, width: int = 0) -> torch.Tensor:
    """``y * silu(z)`` RMS-normed over its last dim; with the ``"model"``
    ``group`` that dim is this rank's part of ``width`` channels, whose
    sum of squares is psummed over the group in f32 (its gradient, a
    part on each rank, summed back)."""
    y = y * F.silu(z.float()).to(dtype)
    yf = y.float()
    if group is None:
        ms = yf.square().mean(-1, keepdim=True)
    else:
        ms = comm.replicated_in(comm.psum(
            yf.square().sum(-1, keepdim=True), group), group) / width
    return (yf * torch.rsqrt(ms + 1e-6) * scale.float()).to(dtype)


def apply_mamba2(p, x: torch.Tensor, cfg: ArchConfig,
                 want_cache: bool = True):
    """Full-sequence Mamba-2 block: ``(out, SSMCache | None)``.

    ``want_cache=False`` skips the cache (the conv tail's product and the
    final state): under ``jax.jit`` the reference's loss drops that dead
    code, and here an eager forward would otherwise pay one more K1
    launch a layer.  In the sharded step (the module docstring) each
    rank runs its SSD heads; its cache would hold the whole conv tail and
    its heads' state, and is not made under autograd (the loss does not
    read it)."""
    b, s, _ = x.shape
    din, h, n = d_inner(cfg), n_ssd_heads(cfg), cfg.ssm_state
    sharded = _model_chunk(p["w_out"])[1] is not None
    group, tp, r = None, 1, 0
    if sharded:
        mesh = p["w_out"].device_mesh
        group = mesh.get_group("model")
        tp, r = comm.group_size(group), comm.group_rank(group)
    hl, dl = h // tp, din // tp
    # this rank's heads (of a width per rank) of a tensor every rank
    # reads, whose gradient is then summed over "model"
    shared = (lambda t: t) if group is None else \
        (lambda t: comm.replicated_in(t, group))
    mine = lambda t, width: t if tp == 1 else t.narrow(-1, r * width, width)
    zxbcdt = ops.matmul(x, p["w_in"], out_dtype=x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xbc = F.silu(xbc)
    z, xbc, dt = shared(z), shared(xbc), shared(dt)
    xs, B, C = torch.split(xbc, [din, n, n], dim=-1)
    dtv = F.softplus(mine(dt, hl).float()
                     + mine(shared(p["dt_bias"]), hl).float())
    A = -torch.exp(mine(shared(p["A_log"]), hl).float())
    xh = mine(xs, dl).reshape(b, s, hl, cfg.ssm_head_dim)
    y, final = ssd_chunked(xh, dtv, A, B, C,
                           min(cfg.ssm_chunk, s) if cfg.ssm_chunk else None)
    y = y + mine(shared(p["D"]), hl).float()[None, None, :, None] \
        * xh.float()
    y = _gated_rmsnorm(y.reshape(b, s, dl).to(x.dtype), mine(z, dl),
                       _model_chunk(p["norm_scale"])[0], x.dtype, group, din)
    if sharded:
        y2 = y.reshape(b * s, dl)
        out = sigma_matmul(y2, p["w_out"], mesh,
                           _global_rows(y2, mesh)).reshape(b, s, -1)
    else:
        out = ops.matmul(y, p["w_out"], out_dtype=x.dtype)
    if not want_cache or (sharded and torch.is_grad_enabled()):
        return out, None
    # the cache: the last conv_width-1 pre-conv inputs and the final state
    pre = ops.matmul(x[:, -(cfg.conv_width - 1):], p["w_in"],
                     out_dtype=x.dtype)
    return out, SSMCache(conv=pre[..., din:2 * din + 2 * n], state=final)


def train_traffic(p, cfg: ArchConfig, rows: int, tp: int, esz: int) -> list:
    """The ``"model"`` collectives (``comm.Traffic``) of one Mamba-2 mixer
    (:func:`apply_mamba2`, ``p`` its leaves' shapes and dtypes) in the
    sharded train step on ``rows`` rows of ``esz``-byte activations over
    ``tp`` ranks, where its SSD heads divide: the gradient sums of ``z``,
    the conv's output and ``dt`` and of the three head leaves, the gated
    RMSNorm's f32 sum of squares psummed and its gradient summed, and the
    output's f32 psum."""
    heads = p["A_log"].shape[-1]
    if heads % tp:
        return []
    din = p["norm_scale"].shape[-1]
    out = [comm.Traffic("all-reduce", rows * w * esz, "bwd")
           for w in (din, din + 2 * cfg.ssm_state, heads)]
    out += [comm.Traffic("all-reduce", comm.nbytes(p[k]), "bwd")
            for k in ("A_log", "D", "dt_bias")]
    return out + [comm.Traffic("all-reduce", rows * 4, "fwd"),
                  comm.Traffic("all-reduce", rows * 4, "bwd"),
                  comm.Traffic("all-reduce", rows * cfg.d_model * 4, "fwd")]


def decode_mamba2(p, x: torch.Tensor, cache: SSMCache, cfg: ArchConfig):
    """One-token recurrent step.  x: (B, 1, d); returns ``(out (B, 1, d),
    the new SSMCache)``."""
    b = x.shape[0]
    din, h, n = d_inner(cfg), n_ssd_heads(cfg), cfg.ssm_state
    zxbcdt = ops.matmul(x, p["w_in"], out_dtype=x.dtype)
    z, xbc_new, dt = torch.split(zxbcdt[:, 0], [din, din + 2 * n, h],
                                 dim=-1)
    # conv over (cached W-1 inputs, new input)
    hist = torch.cat([cache.conv, xbc_new[:, None]], dim=1)    # (B, W, C)
    xbc = torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    xbc = F.silu(xbc)
    xs, B, C = torch.split(xbc, [din, n, n], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, h, cfg.ssm_head_dim).float()
    dA = torch.exp(dtv * A)                                     # (b, h)
    Bx = torch.einsum("bhp,bn->bhpn", xh * dtv[..., None], B.float())
    state = dA[..., None, None] * cache.state + Bx
    y = torch.einsum("bhpn,bn->bhp", state, C.float())
    y = y + p["D"].float()[None, :, None] * xh
    y = _gated_rmsnorm(y.reshape(b, din).to(x.dtype), z, p["norm_scale"],
                       x.dtype)
    out = ops.matmul(y, p["w_out"], out_dtype=x.dtype)[:, None]
    return out, SSMCache(conv=hist[:, 1:], state=state)
