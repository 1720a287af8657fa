"""The Mamba-2 block (``repro.models.ssm``): the chunked SSD for prefill
and training, the recurrent form for decode.  [arXiv:2405.21060]

The scan is ``ops.scan_ssd`` (K6, its backward K7), at the config's
``ssm_chunk`` or, for ``ssm_chunk = 0``, at the chunk derived on the H100
table (``ops.default_ssd_chunk``, as the reference derives it on its
own); the projections are ``ops.matmul`` (K1).  The causal conv, the gates, softplus and the gated
RMSNorm, and the one-token decode step's state update stay plain
PyTorch, as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.device import cache_device
from repro_torch.kernels import ops


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
                   dtype) -> torch.Tensor:
    y = y * F.silu(z.float()).to(dtype)
    yf = y.float()
    return (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
            * scale.float()).to(dtype)


def apply_mamba2(p, x: torch.Tensor, cfg: ArchConfig,
                 want_cache: bool = True):
    """Full-sequence Mamba-2 block: ``(out, SSMCache | None)``.

    ``want_cache=False`` skips the cache (the conv tail's product and the
    final state): under ``jax.jit`` the reference's loss drops that dead
    code, and here an eager forward would otherwise pay one more K1
    launch a layer."""
    b, s, _ = x.shape
    din, h, n = d_inner(cfg), n_ssd_heads(cfg), cfg.ssm_state
    zxbcdt = ops.matmul(x, p["w_in"], out_dtype=x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, h], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xbc = F.silu(xbc)
    xs, B, C = torch.split(xbc, [din, n, n], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, s, h, cfg.ssm_head_dim)
    y, final = ssd_chunked(xh, dtv, A, B, C,
                           min(cfg.ssm_chunk, s) if cfg.ssm_chunk else None)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = _gated_rmsnorm(y.reshape(b, s, din).to(x.dtype), z,
                       p["norm_scale"], x.dtype)
    out = ops.matmul(y, p["w_out"], out_dtype=x.dtype)
    if not want_cache:
        return out, None
    # the cache: the last conv_width-1 pre-conv inputs and the final state
    pre = ops.matmul(x[:, -(cfg.conv_width - 1):], p["w_in"],
                     out_dtype=x.dtype)
    return out, SSMCache(conv=pre[..., din:2 * din + 2 * n], state=final)


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
