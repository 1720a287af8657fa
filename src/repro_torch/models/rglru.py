"""The RG-LRU recurrent block (``repro.models.rglru``; Griffin /
RecurrentGemma).  [arXiv:2402.19427]

Recurrence (elementwise over the lru_width channels, f32):

    r_t = sigmoid(W_a x_t)            recurrence gate
    i_t = sigmoid(W_x x_t)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence scan is ``ops.gated_scan`` (K8, its backward K8's
reverse walk) at the chunk derived on the H100 table
(``ops.default_gated_chunk``, as the reference's ``gated_scan`` derives
it on its own); the one-token decode step is the recurrence itself, in
plain PyTorch as in the reference.  The block is (x-branch: linear ->
causal conv -> RG-LRU) gated by (gate-branch: linear -> gelu), then an
output projection.  Every product is ``ops.matmul`` (K1): the reference's
``jnp.einsum`` with ``preferred_element_type=f32``, whose f32 result is
kept (the gate branch, the two gate products) or rounded to the
activations' dtype (the x-branch and the output) at the same places.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.ssm import _causal_conv

_C = 8.0


def lru_width(cfg: ArchConfig) -> int:
    return cfg.lru_width or cfg.d_model


def param_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    """``{name: (shape, init scale, "ones" or "zeros")}`` of one RG-LRU
    stack (``repro.models.rglru.init_rglru``), in its order."""
    d, w = cfg.d_model, lru_width(cfg)
    return {
        "w_x": (lead + (d, w), d ** -0.5),
        "w_gate": (lead + (d, w), d ** -0.5),
        "conv_w": (lead + (cfg.conv_width, w), cfg.conv_width ** -0.5),
        "conv_b": (lead + (w,), "zeros"),
        "wa": (lead + (w, w), w ** -0.5),
        "wi": (lead + (w, w), w ** -0.5),
        "ba": (lead + (w,), "zeros"),
        "bi": (lead + (w,), "zeros"),
        "lam": (lead + (w,), "ones"),
        "w_out": (lead + (w, d), w ** -0.5),
    }


class RGLRUCache(NamedTuple):
    h: torch.Tensor           # (B, lru) f32 recurrent state
    conv: torch.Tensor        # (B, conv_width-1, lru) conv history


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> RGLRUCache:
    """A zero cache on the card (``device="cpu"`` asks for the host)."""
    device = resolve_device(device)
    w = lru_width(cfg)
    return RGLRUCache(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device))


def _gates(p, xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(log_a, b)`` f32: the gate's log (what the scan takes) and the
    gated input ``sqrt(1 - a^2) * i * xc``."""
    r = torch.sigmoid(ops.matmul(xc, p["wa"], out_dtype=torch.float32)
                      + p["ba"].float())
    i = torch.sigmoid(ops.matmul(xc, p["wi"], out_dtype=torch.float32)
                      + p["bi"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return log_a, mult * i * xc.float()


def apply_rglru(p, x: torch.Tensor, cfg: ArchConfig
                ) -> tuple[torch.Tensor, RGLRUCache]:
    """Full-sequence block.  x: (B, S, d); returns ``(out (B, S, d), the
    RGLRUCache after the last position)``.  The cache costs no product
    (the conv history is the x-branch's last rows), so it is always
    returned."""
    xb = ops.matmul(x, p["w_x"], out_dtype=x.dtype)
    gate = ops.matmul(x, p["w_gate"], out_dtype=torch.float32)
    xc = _causal_conv(xb, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    log_a, b_in = _gates(p, xc)
    h, h_last = ops.gated_scan(log_a, b_in)
    y = (h * F.gelu(gate, approximate="tanh")).to(x.dtype)
    out = ops.matmul(y, p["w_out"], out_dtype=x.dtype)
    return out, RGLRUCache(h=h_last, conv=xb[:, -(cfg.conv_width - 1):])


def decode_rglru(p, x: torch.Tensor, cache: RGLRUCache, cfg: ArchConfig
                 ) -> tuple[torch.Tensor, RGLRUCache]:
    """One-token step.  x: (B, 1, d); returns ``(out (B, 1, d), the new
    RGLRUCache)``."""
    xb = ops.matmul(x, p["w_x"], out_dtype=x.dtype)
    gate = ops.matmul(x, p["w_gate"], out_dtype=torch.float32)
    hist = torch.cat([cache.conv, xb], dim=1)                 # (B, W, lru)
    xc = (torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype))
          + p["conv_b"].to(x.dtype))[:, None]
    log_a, b_in = _gates(p, xc)
    h = torch.exp(log_a[:, 0]) * cache.h + b_in[:, 0]
    y = (h[:, None] * F.gelu(gate, approximate="tanh")).to(x.dtype)
    out = ops.matmul(y, p["w_out"], out_dtype=x.dtype)
    return out, RGLRUCache(h=h, conv=hist[:, 1:])
