"""Attention for the dense family: the prefill forward and the batched
paged decode (``repro.models.attention``).

Grouped-query attention never repeats K/V heads: queries are reshaped to
``(kv_heads, group)`` and the kernels contract them against the
un-repeated K/V.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rope_tables


class KV(NamedTuple):
    k: torch.Tensor
    v: torch.Tensor


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bsd,d...->bs... through the K1 matmul, cast back to x's dtype."""
    return ops.matmul(x, w, out_dtype=x.dtype)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, out_dtype) -> torch.Tensor:
    """bshk,hkd->bsd: collapse (heads, head_dim) into one K1 product."""
    b, s = out.shape[:2]
    return ops.matmul(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]),
                      out_dtype=out_dtype)


def _rope_pct(cfg: ArchConfig, hd: int) -> float:
    return 1.0 if cfg.rope_pct == 1.0 else (hd * cfg.rope_pct) / hd


def attention_fwd(p, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor, window: int = 0,
                  prefix_len: int = 0) -> tuple[torch.Tensor, KV]:
    """Causal full-sequence attention (prefill) through the K2 flash
    kernel.  Returns the output and the rotated per-layer K/V for the
    cache.  ``prefix_len > 0`` (the VLM prefix-LM) raises for now."""
    b, s, _ = x.shape
    hd = p["wq"].shape[-1]
    scale = hd ** -0.5
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.rope_pct > 0:
        sin, cos = rope_tables(positions, int(hd * cfg.rope_pct),
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos, _rope_pct(cfg, hd))
        k = apply_rope(k, sin, cos, _rope_pct(cfg, hd))
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, q.shape[2] // kvh, hd)
    out = ops.attention(qg, k, v, scale=scale, causal=True, window=window,
                        prefix_len=prefix_len)
    return _out_proj(out, p["wo"], x.dtype), KV(k, v)


def attention_decode_paged_batched(p, x: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor, pos: torch.Tensor,
                                   cfg: ArchConfig, *, tables: torch.Tensor,
                                   page: int, window: int = 0
                                   ) -> torch.Tensor:
    """One-token decode for every serving slot against the shared slab
    pools, one K5 launch for all slots.

    x: (slots, 1, d); pos: (slots,) int32 absolute positions, -1 for a
    dead slot; ``tables`` the (slots, width) int32 view->slab map on the
    device.  Each live slot's new K/V row is written into ``k_pool`` /
    ``v_pool`` IN PLACE at ``tables[s, pos // page] * page + pos % page``.
    A dead slot's write is dropped: it repeats the first live slot's write
    (same row, same value), so the scatter stays one launch with no host
    sync.  At least one slot must be live."""
    hd = p["wq"].shape[-1]
    scale = hd ** -0.5
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.rope_pct > 0:
        sin, cos = rope_tables(pos[:, None], int(hd * cfg.rope_pct),
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos, _rope_pct(cfg, hd))
        k = apply_rope(k, sin, cos, _rope_pct(cfg, hd))
    slots = x.shape[0]
    vpos = pos.long()
    live = vpos >= 0
    ar = torch.arange(slots, device=x.device)
    rows = tables.long()[ar, vpos.clamp_min(0) // page] * page \
        + vpos.clamp_min(0) % page
    # first live slot, kept 1-D: indexing with a 0-d tensor would read it
    # on the host (a device sync per layer)
    first = torch.argmax(live.int()).reshape(1)
    rows = torch.where(live, rows, rows[first])
    k_new = torch.where(live[:, None, None], k[:, 0], k[first, 0])
    v_new = torch.where(live[:, None, None], v[:, 0], v[first, 0])
    k_pool[rows] = k_new.to(k_pool.dtype)
    v_pool[rows] = v_new.to(v_pool.dtype)
    kvh = k_pool.shape[1]
    h = q.shape[2]
    qg = q[:, 0].reshape(slots, kvh, h // kvh, hd).to(k_pool.dtype)
    ctx = ops.paged_decode_batched(qg, k_pool, v_pool, pos, tables,
                                   page=page, scale=scale, window=window)
    out = ctx.reshape(slots, 1, h, hd).to(x.dtype)
    return _out_proj(out, p["wo"], x.dtype)
