"""Attention (``repro.models.attention``): the prefill forward, the dense
family's decodes (contiguous per-slot caches, one sequence's paged view,
every slot's paged views in one launch) and the ring-cache decode of the
local (windowed) layers.  The q/k/v and output biases (``use_bias``) are
added where the reference adds them.

Grouped-query attention never repeats K/V heads: queries are reshaped to
``(kv_heads, group)`` and the kernels contract them against the
un-repeated K/V.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_NEG_INF
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


def _qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         bias: bool = True):
    """The q, k, v projections ``(B, S, heads, hd)`` of ``x (B, S, d)``:
    plus their biases (``use_bias``; the reference's ring decode adds none,
    ``bias=False``), then the rotary embedding of ``positions``
    (broadcastable to ``(B, S)``) on the leading ``rope_pct`` of each
    head."""
    hd = p["wq"].shape[-1]
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if bias and cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.rope_pct > 0:
        sin, cos = rope_tables(positions, int(hd * cfg.rope_pct),
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos, _rope_pct(cfg, hd))
        k = apply_rope(k, sin, cos, _rope_pct(cfg, hd))
    return q, k, v


def _out(p, out: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """The output projection of ``out (B, S, heads, hd)``, plus its bias
    (``use_bias``)."""
    o = _out_proj(out, p["wo"], dtype)
    return o + p["bo"].to(dtype) if cfg.use_bias else o


def attention_fwd(p, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor, window: int = 0,
                  prefix_len: int = 0) -> tuple[torch.Tensor, KV]:
    """Causal full-sequence attention (prefill) through the K2 flash
    kernel.  Returns the output and the rotated per-layer K/V for the
    cache.  ``prefix_len > 0`` (the VLM prefix-LM) raises for now."""
    b, s, _ = x.shape
    hd = p["wq"].shape[-1]
    q, k, v = _qkv(p, x, cfg, positions)
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, q.shape[2] // kvh, hd)
    out = ops.attention(qg, k, v, scale=hd ** -0.5, causal=True,
                        window=window, prefix_len=prefix_len)
    return _out(p, out, cfg, x.dtype), KV(k, v)


def attention_decode_paged(p, x: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pos: torch.Tensor,
                           cfg: ArchConfig, *, table: torch.Tensor,
                           page: int, window: int = 0) -> torch.Tensor:
    """One-token decode of ONE sequence against its paged view of the slab
    pools, through K5 at one slot (``ops.paged_decode``).

    x: (1, 1, d); pos: (1,) int32 the new token's position on the device;
    ``table`` the (width,) int32 view->slab map on the device.  The new
    K/V row is written into ``k_pool`` / ``v_pool`` IN PLACE at
    ``table[pos // page] * page + pos % page`` (the reference returns new
    pools).  Returns the output (1, 1, d)."""
    hd = p["wq"].shape[-1]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    vpos = pos.long()
    row = table.long()[vpos // page] * page + vpos % page
    k_pool[row] = k[:, 0].to(k_pool.dtype)
    v_pool[row] = v[:, 0].to(v_pool.dtype)
    kvh, h = k_pool.shape[1], q.shape[2]
    qg = q[0, 0].reshape(kvh, h // kvh, hd).to(k_pool.dtype)
    ctx = ops.paged_decode(qg, k_pool, v_pool, pos, table, page=page,
                           scale=hd ** -0.5, window=window)
    return _out(p, ctx.reshape(1, 1, h, hd).to(x.dtype), cfg, x.dtype)


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
    q, k, v = _qkv(p, x, cfg, pos[:, None])
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
                                   page=page, scale=hd ** -0.5,
                                   window=window)
    return _out(p, ctx.reshape(slots, 1, h, hd).to(x.dtype), cfg, x.dtype)


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """A new cache with ``new (B, 1, ...)`` written at each row's ``slot
    (B,)`` of ``cache (B, S, ...)``: a one-hot select on the device (the
    reference's ``_cache_write``), so no index is read on the host."""
    b, s = cache.shape[:2]
    hit = torch.arange(s, device=cache.device)[None, :] == slot[:, None]
    hit = hit.reshape(b, s, *([1] * (cache.dim() - 2)))
    return torch.where(hit, new.to(cache.dtype), cache)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The materialized masked softmax of the reference's ``_attend``:
    ``q (B, Sq, KV, G, hd)``, ``k/v (B, Sk, KV, hd)``, ``mask``
    broadcastable to ``(B, KV, G, Sq, Sk)`` -> ``(B, Sq, KV*G, hd)`` in
    v's dtype; f32 scores and softmax, the weights rounded to v's dtype
    before the f32-accumulated product."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    w = torch.softmax(torch.where(mask, s, MASK_NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    b, sq, kv, g, hd = out.shape
    return out.reshape(b, sq, kv * g, hd)


def attention_decode(p, x: torch.Tensor, cache: KV, pos: torch.Tensor,
                     cfg: ArchConfig, *, window: int = 0
                     ) -> tuple[torch.Tensor, KV]:
    """One-token decode against contiguous caches.  x: (B, 1, d); ``cache``
    k/v (B, cache_len, KV, hd); ``pos (B,)`` the new token's absolute
    positions on the device.  The new K/V are written at ``pos`` (a one-hot
    select), and each row attends to the keys at positions ``<= pos`` (and
    ``> pos - window`` with a window).  Returns the output and a new cache
    (the input cache is not written).  The reference computes this in jnp
    with no Pallas kernel; so does the port, in plain PyTorch (its
    projections through K1)."""
    b = x.shape[0]
    hd = p["wq"].shape[-1]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    pos = pos.long()
    ck = _cache_write(cache.k, k, pos)
    cv = _cache_write(cache.v, v, pos)
    kpos = torch.arange(ck.shape[1], device=x.device)[None, :]
    valid = kpos <= pos[:, None]
    if window > 0:
        valid = valid & (kpos > pos[:, None] - window)
    kvh = ck.shape[2]
    qg = q.reshape(b, 1, kvh, q.shape[2] // kvh, hd)
    out = _attend(qg, ck, cv, valid[:, None, None, None, :], hd ** -0.5)
    return _out(p, out, cfg, x.dtype), KV(ck, cv)


def attention_decode_ring(p, x: torch.Tensor, cache: KV, pos: torch.Tensor,
                          cfg: ArchConfig) -> tuple[torch.Tensor, KV]:
    """One-token decode against a RING cache for windowed (local)
    attention.  x: (B, 1, d); ``pos (B,)`` the new token's absolute
    positions on the device; ``cache`` k/v (B, W, KV, hd), W =
    min(window, cache_len).

    The cache holds exactly the last W tokens: after the write at slot
    ``pos % W``, slot j carries the key/value of absolute position ``pos -
    ((pos - j) mod W)``, and slots whose position is negative are masked.
    Returns the output and a new cache (the input cache is not written).
    The reference computes this in jnp with no Pallas kernel; so does the
    port, in plain PyTorch."""
    b = x.shape[0]
    hd = p["wq"].shape[-1]
    wlen = cache.k.shape[1]
    q, k, v = _qkv(p, x, cfg, pos[:, None], bias=False)
    pos = pos.long()
    slot = pos % wlen
    ck = _cache_write(cache.k, k, slot)
    cv = _cache_write(cache.v, v, slot)
    j = torch.arange(wlen, device=x.device)[None, :]
    kpos = pos[:, None] - torch.remainder(pos[:, None] - j, wlen)
    mask = (kpos >= 0)[:, None, None, None, :]
    kvh = ck.shape[2]
    qg = q.reshape(b, 1, kvh, q.shape[2] // kvh, hd)
    out = _attend(qg, ck, cv, mask, hd ** -0.5)
    return _out(p, out, cfg, x.dtype), KV(ck, cv)
