"""Attention (``repro.models.attention``): the full-sequence forward
(causal, windowed or prefix-LM; bidirectional for the encoder; cross-
attention over given K/V), the dense family's decodes (contiguous
per-slot caches, one sequence's paged view, every slot's paged views in
one launch), the ring-cache decode of the
local (windowed) layers, and MLA (multi-head latent attention: the
non-absorbed forward on K2, the absorbed one-token decode over the
latent cache on K1's head form).  The q/k/v and output biases
(``use_bias``) are added where the reference adds them.

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
                  causal: bool = True, prefix_len: int = 0,
                  kv_override: KV | None = None) -> tuple[torch.Tensor, KV]:
    """Full-sequence attention (training, prefill) through the K2 flash
    kernel.  Returns the output and the per-layer K/V (rotated) for the
    cache.  ``prefix_len``: the leading positions attend to each other
    both ways (the VLM's prefix-LM over its image patches).  ``causal``
    False: bidirectional (the whisper encoder; the reference takes it in
    einsums, the port on K2's bidirectional form).  ``kv_override``: the
    given K/V are attended to, and none are projected (whisper's
    cross-attention; the queries are not rotated, as in the reference).
    A window or a prefix without ``causal`` raises (``ops.attention``)."""
    b, s, _ = x.shape
    hd = p["wq"].shape[-1]
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg, positions)
    else:
        q = _proj(x, p["wq"])
        if cfg.use_bias:
            q = q + p["bq"].to(x.dtype)
        k, v = kv_override
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, q.shape[2] // kvh, hd)
    out = ops.attention(qg, k, v, scale=hd ** -0.5, causal=causal,
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

#: MLA widths (MiniCPM3-4B): q_rank, kv_rank, qk_nope, qk_rope, v_head
MLA_DIMS = (768, 256, 64, 32, 64)


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, S, kv_rank)
    k_pe: torch.Tensor       # (B, S, rope_dim)


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """MLA's RMSNorm of the latents, in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _mla_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """``(q_nope, q_pe, c_kv, k_pe)`` of ``x (B, S, d)``: the queries
    ``(B, S, h, nope)`` / ``(B, S, h, rope)`` through the normed q latent,
    the normed kv latent ``(B, S, kv_rank)`` and the shared rotary key
    ``(B, S, rope)``, the rotary embedding of ``positions``
    (broadcastable to ``(B, S)``) on ``q_pe`` and ``k_pe``."""
    _, kvr, nope, rope, _ = MLA_DIMS
    cq = _rms(_proj(x, p["wq_a"]), p["q_norm"])
    q = _proj(cq, p["wq_b"])                        # (B, S, h, nope + rope)
    kv_all = _proj(x, p["wkv_a"])                   # (B, S, kv_rank + rope)
    c_kv = _rms(kv_all[..., :kvr], p["kv_norm"])
    sin, cos = rope_tables(positions, rope, cfg.rope_theta)
    q_pe = apply_rope(q[..., nope:], sin, cos)
    k_pe = apply_rope(kv_all[..., None, kvr:], sin, cos)[:, :, 0, :]
    return q[..., :nope], q_pe, c_kv, k_pe


def mla_attention(q_nope: torch.Tensor, q_pe: torch.Tensor,
                  k_nope: torch.Tensor, k_pe: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """MLA's causal full-sequence attention on K2 (K3 / K4 for its
    gradients): ``q'' = [q_nope, q_pe]`` and ``k'' = [k_nope, k_pe
    broadcast over the heads]`` (the reference's chunked branch folds its
    two score terms alike) at their q.k width (nope + rope, 96 at
    minicpm3-4b) and ``v`` at its own (64), taken as ``h`` KV heads of one
    query head each at MLA's own ``scale`` -> ``(B, S, h, vd)``.  K2-K4
    are built for (96, 64) (``ops.FLASH_WIDTHS``): no zero column."""
    b, s, h, nope = q_nope.shape
    rope = q_pe.shape[-1]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rope)],
                  dim=-1)
    return ops.attention(q.reshape(b, s, h, 1, nope + rope), k,
                         v.contiguous(), scale=scale, causal=True)


def mla_fwd(p, x: torch.Tensor, cfg: ArchConfig, *,
            positions: torch.Tensor) -> tuple[torch.Tensor, MLACache]:
    """Full-sequence MLA (training, prefill): the non-absorbed expansion
    of the kv latent into per-head keys and values, then
    :func:`mla_attention` on K2 at every length (the reference computes
    the same function in einsums below ``cfg.attn_chunk_min_seq`` and by
    chunks above it).  Returns the output and the ``MLACache`` (the normed
    kv latent and the rotated shared key)."""
    _, _, nope, rope, _ = MLA_DIMS
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(p, x, cfg, positions)
    kv = _proj(c_kv, p["wkv_b"])                    # (B, S, h, nope + vd)
    out = mla_attention(q_nope, q_pe, kv[..., :nope], k_pe, kv[..., nope:],
                        (nope + rope) ** -0.5)
    return _out_proj(out, p["wo"], x.dtype), MLACache(c_kv, k_pe)


def mla_decode(p, x: torch.Tensor, cache: MLACache, pos: torch.Tensor,
               cfg: ArchConfig) -> tuple[torch.Tensor, MLACache]:
    """Absorbed one-token MLA decode over the latent cache.  x: (B, 1, d);
    ``cache`` c_kv (B, cache_len, kv_rank), k_pe (B, cache_len, rope);
    ``pos (B,)`` the new token's absolute positions on the device.  The
    new latents are written at ``pos`` (a one-hot select); ``W_UK`` is
    absorbed into the query and ``W_UV`` applied to the latent context by
    ``ops.head_matmul`` on strided views of the stored ``wkv_b`` (K1's
    head form: no per-step weight relayout).  The attention over the
    latent cache is plain PyTorch, as the reference's is jnp.  Returns the
    output and a new cache (the input cache is not written)."""
    _, _, nope, rope, _ = MLA_DIMS
    q_nope, q_pe, c_new, kpe_new = _mla_qkv(p, x, cfg, pos[:, None])
    pos = pos.long()
    c_kv = _cache_write(cache.c_kv, c_new, pos)
    k_pe = _cache_write(cache.k_pe, kpe_new, pos)
    q_lat = ops.head_matmul(q_nope, p["wkv_b"][..., :nope], transpose_b=True,
                            out_dtype=x.dtype)      # (B, 1, h, kv_rank)
    sc = torch.einsum("bshr,bkr->bhsk", q_lat.float(), c_kv.float())
    sp = torch.einsum("bshr,bkr->bhsk", q_pe.float(), k_pe.float())
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, :] \
        <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], (sc + sp) * (nope + rope)
                         ** -0.5, MASK_NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhsk,bkr->bshr", w.float(), c_kv.float()).to(
        x.dtype).contiguous()
    out = ops.head_matmul(ctx, p["wkv_b"][..., nope:], out_dtype=x.dtype)
    return _out_proj(out, p["wo"], x.dtype), MLACache(c_kv, k_pe)
