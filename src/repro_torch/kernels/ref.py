"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
dtypes at the same places, in straightforward tensor code: the CPU path of
the wrappers in ``kernels/ops.py`` and, on the card, the reference
``chip_smoke.py`` holds each kernel against.  Counterparts in the JAX
package: ``ops._xla_matmul_f32``, ``models.chunked_attention`` /
``ops._oracle_attention``, ``kernels.ref.flash_dq_ref`` /
``flash_dkv_ref`` and ``ops._batched_oracle``.
"""
from __future__ import annotations

import torch

#: the masked-score value of the reference (``repro.core.semiring``):
#: finite, so a fully masked block keeps exp() well defined
MASK_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def matmul(x2: torch.Tensor, w2: torch.Tensor, transpose_b: bool = False,
           *, transpose_a: bool = False) -> torch.Tensor:
    """``x2 (m, k) @ w2 (k, n)`` with an f32 result accumulated in f32;
    ``transpose_b`` takes ``w2`` stored ``(n, k)``, ``transpose_a`` takes
    ``x2`` stored ``(k, m)``.  Either operand may be f32 or bf16: a bf16
    operand is promoted to f32 exactly, as the reference's einsum does."""
    x = x2.float()
    w = w2.float()
    return (x.t() if transpose_a else x) @ (w.t() if transpose_b else w)


def _mask(sq: int, sk: int, causal: bool, window: int, device):
    """(sq, sk) bool: key j visible from query i (causal, window)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
            window: int) -> torch.Tensor:
    """Masked f32 scores ``(B, KV, G, Sq, Sk)`` on the grouped layout;
    masked entries take ``MASK_NEG_INF``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
        s = torch.where(mask, s, MASK_NEG_INF)
    return s


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked-softmax attention on the grouped layout, with the softmax
    statistics.

    ``q (B, Sq, KV, G, hd)``, ``k/v (B, Sk, KV, hd)`` -> ``out (B, Sq,
    KV*G, vd)`` in ``q.dtype`` and ``m, l (B, KV, G, Sq)`` f32: the row
    max of the masked scores and the sum of ``exp(s - m)``.  Scores and
    the softmax are f32; the unnormalized probabilities are cast to
    ``v``'s dtype before ``P.V`` and the sum is divided by the f32
    denominator, as the flash kernel does."""
    b, sq, kv, g, _ = q.shape
    vd = v.shape[-1]
    s = _scores(q, k, scale, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * g, vd).to(q.dtype)
    return out, m[..., 0], l[..., 0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """:func:`attention_stats` without the statistics."""
    return attention_stats(q, k, v, scale=scale, causal=causal,
                           window=window)[0]


def _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window):
    """The flash backward's rebuilt ``p = exp(s - (m + log max(l,
    1e-30)))`` (f32, NOT rounded to v's dtype, as in the reference) and
    ``dS = p * (dO.v - delta)``, both ``(B, KV, G, Sq, Sk)``."""
    s = _scores(q, k, scale, causal, window)
    lse = m.float() + torch.log(l.float().clamp_min(1e-30))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             delta: torch.Tensor, *, scale: float, causal: bool = True,
             window: int = 0) -> torch.Tensor:
    """Flash-backward dq, unblocked: ``q, do (B, Sq, KV, G, ·)``, ``k, v
    (B, Sk, KV, ·)``, ``m, l, delta (B, KV, G, Sq)`` f32 -> ``dq (B, Sq,
    KV, G, hd)`` in ``q.dtype``; the scale applied once at the end (the
    semantics of ``repro.kernels.ref.flash_dq_ref``)."""
    _, ds = _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              delta: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-backward dk, dv, unblocked and summed over the query heads of
    each KV head in f32 (the reference's ``flash_dkv_ref`` followed by its
    group sum): ``(B, Sk, KV, hd)`` each, in k's / v's dtype."""
    p, ds = _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def paged_decode_batched(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, pos: torch.Tensor,
                         tables: torch.Tensor, *, page: int, scale: float,
                         window: int = 0) -> torch.Tensor:
    """Gather each slot's view pages into a contiguous cache, then run the
    masked softmax.  ``q (slots, KV, G, hd)``, pools ``(pool_tokens, KV,
    hd)``, ``pos (slots,)`` int (-1: dead slot), ``tables (slots, width)``
    int slab ids -> ``(slots, KV, G, vd)`` f32; a dead slot's row is 0."""
    slots, width = tables.shape
    idx = (tables.long()[:, :, None] * page
           + torch.arange(page, device=q.device)).reshape(slots, -1)
    k = k_pool[idx].float()                     # (slots, width*page, KV, hd)
    v = v_pool[idx]
    s = torch.einsum("shgc,sjhc->shgj", q.float(), k) * scale
    j = torch.arange(width * page, device=q.device)[None, :]
    vpos = pos.long()[:, None]
    mask = j <= vpos
    if window:
        mask = mask & (j > vpos - window)
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("shgj,sjhd->shgd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    return torch.where((pos >= 0)[:, None, None, None], o, 0.0)
