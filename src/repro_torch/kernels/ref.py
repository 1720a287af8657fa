"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
dtypes at the same places, in straightforward tensor code: the CPU path of
the wrappers in ``kernels/ops.py`` and, on the card, the reference
``chip_smoke.py`` holds each kernel against.  Counterparts in the JAX
package: ``ops._xla_matmul_f32``, ``models.chunked_attention`` /
``ops._oracle_attention`` and ``ops._batched_oracle``.
"""
from __future__ import annotations

import torch

#: the masked-score value of the reference (``repro.core.semiring``):
#: finite, so a fully masked block keeps exp() well defined
MASK_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def matmul(x2: torch.Tensor, w2: torch.Tensor,
           transpose_b: bool = False) -> torch.Tensor:
    """``x2 (m, k) @ w2 (k, n)`` (or ``@ w2 (n, k).T``) with an f32
    result accumulated in f32."""
    w = w2.float()
    return x2.float() @ (w.t() if transpose_b else w)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Masked-softmax attention on the grouped layout.

    ``q (B, Sq, KV, G, hd)``, ``k/v (B, Sk, KV, hd)`` -> ``(B, Sq, KV*G,
    vd)`` in ``q.dtype``.  Scores and the softmax are f32; the unnormalized
    probabilities are cast to ``v``'s dtype before ``P.V`` and the sum is
    divided by the f32 denominator, as the flash kernel does."""
    b, sq, kv, g, _ = q.shape
    sk, vd = k.shape[1], v.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, MASK_NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * g, vd).to(q.dtype)


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
