"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
dtypes at the same places, in straightforward tensor code: the CPU path of
the wrappers in ``kernels/ops.py`` and, on the card, the reference
``chip_smoke.py`` holds each kernel against.  Counterparts in the JAX
package: ``ops._xla_matmul_f32``, ``models.chunked_attention`` /
``ops._oracle_attention``, ``kernels.ref.flash_dq_ref`` /
``flash_dkv_ref``, ``ops._batched_oracle``, ``kernels.ref.ssd_scan_ref``,
``ssd_bwd_ref`` and ``gated_scan_ref``.
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


# ---------------------------------------------------------------------------
# the SSD (Mamba-2) chunked scan and its reverse scan
# ---------------------------------------------------------------------------

def _ssd_chunk_factors(dab: torch.Tensor, Cb: torch.Tensor,
                       Bb: torch.Tensor, tril: torch.Tensor):
    """One chunk's forward factoring, in the reference's order: ``csh``
    the in-chunk cumulative log decay ``(b, h, q)``, the masked segsum
    decay ``L (b, h, q, q)``, the scores ``G = C.B' (b, q, q)``, ``P = G
    L``, ``in_decay = exp(csh)``, ``total`` ``(b, h)`` and the decay to
    the chunk's end ``decay_states (b, h, q)``."""
    csh = torch.cumsum(dab, dim=1).transpose(1, 2)             # (b, h, i)
    seg = csh[..., :, None] - csh[..., None, :]                # (b, h, i, j)
    L = torch.exp(torch.where(tril, seg, MASK_NEG_INF))
    G = torch.einsum("bin,bjn->bij", Cb, Bb)
    P = G[:, None] * L
    in_decay = torch.exp(csh)
    total = csh[..., -1]
    decay_states = torch.exp(total[..., None] - csh)
    return csh, L, G, P, in_decay, total, decay_states


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, h0: torch.Tensor, chunk: int,
             export_h_in: bool = False):
    """The chunked SSD scan (the semantics of ``repro.kernels.ref.
    ssd_scan_ref``, step for step): ``xdt (b, S, h, p)`` the dt-folded
    input, ``dA (b, S, h)`` the log decay, ``B/C (b, S, n)``, ``h0 (b, h,
    p, n)``, all f32, with ``S`` a multiple of ``chunk``.  Returns ``(y
    (b, S, h, p), final state (b, h, p, n), h_in (b, nc, h, p, n) | None)``
    where ``h_in[:, c]`` is the state entering chunk ``c`` (the
    checkpoints the reverse scan replays from)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    xc = xdt.float().reshape(b, nc, q, h, p)
    dac = dA.float().reshape(b, nc, q, h)
    Bc = B.float().reshape(b, nc, q, n)
    Cc = C.float().reshape(b, nc, q, n)
    tril = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    h_prev = h0.float()
    ys, h_in = [], []
    for c in range(nc):
        xb, Bb, Cb = xc[:, c], Bc[:, c], Cc[:, c]
        if export_h_in:
            h_in.append(h_prev)
        _, _, _, P, in_decay, total, decay_states = _ssd_chunk_factors(
            dac[:, c], Cb, Bb, tril)
        y = torch.einsum("bhij,bjhp->bihp", P, xb)
        t_off = torch.einsum("bin,bhpn->bihp", Cb, h_prev)
        y = y + t_off * in_decay.transpose(1, 2)[..., None]
        xd = xb * decay_states.transpose(1, 2)[..., None]
        S = torch.einsum("bjn,bjhp->bhpn", Bb, xd)
        h_prev = torch.exp(total)[..., None, None] * h_prev + S
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, h_prev, (torch.stack(h_in, dim=1) if export_h_in else None)


def ssd_bwd(C: torch.Tensor, B: torch.Tensor, dY: torch.Tensor,
            X: torch.Tensor, dA: torch.Tensor, Hin: torch.Tensor,
            dHf: torch.Tensor):
    """The SSD reverse scan (the semantics of ``repro.kernels.ref.
    ssd_bwd_ref``, einsum for einsum), over operands in forward order:
    ``C/B (b, S, n)``, ``dY/X (b, S, h, p)``, ``dA (b, S, h)``, the saved
    entering states ``Hin (b, nc, h, p, n)`` (the chunk is ``S // nc``)
    and the final-state cotangent ``dHf (b, h, p, n)``, all f32.  Walks
    the chunks from last to first carrying the state cotangent ``dh``,
    replaying each chunk's forward factoring from its ``Hin``.  Returns
    ``(dX (b, S, h, p), dh0 (b, h, p, n), dB (b, S, n), dC (b, S, n),
    ddA (b, S, h))`` f32, in forward order."""
    b, s, n = C.shape
    h, p = X.shape[2:]
    nc = Hin.shape[1]
    q = s // nc
    rs = lambda t, *tail: t.float().reshape(b, nc, q, *tail)
    Cc, Bc, dYc, Xc, dAc = (rs(C, n), rs(B, n), rs(dY, h, p), rs(X, h, p),
                            rs(dA, h))
    tril = torch.ones(q, q, dtype=torch.bool, device=C.device).tril()
    last = torch.arange(q, device=C.device)[None, :] == q - 1
    dh = dHf.float()
    dX, dB, dC, ddA = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        Cb, Bb, dYb, Xb, Hc = Cc[:, c], Bc[:, c], dYc[:, c], Xc[:, c], \
            Hin[:, c].float()
        _, L, G, P, in_decay, total, decay_states = _ssd_chunk_factors(
            dAc[:, c], Cb, Bb, tril)
        t_off = torch.einsum("bin,bhpn->bihp", Cb, Hc)
        Xd = Xb * decay_states.transpose(1, 2)[..., None]
        dtotal = torch.einsum("bhpn,bhpn->bh", dh, Hc) * torch.exp(total)
        dh_prev = torch.exp(total)[..., None, None] * dh
        dBb = torch.einsum("bhpn,bjhp->bjn", dh, Xd)
        dXd = torch.einsum("bjn,bhpn->bjhp", Bb, dh)
        dXb = dXd * decay_states.transpose(1, 2)[..., None]
        ddec = torch.einsum("bjhp,bjhp->bhj", dXd, Xb)
        dtotal = dtotal + torch.sum(ddec * decay_states, dim=2)
        dcsh = -(ddec * decay_states)
        dt_off = dYb * in_decay.transpose(1, 2)[..., None]
        din_decay = torch.sum(dYb * t_off, dim=-1).transpose(1, 2)
        dcsh = dcsh + din_decay * in_decay
        dCb = torch.einsum("bihp,bhpn->bin", dt_off, Hc)
        dh_prev = dh_prev + torch.einsum("bin,bihp->bhpn", Cb, dt_off)
        dP = torch.einsum("bihp,bjhp->bhij", dYb, Xb)
        dXb = dXb + torch.einsum("bhij,bihp->bjhp", P, dYb)
        dG = torch.sum(dP * L, dim=1)
        dL = dP * G[:, None]
        dseg = torch.where(tril, dL * L, 0.0)
        dcsh = dcsh + dseg.sum(dim=3) - dseg.sum(dim=2)
        dCb = dCb + torch.einsum("bij,bjn->bin", dG, Bb)
        dBb = dBb + torch.einsum("bij,bin->bjn", dG, Cb)
        dcsh = dcsh + torch.where(last, dtotal[..., None], 0.0)
        ddA[c] = torch.flip(torch.cumsum(torch.flip(dcsh, dims=(2,)), dim=2),
                            dims=(2,)).transpose(1, 2)
        dX[c], dB[c], dC[c] = dXb, dBb, dCb
        dh = dh_prev
    cat = lambda ts, *tail: torch.stack(ts, dim=1).reshape(b, s, *tail)
    return cat(dX, h, p), dh, cat(dB, n), cat(dC, n), cat(ddA, h)


# ---------------------------------------------------------------------------
# the RG-LRU gated linear scan, forward and reverse
# ---------------------------------------------------------------------------

def gated_scan(log_a: torch.Tensor, b_in: torch.Tensor,
               h0: torch.Tensor | None = None, reverse: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gated linear scan walked step by step (the semantics of
    ``repro.kernels.ref.gated_scan_ref`` and ``gated_chunk_ref``):
    ``h_t = a_t * h_{t-1} + b_t`` with ``a = exp(log_a)`` and ``h_{-1} =
    h0`` (zeros when None).  ``log_a/b_in (B, S, w)``, ``h0 (B, w)``, all
    f32.  Returns ``(h (B, S, w), final (B, w))``, ``final`` the last step's
    ``h``.

    ``reverse`` walks ``t = S-1 .. 0`` with the gate one step ahead, ``h_t
    = a_{t+1} * h_{t+1} + b_t`` (a gate of 1 past the end, ``h_S = h0``):
    the cotangent recurrence ``dbar_t = dy_t + a_{t+1} dbar_{t+1}`` of the
    reference's ``ops._gated_kernel_bwd``, on forward-order operands;
    ``final`` is then ``h_0``."""
    a = torch.exp(log_a.float())
    b = b_in.float()
    bsz, s, w = b.shape
    if reverse:
        a = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    carry = b.new_zeros((bsz, w)) if h0 is None else h0.float()
    h = torch.empty_like(b)
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        carry = a[:, t] * carry + b[:, t]
        h[:, t] = carry
    return h, carry
