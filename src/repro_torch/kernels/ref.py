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

import functools

import torch

from repro_torch.core import semiring

#: the masked-score value of the reference (``repro.core.semiring``):
#: finite, so a fully masked block keeps exp() well defined
MASK_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def matmul(x2: torch.Tensor, w2: torch.Tensor, transpose_b: bool = False,
           *, transpose_a: bool = False) -> torch.Tensor:
    """``x2 (m, k) @ w2 (k, n)`` with an f32 result accumulated in f32;
    ``transpose_b`` takes ``w2`` stored ``(n, k)``, ``transpose_a`` takes
    ``x2`` stored ``(k, m)``.  Either operand may be f32, bf16 or f16: a
    16-bit operand is promoted to f32 exactly, as the reference's einsum
    does, so a product of two 16-bit values is exact in f32 too."""
    x = x2.float()
    w = w2.float()
    return (x.t() if transpose_a else x) @ (w.t() if transpose_b else w)


def exact_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued f64 sums (exact below 2^53) as int32, checked: a sum
    past int32's range raises instead of wrapping."""
    y = x.to(torch.int64)
    info = torch.iinfo(torch.int32)
    if y.numel() and (int(y.max()) > info.max or int(y.min()) < info.min):
        raise OverflowError("an int8 product's exact sum overflows int32")
    return y.to(torch.int32)


def matmul_int8(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
                transpose_b: bool = False) -> torch.Tensor:
    """K1's int8 form: ``op(a) (m, k) @ op(b) (k, n)`` (``op`` the
    transpose of an ``(k, m)`` / ``(n, k)`` stored operand, or of the last
    two axes of a stacked ``(e, ., .)`` expert operand) of int8 operands,
    accumulated exactly and returned as int32 (``exact_int32``).  The sums
    run in float64, where every product of two int8 values and every sum
    of fewer than 2^39 of them is an exact integer, so the result is the
    int64 sum; PyTorch has no int64 matrix product on the card."""
    x = a.transpose(-1, -2) if transpose_a else a
    w = b.transpose(-1, -2) if transpose_b else b
    return exact_int32(torch.matmul(x.double(), w.double()))


def pack_kmajor_int8(t: torch.Tensor, mn_major: bool,
                     granule: int = 16) -> torch.Tensor:
    """The K-major pack of K1's int8 tile: an int8 matrix or stack stored
    ``(..., k, rows)`` (``mn_major``) or ``(..., rows, k)``, as the
    contiguous ``(..., rows, k_pad)`` copy, ``k_pad`` the next multiple of
    ``granule`` (the tile's 16-byte rows), zeros past ``k`` (they add
    nothing to the sums)."""
    x = t.transpose(-1, -2) if mn_major else t
    k = x.shape[-1]
    out = torch.zeros(x.shape[:-1] + (-(-k // granule) * granule,),
                      dtype=t.dtype, device=t.device)
    out[..., :k] = x
    return out


def expert_gemm(x: torch.Tensor, w: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """The capacity-padded expert GEMM ``x (E, cap, d) @ w (E, d, f) ->
    (E, cap, f)``: ``einsum("ecd,edf->ecf")`` on the operands promoted to
    f32 (exact for bf16), accumulated in f32, then cast to
    ``out_dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(out_dtype)


def head_gemm(x: torch.Tensor, w: torch.Tensor,
              transpose_b: bool = False) -> torch.Tensor:
    """The per-head GEMM over a head-middle weight, ``x (m, h, k) @ w (k,
    h, n) -> (h, m, n)`` (``w`` stored ``(n, h, k)`` with
    ``transpose_b``): ``einsum`` on the operands promoted to f32 (exact
    for bf16), accumulated and returned in f32.  Any strides."""
    eq = "mhk,nhk->hmn" if transpose_b else "mhk,khn->hmn"
    return torch.einsum(eq, x.float(), w.float())


def head_gemm_int8(x: torch.Tensor, w: torch.Tensor,
                   transpose_b: bool = False) -> torch.Tensor:
    """K1's int8 head form: ``x (m, h, k) @ w (k, h, n) -> (h, m, n)``
    (``w`` stored ``(n, h, k)`` with ``transpose_b``) of int8 operands,
    summed in float64 (exact, as ``matmul_int8``) and returned as int32
    (``exact_int32``).  Any strides."""
    eq = "mhk,nhk->hmn" if transpose_b else "mhk,khn->hmn"
    return exact_int32(torch.einsum(eq, x.double(), w.double()))


def split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(hi, mid, lo)`` bf16 of an f32 tensor: ``hi = bf16(g)``, ``mid =
    bf16(g - hi)``, ``lo = bf16(g - hi - mid)`` (round to nearest even;
    each difference is exact in f32).  Each part holds the next 8 bits, so
    ``|g - hi - mid - lo| <= 2^-24 |g|`` for normal values (``hi`` alone
    is within 2^-8, ``hi + mid`` within 2^-16).  K1's split route multiplies
    the three parts as bf16 into one f32 accumulator."""
    g = g.float()
    hi = g.to(torch.bfloat16)
    r1 = g - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _mask(sq: int, sk: int, causal: bool, window: int, device,
          prefix_len: int = 0):
    """(sq, sk) bool, the causal mask: key j visible from query i when ``j
    <= i`` (and ``j > i - window`` with a window), or when both lie below
    ``prefix_len`` (the prefix-LM's bidirectional block)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    if prefix_len:
        mask = mask | ((qpos < prefix_len) & (kpos < prefix_len))
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
            window: int, prefix_len: int = 0) -> torch.Tensor:
    """Masked f32 scores ``(B, KV, G, Sq, Sk)`` on the grouped layout;
    masked entries take ``MASK_NEG_INF``; no mask unless ``causal``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        mask = _mask(q.shape[1], k.shape[1], causal, window, q.device,
                     prefix_len)
        s = torch.where(mask, s, MASK_NEG_INF)
    return s


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    prefix_len: int = 0
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
    s = _scores(q, k, scale, causal, window, prefix_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * g, vd).to(q.dtype)
    return out, m[..., 0], l[..., 0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """:func:`attention_stats` without the statistics."""
    return attention_stats(q, k, v, scale=scale, causal=causal,
                           window=window, prefix_len=prefix_len)[0]


def _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window,
                  prefix_len):
    """The flash backward's rebuilt ``p = exp(s - (m + log max(l,
    1e-30)))`` (f32, NOT rounded to v's dtype, as in the reference) and
    ``dS = p * (dO.v - delta)``, both ``(B, KV, G, Sq, Sk)``."""
    s = _scores(q, k, scale, causal, window, prefix_len)
    lse = m.float() + torch.log(l.float().clamp_min(1e-30))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             delta: torch.Tensor, *, scale: float, causal: bool = True,
             window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Flash-backward dq, unblocked: ``q, do (B, Sq, KV, G, ·)``, ``k, v
    (B, Sk, KV, ·)``, ``m, l, delta (B, KV, G, Sq)`` f32 -> ``dq (B, Sq,
    KV, G, hd)`` in ``q.dtype``; the scale applied once at the end (the
    semantics of ``repro.kernels.ref.flash_dq_ref``)."""
    _, ds = _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window,
                          prefix_len)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              delta: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0, prefix_len: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-backward dk, dv, unblocked and summed over the query heads of
    each KV head in f32 (the reference's ``flash_dkv_ref`` followed by its
    group sum): ``(B, Sk, KV, hd)`` each, in k's / v's dtype."""
    p, ds = _probs_and_ds(q, k, v, do, m, l, delta, scale, causal, window,
                          prefix_len)
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


# ---------------------------------------------------------------------------
# normal forms over any registered semiring (K9, and K1's matmul forms)
# ---------------------------------------------------------------------------

#: most elements a plain general-semiring fold pairs at once (1 GiB of
#: f32): the contraction is walked in slabs of its first contracted axis
#: so that the paired (out x slab x other contracted) block stays under
#: this; the whole broadcast of an 8192^3 product would be 2 TiB
SLAB_ELEMS = 1 << 28


def _letters(n: int) -> str:
    return "abcdefghijklmnopqrstuvwxyz"[:n]


def _fold_slabs(operands, combine: str, reduce_op: str, n_out: int,
                slab_elems: int) -> torch.Tensor:
    """``reduce_op`` over dims ``n_out..`` of the ``combine`` pairing of
    ``operands``, f32 tensors aligned (by broadcasting) to one (out +
    contracted) shape; the first contracted dim is walked in slabs."""
    comb = semiring.combine_def(combine).torch_fn
    rdef = semiring.reduce_def(reduce_op)
    shape = torch.broadcast_shapes(*(x.shape for x in operands))
    red = tuple(range(n_out, len(shape)))
    per = 1
    for d, e in enumerate(shape):
        if d != n_out:
            per *= e
    k = shape[n_out]
    slab = max(1, slab_elems // max(per, 1))
    acc = None
    for s0 in range(0, k, slab):
        w = min(slab, k - s0)
        parts = [x.narrow(n_out, s0, w) if x.shape[n_out] > 1 else x
                 for x in operands]
        part = rdef.torch_reducer(functools.reduce(comb, parts), dim=red)
        acc = part if acc is None else rdef.torch_fn(acc, part)
    return acc


def eval_nf(nf, *arrays: torch.Tensor, slab_elems: int = SLAB_ELEMS
            ) -> torch.Tensor:
    """The plain version of K9 (and of K1 on a normal form): evaluate a
    ``core.expr.NormalForm`` over its leaves' storage buffers, f32 result
    accumulated in f32 (``repro.kernels.ref.eval_nf``).

    Leaves bind by storage shape (a col-layout leaf takes the reversed
    buffer, a constant dim is indexed out); every operand is cast to f32
    and aligned to the (out + contracted) axes; (mul, add) is an einsum
    (on int8 operands, K9's integer accumulator's plain version: an
    einsum in f64, exact for these sums, returned as int32 by
    :func:`exact_int32`, which raises past int32's range),
    any other semiring pairs with its combine op and folds the contracted
    axes with its reduce op, the first contracted axis in slabs of at most
    ``slab_elems`` paired elements."""
    if len(arrays) != len(nf.leaves):
        raise ValueError(f"normal form has {len(nf.leaves)} leaves, got "
                         f"{len(arrays)}")
    bound = []
    for leaf, x in zip(nf.leaves, arrays):
        storage = leaf.storage_shape()
        if tuple(x.shape) != storage:
            raise ValueError(f"leaf {leaf.array!r} expects storage shape "
                             f"{storage}, got {tuple(x.shape)}")
        if leaf.layout == "col":
            x = x.permute(*reversed(range(x.dim())))
        x = x[tuple(t if isinstance(t, int) else slice(None)
                    for t, _ in leaf.dims)]
        syms = tuple(t for t, _ in leaf.dims if isinstance(t, str))
        if len(set(syms)) != len(syms):
            raise NotImplementedError(
                f"leaf {leaf.array!r} repeats an index (diagonal access)")
        bound.append((syms, x))
    joint = tuple(nf.out_axes) + tuple(nf.reduce_axes)
    if (nf.combine, nf.reduce_op) == ("mul", "add"):
        exact = any(x.dtype == torch.int8 for _, x in bound)
        letters = dict(zip(joint, _letters(len(joint))))
        spec = ",".join("".join(letters[s] for s in syms)
                        for syms, _ in bound)
        spec += "->" + "".join(letters[s] for s in nf.out_axes)
        out = torch.einsum(spec, *(x.double() if exact else x.float()
                                   for _, x in bound))
        return exact_int32(out) if exact else out
    bound = [(syms, x.float()) for syms, x in bound]
    aligned = []
    for syms, x in bound:
        x = x.permute(*sorted(range(len(syms)),
                              key=lambda d: joint.index(syms[d])))
        shape = [nf.extent_map[s] if s in syms else 1 for s in joint]
        aligned.append(x.reshape(shape))
    if not nf.reduce_axes:
        comb = semiring.combine_def(nf.combine).torch_fn
        out = functools.reduce(comb, aligned)
        return out.expand(nf.out_shape()).contiguous()
    return _fold_slabs(aligned, nf.combine, nf.reduce_op,
                       len(nf.out_axes), slab_elems)


def eval_expr(expr, *arrays: torch.Tensor, slab_elems: int = SLAB_ELEMS
              ) -> torch.Tensor:
    """Evaluate a ``core.expr`` expression directly, node by node, in f32
    (``repro.kernels.ref.eval_expr``, the DNF semantics before any normal
    form): a second, independent plain version of ``ops.apply``.  Leaves
    bind in composition order by storage shape; a general-semiring inner
    product walks its contraction in slabs (``slab_elems``)."""
    from repro_torch.core import expr as E
    it = iter(arrays)

    def ev(e) -> torch.Tensor:
        if isinstance(e, E.Arr):
            x = next(it)
            storage = e.shape if e.layout == "row" else tuple(
                reversed(e.shape))
            if tuple(x.shape) != storage:
                raise ValueError(f"leaf {e.name!r} expects storage shape "
                                 f"{storage}, got {tuple(x.shape)}")
            if e.layout == "col":
                x = x.permute(*reversed(range(x.dim())))
            return x.float()
        if isinstance(e, E.Transpose):
            return ev(e.x).permute(*e.perm)
        if isinstance(e, E.Psi):
            return ev(e.x)[e.idx]
        if isinstance(e, E.Combine):
            return semiring.combine_def(e.op).torch_fn(ev(e.a), ev(e.b))
        if isinstance(e, E.Reduce):
            return semiring.reduce_def(e.op).torch_reducer(ev(e.x),
                                                           dim=(e.axis,))
        if isinstance(e, E.Inner):
            a, b = ev(e.a), ev(e.b)
            nb, na, nrest = e.batch, a.dim(), b.dim() - e.batch - 1
            if (e.plus, e.times) == ("add", "mul"):
                lt = _letters(na + nrest)
                sa = lt[:na]
                sb = lt[:nb] + lt[na - 1] + lt[na:]
                return torch.einsum(f"{sa},{sb}->{lt[:na - 1]}{lt[na:]}",
                                    a, b)
            # align to (a's leading axes, b's trailing axes, contraction)
            ar = a.movedim(na - 1, -1).reshape(
                a.shape[:-1] + (1,) * nrest + a.shape[-1:])
            bm = b.movedim(nb, -1)
            br = bm.reshape(bm.shape[:nb] + (1,) * (na - 1 - nb)
                            + bm.shape[nb:])
            return _fold_slabs([ar, br], e.times, e.plus,
                               na - 1 + nrest, slab_elems)
        raise TypeError(f"not an Expr node: {e!r}")

    out = ev(expr)
    if next(it, None) is not None:
        raise ValueError("more arrays than expression leaves")
    return out


def gemm_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None
             ) -> torch.Tensor:
    """C = A @ B with f32 accumulation, in ``out_dtype`` (default
    ``a.dtype``)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def hadamard_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The elementwise product in f32, in the operands' dtype."""
    return (a.float() * b.float()).to(torch.promote_types(a.dtype, b.dtype))


def outer_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The MoA outer product of two matrices, ``(m, n, p, q)``."""
    return torch.einsum("mn,pq->mnpq", a.float(), b.float()).to(
        torch.promote_types(a.dtype, b.dtype))


def kron_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Kronecker product: the outer product transposed and reshaped."""
    m, n = a.shape
    p, q = b.shape
    return outer_ref(a, b).permute(0, 2, 1, 3).reshape(m * p, n * q)


def ipophp_ref(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """The unified inner / outer / Hadamard / Kronecker operator."""
    if mode == "ip":
        return gemm_ref(a, b)
    if mode == "hp":
        return hadamard_ref(a, b)
    if mode == "op":
        return outer_ref(a, b)
    if mode == "kp":
        return kron_ref(a, b)
    raise ValueError(f"unknown ipophp mode {mode!r}")
