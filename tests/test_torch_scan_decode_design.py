"""The designs of K8 (``src/repro_torch/kernels/csrc/gated_scan.cu``) and
K5 (``csrc/paged_decode.cu``) on the CPU, where the CUDA kernels cannot
run.  Each is emulated step for step in plain PyTorch, at the card tests'
shapes:

- K8's chunk decomposition: a walk of each chunk from h = 0 to its
  aggregate (A, H), the fold ``h_in[c] = A[c-1] h_in[c-1] + H[c-1]`` from
  h0 over the chunks in chunk order, and a re-walk of each chunk from its
  entering state with the plain step; against ``ref.gated_scan`` (the
  card tests' ``GATED_REL``), bit for bit where log_a = 0 on integers, and
  against the JAX ``gated_scan`` in interpret mode; the fold published at
  group ends gives the same bits as the fold from h0;
- ``ops.default_gated_chunk``: the derived chunk (the reference's
  formula; 16 on the H100 table) covers every step in exactly one chunk;
- K5's split-and-combine: each split's online softmax over 16-key tiles
  of its pages, p rounded to the pool's dtype before P V, and the splits'
  partials folded in split order; against ``ref.paged_decode_batched`` and
  the JAX ``paged_decode_batched`` (interpret mode);
- ``ops.decode_splits``: every page in exactly one split, from the
  table's width alone.
"""
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: K8 against its plain walk, relative to the largest plain entry
#: (``GATED_REL`` of tests/test_torch_kernels.py)
GATED_REL = 1e-6
#: K5 in f32 against the plain version and the JAX kernel (the card
#: tests' f32 atol); in bf16, relative to the largest plain entry (the
#: smoke's ``TOL[("K5", "bfloat16")]``)
DECODE_ATOL = 1e-5
DECODE_BF16_REL = 2e-2


# ---------------------------------------------------------------------------
# K8: the chunk-parallel gated scan
# ---------------------------------------------------------------------------

def _walk_order(s: int, chunk: int, reverse: bool):
    """The chunks' step lists in walk order (each chunk's steps too)."""
    chunks = [list(range(c0, min(s, c0 + chunk)))
              for c0 in range(0, s, chunk)]
    if reverse:
        chunks = [steps[::-1] for steps in chunks[::-1]]
    return chunks


def chunked_scan(log_a, b, h0, reverse, chunk):
    """K8's decomposition in f32 with the multiply and the add rounded
    separately: (1) each chunk's aggregate from h = 0, (2) the entering
    states folded from h0 in chunk order (the kernel's checkpoints give
    the same bits: ``test_fold_from_group_ends_is_the_fold_from_h0``),
    (3) the re-walk.  Returns ``(h, final)`` as ``ref.gated_scan``."""
    a = torch.exp(log_a)
    if reverse:
        a = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    bsz, s, w = b.shape
    order = _walk_order(s, chunk, reverse)
    aggs = []
    for steps in order:
        A, H = torch.ones(bsz, w), torch.zeros(bsz, w)
        for t in steps:
            A = A * a[:, t]
            H = a[:, t] * H + b[:, t]
        aggs.append((A, H))
    state = torch.zeros(bsz, w) if h0 is None else h0.clone()
    h_in = []
    for A, H in aggs:
        h_in.append(state)
        state = A * state + H
    h = torch.empty_like(b)
    for k, steps in enumerate(order):
        hh = h_in[k]
        for t in steps:
            hh = a[:, t] * hh + b[:, t]
            h[:, t] = hh
    return h, hh


def _fold_from_checkpoints(aggs, h0, group):
    """Each chunk's entering state as the kernel's block forms it: the
    fold at the end of the previous group (itself formed so), then the
    group's earlier aggregates."""
    fold_end, h_in = {}, []
    for k in range(len(aggs)):
        g0 = k // group * group
        state = h0 if g0 == 0 else fold_end[g0 - 1]
        for j in range(g0, k):
            state = aggs[j][0] * state + aggs[j][1]
        h_in.append(state)
        if k % group == group - 1:
            fold_end[k] = aggs[k][0] * state + aggs[k][1]
    return h_in


def _gated_inputs(seed, b, s, w, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        out = (np.zeros((b, s, w)), rng.integers(-3, 4, (b, s, w)),
               rng.integers(-3, 4, (b, w)))
    else:
        out = (-0.5 * np.abs(rng.standard_normal((b, s, w))),
               rng.standard_normal((b, s, w)),
               0.5 * rng.standard_normal((b, w)))
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in out]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


CHUNK = 16


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1])
@pytest.mark.parametrize("w", [5, 70])
def test_chunked_scan_matches_the_plain_walk(reverse, with_h0, s, w):
    """The decomposition at S = L-1, L, L+1, 2L+1 and ragged widths holds
    the plain walk within GATED_REL; the final state is the walk's last
    step bit for bit."""
    la, bb, h0 = _gated_inputs(s + w, 2, s, w)
    h0 = h0 if with_h0 else None
    h, f = chunked_scan(la, bb, h0, reverse, CHUNK)
    hr, fr = ref.gated_scan(la, bb, h0, reverse)
    assert _rel(h, hr) <= GATED_REL and _rel(f, fr) <= GATED_REL
    assert torch.equal(f, h[:, 0] if reverse else h[:, -1])


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_scan_is_exact_where_log_a_is_zero(reverse):
    """With log_a = 0 on integers every partial sum is an exact integer:
    the decomposition equals the plain walk bit for bit."""
    la, bb, h0 = _gated_inputs(3, 2, 4 * CHUNK + 5, 70, integer=True)
    h, f = chunked_scan(la, bb, h0, reverse, CHUNK)
    hr, fr = ref.gated_scan(la, bb, h0, reverse)
    assert torch.equal(h, hr) and torch.equal(f, fr)


@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_scan_matches_jax_kernel(with_h0):
    """Against the JAX ``gated_scan`` in interpret mode (its own chunk of
    8), forward, within GATED_REL."""
    la, bb, h0 = _gated_inputs(4, 2, 3 * CHUNK + 7, 70)
    h0 = h0 if with_h0 else None
    hj, fj = jops.gated_scan(jnp.asarray(la.numpy()),
                             jnp.asarray(bb.numpy()),
                             init_state=None if h0 is None else
                             jnp.asarray(h0.numpy()), chunk=8,
                             interpret=True)
    h, f = chunked_scan(la, bb, h0, False, CHUNK)
    assert _rel(h, torch.from_numpy(np.array(hj))) <= GATED_REL
    assert _rel(f, torch.from_numpy(np.array(fj))) <= GATED_REL


@pytest.mark.parametrize("group", [1, 3, 8])
def test_fold_from_group_ends_is_the_fold_from_h0(group):
    """The entering states that the kernel's blocks fold from the
    previous group's published fold are the same bits as the fold from
    h0 over every earlier chunk: each is the same sequence of multiplies
    and adds on the same values, whichever block runs it."""
    la, bb, h0 = _gated_inputs(5, 2, 21 * CHUNK, 7)
    a = torch.exp(la)
    aggs = []
    for c0 in range(0, la.shape[1], CHUNK):
        A, H = torch.ones(2, 7), torch.zeros(2, 7)
        for t in range(c0, c0 + CHUNK):
            A, H = A * a[:, t], a[:, t] * H + bb[:, t]
        aggs.append((A, H))
    state, sequential = h0, []
    for A, H in aggs:
        sequential.append(state)
        state = A * state + H
    for got, want in zip(_fold_from_checkpoints(aggs, h0, group),
                         sequential):
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,s,w", [(1, 4096, 4096), (1, 1, 5), (2, 300, 70),
                                   (3, 33, 4096), (4, 4096, 4096),
                                   (1, 1000, 256)])
def test_gated_chunks_cover_every_step_once(b, s, w):
    """The derived chunk (``ops.default_gated_chunk`` on the H100 table,
    clamped to S as ``gated_recurrence`` clamps it) is a multiple of 16
    within K8's limit, or the whole of a shorter sequence, and its chunks
    cover every step once; on the v5e copy it is the reference's
    ``default_gated_chunk`` on its own v5e table."""
    chunk = min(ops.default_gated_chunk(s, w), s)
    assert chunk == s or (chunk % 16 == 0
                          and chunk <= ops.GATED_MAX_CHUNK)
    seen = np.zeros(s, int)
    for c in range(-(-s // chunk)):
        seen[c * chunk:min(s, (c + 1) * chunk)] += 1
    assert (seen == 1).all()
    from repro.core import hardware as jhw
    from repro_torch.hardware import TPU_V5E
    assert ops.default_gated_chunk(s, w, hardware=TPU_V5E) == \
        jops.default_gated_chunk(s, w, hardware=jhw.get_entry("tpu_v5e"))


def test_gated_chunks_at_the_hybrid_prefill():
    """recurrentgemma-9b's B=1 S=4096 lru width 4096: the H100 table
    derives 16 (the per-channel state and three streams of 4096 channels
    leave no room in a quarter of 227 KB, so the smallest aligned chunk);
    the reference's v5e table 128."""
    from repro_torch.hardware import TPU_V5E
    assert ops.default_gated_chunk(4096, 4096) == 16
    assert ops.default_gated_chunk(4096, 4096, hardware=TPU_V5E) == 128


# ---------------------------------------------------------------------------
# K5: split-k paged decode
# ---------------------------------------------------------------------------

KT = 16


def split_decode(q, k_pool, v_pool, pos, tables, *, page, scale, window,
                 nsplit):
    """K5's design: split ``s`` of ``nsplit`` walks the 16-key tiles of
    pages ``[s per, (s + 1) per)`` that hold a live key with the online
    softmax (p rounded to the pool's dtype before P V, each tile's P V
    added to the rescaled sum), and the combine folds the splits' (m, l,
    acc) in split order, then acc / max(l, 1e-30); a dead slot is 0."""
    slots, kv, g, hd = q.shape
    width = tables.shape[1]
    per = -(-width // nsplit)
    neg = -0.7 * 3.4028234663852886e38
    tpp = -(-page // KT)
    out = torch.zeros(slots, kv, g, hd)
    for si in range(slots):
        vpos = int(pos[si])
        if vpos < 0:
            continue
        first = max(0, vpos - window + 1) if window > 0 else 0
        tile_of = lambda x: x // page * tpp + x % page // KT
        for h in range(kv):
            qf = q[si, h].float()
            parts = []
            for s in range(nsplit):
                lo = max(s * per * tpp, tile_of(first))
                hi = min(min(width, (s + 1) * per) * tpp - 1, tile_of(vpos))
                m = torch.full((g,), neg)
                l, acc = torch.zeros(g), torch.zeros(g, hd)
                for tile in range(lo, hi + 1):
                    p, c0 = tile // tpp, tile % tpp * KT
                    nk = min(KT, page - c0)
                    rows = int(tables[si, p]) * page + c0 + torch.arange(nk)
                    kp = p * page + c0 + torch.arange(nk)
                    ok = kp <= vpos
                    if window > 0:
                        ok &= kp > vpos - window
                    sc = qf @ k_pool[rows, h].float().T * scale
                    sc = torch.where(ok[None], sc, torch.tensor(neg))
                    m_new = torch.maximum(m, sc.amax(-1))
                    pr = torch.exp(sc - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + pr.sum(-1)
                    vt = v_pool[rows, h]
                    acc = acc * corr[:, None] + \
                        pr.to(vt.dtype).float() @ vt.float()
                    m = m_new
                parts.append((m, l, acc, lo <= hi))
            mx = torch.stack([m for m, *_ in parts]).amax(0)
            num, den = torch.zeros(g, hd), torch.zeros(g)
            for m, l, acc, live in parts:
                if live:
                    c = torch.exp(m - mx)
                    den = den + c * l
                    num = num + c[:, None] * acc
            out[si, h] = num / den.clamp_min(1e-30)[:, None]
    return out


def _decode_case(seed, page, dtype=torch.float32, slots=4, kv=1, g=8,
                 hd=256, tokens=64, positions=(40, 3, -1, 63)):
    """The card tests' case: scrambled slabs, ``tokens`` a slot."""
    rng = np.random.default_rng(seed)
    pool_pages = tokens // page * slots
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    q, kp, vp = f(slots, kv, g, hd), f(pool_pages * page, kv, hd), \
        f(pool_pages * page, kv, hd)
    tables = torch.from_numpy(
        rng.permutation(pool_pages).astype(np.int32).reshape(slots, -1))
    pos = torch.tensor(positions, dtype=torch.int32)
    return q, kp, vp, pos, tables


@pytest.mark.parametrize("page,window", [(16, 0), (4, 0), (16, 40),
                                         (4, 40)])
@pytest.mark.parametrize("nsplit", [None, 1, 3])
def test_split_decode_matches_plain(page, window, nsplit):
    """Dead slot, window 40 across split edges, page 4 and 16, the split
    count of ``ops.decode_splits`` and others: within the card tests'
    f32 atol of the plain version; the dead row is 0."""
    q, kp, vp, pos, tables = _decode_case(7, page)
    width = tables.shape[1]
    n = ops.decode_splits(4, 1, width) if nsplit is None else \
        min(nsplit, width)
    args = dict(page=page, scale=256 ** -0.5, window=window)
    got = split_decode(q, kp, vp, pos, tables, nsplit=n, **args)
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, **args)
    assert (got[2] == 0).all()
    torch.testing.assert_close(got, want, rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("g", [8, 16])
def test_split_decode_bf16_within_the_smoke_tolerance(g):
    """The bf16 pool (p rounded to bf16 against each split's running max,
    the plain version against the final max): within the smoke's bf16
    tolerance, G up to 16."""
    q, kp, vp, pos, tables = _decode_case(8, 16, torch.bfloat16, g=g)
    args = dict(page=16, scale=256 ** -0.5, window=0)
    got = split_decode(q, kp, vp, pos, tables,
                       nsplit=ops.decode_splits(4, 1, 4), **args)
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, **args)
    assert (got - want).abs().max() <= DECODE_BF16_REL * want.abs().max()


@pytest.mark.parametrize("page,window", [(4, 0), (4, 6), (4, 40), (16, 20),
                                         (16, 40)])
def test_split_decode_matches_jax_kernel(page, window):
    """Against the JAX batched decode kernel (interpret mode): a dead
    slot, splits over more than one page, window 40 across split edges."""
    q, kp, vp, pos, tables = _decode_case(9, page, kv=2, g=4, hd=32,
                                          tokens=64,
                                          positions=(40, 3, -1, 63))
    args = dict(page=page, scale=32 ** -0.5, window=window)
    got = split_decode(q, kp, vp, pos, tables, nsplit=3, **args)
    pos_aux = np.stack([pos.numpy(), np.zeros(4, np.int32)], axis=-1)
    want = np.asarray(jops.paged_decode_batched(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(pos_aux),
        page_tables=tuple(map(tuple, tables.tolist())), page=page,
        scale=args["scale"], window=window, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("width", range(1, 65))
@pytest.mark.parametrize("slots,kv", [(1, 1), (4, 1), (4, 2), (64, 8)])
def test_decode_splits_cover_every_page_once(width, slots, kv):
    n = ops.decode_splits(slots, kv, width)
    per = -(-width // n)
    seen = np.zeros(width, int)
    for s in range(n):
        pages = range(s * per, min(width, (s + 1) * per))
        assert len(pages) > 0
        seen[list(pages)] += 1
    assert (seen == 1).all()


def test_decode_splits_read_no_position():
    """The rule's inputs are the slots, KV heads and the table's width:
    no position (device data, which the host would have to wait for)."""
    assert list(inspect.signature(ops.decode_splits).parameters) == \
        ["slots", "kv", "width"]
    # gemma-2b's serving table (max_len 512, page 16): a page a split;
    # its 8192-token context: 16 pages a split; either one wave of blocks
    assert ops.decode_splits(4, 1, 32) == 32
    assert ops.decode_splits(4, 1, 512) == 32
    for width in (32, 512):
        assert 4 * ops.decode_splits(4, 1, width) <= \
            ops.DECODE_BLOCKS_PER_SM * ops.SM_COUNT
