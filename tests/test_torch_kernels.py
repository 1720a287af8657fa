"""Each CUDA kernel of the port against its plain PyTorch version on an
H100 (marked ``h100``; each test skips without such a card).  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m h100 tests/test_torch_kernels.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an H100 (compute capability 9.0)")
    ops.reset_launches()
    return torch.device("cuda")


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,tb", [(37, 72, 130, False),
                                      (4, 64, 300, True), (65, 48, 64, True),
                                      (5, 50, 33, False), (3, 50, 33, True)])
def test_gemm_kernel_matches_plain(h100, dtype, m, k, n, tb):
    g = torch.Generator(device=h100).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=h100).to(dtype)
    w = torch.randn(*((n, k) if tb else (k, n)), generator=g,
                    device=h100).to(dtype)
    got = ops.matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1
    want = ref.matmul(x, w, tb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


#: (b, s, kv, g, hd, window) of the flash kernels' cases: ragged Sq*G and
#: Sk (70, 130, 1000: no multiple of any tile), G in {2, 4, 8, 16}, hd in
#: {64, 128, 256}, a window that cuts inside a key tile (300 over 1000)
#: with the K/V ring wrapping many times, and B = 2 with KV = 2 (the
#: tensor maps' batch and head strides).  The (2, 1000, 2, ...) cases have
#: enough 128-row blocks to fill the card, so the bf16 kernels run two
#: consumer warpgroups a block; the others run one.
FLASH_SHAPES = [(1, 70, 1, 8, 256, 0), (1, 130, 1, 8, 256, 33),
                (2, 130, 2, 2, 64, 0), (2, 70, 2, 4, 128, 17),
                (1, 1000, 1, 2, 64, 0), (2, 512, 1, 8, 256, 0),
                (2, 1000, 2, 16, 256, 300), (2, 1000, 2, 8, 128, 300),
                (2, 1000, 2, 16, 64, 0)]
#: the rest of the dense family: stablelm-1.6b's multi-head attention (G =
#: 1, 32 KV heads of 64) at its training shape and ragged (130 rows of one
#: head a tile), and command-r-plus-104b's GQA (8 KV heads, G = 12, hd 128)
DENSE_FLASH_SHAPES = [(2, 2048, 32, 1, 64, 0), (1, 130, 32, 1, 64, 0),
                      (1, 512, 8, 12, 128, 0)]
#: deepseek-moe-16b's prefill attention: 16 KV heads of 128, G = 1
MOE_FLASH_SHAPES = [(1, 2048, 16, 1, 128, 0)]
#: llama4-scout-17b-a16e's prefill attention: 8 KV heads of 128, G = 5
#: (no power of two), windowed (its local layers) and causal (its full
#: ones); a ragged length with a window that cuts inside a key tile
LLAMA4_FLASH_SHAPES = [(1, 2048, 8, 5, 128, 8192), (1, 2048, 8, 5, 128, 0),
                       (1, 300, 8, 5, 128, 100)]
#: minicpm3-4b's MLA attention shapes at hd = vd = 128: 40 KV heads of
#: one query head each, its chunked-branch length and a ragged one at B =
#: 2 (its own widths, q.k 96 and v 64, are in WIDTH_CASES)
MLA_FLASH_SHAPES = [(1, 4096, 40, 1, 128, 0), (2, 300, 40, 1, 128, 0)]


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,kv,g,hd,window",
                         FLASH_SHAPES + DENSE_FLASH_SHAPES + MOE_FLASH_SHAPES
                         + LLAMA4_FLASH_SHAPES + MLA_FLASH_SHAPES)
def test_flash_kernel_matches_plain(h100, dtype, atol, b, s, kv, g, hd,
                                    window):
    q, k, v, _ = _attn_case(h100, dtype, b, s, g, hd, 1, kv=kv)
    got = ops.attention(q, k, v, scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K2"] == 1
    want = ref.attention(q, k, v, scale=hd ** -0.5, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("page,window", [(16, 0), (4, 0), (16, 40)])
def test_paged_decode_kernel_matches_plain(h100, dtype, atol, page, window):
    g = torch.Generator(device=h100).manual_seed(2)
    pool_pages = 64 // page * 4
    q = torch.randn(4, 1, 8, 256, generator=g, device=h100).to(dtype)
    kp = torch.randn(pool_pages * page, 1, 256, generator=g,
                     device=h100).to(dtype)
    vp = torch.randn(pool_pages * page, 1, 256, generator=g,
                     device=h100).to(dtype)
    perm = torch.randperm(pool_pages, generator=g, device=h100).int()
    tables = perm.reshape(4, -1).contiguous()        # 64 tokens per slot
    pos = torch.tensor([40, 3, -1, 63], dtype=torch.int32, device=h100)
    got = ops.paged_decode_batched(q, kp, vp, pos, tables, page=page,
                                   scale=256 ** -0.5, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K5"] == 1
    assert (got[2] == 0).all()
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, page=page,
                                    scale=256 ** -0.5, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def _paged_case(dev, dtype, slots, kv, g, hd, page, width, positions,
                seed):
    """Scrambled slabs of a pool of ``slots * width`` pages, one table row
    of ``width`` pages a slot."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    pool_pages = slots * width
    q = rnd(slots, kv, g, hd)
    kp, vp = rnd(pool_pages * page, kv, hd), rnd(pool_pages * page, kv, hd)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).int()
    tables = perm.reshape(slots, width).contiguous()
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, kp, vp, pos, tables


#: K5's split-k cases: G = 16 (two row tiles); gemma-2b's whole 8192-token
#: context; a 64-page table whose splits (two pages each) mostly lie past
#: the live pages; splits of 7 pages (112 keys) with window 40 across
#: their edges at positions 1130 and 120; two KV heads at a head width
#: that is not a multiple of 16
PAGED_SPLIT_CASES = [
    (4, 1, 16, 256, 16, 4, (40, 3, -1, 63), 0),
    (4, 1, 8, 256, 16, 512, (8191, 8191, 8191, 8191), 0),
    (4, 1, 8, 256, 16, 64, (40, 3, -1, 63), 0),
    (4, 1, 8, 256, 16, 200, (1130, 120, -1, 3000), 40),
    (3, 2, 4, 72, 4, 30, (100, 0, 57), 0),
    # one slot at gemma-2b's shape (ServeEngine(batched=False)), and
    # command-r-plus-104b's 8 KV heads of 128 under G = 12, at 4 slots and
    # at one
    (1, 1, 8, 256, 16, 32, (300,), 0),
    (4, 8, 12, 128, 16, 32, (200, 37, -1, 511), 0),
    (1, 8, 12, 128, 16, 32, (200,), 0),
]


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("slots,kv,g,hd,page,width,positions,window",
                         PAGED_SPLIT_CASES)
def test_paged_decode_splits_match_plain(h100, dtype, atol, slots, kv, g,
                                         hd, page, width, positions,
                                         window):
    q, kp, vp, pos, tables = _paged_case(h100, dtype, slots, kv, g, hd,
                                         page, width, positions, 40)
    args = dict(page=page, scale=hd ** -0.5, window=window)
    got = ops.paged_decode_batched(q, kp, vp, pos, tables, **args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K5"] == 1
    for s, p in enumerate(positions):
        if p < 0:
            assert (got[s] == 0).all()
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, **args)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [PAGED_SPLIT_CASES[1],
                                  PAGED_SPLIT_CASES[3]])
def test_paged_decode_reruns_are_bit_identical(h100, dtype, case):
    """The splits' partials are folded in split order: two runs give the
    same bits."""
    slots, kv, g, hd, page, width, positions, window = case
    q, kp, vp, pos, tables = _paged_case(h100, dtype, slots, kv, g, hd,
                                         page, width, positions, 41)
    args = dict(page=page, scale=hd ** -0.5, window=window)
    first = ops.paged_decode_batched(q, kp, vp, pos, tables, **args)
    again = ops.paged_decode_batched(q, kp, vp, pos, tables, **args)
    assert torch.equal(first, again)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kv,g,hd,width,position,window",
                         [(1, 8, 256, 32, 300, 0), (8, 12, 128, 32, 200, 0),
                          (2, 4, 72, 30, 57, 40)])
def test_paged_decode_single_slot_matches_plain(h100, dtype, atol, kv, g, hd,
                                                width, position, window):
    """``ops.paged_decode``, one sequence (q (KV, G, hd), a 1-D table):
    one K5 launch at one slot, against its plain version and against the
    batched entry's plain version at one slot."""
    q, kp, vp, pos, tables = _paged_case(h100, dtype, 1, kv, g, hd, 16,
                                         width, (position,), 42)
    args = dict(page=16, scale=hd ** -0.5, window=window)
    got = ops.paged_decode(q[0], kp, vp, pos, tables[0], **args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K5"] == 1 and got.shape == (kv, g, hd)
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, **args)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    with ops.reference_mode():
        plain = ops.paged_decode(q[0], kp, vp, pos, tables[0], **args)
    assert torch.equal(plain, want) and ops.LAUNCHES["K5"] == 1


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(True, False), (False, True),
                                   (False, False), (True, True)])
@pytest.mark.parametrize("a_dt,b_dt", [(_F32, _BF16), (_BF16, _F32),
                                       (_BF16, _BF16), (_F32, _F32)])
@pytest.mark.parametrize("m,k,n", [(37, 72, 130), (130, 5, 33),
                                   (3, 257, 129), (296, 200, 520),
                                   (128, 512, 264)])
def test_gemm_transposed_and_mixed_forms_match_plain(h100, ta, tb, a_dt,
                                                     b_dt, m, k, n):
    """K1's VJP forms: ``transpose_a`` (a stored (k, m) read as its
    transpose), ``transpose_b`` and the plain form, with (f32, bf16)
    mixed operands, at ragged m, n, k (edges of the 128x128 tile).  The
    last two shapes have every stored row a multiple of 8 elements, so
    bf16 x bf16 takes the tile path and the mixed pairs the split path
    (the f32 operand as three bf16 parts); the others the first kernels
    where an operand's rows are not."""
    g = torch.Generator(device=h100).manual_seed(3)
    a = torch.randn(*((k, m) if ta else (m, k)), generator=g,
                    device=h100).to(a_dt)
    b = torch.randn(*((n, k) if tb else (k, n)), generator=g,
                    device=h100).to(b_dt)
    route = ops._route(a, b, ta, tb)
    if (m, k, n) in ((296, 200, 520), (128, 512, 264)):
        assert route == {(_BF16, _BF16): "tile", (_F32, _F32): "fma"}.get(
            (a_dt, b_dt), "split")
    got = ops._gemm(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1 and got.dtype == torch.float32
    want = ref.matmul(a, b, tb, transpose_a=ta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(True, False), (False, True),
                                   (False, False), (True, True)])
@pytest.mark.parametrize("mixed", [False, True])
def test_gemm_tile_path_at_model_widths(h100, ta, tb, mixed):
    """The tile path where its 128x256 tiles fill the card (bf16 x bf16)
    and the split path's 128x128 tiles (an f32 operand, first or second by
    the transpose), at gemma-2b-like widths with a ragged edge, each
    (transpose_a, transpose_b) pair."""
    g = torch.Generator(device=h100).manual_seed(30)
    m, k, n = 2048, 136, 2304
    a_dt = _F32 if mixed and not tb else _BF16
    b_dt = _F32 if mixed and tb else _BF16
    a = torch.randn(*((k, m) if ta else (m, k)), generator=g,
                    device=h100).to(a_dt)
    b = (torch.randn(*((n, k) if tb else (k, n)), generator=g,
                     device=h100) * k ** -0.5).to(b_dt)
    assert ops._route(a, b, ta, tb) == ("split" if mixed else "tile")
    got = ops._gemm(a, b, ta, tb)
    again = ops._gemm(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and torch.equal(got, again)
    want = ref.matmul(a, b, tb, transpose_a=ta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.h100
@pytest.mark.parametrize("m", [1, 3, 4, 16])
@pytest.mark.parametrize("k,n,tb", [(2048, 2048, False), (2048, 2048, True),
                                    (16384, 2048, False),
                                    (2048, 256000, True),
                                    (1536, 50280, False)])
def test_gemm_decode_rows_match_plain(h100, m, k, n, tb):
    """The decode-row path (weight streaming, mma.sync on rows padded to
    16) at the serving steps' row counts: the 2048-column products split
    over k (a second pass adds the partials in split order, so a rerun is
    the same bits), the vocab head (no split) and mamba2's untied head (a
    ragged last column tile)."""
    g = torch.Generator(device=h100).manual_seed(31 + m)
    x = torch.randn(m, k, generator=g, device=h100).to(_BF16)
    w = (torch.randn(*((n, k) if tb else (k, n)), generator=g, device=h100)
         * k ** -0.5).to(_BF16)
    assert ops._route(x, w, False, tb) == "gemv"
    if n == 2048:
        assert ops.gemv_splits(m, n, k) > 1
    got = ops.matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    again = ops.matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and torch.equal(got, again)
    torch.testing.assert_close(got, ref.matmul(x, w, tb), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.h100
@pytest.mark.parametrize("dt", [_BF16, _F32])
def test_gemm_alignment_boundary(h100, dt):
    """Rows of 104 elements take the tensor-core paths; rows of 100, or a
    base off a 16-byte boundary, keep a bf16 operand off TMA (gemm_bf16),
    while an f32 operand's own rows and base do not matter (its split parts
    are written pitched and aligned: the split route every time); each
    agrees with the plain version."""
    g = torch.Generator(device=h100).manual_seed(32)
    w = torch.randn(104, 64, generator=g, device=h100).to(_BF16)
    for k, offset, want_route in ((104, 0, "tile" if dt == _BF16 else
                                   "split"), (100, 0, None), (104, 1, None)):
        flat = torch.randn(64 * k + offset, generator=g, device=h100).to(dt)
        x = flat[offset:].view(64, k)
        route = ops._route(x, w[:k], False, False)
        if want_route is None:
            assert route == ("wmma" if dt == _BF16 else "split")
        else:
            assert route == want_route
        got = ops._gemm(x, w[:k])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.matmul(x, w[:k]), rtol=1e-5,
                                   atol=1e-4)


#: (m, n, k, a dtype, b dtype) of K1's exact-f32 FMA kernel at ragged m, n
#: and k (no multiple of any tile or k-step): each tile width (128 x 64 at
#: n <= 64, 256 x 16 at n <= 16, 128 x 128) split over k (through the
#: workspace; 1500 x 100 in 5 splits) and unsplit (3 k-steps; tiles that
#: fill the card); the row form (at most 16 rows, no transpose_a; its
#: split folded in a cluster; its code bounded to 2, 4 or 16 rows) split
#: and unsplit, with 16-byte loads (k 2048) and without; and mixed
#: products whose bf16 operand TMA cannot read (rows of 130, 515, 301 or 7)
FMA_CASES = [(1001, 37, 999, _F32, _F32), (777, 13, 1333, _F32, _F32),
             (300, 200, 77, _F32, _F32), (2100, 2100, 99, _F32, _F32),
             (1500, 100, 300, _F32, _F32),
             (2, 64, 2048, _F32, _F32), (4, 70, 1001, _F32, _F32),
             (13, 37, 999, _F32, _F32),
             (5, 3, 300, _F32, _F32), (333, 130, 515, _F32, _BF16),
             (7, 70, 301, _BF16, _F32)]


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("m,n,k,a_dt,b_dt", FMA_CASES)
def test_gemm_fma_kernel_forms_match_plain(h100, m, n, k, a_dt, b_dt, ta,
                                           tb):
    """The FMA kernel (route ``"fma"``) in its form (``ops.fma_form``) and
    split (``ops.fma_splits``) against ``ref.matmul`` within 1e-4 of the
    largest plain entry (f32 sums in another order), each rerun to the
    same bits (the split partials are added in split order)."""
    g = torch.Generator(device=h100).manual_seed(m + 3 * n + 7 * k)
    a = torch.randn(*((k, m) if ta else (m, k)), generator=g,
                    device=h100).to(a_dt)
    b = (torch.randn(*((n, k) if tb else (k, n)), generator=g, device=h100)
         * k ** -0.5).to(b_dt)
    assert ops._route(a, b, ta, tb) == "fma"
    f32 = a_dt == b_dt == _F32
    form = ops.fma_form(m, n, ta, f32)
    nsplit = ops.fma_splits(m, n, k, ta, tb, f32)
    if (m, n, k) in ((1001, 37, 999), (777, 13, 1333), (13, 37, 999),
                     (2, 64, 2048)):
        assert nsplit > 1, (form, nsplit)
    if (m, n, k) in ((300, 200, 77), (2100, 2100, 99)) or (
            (m, n, k) == (5, 3, 300) and not ta):
        assert nsplit == 1, (form, nsplit)
    got = ops._gemm(a, b, ta, tb)
    again = ops._gemm(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and torch.equal(got, again)
    _held(got, ref.matmul(a, b, tb, transpose_a=ta), 1e-4)


@pytest.mark.h100
@pytest.mark.parametrize("rows,cols", [(5, 13), (3, 51865), (64, 104),
                                       (1, 1)])
def test_split_bf16_pitched_parts_match_plain(h100, rows, cols):
    """The split pass writes each part at a row pitch rounded up to 8
    elements, zero past the last column: the parts' views equal the plain
    split bit for bit, and the padding is zero."""
    g = torch.Generator(device=h100).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=g, device=h100) * 3.0
    parts = ops.split_bf16(x)
    pitch = -(-cols // 8) * 8
    for got, want in zip(parts, ref.split_bf16(x)):
        assert got.shape == (rows, cols) and got.stride(0) == pitch
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, want)
        full = torch.as_strided(got, (rows, pitch), (pitch, 1))
        assert (full[:, cols:] == 0).all()


#: (e, cap, d, f, route) of K1's expert form: deepseek-moe-16b's decode
#: (cap 8) and S=2048 prefill (cap 240) products, wi and wo; a stack whose
#: 2048-column products split k (8 experts x 32 column blocks); a ragged
#: expert (d = 200 and f = 136: no multiple of a tile, so each expert's
#: k, row and column edges fall inside a tile, where the rank-3 maps
#: zero-fill and clip); cap 17 (one row past the decode rows) and cap 16
#: at a d that is no multiple of 32 on the tile path
EXPERT_CASES = [(64, 8, 2048, 2816, "gemv"), (64, 8, 1408, 2048, "gemv"),
                (64, 240, 2048, 2816, "tile"), (64, 240, 1408, 2048, "tile"),
                (8, 16, 2048, 2048, "gemv"), (8, 24, 200, 136, "tile"),
                (5, 17, 64, 72, "tile"), (3, 16, 40, 64, "tile")]


@pytest.mark.h100
@pytest.mark.parametrize("e,cap,d,f,route", EXPERT_CASES)
def test_expert_gemm_matches_plain(h100, e, cap, d, f, route):
    """``ops.expert_gemm`` on aligned bf16 runs K1's expert form (one
    launch, the route ``ops.expert_route`` names) and agrees with
    ``ref.expert_gemm`` (f32 sums in another order: the 2-D K1 cases'
    tolerance); a rerun gives the same bits."""
    g = torch.Generator(device=h100).manual_seed(e + cap + d + f)
    x = torch.randn(e, cap, d, generator=g, device=h100).to(_BF16)
    w = (torch.randn(e, d, f, generator=g, device=h100)
         * d ** -0.5).to(_BF16)
    assert ops.expert_route(e, cap, d, f, _BF16, _BF16) == route
    if (e, d, f) == (8, 2048, 2048):
        assert ops.gemv_splits(cap, f, d, e) > 1
    got = ops.expert_gemm(x, w, out_dtype=torch.float32)
    again = ops.expert_gemm(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.expert_gemm(x, w), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.h100
def test_expert_gemm_routes_other_forms_to_k9(h100):
    """A row of d = 201 (no multiple of 8 elements) and f32 operands take
    K9's batched tile; ``expert_matmul`` casts."""
    g = torch.Generator(device=h100).manual_seed(61)
    for (e, cap, d, f), dt in (((4, 24, 201, 64), _BF16),
                               ((4, 24, 64, 72), _F32)):
        x = torch.randn(e, cap, d, generator=g, device=h100).to(dt)
        w = torch.randn(e, d, f, generator=g, device=h100).to(dt)
        ops.reset_launches()
        got = ops.expert_matmul(x, w, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["K1"] == 0 and ops.LAUNCHES["K9"] == 1
        torch.testing.assert_close(got, ref.expert_gemm(x, w), rtol=0,
                                   atol=K9_SUM_REL * d *
                                   ref.expert_gemm(x, w).abs().max().item())


#: the rows of K1's head form at minicpm3-4b's decode (1-4 slots, and on
#: to K1_DECODE_ROWS)
HEAD_ROWS = [1, 2, 3, 4, 8, 16]


def _mla_head_operands(dev, m, tb, seed=71, dtype=None):
    """``(x, w)`` of one of minicpm3-4b's absorbed decode products, as
    ``mla_decode`` passes them: strided views of one (256, 40, 128)
    ``wkv_b`` table (bf16, or ``dtype``), ``w_uk`` its first 64 columns
    (``transpose_b``: q_nope (m, 1, 40, 64), itself the first 64 of 96
    columns) or ``w_uv`` its last 64 (the latent context (m, 1, 40,
    256))."""
    dtype = dtype or _BF16
    gen = torch.Generator(device=dev).manual_seed(seed + m)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    table = (rnd(256, 40, 128) * 256 ** -0.5).to(dtype)
    if tb:
        return rnd(m, 1, 40, 96).to(dtype)[..., :64], table[..., :64]
    return rnd(m, 1, 40, 256).to(dtype), table[..., 64:]


@pytest.mark.h100
@pytest.mark.parametrize("tb", [True, False])
@pytest.mark.parametrize("m", HEAD_ROWS)
def test_head_form_matches_plain(h100, m, tb):
    """``ops.head_matmul`` at minicpm3-4b's absorbed decode products runs
    K1's head form (``ops.head_route`` "gemv"; one launch, no K9) on the
    strided views of the stored table, and agrees with ``ref.head_gemm``
    (f32 sums in another order: the 2-D K1 cases' tolerance); a rerun
    gives the same bits (the k splits summed in order)."""
    x, w = _mla_head_operands(h100, m, tb)
    n = 256 if tb else 64
    assert ops.head_aligned(x.reshape(m, 40, -1), w)
    assert ops.head_route(40, m, x.shape[-1], n, _BF16, _BF16, tb) == "gemv"
    got = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    again = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert got.shape == (m, 1, 40, n) and torch.equal(got, again)
    want = ref.head_gemm(x.reshape(m, 40, -1), w, tb).transpose(0, 1)
    torch.testing.assert_close(got.reshape(m, 40, n), want, rtol=1e-5,
                               atol=1e-4)


#: the head form's tile rows: one past K1_DECODE_ROWS, MLA's decode at
#: B = 64, and a batch off every tile multiple
HEAD_TILE_ROWS = [17, 64, 100]
#: the tile's f32 sums (the tensor cores', over k = 64 or 256) run in
#: another order than the plain version's: 1e-5 of the largest plain
#: entry a term, as K9_SUM_REL
HEAD_TILE_REL = 1e-5


@pytest.mark.h100
@pytest.mark.parametrize("tb", [True, False])
@pytest.mark.parametrize("m", HEAD_TILE_ROWS)
def test_head_tile_matches_plain(h100, m, tb):
    """Past 16 rows ``ops.head_matmul`` at minicpm3-4b's absorbed decode
    products (q_lat, ``transpose_b``, and out, on strided views of one
    (256, 40, 128) ``wkv_b`` table) runs K1's head tile (``ops.head_route``
    "tile"; one launch, no K9, no copy), agrees with ``ref.head_gemm``
    within HEAD_TILE_REL x k x max|plain|, and a rerun gives the same
    bits."""
    x, w = _mla_head_operands(h100, m, tb)
    k, n = x.shape[-1], 256 if tb else 64
    assert ops.head_aligned(x.reshape(m, 40, k), w)
    assert ops.head_route(40, m, k, n, _BF16, _BF16, tb) == "tile"
    got = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    again = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert got.shape == (m, 1, 40, n) and torch.equal(got, again)
    want = ref.head_gemm(x.reshape(m, 40, k), w, tb).transpose(0, 1)
    torch.testing.assert_close(got.reshape(m, 40, n), want, rtol=0,
                               atol=HEAD_TILE_REL * k *
                               want.abs().max().item())


@pytest.mark.h100
def test_head_tile_reads_a_head_major_view(h100):
    """An activation stored head-major, (h, m, k), and read as its (m, h,
    k) transpose (head stride above the row stride: the tile's map takes
    its dimensions in that order) on the tile, against ``ref.head_gemm``
    on a contiguous copy."""
    gen = torch.Generator(device=h100).manual_seed(73)
    x = torch.randn(40, 64, 64, generator=gen, device=h100).to(_BF16)
    table = (torch.randn(256, 40, 128, generator=gen, device=h100)
             * 256 ** -0.5).to(_BF16)
    xv, w = x.transpose(0, 1), table[..., :64]
    assert xv.stride(1) > xv.stride(0)
    assert ops.head_route(40, 64, 64, 256, _BF16, _BF16, True,
                          ops.head_aligned(xv, w)) == "tile"
    got = ops._head_gemm(xv, w, True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1
    want = ref.head_gemm(xv.contiguous(), w, True)
    torch.testing.assert_close(got, want, rtol=0, atol=HEAD_TILE_REL * 64 *
                               want.abs().max().item())


#: the float16 head tile's rows: a decode step of 4 (one 128-row tile a
#: head, no float16 decode-row kernel) and the bf16 tile's rows
HEAD_F16_ROWS = [4] + HEAD_TILE_ROWS


@pytest.mark.h100
@pytest.mark.parametrize("tb", [True, False])
@pytest.mark.parametrize("m", HEAD_F16_ROWS)
def test_head_tile_float16_matches_plain(h100, m, tb):
    """Two float16 operands (minicpm3-4b's q_lat and out on strided views
    of a float16 (256, 40, 128) table) take K1's head tile at every row
    count (``ops.head_route`` "tile", the float16 maps and f16 wgmma; one
    K1 launch, no K9, no copy), agree with ``ref.head_gemm`` within the
    bf16 tile's HEAD_TILE_REL x k x max|plain| (every f16 product is
    exact in f32, as a bf16 one is), and a rerun gives the same bits."""
    x, w = _mla_head_operands(h100, m, tb, dtype=_F16)
    k, n = x.shape[-1], 256 if tb else 64
    assert ops.head_aligned(x.reshape(m, 40, k), w) and not w.is_contiguous()
    assert ops.head_route(40, m, k, n, _F16, _F16, tb) == "tile"
    got = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    again = ops.head_matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert got.shape == (m, 1, 40, n) and torch.equal(got, again)
    want = ref.head_gemm(x.reshape(m, 40, k), w, tb).transpose(0, 1)
    torch.testing.assert_close(got.reshape(m, 40, n), want, rtol=0,
                               atol=HEAD_TILE_REL * k *
                               want.abs().max().item())


@pytest.mark.h100
@pytest.mark.parametrize("case", ["f16_bf16", "f32", "unaligned"])
def test_head_form_routes_refused_forms_to_k9(h100, case):
    """A head form that K1 refuses (a float16 activation against a bf16
    table at 64 rows; f32 operands; a view whose base is off 16 bytes)
    takes K9 (on row-major copies) and agrees with ``ref.head_gemm``."""
    m = 64 if case == "f16_bf16" else 4
    x, w = _mla_head_operands(h100, m, True)
    if case == "f32":
        x, w = x.float(), w.float()
    if case == "f16_bf16":
        x = x.half()
    if case == "unaligned":
        x = torch.cat([x, x[..., :1]], dim=-1)[..., 1:]
    assert ops.head_route(40, m, 64, 256, x.dtype, w.dtype, True,
                          ops.head_aligned(x.reshape(m, 40, 64), w)) == "K9"
    got = ops.head_matmul(x, w, transpose_b=True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 0 and ops.LAUNCHES["K9"] == 1
    want = ref.head_gemm(x.reshape(m, 40, 64), w, True).transpose(0, 1)
    torch.testing.assert_close(got.reshape(m, 40, 256), want, rtol=0,
                               atol=K9_SUM_REL * 64 *
                               want.abs().max().item())


@pytest.mark.h100
@pytest.mark.parametrize("s", [300, 4096])
def test_mla_padded_attention_matches_plain(h100, s):
    """minicpm3-4b's attention through ``attention.mla_attention`` (q''
    and k'' of width 96 and v of 64, no zero column; one K2 launch
    forward, K3 and K4 backward) against the same function on the plain
    versions, in bf16: the output and the gradients of q_nope, q_pe,
    k_nope, k_pe (summed over the heads) and v, each within 2e-2 of its
    largest plain entry (the flash kernels' bf16 tolerance)."""
    from repro_torch.models import attention
    gen = torch.Generator(device=h100).manual_seed(s)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=h100
                                     ).to(_BF16).requires_grad_(True)
    ins = (rnd(1, s, 40, 64), rnd(1, s, 40, 32), rnd(1, s, 40, 64),
           rnd(1, s, 32), rnd(1, s, 40, 64))
    dout = torch.randn(1, s, 40, 64, generator=gen, device=h100).to(_BF16)
    results = []
    for plain in (False, True):
        ctx = ops.reference_mode() if plain else torch.enable_grad()
        with ctx:
            out = attention.mla_attention(*ins, 96 ** -0.5)
            grads = torch.autograd.grad(out, ins, dout)
        results.append((out, *grads))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K2"] == ops.LAUNCHES["K3"] == \
        ops.LAUNCHES["K4"] == 1
    for got, want in zip(*results):
        assert got.shape == want.shape and got.dtype == _BF16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


def _expert_vjp_plain(x, w, g):
    """The plain expert VJP forms: ``dx = g wᵀ``, ``dw = xᵀ g`` in f32."""
    return (ref.expert_gemm(g, w.transpose(1, 2)),
            ref.expert_gemm(x.transpose(1, 2), g))


#: (e, cap, d, f) of K1's expert VJP forms on the split route:
#: deepseek-moe-16b's training products at a 2048-token microbatch (cap
#: 240; wi with f = 2816, wo from f = 1408 back to 2048), the ragged stack
#: (d 200, f 136, cap 24: each expert's k edge (cap, for dw) and row and
#: column edges fall inside a tile, where the rank-3 maps zero-fill and
#: clip), and cap 17 at one tile of d and f
EXPERT_VJP_CASES = [(64, 240, 2048, 2816), (64, 240, 1408, 2048),
                    (8, 24, 200, 136), (5, 17, 64, 72)]


@pytest.mark.h100
@pytest.mark.parametrize("e,cap,d,f", EXPERT_VJP_CASES)
def test_expert_vjp_forms_match_plain(h100, e, cap, d, f):
    """``dx = g wᵀ`` and ``dw = xᵀ g`` (f32 g against bf16 x and w) on
    K1's split route (``ops.expert_route`` says "split"; one launch each,
    ``g`` split once for both), each held to ``ref.expert_gemm`` on the
    transposed views within 1e-4 of its largest entry (g's three bf16
    parts hold it within 2^-24; f32 sums in another order, each 64-k
    stage added in f32), and each rerun to the same bits."""
    gen = torch.Generator(device=h100).manual_seed(e + cap + d + f)
    x = torch.randn(e, cap, d, generator=gen, device=h100).to(_BF16)
    w = (torch.randn(e, d, f, generator=gen, device=h100)
         * d ** -0.5).to(_BF16)
    gr = torch.randn(e, cap, f, generator=gen, device=h100)
    assert ops.expert_route(e, cap, f, d, _F32, _BF16,
                            transpose_b=True) == "split"
    assert ops.expert_route(e, d, cap, f, _BF16, _F32,
                            transpose_a=True) == "split"
    parts = ops.split_bf16(gr)
    dx = ops._expert_gemm(gr, w, False, True, split=parts)
    dw = ops._expert_gemm(x, gr, True, False, split=parts)
    dx2 = ops._expert_gemm(gr, w, False, True, split=parts)
    dw2 = ops._expert_gemm(x, gr, True, False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 4 and ops.LAUNCHES["K9"] == 0
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    for got, want in zip((dx, dw), _expert_vjp_plain(x, w, gr)):
        assert got.shape == want.shape and got.dtype == torch.float32
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.h100
@pytest.mark.parametrize("e,cap,d,f,k1", [(2, 8, 64, 64, 3),
                                          (4, 24, 201, 64, 1),
                                          (3, 40, 128, 136, 3)])
def test_expert_matmul_backward_matches_plain(h100, e, cap, d, f, k1):
    """``expert_matmul``'s backward on the card: the gradients of x and w
    (cast to bf16, as ``_pallas_expert_bwd``'s) against the plain VJP.
    Aligned forms launch K1 three times (the forward and both VJP forms);
    a row of d = 201 sends the forward and dw = xᵀ g, which read rows of
    d, to K9 (dw on x's transposed row-major copy, bf16 against f32),
    while dx = g wᵀ reads rows of f only and stays on K1's split route."""
    gen = torch.Generator(device=h100).manual_seed(e * cap + d)
    x = torch.randn(e, cap, d, generator=gen, device=h100).to(_BF16)
    w = (torch.randn(e, d, f, generator=gen, device=h100)
         * d ** -0.5).to(_BF16)
    gr = torch.randn(e, cap, f, generator=gen, device=h100)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.expert_matmul(xg, wg, out_dtype=torch.float32)
    y.backward(gr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == k1 and ops.LAUNCHES["K9"] == 3 - k1
    for got, want in zip((xg.grad, wg.grad), _expert_vjp_plain(x, w, gr)):
        assert got.dtype == _BF16 and got.shape[0] == e
        # the result's bf16 rounding (2^-8) on top of the forms' f32 sums
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=1e-3 * want.abs().max().item())


@pytest.mark.h100
def test_moe_layer_loss_and_gradients_rerun_bit_identical(h100):
    """One MoE layer (reduced deepseek-moe-16b in bf16 on the card: K1's
    expert form, its VJP forms, the f32 router on K1's FMA route): a
    loss of its output and stats, and the gradients of every leaf and of
    the input, rerun to the same bits (dispatch and combine are gathers
    both ways: no atomic adds)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer
    cfg = get_config("deepseek-moe-16b", reduced=True).with_(
        dtype="bfloat16")
    params = transformer.init_lm(cfg, torch.Generator(
        device=h100).manual_seed(0), device=h100, trainable=True)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device=h100).manual_seed(3)
    x = torch.randn(2, 96, cfg.d_model, generator=gen,
                    device=h100).to(_BF16).requires_grad_()
    c = torch.randn(2, 96, cfg.d_model, generator=gen, device=h100)
    leaves = [x] + list(params["layers"]["moe"].values())

    def run():
        y, st = moe.apply_moe(lp, x, cfg)
        loss = (y.float() * c).sum() + 0.01 * st.aux_loss + 1e-3 * st.z_loss
        return (loss.detach(),) + torch.autograd.grad(loss, leaves)

    first = run()
    ops.reset_launches()
    again = run()
    torch.cuda.synchronize()
    # the router, both expert GEMMs and the shared pair, each forward and
    # VJP: the router's and the shared products' two each, the experts'
    assert ops.LAUNCHES["K1"] == 5 + 2 * 5
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(bool(torch.isfinite(t.float()).all()) for t in first)


def _attn_case(dev, dtype, b, s, g, hd, seed, kv=1):
    """q, k, v, dO of the grouped layout from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=dev).to(dtype)
    return (rnd(b, s, kv, g, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd),
            rnd(b, s, kv, g, hd))


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("b,s,kv,g,hd,window",
                         [(2, 70, 1, 8, 256, 0), (2, 130, 1, 8, 256, 33),
                          (2, 1000, 2, 16, 256, 300), (1, 130, 2, 4, 64, 0)]
                         + DENSE_FLASH_SHAPES)
def test_flash_export_leaves_output_unchanged(h100, dtype, b, s, kv, g, hd,
                                              window):
    q, k, v, _ = _attn_case(h100, dtype, b, s, g, hd, 4, kv=kv)
    scale = hd ** -0.5
    plain_out = ops.attention(q, k, v, scale=scale, window=window)
    out, m, l = ops.attention_stats(q, k, v, scale=scale, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K2"] == 2
    assert torch.equal(out, plain_out)
    _, rm, rl = ref.attention_stats(q, k, v, scale=scale, window=window)
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-4)
    # l sums p in f32 online (kernel) or at once (plain): order only
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,rel", [(_F32, 1e-4), (_BF16, 1e-2)])
@pytest.mark.parametrize("b,s,kv,g,hd,window",
                         [(2, 70, 1, 8, 256, 0), (2, 130, 1, 8, 256, 33),
                          (2, 37, 1, 4, 64, 0), (2, 45, 1, 2, 128, 7),
                          (1, 513, 1, 16, 128, 100), (1, 200, 1, 4, 256, 0),
                          (4, 4200, 1, 2, 64, 0)]
                         + FLASH_SHAPES[2:])
def test_flash_backward_kernels_match_plain(h100, dtype, rel, b, s, kv, g,
                                            hd, window):
    """K3 and K4 against their plain versions at ragged lengths, causal
    and windowed, from the kernel's own (m, l) and delta.  Tolerance
    relative to the largest entry: f32 differs in summation order only;
    bf16 rounds the outputs (2^-8), K3 rounds dS to bf16 for its
    tensor-core product, K4 rounds P and dS to bf16 for its products and
    sums the group in another order.  In bf16 K4 runs its tensor-core form
    with each key tile's rows split over blocks (every shape but the B=4
    S=4200 one, whose key tiles fill the card alone); a rerun of K4 is the
    same bits (its split partials are summed in a fixed order)."""
    q, k, v, do = _attn_case(h100, dtype, b, s, g, hd, 5, kv=kv)
    scale = hd ** -0.5
    out, m, l = ops.attention_stats(q, k, v, scale=scale, window=window)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    args = (q, k, v, do, m, l, delta)
    dq = ops.flash_dq(*args, scale=scale, window=window)
    dk, dv = ops.flash_dkv(*args, scale=scale, window=window)
    dk2, dv2 = ops.flash_dkv(*args, scale=scale, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K3"] == 1 and ops.LAUNCHES["K4"] == 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert (ops.dkv_splits(b, s, s, kv, g, True, window) == 1) == (b == 4)
    want = (ref.flash_dq(*args, scale=scale, window=window),
            *ref.flash_dkv(*args, scale=scale, window=window))
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == exp.shape
        err = (got.float() - exp.float()).abs().max().item()
        assert err <= rel * exp.float().abs().max().item(), err


@pytest.mark.h100
@pytest.mark.parametrize("dtype,rel", [(_F32, 1e-4), (_BF16, 1e-2)])
@pytest.mark.parametrize("b,s,kv,g,hd,window",
                         DENSE_FLASH_SHAPES + MOE_FLASH_SHAPES
                         + MLA_FLASH_SHAPES)
def test_flash_backward_kernels_match_plain_dense_family(h100, dtype, rel, b,
                                                         s, kv, g, hd,
                                                         window):
    """K3 and K4 at the rest of the dense family's shapes (G = 1 over 32
    KV heads of 64; G = 12 over 8 of 128), at deepseek-moe-16b's
    training attention (G = 1 over 16 KV heads of 128) and at
    minicpm3-4b's padded MLA attention (G = 1 over 40 of 128), held as
    ``test_flash_backward_kernels_match_plain`` holds its shapes; K4's
    rerun is the same bits, whatever its row split
    (``ops.dkv_splits``)."""
    q, k, v, do = _attn_case(h100, dtype, b, s, g, hd, 5, kv=kv)
    scale = hd ** -0.5
    out, m, l = ops.attention_stats(q, k, v, scale=scale, window=window)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    args = (q, k, v, do, m, l, delta)
    dq = ops.flash_dq(*args, scale=scale, window=window)
    dk, dv = ops.flash_dkv(*args, scale=scale, window=window)
    dk2, dv2 = ops.flash_dkv(*args, scale=scale, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K3"] == 1 and ops.LAUNCHES["K4"] == 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    want = (ref.flash_dq(*args, scale=scale, window=window),
            *ref.flash_dkv(*args, scale=scale, window=window))
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == exp.shape
        err = (got.float() - exp.float()).abs().max().item()
        assert err <= rel * exp.float().abs().max().item(), err


def _ssd_case(dev, b, s, h, n=128, p=64, seed=6):
    """Inputs of the SSD scan at Mamba-2's head width: a per-token log
    decay of -0.3|N(0, 1)| (the reference's tests), unit-normal X, B, C
    and a 0.1-normal entering state."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    return (rnd(b, s, h, p), -0.3 * rnd(b, s, h).abs(), rnd(b, s, n),
            rnd(b, s, n), 0.1 * rnd(b, h, p, n))


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


#: K6/K7 against their plain versions: both f32, differing in summation
#: order and in the kernel's fused multiply-adds (relative to the largest
#: plain entry of each output)
SSD_REL = 1e-4
SSD_SHAPES = [(51, 3 * 51 + 20), (175, 400), (256, 600)]


@pytest.mark.h100
@pytest.mark.parametrize("q,s", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(h100, q, s):
    """K6 over several chunks with a padded tail, with and without the
    per-chunk state export: the export leaves y and the final state the
    same bits, and h_in[:, 0] is the entering state."""
    xdt, dA, B, C, h0 = _ssd_case(h100, 2, s, 4)
    pad = (-s) % q
    args = [ops._pad_seq(t, pad) for t in (xdt, dA, B, C)] + [h0]
    y, final, none = ops.ssd_scan_chunked(*args, q)
    ye, finale, h_in = ops.ssd_scan_chunked(*args, q, export_h_in=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K6"] == 2 and none is None
    assert torch.equal(y, ye) and torch.equal(final, finale)
    assert torch.equal(h_in[:, 0], h0)
    yr, fr, hr = ref.ssd_scan(*args, q, export_h_in=True)
    for got, want in ((y, yr), (final, fr), (h_in, hr)):
        assert _rel_err(got, want) <= SSD_REL


@pytest.mark.h100
@pytest.mark.parametrize("q,s", SSD_SHAPES)
def test_ssd_pad_contract_keeps_the_final_state(h100, q, s):
    """A sequence padded to a multiple of the chunk with identity steps
    (zero input, zero log decay) ends in the state of the same tokens
    scanned as one unpadded chunk (q = s <= 256) or in unpadded chunks of
    the padded length's divisor."""
    xdt, dA, B, C, h0 = _ssd_case(h100, 1, s, 4, seed=7)
    y, final = ops.scan_ssd(xdt, dA, B, C, init_state=h0, chunk=q)
    whole = s if s <= 256 else next(c for c in range(256, 0, -1)
                                    if s % c == 0)
    y1, final1 = ops.scan_ssd(xdt, dA, B, C, init_state=h0, chunk=whole)
    torch.cuda.synchronize()
    assert y.shape == xdt.shape
    assert _rel_err(final, final1) <= SSD_REL
    assert _rel_err(y, y1) <= SSD_REL


@pytest.mark.h100
@pytest.mark.parametrize("q,s", SSD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(h100, q, s):
    """K7 from K6's own export, seeded with a non-zero final-state
    cotangent, against its plain version; a rerun is the same bits (the
    head sums of dB and dC take no atomics)."""
    xdt, dA, B, C, h0 = _ssd_case(h100, 2, s, 4, seed=8)
    gen = torch.Generator(device=h100).manual_seed(9)
    pad = (-s) % q
    args = [ops._pad_seq(t, pad) for t in (xdt, dA, B, C)]
    _, _, h_in = ops.ssd_scan_chunked(*args, h0, q, export_h_in=True)
    dy = ops._pad_seq(torch.randn(xdt.shape, generator=gen, device=h100),
                      pad)
    dhf = torch.randn(h0.shape, generator=gen, device=h100)
    xp, dap, bp, cp = args
    got = ops.ssd_bwd_chunked(cp, bp, dy, xp, dap, h_in, dhf)
    again = ops.ssd_bwd_chunked(cp, bp, dy, xp, dap, h_in, dhf)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K7"] == 2
    want = ref.ssd_bwd(cp, bp, dy, xp, dap, h_in, dhf)
    for name, g, a, w in zip(("dX", "dh0", "dB", "dC", "ddA"), got, again,
                             want):
        assert torch.equal(g, a), name
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= SSD_REL, (name, _rel_err(g, w))


#: K6/K7 at mamba2-780m's training shape (B=2 S=2048) across the kernels'
#: shape rules: h = 48 (three head groups of 16) and h = 20 (two groups of
#: 10: the group size does not divide it); n = 128, 64, 16 and 30 (not a
#: multiple of 4: 4-byte copies); q = 256, 175 (a ragged last tile and a
#: padded tail), 64 and 1; and the chunks shorter than a 64-row tile that
#: the H100 table derives (16 for mamba2-780m, ops.default_ssd_chunk) or
#: that lie between: 16, 32, 48
SSD_WIDE = [(48, 128, 256), (48, 128, 175), (48, 128, 64), (48, 128, 1),
            (48, 64, 256), (48, 16, 256), (48, 30, 256), (20, 128, 256),
            (20, 128, 64), (20, 30, 175), (48, 128, 16), (48, 128, 32),
            (48, 128, 48)]


@pytest.mark.h100
@pytest.mark.parametrize("h,n,q", SSD_WIDE)
def test_ssd_kernels_at_model_widths(h100, h, n, q):
    """K6 with and without its export (the same bits), K7 seeded from K6's
    own export with a non-zero final-state cotangent, each against its
    plain version; reruns of both give the same bits."""
    s = 2048
    xdt, dA, B, C, h0 = _ssd_case(h100, 2, s, h, n=n, seed=10)
    gen = torch.Generator(device=h100).manual_seed(11)
    pad = (-s) % q
    xp, dap, bp, cp = [ops._pad_seq(t, pad) for t in (xdt, dA, B, C)]
    y, final, _ = ops.ssd_scan_chunked(xp, dap, bp, cp, h0, q)
    ye, finale, h_in = ops.ssd_scan_chunked(xp, dap, bp, cp, h0, q, True)
    again = ops.ssd_scan_chunked(xp, dap, bp, cp, h0, q, True)
    dy = ops._pad_seq(torch.randn(xdt.shape, generator=gen, device=h100),
                      pad)
    dhf = torch.randn(h0.shape, generator=gen, device=h100)
    got = ops.ssd_bwd_chunked(cp, bp, dy, xp, dap, h_in, dhf)
    got2 = ops.ssd_bwd_chunked(cp, bp, dy, xp, dap, h_in, dhf)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K6"] == 3 and ops.LAUNCHES["K7"] == 2
    assert torch.equal(y, ye) and torch.equal(final, finale)
    assert all(torch.equal(a, b) for a, b in zip((ye, finale, h_in), again))
    assert torch.equal(h_in[:, 0], h0)
    yr, fr, hr = ref.ssd_scan(xp, dap, bp, cp, h0, q, export_h_in=True)
    for name, g, w in (("y", y, yr), ("final", final, fr), ("h_in", h_in,
                                                             hr)):
        assert _rel_err(g, w) <= SSD_REL, (name, _rel_err(g, w))
    want = ref.ssd_bwd(cp, bp, dy, xp, dap, h_in, dhf)
    for name, g, a, w in zip(("dX", "dh0", "dB", "dC", "ddA"), got, got2,
                             want):
        assert torch.equal(g, a), name
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= SSD_REL, (name, _rel_err(g, w))


#: K8 against its plain version: the same steps with the multiply and the
#: add rounded separately on both sides; exp() may differ in its last bit
#: (the kernel's expf against PyTorch's exp kernel), and each chunk's
#: entering state is folded from the chunks' aggregates (A, H), not walked
#: step by step, so it may differ in its last bits too, a difference that
#: the gates (a < 1) decay along the chunk; 1e-6 relative to the largest
#: plain entry of each output
GATED_REL = 1e-6


def _gated_case(dev, b, s, w, seed, integer=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        ints = lambda *shape: torch.randint(-3, 4, shape, generator=g,
                                            device=dev).float()
        return torch.zeros(b, s, w, device=dev), ints(b, s, w), ints(b, w)
    return (-0.5 * torch.randn(b, s, w, generator=g, device=dev).abs(),
            torch.randn(b, s, w, generator=g, device=dev),
            0.5 * torch.randn(b, w, generator=g, device=dev))


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(1, 1, 5), (2, 300, 70), (1, 1000, 256),
                                   (3, 33, 4096)])
def test_gated_scan_kernel_matches_plain(h100, reverse, with_h0, b, s, w):
    """K8's forward and reverse walks, with and without an entering state,
    at ragged lengths and widths (not multiples of its 32-step load groups
    or 32-channel blocks), against the plain walk."""
    la, bb, h0 = _gated_case(h100, b, s, w, seed=10 + s)
    h0 = h0 if with_h0 else None
    h, f = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K8"] == 1
    hr, fr = ref.gated_scan(la, bb, h0, reverse=reverse)
    assert _rel_err(h, hr) <= GATED_REL and _rel_err(f, fr) <= GATED_REL
    assert torch.equal(f, h[:, 0] if reverse else h[:, -1])


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
def test_gated_scan_kernel_is_exact_where_log_a_is_zero(h100, reverse):
    """With log_a = 0 on integers every partial sum is an exact integer:
    the kernel equals its plain version bit for bit."""
    la, bb, h0 = _gated_case(h100, 2, 517, 300, seed=11, integer=True)
    h, f = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    hr, fr = ref.gated_scan(la, bb, h0, reverse=reverse)
    assert torch.equal(h, hr) and torch.equal(f, fr)


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,s,w", [(1, 15, 64), (1, 16, 65), (1, 17, 130),
                                   (2, 33, 70), (1, 129, 260),
                                   (1, 2049, 256), (1, 4096, 4096)])
def test_gated_scan_at_chunk_and_strip_edges(h100, reverse, b, s, w):
    """K8's chunks (derived, ``ops.default_gated_chunk``: 16 steps on the
    H100 table at each of these shapes, 4096 x 4096 included) and
    64-channel strips at their edges: one step short of a chunk, exactly
    one, one past, ragged strips, and past groups of eight chunks (129 and
    2049 steps of 16-step chunks), with an entering state."""
    la, bb, h0 = _gated_case(h100, b, s, w, seed=20 + s)
    assert ops.default_gated_chunk(s, w) == 16
    h, f = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K8"] == 1
    hr, fr = ref.gated_scan(la, bb, h0, reverse=reverse)
    assert _rel_err(h, hr) <= GATED_REL and _rel_err(f, fr) <= GATED_REL
    assert torch.equal(f, h[:, 0] if reverse else h[:, -1])


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("chunk", [16, 48, 64, 128, 1024])
def test_gated_scan_at_derived_chunks(h100, reverse, chunk):
    """K8 at the chunks a derivation can give (multiples of 16 up to 1024:
    the H100 table's 16, the v5e copy's 128, the solver's cap 1024), a
    chunk of more than one 64-step piece staged piece by piece: against
    the plain walk, a rerun the same bits."""
    la, bb, h0 = _gated_case(h100, 2, 2049, 260, seed=chunk)
    h, f = ops.gated_recurrence(la, bb, h0, reverse=reverse, chunk=chunk)
    again = ops.gated_recurrence(la, bb, h0, reverse=reverse, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K8"] == 2
    hr, fr = ref.gated_scan(la, bb, h0, reverse=reverse)
    assert _rel_err(h, hr) <= GATED_REL and _rel_err(f, fr) <= GATED_REL
    assert torch.equal(h, again[0]) and torch.equal(f, again[1])
    assert torch.equal(f, h[:, 0] if reverse else h[:, -1])


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
def test_gated_scan_unaligned_operands(h100, reverse):
    """Bases that are not 16-byte aligned take the kernel's 4-byte
    copies."""
    b, s, w = 2, 100, 128
    la, bb, h0 = _gated_case(h100, b, s, w, seed=21)
    shift = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(
        x.shape)
    la, bb = shift(la), shift(bb)
    assert la.data_ptr() % 16 and la.is_contiguous()
    h, f = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    hr, fr = ref.gated_scan(la, bb, h0, reverse=reverse)
    assert _rel_err(h, hr) <= GATED_REL and _rel_err(f, fr) <= GATED_REL


@pytest.mark.h100
@pytest.mark.parametrize("reverse", [False, True])
def test_gated_scan_reruns_are_bit_identical(h100, reverse):
    """Each chunk's entering state is folded in chunk order whichever
    block finishes first: two runs give the same bits."""
    la, bb, h0 = _gated_case(h100, 1, 4096, 4096, seed=22)
    first = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    again = ops.gated_recurrence(la, bb, h0, reverse=reverse)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.h100
def test_gated_scan_backward_runs_the_reverse_walk(h100):
    """Autograd through ``ops.gated_scan`` launches K8 twice (the forward
    and the reverse walk) and matches the plain version's gradients."""
    la, bb, h0 = _gated_case(h100, 2, 300, 70, seed=12)
    g = torch.Generator(device=h100).manual_seed(13)
    gy = torch.randn(la.shape, generator=g, device=h100)
    gf = torch.randn(h0.shape, generator=g, device=h100)
    grads = []
    for plain in (False, True):
        tin = [t.clone().requires_grad_(True) for t in (la, bb, h0)]
        with ops.reference_mode() if plain else torch.enable_grad():
            h, f = ops.gated_scan(tin[0], tin[1], init_state=tin[2])
            grads.append(torch.autograd.grad(
                (h * gy).sum() + (f * gf).sum(), tin))
    assert ops.LAUNCHES["K8"] == 2
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= GATED_REL


# ---------------------------------------------------------------------------
# K1's int8 tile: int8 x int8 -> exact int32 (ops.apply, acc_dtype="int32")
# ---------------------------------------------------------------------------

#: (m, k, n): ragged (no multiple of the 128 x BN x 128 tiles, k not a
#: multiple of 16: both operands packed to k_pad), aligned (each operand
#: read in place or packed by its layout), k of one element, and
#: mamba-width rows
INT8_SHAPES = [(37, 72, 130), (1001, 37, 999), (256, 4096, 512),
               (130, 1, 33), (2048, 2560, 1024)]


def _int8(dev, *shape, seed=0, lo=-128, hi=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, device=dev,
                         dtype=torch.int8)


def _packs(k, ta, tb, aligned=True):
    """The operands K1's int8 tile packs K-major for op(a) @ op(b)."""
    return sum(not ops.int8_reads_in_place(k, mn, aligned)
               for mn in (ta, not tb))


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_gemm_int8_form_matches_plain_bit_for_bit(h100, m, k, n, ta, tb):
    """Every 2-D int8 product is K1's int8 tile (TMA + wgmma s8), each
    operand 8-bit wgmma cannot read in place packed K-major first: equal
    to the exact plain version (int64 sums checked into int32) bit for
    bit, to K1's ``mma.sync`` int8 form (no route: the comparison) on
    the same operands, and a rerun too."""
    a = _int8(h100, *((k, m) if ta else (m, k)), seed=m + k)
    b = _int8(h100, *((n, k) if tb else (k, n)), seed=n + 3 * k)
    assert ops.gemm_route(m, n, k, a.dtype, b.dtype, ta, tb) == "int8_tile"
    got = ops._product(a, b, ta, tb)
    again = ops._product(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and got.dtype == torch.int32
    assert ops.PACKED["int8"] == 2 * _packs(k, ta, tb)
    assert torch.equal(got, ref.matmul_int8(a, b, ta, tb))
    assert torch.equal(got, again)
    assert torch.equal(got, ops._gemm_int8(a, b, ta, tb))


@pytest.mark.h100
def test_gemm_int8_form_at_the_int32_edge(h100):
    """All operands -128 over k = 4096: every sum is 2^26, far past f32's
    exact integers (2^24) and exact in int32; an unaligned base is packed
    (its byte loads) before the tile reads it."""
    k = 4096
    a = torch.full((40, k), -128, dtype=torch.int8, device=h100)
    b = torch.full((k, 24), -128, dtype=torch.int8, device=h100)
    got = ops._product(a, b)
    assert torch.equal(got, torch.full((40, 24), 128 * 128 * k,
                                       dtype=torch.int32, device=h100))
    flat = _int8(h100, 40 * k + 1, seed=5)
    a2 = flat[1:].view(40, k)
    assert a2.data_ptr() % 16
    ops.reset_launches()
    assert torch.equal(ops._product(a2, b), ref.matmul_int8(a2, b))
    assert ops.LAUNCHES["K1"] == 1 and ops.PACKED["int8"] == 2


@pytest.mark.h100
@pytest.mark.parametrize("e,cap,d,f", [(4, 60, 96, 72), (8, 8, 2048, 2816),
                                       (3, 200, 37, 130)])
def test_gemm_int8_expert_form_matches_plain(h100, e, cap, d, f):
    """The expert form through ``ops.apply`` (acc_dtype int32) on K1's int8
    tile, w stored (e, d, f) packed K-major first: each expert's product
    exact, bit for bit."""
    x, w = _int8(h100, e, cap, d, seed=e), _int8(h100, e, d, f, seed=f)
    expr = ops.E.expert_gemm_expr(e, cap, d, f)
    got = ops.apply(expr, x, w, acc_dtype="int32", out_dtype=torch.int32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1 and ops.LAUNCHES["K9"] == 0
    assert ops.PACKED["int8"] == _packs(d, False, False)
    assert torch.equal(got, ref.matmul_int8(x, w))


#: int8 stacks (e, m, k, n): e = 16 of 1024^3 (the [derive_path] row),
#: ragged m and n (130, 70: clipped TMA stores; n % 4 != 0: register
#: stores), one k granule (16), k = 4096 past every tile, and k % 16 != 0
#: (65: both operands packed to a pitch of 80)
INT8_STACKS = [(16, 1024, 1024, 1024), (3, 130, 64, 70), (5, 200, 16, 136),
               (2, 257, 4096, 300), (3, 130, 65, 70)]


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(False, True), (False, False),
                                   (True, True)])
@pytest.mark.parametrize("e,m,k,n", INT8_STACKS)
def test_int8_stack_matches_plain_bit_for_bit(h100, e, m, k, n, ta, tb):
    """An int8 stack through ``ops.apply`` (acc_dtype int32) of each
    transpose is one K1 launch and no K9: the int8 tile, which reads in
    place an operand stored K-major (A (e, m, k), B (e, n, k)) with k %
    16 == 0 and packs every other one K-major first; each bit for bit the
    exact plain version, and a rerun the same bits."""
    x = _int8(h100, *((e, k, m) if ta else (e, m, k)), seed=e + m)
    w = _int8(h100, *((e, n, k) if tb else (e, k, n)), seed=n + k)
    route = ops.expert_route(e, m, k, n, x.dtype, w.dtype, True, ta, tb)
    assert route == "int8_tile"
    E = ops.E
    xe, we = E.arr("X", tuple(x.shape)), E.arr("W", tuple(w.shape))
    expr = E.inner("add", "mul", E.transpose(xe, (0, 2, 1)) if ta else xe,
                   E.transpose(we, (0, 2, 1)) if tb else we, batch=1)
    call = lambda: ops.apply(expr, x, w, acc_dtype="int32",
                             out_dtype=torch.int32)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert ops.PACKED["int8"] == 2 * _packs(k, ta, tb)
    assert got.dtype == torch.int32 and got.shape == (e, m, n)
    assert torch.equal(got, ref.matmul_int8(x, w, ta, tb))
    assert torch.equal(got, again)


@pytest.mark.h100
def test_int8_tile_sums_wrap_as_an_int32_accumulator(h100):
    """The int8 tile's integer sums wrap (two's complement) past 2^31, as
    the int8 form's (the same bits on the same operands) and the
    reference's int32 accumulator do: (-128)^2 over 2^17 + 16 terms is
    2^31 + 2^18; at k = 4096 every sum is 2^26, far past f32's exact
    integers, and exact."""
    k = 2 ** 17 + 16
    x = torch.full((2, 3, k), -128, dtype=torch.int8, device=h100)
    w = torch.full((2, 5, k), -128, dtype=torch.int8, device=h100)
    got = ops._gemm_int8_tile(x, w, False, True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1 and ops.PACKED["int8"] == 0
    wrapped = (2 ** 14 * k + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert torch.equal(got, torch.full_like(got, wrapped))
    assert torch.equal(got, ops._gemm_int8(x, w, False, True))
    assert torch.equal(ops._gemm_int8_tile(x.transpose(1, 2).contiguous(),
                                           w, True, True), got)
    x, w = x[..., :4096].contiguous(), w[..., :4096].contiguous()
    assert torch.equal(ops._gemm_int8_tile(x, w, False, True),
                       torch.full((2, 3, 5), 2 ** 26, dtype=torch.int32,
                                  device=h100))


#: (stored shape, MN-major): the pack's cases: 4096^2 B stored (k, n) (the
#: [derive_path] row), a stack of MN-major experts, ragged rows and k (no
#: multiple of its 64 x 64 tiles), K-major rows of k % 16 != 0, one k,
#: and an unaligned base (byte loads)
PACK_CASES = [((4096, 4096), True), ((16, 1024, 1024), True),
              ((999, 37), True), ((3, 65, 130), True), ((1001, 37), False),
              ((2, 70, 65), False), ((1, 33), True), ((130, 1), False)]


@pytest.mark.h100
@pytest.mark.parametrize("shape,mn", PACK_CASES)
def test_int8_pack_matches_plain(h100, shape, mn):
    """The K-major pack (``ops.pack_kmajor_int8``, one launch, counted in
    ``PACKED``) equals ``ref.pack_kmajor_int8`` byte for byte: the
    operand K-major at k rounded up to 16, zeros past k; so does a pack
    from an unaligned base."""
    t = _int8(h100, *shape, seed=sum(shape))
    got = ops.pack_kmajor_int8(t, mn)
    torch.cuda.synchronize()
    assert ops.PACKED["int8"] == 1 and ops.LAUNCHES["K1"] == 0
    assert torch.equal(got, ref.pack_kmajor_int8(t, mn))
    flat = _int8(h100, t.numel() + 1, seed=3)
    u = flat[1:].view(shape)
    assert u.data_ptr() % 16
    assert torch.equal(ops.pack_kmajor_int8(u, mn),
                       ref.pack_kmajor_int8(u, mn))


def _int8_head_operands(dev, m, tb, k=None, seed=11):
    """minicpm3-4b's absorbed decode products in int8: q_lat (``tb``: x
    (m, 40, 64) a column slice of (m, 40, 96), w the (n=256, 40, 64)
    slice of a (256, 40, 128) table) or out (x (m, 40, 256), w the (k=256,
    40, 64) slice at column 64); ``k`` widens q_lat's (its table's
    columns grow with it)."""
    k = k or (64 if tb else 256)
    if tb:
        x = _int8(dev, m, 40, k + 32, seed=seed + m)[..., :k]
        table = _int8(dev, 256, 40, 2 * k, seed=seed)
        return x, table[..., :k]
    table = _int8(dev, k, 40, 128, seed=seed)
    return _int8(dev, m, 40, k, seed=seed + m), table[..., 64:]


@pytest.mark.h100
@pytest.mark.parametrize("tb,k", [(True, 64), (True, 96), (True, 2048),
                                  (False, 256), (False, 32), (False, 4096)])
@pytest.mark.parametrize("m", [1, 2, 4, 16])
def test_int8_head_rows_match_plain_bit_for_bit(h100, m, tb, k):
    """The int8 head form at most 16 rows on K1's int8 decode rows
    (``ops.head_route`` "gemv"): through ``ops.apply`` (acc_dtype int32)
    on the strided views of the stored table, one K1 launch, no K9 and no
    copy; bit for bit ``ref.head_gemm_int8``, unsplit (q_lat, k 64) and
    split over k (k 2048 / 4096; out at k 256 splits 2 ways), at a half
    unit (k 96 with w stored (n, h, k)); a rerun the same bits."""
    x, w = _int8_head_operands(h100, m, tb, k)
    n = w.shape[0] if tb else w.shape[2]
    assert ops.head_aligned(x, w)
    assert ops.head_route(40, m, k, n, x.dtype, w.dtype, tb) == "gemv"
    nsplit = ops.gemv_splits(m, n, k, 40, *ops.K1_GEMV8[tb])
    expr = ops.E.head_gemm_expr(40, m, k, n, transpose_b=tb)
    call = lambda: ops.apply(expr, x, w, acc_dtype="int32",
                             out_dtype=torch.int32)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2 and ops.LAUNCHES["K9"] == 0
    assert got.dtype == torch.int32 and got.shape == (40, m, n)
    assert torch.equal(got, ref.head_gemm_int8(x, w, tb))
    assert torch.equal(got, again)
    # the k split (ops.gemv_splits in the int8 rows' units): q_lat's k 64
    # and 96 and out's k 32 unsplit, the rest split
    assert (nsplit > 1) == (k >= 2048 or (not tb and k >= 256))


@pytest.mark.h100
@pytest.mark.parametrize("tb", [True, False])
def test_int8_head_rows_wrap_as_an_int32_accumulator(h100, tb):
    """The int8 decode rows' sums wrap past 2^31 as the reference's int32
    accumulator does, split or not: (-128)^2 over 2^17 + 32 terms is
    2^31 + 2^19 (two's complement)."""
    k, n = 2 ** 17 + 32, 16
    x = torch.full((4, 2, k), -128, dtype=torch.int8, device=h100)
    w = torch.full((n, 2, k) if tb else (k, 2, n), -128, dtype=torch.int8,
                   device=h100)
    got = ops._head_gemm(x, w, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1
    assert ops.gemv_splits(4, n, k, 2, *ops.K1_GEMV8[tb]) > 1
    wrapped = (2 ** 14 * k + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert torch.equal(got, torch.full((2, 4, n), wrapped,
                                       dtype=torch.int32, device=h100))


@pytest.mark.h100
def test_gemm_int8_head_form_and_k9_refuse_int32(h100):
    """int32 accumulation of the head form: at k = 32, m = 4 on K1's int8
    decode rows, one K1 launch and no K9; at k = 40 (no multiple of 32,
    refused by K1) on K9's integer accumulator, one K9 launch and no K1;
    each bit for bit the plain version's exact sums."""
    for k, kid in ((32, "K1"), (40, "K9")):
        x, w = _int8(h100, 4, 2, k), _int8(h100, k, 2, 16, seed=1)
        expr = ops.E.head_gemm_expr(2, 4, k, 16)
        ops.reset_launches()
        got = ops.apply(expr, x, w, acc_dtype="int32", out_dtype=torch.int32)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kid] == 1 and sum(ops.LAUNCHES.values()) == 1
        with ops.reference_mode():
            want = ops.apply(expr, x, w, acc_dtype="int32",
                             out_dtype=torch.int32)
        assert got.dtype == torch.int32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# K9: the general-semiring contraction (ops.apply and its builders)
# ---------------------------------------------------------------------------

def _k9(expr, *arrays, out_dtype=torch.float32):
    """K9 on the card, then its plain version on the same tensors.  K9
    runs from the plan of unaligned bases: ``ops.apply`` gives an aligned
    bf16 batched (mul, add) form to K1's expert form (``ops.expert_route``),
    and K9 is what these tests hold."""
    from repro_torch.kernels import emit
    nf = ops.E.normal_form(expr)
    plan = ops._plan(nf, tuple(str(a.dtype)[6:] for a in arrays), out_dtype,
                     ops.H100, None, "float32", False)
    assert plan[0] == "K9" and isinstance(plan[1], emit.Launch)
    got = ops.semiring_contract(plan[1], *arrays, out_dtype=out_dtype)
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = ops.apply(expr, *arrays, out_dtype=out_dtype)
    return got, want, plan[1].mode


def _mm(plus, times, m, k, n, a_layout="row"):
    E = ops.E
    b = E.arr("B", (k, n), a_layout)
    return E.inner(plus, times, E.arr("A", (m, k)), b)


#: (mul, add) and (add, add) fold in another order than the plain
#: version's (and (mul, add) multiplies bf16 hi / lo parts on the tensor
#: cores, within about 2^-16 of each product): 1e-5 of the largest
#: entry's sum of magnitudes per contracted term
K9_SUM_REL = 1e-5


@pytest.mark.h100
@pytest.mark.parametrize("plus,times", [("add", "mul"), ("add", "add"),
                                        ("max", "add"), ("min", "add"),
                                        ("max", "mul"), ("min", "mul")])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_k9_every_semiring_pair_matches_plain(h100, plus, times, dtype):
    """Every (combine, reduce) pair at a shape the H100 schedule does not
    pad (so (mul, max) / (mul, min), with no inert element, may run);
    ``ops.apply`` of a 2-D (mul, add) product is K1's, so that pair runs
    batched (one more out axis) to reach K9."""
    g = torch.Generator(device=h100).manual_seed(20)
    E = ops.E
    if (plus, times) == ("add", "mul"):
        expr = E.inner(plus, times, E.arr("X", (2, 64, 128)),
                       E.arr("W", (2, 128, 96)), batch=1)
        shapes = [(2, 64, 128), (2, 128, 96)]
    else:
        expr = _mm(plus, times, 96, 96, 96)
        shapes = [(96, 96), (96, 96)]
    arrays = [torch.randn(*s, generator=g, device=h100).to(dtype)
              for s in shapes]
    got, want, _ = _k9(expr, *arrays)
    assert ops.LAUNCHES["K9"] == 1
    if plus in ("max", "min"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=K9_SUM_REL * shapes[0][-1] *
                                   want.abs().max().item())


@pytest.mark.h100
@pytest.mark.parametrize("plus", ["max", "min"])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 70, 130), (130, 33, 65),
                                   (200, 513, 70)])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_k9_tropical_is_bit_for_bit_at_ragged_shapes(h100, plus, m, k, n,
                                                     dtype):
    """Masking past the logical extents stands for the inert padding: the
    tropical product equals its plain version bit for bit at shapes that
    are no multiple of K9's 128x128x16 tiles, f32 and bf16 inputs."""
    g = torch.Generator(device=h100).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=h100).to(dtype)
    b = torch.randn(k, n, generator=g, device=h100).to(dtype)
    got = ops.semiring_matmul(a, b, plus=plus, times="add")
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = ops.semiring_matmul(a, b, plus=plus, times="add")
    assert ops.LAUNCHES["K9"] == 1 and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.h100
@pytest.mark.parametrize("plus,times", [("add", "mul"), ("add", "add")])
def test_k9_sums_are_exact_on_integers(h100, plus, times):
    """On integer-valued inputs every product (its bf16 parts exact too)
    and every partial sum is exact, so the (mul, add) products on the
    tensor cores and the (add, add) folds equal the plain version bit for
    bit."""
    g = torch.Generator(device=h100).manual_seed(21)
    E = ops.E
    x = torch.randint(-4, 5, (3, 70, 130), generator=g, device=h100).float()
    w = torch.randint(-4, 5, (3, 130, 45), generator=g, device=h100).float()
    expr = E.inner(plus, times, E.arr("X", (3, 70, 130)),
                   E.arr("W", (3, 130, 45)), batch=1)
    got, want, mode = _k9(expr, x, w)
    assert mode == 0 and torch.equal(got, want)


@pytest.mark.h100
def test_k9_reads_col_and_psi_leaves_in_place(h100):
    """A col-layout B (its stored (n, k) buffer) and a psi slab of a stack
    (a base offset into the whole buffer) go to K9 as strides and a base:
    bit for bit against the plain version, which slices and transposes."""
    g = torch.Generator(device=h100).manual_seed(22)
    E = ops.E
    a = torch.randn(100, 70, generator=g, device=h100)
    bt = torch.randn(90, 70, generator=g, device=h100)      # stored (n, k)
    got, want, _ = _k9(_mm("max", "add", 100, 70, 90, "col"), a, bt)
    assert torch.equal(got, want)
    assert torch.equal(want, (a[:, :, None] + bt.t()[None]).amax(1))
    stack = torch.randn(5, 100, 70, generator=g, device=h100)
    b = torch.randn(70, 90, generator=g, device=h100)
    expr = E.inner("min", "add", E.psi((3,), E.arr("S", (5, 100, 70))),
                   E.arr("B", (70, 90)))
    got, want, _ = _k9(expr, stack, b)
    assert torch.equal(got, want)
    assert torch.equal(want, (stack[3][:, :, None] + b[None]).amin(1))


@pytest.mark.h100
def test_k9_propagates_nan_as_torch_maximum(h100):
    """NaN inputs and -inf + inf pairs give NaN where ``torch.maximum`` /
    ``torch.amax`` do, and +-inf elsewhere as they do."""
    g = torch.Generator(device=h100).manual_seed(23)
    a = torch.randn(40, 50, generator=g, device=h100)
    b = torch.randn(50, 60, generator=g, device=h100)
    a[3, 7] = float("nan")
    a[5, :] = float("-inf")
    b[:, 9] = float("inf")
    a[8, 2] = float("inf")
    b[2, 11] = float("-inf")
    for plus in ("max", "min"):
        got = ops.semiring_matmul(a, b, plus=plus, times="add")
        torch.cuda.synchronize()
        want = getattr(torch, "amax" if plus == "max" else "amin")(
            a[:, :, None] + b[None], dim=1)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(want).any())
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep], want[keep])


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_k9_elementwise_reduce_chain_and_kron(h100, dtype):
    """The map, reduce and chain paths and the outer product: Hadamard
    (bf16 out), the lone max along rows and min along columns (reduce),
    the 3-operand chain, mul over a reduce, and kron written in place."""
    from repro_torch.kernels import emit
    g = torch.Generator(device=h100).manual_seed(24)
    E = ops.E
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100).to(dtype)
    a, b = rnd(70, 130), rnd(70, 130)
    got = ops.hadamard(a, b)
    assert got.dtype == dtype
    assert torch.equal(got, (a.float() * b.float()).to(dtype))
    x = rnd(70, 130)
    for op, axis in (("max", 1), ("min", 0)):
        got, want, m = _k9(E.reduce(op, E.arr("A", (70, 130)), axis), x)
        assert m == emit.REDUCE and torch.equal(got, want)
    chain = E.arr("A", (33, 40)) @ E.arr("B", (40, 50)) @ E.arr("C", (50, 20))
    ca, cb, cc = rnd(33, 40), rnd(40, 50), rnd(50, 20)
    got, want, mode = _k9(chain, ca, cb, cc)
    assert mode == emit.CHAIN
    torch.testing.assert_close(got, want, rtol=0,
                               atol=K9_SUM_REL * 2000 * want.abs().max().item())
    scale = E.combine("mul", E.reduce("add", E.arr("X", (30, 40, 50)), 1),
                      E.arr("Y", (30, 50)))
    sx, sy = rnd(30, 40, 50), rnd(30, 50)
    got, want, _ = _k9(scale, sx, sy)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=K9_SUM_REL * 40 * want.abs().max().item())
    p, q = rnd(16, 24), rnd(8, 12)
    ops.reset_launches()
    got = ops.kron(p, q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] == 1
    assert torch.equal(got, ref.kron_ref(p, q))


def _map_cases(E, rnd, ints):
    """(label) -> (expr, operands, out dtype, apply's acc_dtype) of MAP's
    span walk: the 6-axis Kronecker product of two (16, 16, 16) cubes
    (the long walk, 32-bit, streaming stores), kron 64x64 (x) 64x64, a
    last axis no multiple of 4 (scalar edge stores, a ragged row of
    runs), an operand broadcast along the last axis, int8 -> int32
    Hadamard and a nest of 6 operands (FACTOR's first stage pairs 4 on
    MAP), the last two on small integers (exact products)."""
    A = E.arr
    c = 16
    hada = lambda n, s: E.combine("mul", hada(n - 1, s) if n > 2 else
                                  A("H0", s), A(f"H{n - 1}", s))
    i8 = ints(300, 1001).to(torch.int8), ints(300, 1001).to(torch.int8)
    return {
        "kron6": (E.transpose(E.inner("add", "mul", A("A", (c, c, c, 1)),
                                      A("B", (1, c, c, c))),
                              (0, 3, 1, 4, 2, 5)),
                  (rnd(c, c, c, 1), rnd(1, c, c, c)), _F32, "float32"),
        "kron64": (E.transpose(ops._outer_expr(64, 64, 64, 64),
                               (0, 2, 1, 3)),
                   (rnd(64, 64, 1), rnd(1, 64, 64)), _F32, "float32"),
        "ragged": (E.transpose(E.inner("add", "mul", A("A", (7, 9, 1)),
                                       A("B", (1, 11, 1001))),
                               (0, 2, 1, 3)),
                   (rnd(7, 9, 1), rnd(1, 11, 1001)), _BF16, "float32"),
        "broadcast": (ops._outer_expr(300, 5, 3, 1024),
                      (rnd(300, 5, 1), rnd(1, 3, 1024)), _F32, "float32"),
        "int8": (E.hadamard_expr(300, 1001), i8, torch.int32, "int32"),
        "nest6": (hada(6, (130, 1000)),
                  tuple(ints(130, 1000) for _ in range(6)), _F32,
                  "float32"),
    }


@pytest.mark.h100
@pytest.mark.parametrize("name", ["kron6", "kron64", "ragged", "broadcast",
                                  "int8", "nest6"])
def test_k9_map_span_walk_bit_for_bit(h100, name):
    """MAP's span walk (a thread's first run decoded once, the rest
    reached by carries; 32-bit where its indices fit; streaming stores
    past the L2) through ``ops.apply``: one K9 launch, bit for bit
    against the plain version, and the descriptor's walk as the host's
    model of it (``emit.map_walk_offsets``) holds on the CPU."""
    from repro_torch.kernels import emit
    g = torch.Generator(device=h100).manual_seed(len(name) + 41)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100)
    ints = lambda *s: torch.randint(-3, 4, s, generator=g,
                                    device=h100).float()
    expr, arrays, out_dt, acc = _map_cases(ops.E, rnd, ints)[name]
    ops.reset_launches()
    got = ops.apply(expr, *arrays, out_dtype=out_dt, acc_dtype=acc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(ops.LAUNCHES, K1=0, K9=1)
    with ops.reference_mode():
        want = ops.apply(expr, *arrays, out_dtype=out_dt, acc_dtype=acc)
    assert got.dtype == want.dtype and torch.equal(got, want)
    plan = ops._plan(ops.E.normal_form(expr),
                     tuple(str(a.dtype)[6:] for a in arrays), out_dt,
                     ops.H100, None, acc, True)[1]
    first = plan.stages[0] if plan.stages else plan
    assert first.mode == emit.MAP
    if name in ("kron6", "kron64"):
        d = plan.c_struct((_F32, _F32), _F32, (0, 0))
        assert d.narrow == 1 and d.stream_out == 1


@pytest.mark.h100
def test_apply_takes_strided_views_on_both_routes(h100):
    """A transposed view through ``moa_gemm`` (K1) and through
    ``semiring_matmul`` (K9), and a column slice ``x[:, :k]`` of a wider
    tensor (K9), each equal the plain version on contiguous copies."""
    g = torch.Generator(device=h100).manual_seed(25)
    a = torch.randn(130, 70, generator=g, device=h100)
    bt = torch.randn(90, 70, generator=g, device=h100)      # b = bt.t()
    wide = torch.randn(130, 100, generator=g, device=h100)
    x = wide[:, :70]
    assert not bt.t().is_contiguous() and not x.is_contiguous()
    got = ops.moa_gemm(a, bt.t())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1 and ops.LAUNCHES["K9"] == 0
    torch.testing.assert_close(got, ref.matmul(a, bt.t().contiguous()),
                               rtol=1e-5, atol=1e-4)
    got_t = ops.semiring_matmul(a, bt.t(), plus="max", times="add")
    got_x = ops.semiring_matmul(x, bt.t(), plus="max", times="add")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] == 2
    with ops.reference_mode():
        want_t = ops.semiring_matmul(a, bt.t().contiguous(), plus="max",
                                     times="add")
        want_x = ops.semiring_matmul(x.contiguous(), bt.t().contiguous(),
                                     plus="max", times="add")
    assert torch.equal(got_t, want_t) and torch.equal(got_x, want_x)


# K9's paths (emit._mode): the pipelined TILE, MAP, REDUCE, CHAIN, THREAD

#: ragged (m, k, n): a single element, and sizes off every tile, slab and
#: vector multiple (TILE's 128 x 128 x 16, MAP's and REDUCE's runs of 4)
K9_RAGGED = [(1, 1, 1), (37, 70, 130), (130, 33, 65), (257, 300, 129)]


def _leaf_case(E, kind, m, k, n, rnd, plus="max", times="add"):
    """An (m, k) x (k, n) contraction whose A or B is read through
    ``kind``: row-major, a col-layout B (stored (n, k)), a transposed A
    (stored (k, m)) or a psi slab of a stack of three; its arrays."""
    if kind == "row":
        return (E.inner(plus, times, E.arr("A", (m, k)), E.arr("B", (k, n))),
                [rnd(m, k), rnd(k, n)])
    if kind == "col":
        return (E.inner(plus, times, E.arr("A", (m, k)),
                        E.arr("B", (k, n), "col")), [rnd(m, k), rnd(n, k)])
    if kind == "trans":
        return (E.inner(plus, times, E.transpose(E.arr("A", (k, m)), (1, 0)),
                        E.arr("B", (k, n))), [rnd(k, m), rnd(k, n)])
    return (E.inner(plus, times, E.psi((1,), E.arr("S", (3, m, k))),
                    E.arr("B", (k, n))), [rnd(3, m, k), rnd(k, n)])


def _sum_close(got, want, k):
    """(mul, add) / (add, add) sums: K9_SUM_REL per contracted term of the
    largest entry, and a bf16 output's own rounding (2^-8)."""
    tol = K9_SUM_REL * k * want.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        tol += 2.0 ** -8 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.h100
@pytest.mark.parametrize("kind", ["row", "col", "trans", "psi"])
@pytest.mark.parametrize("m,k,n", K9_RAGGED)
@pytest.mark.parametrize("in_dt,out_dt", [(_F32, _F32), (_BF16, _F32),
                                          (_F32, _BF16), (_BF16, _BF16)])
def test_k9_tile_leaves_match_plain(h100, kind, m, k, n, in_dt, out_dt):
    """The pipelined TILE path on row-major, col-layout, transposed and
    psi leaves (each read along its smaller stride, by 16-byte or 4-byte
    copies): max-plus bit for bit, (mul, add) batched within K9_SUM_REL."""
    from repro_torch.kernels import emit
    g = torch.Generator(device=h100).manual_seed(m + 3 * k + 7 * n)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100).to(in_dt)
    expr, arrays = _leaf_case(ops.E, kind, m, k, n, rnd)
    # every contracted extent 1: MAP before TILE
    path = emit.TILE if k > 1 else emit.MAP
    got, want, mode = _k9(expr, *arrays, out_dtype=out_dt)
    assert mode == path and got.dtype == out_dt
    assert torch.equal(got, want)
    E = ops.E
    x, w = rnd(2, m, k), rnd(2, k, n)
    batched = E.inner("add", "mul", E.arr("X", (2, m, k)),
                      E.arr("W", (2, k, n)), batch=1)
    got, want, mode = _k9(batched, x, w, out_dtype=out_dt)
    assert mode == path
    _sum_close(got, want, k)


@pytest.mark.h100
@pytest.mark.parametrize("dt", [_F32, _BF16])
def test_k9_tile_copy_width_boundary(h100, dt):
    """The copy width the host picks (``emit.vector_ok``): 16-byte copies
    where rows are a multiple of 16 bytes and the base is aligned, 4-byte
    ones (element loads for bf16) a row or a base off it; the two agree
    bit for bit with the plain version, and a K split of a small grid
    too."""
    from repro_torch.kernels import emit
    E = ops.E
    per = 16 // torch.empty((), dtype=dt).element_size()
    g = torch.Generator(device=h100).manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100).to(dt)
    cases = []
    for k in (8 * per, 8 * per + 1, 8 * per - 2):       # A's rows
        for n in (144, 8 * per + 2):                    # B's rows
            cases.append((rnd(150, k), rnd(k, n), k % per == 0,
                          n % per == 0))
    stor = rnd(150 * 8 * per + 1)
    a_off = stor[1:].view(150, 8 * per)                 # base off 16 bytes
    cases.append((a_off, rnd(8 * per, 144), False, True))
    for a, b, a_ok, b_ok in cases:
        expr = E.inner("max", "add", E.arr("A", tuple(a.shape)),
                       E.arr("B", tuple(b.shape)))
        nf = E.normal_form(expr)
        plan = ops._plan(nf, (str(dt)[6:],) * 2, torch.float32, ops.H100,
                         None, "float32")
        d = plan[1].c_descs((dt, dt), torch.float32,
                            (a.data_ptr(), b.data_ptr()))[0]
        assert d.mode == emit.TILE and d.k_fast[0] == 1 and d.k_fast[1] == 0
        assert d.vec[0] == int(a_ok)
        assert d.vec[1] == int(b_ok)
        got, want, _ = _k9(expr, a, b)
        assert torch.equal(got, want)
    a, b = rnd(100, 3000), rnd(3000, 90)                # 1 tile: K split
    expr = E.inner("min", "add", E.arr("A", (100, 3000)),
                   E.arr("B", (3000, 90)))
    got, want, _ = _k9(expr, a, b)
    plan = ops._plan(E.normal_form(expr), (str(dt)[6:],) * 2, torch.float32,
                     ops.H100, None, "float32")
    assert plan[1].splits > 1 and torch.equal(got, want)


@pytest.mark.h100
@pytest.mark.parametrize("m,n", [(1, 1), (37, 70), (33, 65), (64, 128)])
@pytest.mark.parametrize("in_dt,out_dt", [(_F32, _F32), (_BF16, _F32),
                                          (_F32, _BF16), (_BF16, _BF16)])
def test_k9_map_matches_plain(h100, m, n, in_dt, out_dt):
    """MAP: Hadamard and a pointwise add of three operands (vectors and an
    edge run), the outer product (a broadcast operand) and kron (an
    output written through the gamma permutation): bit for bit."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(m * n)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100).to(in_dt)
    a, b, c = rnd(m, n), rnd(m, n), rnd(m, n)
    got, want, mode = _k9(E.combine("mul", E.arr("A", (m, n)),
                                    E.arr("B", (m, n))), a, b,
                          out_dtype=out_dt)
    assert mode == emit.MAP and torch.equal(got, want)
    three = E.combine("add", E.combine("add", E.arr("A", (m, n)),
                                       E.arr("B", (m, n))),
                      E.arr("C", (m, n)))
    got, want, mode = _k9(three, a, b, c, out_dtype=out_dt)
    assert mode == emit.MAP and torch.equal(got, want)
    p, q = rnd(m, 5), rnd(3, n)
    got, want, mode = _k9(ops._outer_expr(m, 5, 3, n), p.reshape(m, 5, 1),
                          q.reshape(1, 3, n), out_dtype=out_dt)
    assert mode == emit.MAP and torch.equal(got, want)
    ops.reset_launches()
    got = ops.kron(p, q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] == 1
    assert torch.equal(got, ref.kron_ref(p, q))


@pytest.mark.h100
@pytest.mark.parametrize("m,n", [(2, 3), (37, 70), (130, 33), (700, 3000)])
@pytest.mark.parametrize("in_dt,out_dt", [(_F32, _F32), (_BF16, _F32),
                                          (_F32, _BF16), (_BF16, _BF16)])
def test_k9_reduce_matches_plain(h100, m, n, in_dt, out_dt):
    """REDUCE along rows (a warp an output) and along columns (strips,
    split and folded where they do not fill the card): max / min bit for
    bit, sums within K9_SUM_REL; a matrix-vector product and mul over a
    reduce take it with two operands."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(m + n)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100).to(in_dt)
    x = rnd(m, n)
    for op in ("max", "min", "add"):
        for axis in (0, 1):
            got, want, mode = _k9(E.reduce(op, E.arr("A", (m, n)), axis), x,
                                  out_dtype=out_dt)
            assert mode == emit.REDUCE
            if op == "add":
                _sum_close(got, want, x.shape[axis])
            else:
                assert torch.equal(got, want)
    v = rnd(n)
    mv = E.inner("add", "mul", E.arr("A", (m, n)), E.arr("v", (n,)))
    got, want, mode = _k9(mv, x, v, out_dtype=out_dt)
    assert mode == emit.REDUCE
    _sum_close(got, want, n)
    y = rnd(m)
    scale = E.combine("mul", E.reduce("add", E.arr("A", (m, n)), axis=1),
                      E.arr("y", (m,)))
    got, want, mode = _k9(scale, x, y, out_dtype=out_dt)
    assert mode == emit.REDUCE
    _sum_close(got, want, n)


@pytest.mark.h100
@pytest.mark.parametrize("shape,axes,warp", [((64, 4096, 64), (0, 2), True),
                                             ((5, 37, 9), (0, 2), True),
                                             ((40, 6, 33), (0, 2), True),
                                             ((3, 6, 5), (0, 2), False)])
@pytest.mark.parametrize("dt", [_F32, _BF16])
def test_k9_thread_forms_match_plain(h100, shape, axes, warp, dt):
    """THREAD takes a lone reduce over axes whose strides do not chain: a
    warp an output where the contracted volume is at least 32 (its lanes
    on the flattened contracted index, a fixed shuffle tree), else a
    thread.  max / min bit for bit, sums within K9_SUM_REL and rerun to
    the same bits; an adjacent pair of the same axes merges to REDUCE."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g, device=h100).to(dt)
    volume = 1
    for a in axes:
        volume *= shape[a]
    for op in ("max", "min", "add"):
        expr = E.arr("A", shape)
        for a in sorted(axes, reverse=True):
            expr = E.reduce(op, expr, a)
        got, want, mode = _k9(expr, x)
        plan = ops._plan(E.normal_form(expr), (str(dt)[6:],), _F32,
                         ops.H100, None, "float32", False)
        assert mode == emit.THREAD and plan[1].rows == warp
        if op == "add":
            _sum_close(got, want, volume)
            again, _, _ = _k9(expr, x)
            assert torch.equal(got, again)
        else:
            assert torch.equal(got, want)
    near = E.reduce("max", E.reduce("max", E.arr("A", shape), 2), 1)
    got, want, mode = _k9(near, x)
    assert mode == emit.REDUCE and torch.equal(got, want)


def _chain(E, plus, times, m, j, k, n, batch=0):
    shapes = [(m, j), (j, k), (k, n)]
    if batch:
        shapes = [(batch,) + s for s in shapes]
    A, B, C = (E.arr(nm, s) for nm, s in zip("ABC", shapes))
    inner = E.inner(plus, times, E.inner(plus, times, A, B, batch=int(
        bool(batch))), C, batch=int(bool(batch)))
    return inner, shapes


@pytest.mark.h100
@pytest.mark.parametrize("plus", ["max", "min"])
@pytest.mark.parametrize("m,j,k,n", [(1, 2, 2, 1), (37, 70, 130, 45),
                                     (200, 33, 257, 129)])
@pytest.mark.parametrize("in_dt,out_dt", [(_F32, _F32), (_BF16, _F32),
                                          (_F32, _BF16), (_BF16, _BF16)])
def test_k9_tropical_chain_is_bit_for_bit(h100, plus, m, j, k, n, in_dt,
                                          out_dt):
    """CHAIN contracts a tropical chain pairwise (T = A (x) B, then
    T (x) C); rounding is monotone, so it equals the plain version's nest
    bit for bit on finite inputs, batched too."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(m + j + k + n)
    for batch in (0, 3):
        expr, shapes = _chain(E, plus, "add", m, j, k, n, batch)
        arrays = [torch.randn(*s, generator=g, device=h100).to(in_dt)
                  for s in shapes]
        ops.reset_launches()
        got, want, mode = _k9(expr, *arrays, out_dtype=out_dt)
        assert mode == emit.CHAIN and ops.LAUNCHES["K9"] == 1
        assert torch.equal(got, want)


@pytest.mark.h100
def test_k9_sums_rerun_to_the_same_bits(h100):
    """REDUCE's split column sums and row sums and CHAIN's (mul, add)
    stages (a K split on the small grid) fold in a fixed order: a rerun
    gives the same bits; each within K9_SUM_REL of the plain version."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(41)
    x = torch.randn(3000, 700, generator=g, device=h100)
    for axis in (0, 1):
        expr = E.reduce("add", E.arr("A", (3000, 700)), axis)
        first, want, mode = _k9(expr, x)
        assert mode == emit.REDUCE
        _sum_close(first, want, x.shape[axis])
        assert torch.equal(ops.apply(expr, x), first)
    expr, shapes = _chain(E, "add", "mul", 200, 640, 512, 100)
    arrays = [torch.randn(*s, generator=g, device=h100) * s[0] ** -0.5
              for s in shapes]
    first, want, mode = _k9(expr, *arrays)
    nf = E.normal_form(expr)
    stages = ops._plan(nf, ("float32",) * 3, torch.float32, ops.H100, None,
                       "float32")[1].stages
    assert mode == emit.CHAIN and all(s.splits > 1 for s in stages)
    _sum_close(first, want, 640 + 512)
    assert torch.equal(ops.apply(expr, *arrays), first)


@pytest.mark.h100
def test_k9_every_path_propagates_nan(h100):
    """A NaN input gives NaN where the plain version has one, on MAP,
    REDUCE (rows and columns, and a lone reduce over two adjacent axes,
    merged), CHAIN and THREAD (a lone reduce over axes (0, 2), its warp
    form), and the same values elsewhere."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(43)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100)
    a, b = rnd(40, 50), rnd(40, 50)
    a[3, 7] = b[9, 1] = float("nan")
    cube = rnd(20, 30, 40)
    cube[4, 5, 6] = float("nan")
    chain, shapes = _chain(E, "max", "add", 30, 40, 50, 20)
    ca, cb, cc = (rnd(*s) for s in shapes)
    cb[4, 9] = float("nan")
    cases = [(E.combine("add", E.arr("A", (40, 50)), E.arr("B", (40, 50))),
              (a, b), emit.MAP),
             (E.reduce("max", E.arr("A", (40, 50)), 1), (a,), emit.REDUCE),
             (E.reduce("min", E.arr("A", (40, 50)), 0), (a,), emit.REDUCE),
             (chain, (ca, cb, cc), emit.CHAIN),
             (E.reduce("max", E.reduce("max", E.arr("X", (20, 30, 40)), 2),
                       1), (cube,), emit.REDUCE),
             (E.reduce("max", E.reduce("max", E.arr("X", (20, 30, 40)), 2),
                       0), (cube,), emit.THREAD)]
    for expr, arrays, path in cases:
        got, want, mode = _k9(expr, *arrays)
        assert mode == path
        assert bool(torch.isnan(want).any())
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep], want[keep])


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_k9_tensor_core_tile_carries_inf_and_nan(h100, dtype):
    """(mul, add) on the tensor cores (batched TILE and CHAIN's stages)
    with an inf, a NaN, infinities of both signs in one sum and a finite
    value past bf16's range: the plain version's NaNs, signed infs and
    finite entries in the same places, the finite ones within K9_SUM_REL
    of their row's largest.
    The chain's operands are positive, so its infs do not hang on the
    order in which the plain einsum contracts."""
    from repro_torch.kernels import emit
    E = ops.E
    g = torch.Generator(device=h100).manual_seed(47)
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100)
    big = 3.4e38 if dtype == _F32 else torch.finfo(torch.bfloat16).max
    e, m, k, n = 5, 70, 150, 90
    x, w = rnd(e, m, k), rnd(e, k, n)
    x[0, 2, 5] = float("inf")
    x[1, 3, 7] = float("nan")
    w[2, 4, 6] = float("-inf")
    x[4, 0, 0] = x[4, 0, 1] = float("inf")
    x[3, 1, 2] = big
    w[3, 2] *= 1e-3
    w[0, 5, :4] = 0.0
    batched = E.inner("add", "mul", E.arr("X", (e, m, k)),
                      E.arr("W", (e, k, n)), batch=1)
    chain, shapes = _chain(E, "add", "mul", 60, 130, 140, 70)
    ca, cb, cc = (rnd(*s).abs() for s in shapes)
    ca[2, 3] = float("inf")
    ca[8, 4] = cc[9, 11] = float("nan")
    ca[5, 1] = big
    cb[1] *= 1e-3
    for expr, arrays, path, terms in (
            (batched, (x.to(dtype), w), emit.TILE, k),
            (chain, (ca.to(dtype), cb, cc), emit.CHAIN, 130 + 140)):
        got, want, mode = _k9(expr, *arrays)
        assert mode == path
        assert bool(torch.isnan(want).any() and torch.isinf(want).any())
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(got), test(want))
        fin = torch.isfinite(want)
        assert bool(fin.any())
        zero = torch.zeros_like(want)
        scale = torch.where(fin, want.abs(), zero).amax(-1, keepdim=True)
        err = torch.where(fin, (got - want).abs(), zero)
        assert bool((err <= K9_SUM_REL * terms * scale).all())


#: K2-K4's prefix-LM form: (B, S, KV, G, hd, window, prefix) with the
#: prefix below a tile (5), at the 64-row / 64-key tile edge, past it and
#: not a multiple of any tile (100), with a window that cuts inside a key
#: tile (40), at and past the sequence, paligemma-3b's 256 patches of one
#: KV head under 8 query heads (one consumer warpgroup a block at S = 1000,
#: two at B = 2 S = 2048) and a G that is no power of two
PREFIX_SHAPES = [(1, 300, 1, 8, 256, 0, 5), (1, 300, 1, 8, 256, 0, 64),
                 (1, 300, 1, 8, 256, 0, 100), (2, 300, 2, 4, 128, 40, 90),
                 (1, 130, 1, 8, 256, 0, 130), (1, 130, 1, 8, 256, 0, 200),
                 (1, 1000, 1, 8, 256, 0, 256), (2, 2048, 1, 8, 256, 0, 256),
                 (1, 257, 2, 5, 64, 0, 33)]


def _flash_bwd_args(q, k, v, do, out, m, l):
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    return (q, k, v, do, m, l, delta.permute(0, 2, 3, 1).contiguous())


def _held(got, want, rel):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


# K9's integer accumulator (int8 under int32 on every (mul, add) form K1's
# int8 form does not take), its wide forms (past 4 out axes, 3 contracted
# axes and 3 operands) and its float16 loads

def _int_forms(E, h=3, m=5):
    """(label) -> (expr, storage shapes, K9's path) of the int8 (mul, add)
    forms K9 takes, at ragged sizes (off every tile, slab and run)."""
    from repro_torch.kernels import emit
    A = E.arr
    return {
        "head": (E.head_gemm_expr(h, m, 40, 17), [(m, h, 40), (40, h, 17)],
                 emit.TILE),
        "head_tb": (E.head_gemm_expr(h, m, 40, 17, transpose_b=True),
                    [(m, h, 40), (17, h, 40)], emit.TILE),
        "batched": (E.inner("add", "mul", A("X", (3, 130, 70)),
                            E.transpose(A("W", (3, 65, 70)), (0, 2, 1)),
                            batch=1), [(3, 130, 70), (3, 65, 70)],
                    emit.TILE),
        "hadamard": (E.hadamard_expr(130, 67), [(130, 67)] * 2, emit.MAP),
        "hadamard_vec": (E.hadamard_expr(128, 64), [(128, 64)] * 2,
                         emit.MAP),
        "kron": (E.transpose(E.inner("add", "mul", A("A", (3, 4, 1)),
                                     A("B", (1, 5, 6))), (0, 2, 1, 3)),
                 [(3, 4, 1), (1, 5, 6)], emit.MAP),
        "lone_sum_rows": (E.reduce("add", A("A", (9, 301)), 1), [(9, 301)],
                          emit.REDUCE),
        "lone_sum_cols": (E.reduce("add", A("A", (3000, 130)), 0),
                          [(3000, 130)], emit.REDUCE),
        "thread": (E.reduce("add", E.reduce("add", A("A", (6, 7, 40)), 2), 0),
                   [(6, 7, 40)], emit.THREAD),
        "thread_small": (E.reduce("add", E.reduce("add", A("A", (6, 70, 4)),
                                                  2), 0),
                         [(6, 70, 4)], emit.THREAD),
        "chain": (A("A", (37, 70)) @ A("B", (70, 33)) @ A("C", (33, 20)),
                  [(37, 70), (70, 33), (33, 20)], emit.CHAIN),
        "psi": (E.inner("add", "mul", E.psi((1,), A("S", (3, 130, 70))),
                        A("B", (70, 65))), [(3, 130, 70), (70, 65)],
                emit.TILE),
        "psi_ksplit": (E.inner("add", "mul", E.psi((2,), A("S", (3, 100,
                                                                  3000))),
                               A("B", (3000, 90))),
                       [(3, 100, 3000), (3000, 90)], emit.TILE),
    }


def _k9_int(expr, *arrays, out_dtype=torch.int32):
    """K9's integer accumulator on the card twice (its descriptor for the
    normal form, as ``_plan`` builds it for the forms it sends to K9),
    then its plain version (exact sums, checked into int32)."""
    from repro_torch.core import schedule
    from repro_torch.kernels import emit
    nf = ops.E.normal_form(expr)
    bundle = None if emit.is_chain(nf) else schedule.get_schedule(
        nf, dtype="int8", hardware=ops.H100, acc_dtype="int32")
    launch = emit.describe(bundle, nf)
    got = ops.semiring_contract(launch, *arrays, out_dtype=out_dtype)
    again = ops.semiring_contract(launch, *arrays, out_dtype=out_dtype)
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = ops.apply(expr, *arrays, out_dtype=out_dtype,
                         acc_dtype="int32")
    return got, again, want, launch


@pytest.mark.h100
@pytest.mark.parametrize("out_dt", [torch.int32, _F32])
@pytest.mark.parametrize("name", sorted(_int_forms(ops.E)))
def test_k9_int32_forms_match_plain_bit_for_bit(h100, name, out_dt):
    """int8 x int8 under int32 on each of K9's paths (the integer tile,
    its K split and the chain's int32 scratch, MAP, REDUCE rows and
    columns, THREAD's warp and thread forms): bit for bit the plain
    version's exact sums, into int32 and f32, and a rerun gives the same
    bits; ``apply`` routes each form to K9 but the stack with B
    transposed, which it routes to K1 (its int8 form at k = 70)."""
    expr, shapes, path = _int_forms(ops.E)[name]
    g = torch.Generator(device=h100).manual_seed(len(name))
    arrays = [torch.randint(-128, 128, s, generator=g, device=h100,
                            dtype=torch.int8) for s in shapes]
    got, again, want, launch = _k9_int(expr, *arrays, out_dtype=out_dt)
    assert launch.mode == path and ops.LAUNCHES["K9"] == 2
    assert got.dtype == out_dt and torch.equal(got, want)
    assert torch.equal(again, got)
    if name == "psi_ksplit":
        assert launch.splits > 1
    ops.reset_launches()
    assert torch.equal(ops.apply(expr, *arrays, out_dtype=out_dt,
                                 acc_dtype="int32"), want)
    kid = "K1" if name == "batched" else "K9"
    assert ops.LAUNCHES[kid] == 1 and sum(ops.LAUNCHES.values()) == 1


@pytest.mark.h100
def test_k9_int32_sums_wrap_as_an_int32_accumulator(h100):
    """Past int32's range the card's integer sums wrap (two's
    complement), as K1's int8 form's do, where the plain version raises:
    (-128)^2 over 2^17 + 8 terms is 2^31 + 2^17."""
    k = 2 ** 17 + 8
    x = torch.full((2, k), -128, dtype=torch.int8, device=h100)
    expr = ops.E.reduce("add", ops.E.hadamard_expr(2, k), 1)
    plan = ops._plan(ops.E.normal_form(expr), ("int8", "int8"), torch.int32,
                     ops.H100, None, "int32")
    got = ops.semiring_contract(plan[1], x, x, out_dtype=torch.int32)
    wrapped = (2 ** 14 * k + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got.tolist() == [wrapped, wrapped]
    with pytest.raises(OverflowError), ops.reference_mode():
        ops.apply(expr, x, x, acc_dtype="int32", out_dtype=torch.int32)


def _wide_forms(E):
    """(label) -> (expr, storage shapes, path) of K9's wide forms."""
    from repro_torch.kernels import emit
    A = E.arr
    hada = lambda n, s: E.combine("mul", hada(n - 1, s) if n > 2 else
                                  A("H0", s), A(f"H{n - 1}", s))
    chain = lambda n, d: (A("M0", (d[0], d[1])) if n == 1 else
                          chain(n - 1, d) @ A(f"M{n - 1}", (d[n - 1], d[n])))
    at = E.transpose(A("A", (6, 3, 4, 5, 2)), (1, 2, 3, 0, 4))
    bt = E.transpose(A("B", (2, 5, 4, 3, 7)), (3, 2, 1, 0, 4))
    red4 = E.inner("add", "mul", at, bt, batch=3)
    for _ in range(3):
        red4 = E.reduce("add", red4, 0)
    nine = (2, 3, 2, 2, 3, 2, 2, 2, 3)
    return {
        "kron6": (E.transpose(E.inner("add", "mul", A("A", (4, 5, 6, 1)),
                                      A("B", (1, 3, 2, 7))),
                              (0, 3, 1, 4, 2, 5)),
                  [(4, 5, 6, 1), (1, 3, 2, 7)], emit.MAP),
        "red4": (red4, [(6, 3, 4, 5, 2), (2, 5, 4, 3, 7)], emit.TILE),
        "chain4": (chain(4, (5, 6, 7, 8, 9)),
                   [(5, 6), (6, 7), (7, 8), (8, 9)], emit.THREAD),
        "hadamard4": (hada(4, (13, 70)), [(13, 70)] * 4, emit.MAP),
        "hadamard5": (hada(5, (13, 70)), [(13, 70)] * 5, emit.FACTOR),
        "chain5": (chain(5, (3, 4, 5, 6, 4, 3)),
                   [(3, 4), (4, 5), (5, 6), (6, 4), (4, 3)], emit.FACTOR),
        "hadamard9d": (E.combine("mul", A("A", nine), A("B", nine)),
                       [nine, nine], emit.MAP),
    }


@pytest.mark.h100
@pytest.mark.parametrize("name", sorted(_wide_forms(ops.E)))
def test_k9_wide_forms_match_plain(h100, name):
    """K9 past its old limits (6 interleaved out axes, 4 contracted axes
    that do not merge, 4 operands on one descriptor, 5 through the
    scratch, 9 out axes merged into one): within K9_SUM_REL of the plain
    version (which pairs 4 operands in einsum's order), in one call."""
    expr, shapes, path = _wide_forms(ops.E)[name]
    g = torch.Generator(device=h100).manual_seed(len(name) + 7)
    arrays = [torch.randn(*s, generator=g, device=h100) for s in shapes]
    got, want, mode = _k9(expr, *arrays)
    assert mode == path and ops.LAUNCHES["K9"] == 1
    nf = ops.E.normal_form(expr)
    k = 1
    for a in nf.reduce_axes:
        k *= nf.extent_map[a]
    mags = [a.abs() for a in arrays]
    with ops.reference_mode():
        mag = ops.apply(expr, *mags, out_dtype=_F32)
    tol = K9_SUM_REL * max(len(arrays), k) * mag.max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.h100
@pytest.mark.parametrize("out_dt", [_F32, torch.float16])
@pytest.mark.parametrize("name", ["moa_gemm", "moa_gemm_ksplit", "max_plus",
                                  "hadamard", "lone_sum_rows",
                                  "lone_sum_cols", "head", "thread", "mixed"])
def test_k9_float16_forms_match_plain(h100, name, out_dt):
    """float16 operands under the f32 accumulator on K9 (``_plan`` sends
    each of these forms there: none is a 2-D product whose rows TMA
    reads, or it is not (mul, add) of two float16 operands; those take
    K1's tile, held above): the tensor-core tile (f16 values are their
    bf16 hi + lo parts exactly), its K split, max-plus bit for bit, MAP,
    REDUCE, THREAD, the head form and an f16 x f32 pair; within
    K9_SUM_REL of the plain version, and a float16 output within its own
    rounding."""
    E = ops.E
    A = E.arr
    forms = {
        "moa_gemm": (E.matmul_expr(130, 70, 65), [(130, 70), (70, 65)]),
        "moa_gemm_ksplit": (E.matmul_expr(100, 3000, 90),
                            [(100, 3000), (3000, 90)]),
        "max_plus": (E.inner("max", "add", A("A", (130, 70)),
                             A("B", (70, 65))), [(130, 70), (70, 65)]),
        "hadamard": (E.hadamard_expr(130, 68), [(130, 68)] * 2),
        "lone_sum_rows": (E.reduce("add", A("A", (9, 300)), 1), [(9, 300)]),
        "lone_sum_cols": (E.reduce("add", A("A", (3000, 130)), 0),
                          [(3000, 130)]),
        "head": (E.head_gemm_expr(3, 5, 40, 17), [(5, 3, 40), (40, 3, 17)]),
        "thread": (E.reduce("add", E.reduce("add", A("A", (6, 7, 40)), 2), 0),
                   [(6, 7, 40)]),
        "mixed": (E.matmul_expr(130, 70, 65), [(130, 70), (70, 65)]),
    }
    expr, shapes = forms[name]
    g = torch.Generator(device=h100).manual_seed(len(name) + 11)
    arrays = [torch.randn(*s, generator=g, device=h100).half()
              for s in shapes]
    if name == "mixed":
        arrays[1] = arrays[1].float()
    got, want, _ = _k9(expr, *arrays, out_dtype=out_dt)
    assert got.dtype == out_dt
    if name == "max_plus":
        assert torch.equal(got, want)
        return
    nf = ops.E.normal_form(expr)
    k = 1
    for a in nf.reduce_axes:
        k *= nf.extent_map[a]
    with ops.reference_mode():
        mag = ops.apply(expr, *(a.abs() for a in arrays), out_dtype=_F32)
    tol = K9_SUM_REL * k * mag.max().item()
    if out_dt == torch.float16:
        tol += 2.0 ** -11 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    # apply routes each of these float16 forms to K9
    ops.reset_launches()
    ops.apply(expr, *arrays, out_dtype=out_dt)
    assert ops.LAUNCHES["K9"] == 1 and ops.LAUNCHES["K1"] == 0


#: float16 x float16 on K1's tile route, (m, k, n, transpose_a,
#: transpose_b): moa_gemm's 4096^3, a transposed B, a transposed A, a
#: ragged shape TMA still reads (rows of 1032 and 520 elements, m = 1001),
#: and a long k past gemm.cu's F16_PROMOTE_K (each stage promoted)
F16_TILE_SHAPES = [(4096, 4096, 4096, False, False),
                   (4096, 4096, 4096, False, True),
                   (1024, 2048, 1536, True, False),
                   (1001, 1032, 520, False, False),
                   (1024, 65536, 512, False, False)]
#: the tolerance of the smoke's TOL[("K1", "float16")]: each f16 product
#: is exact in f32 on both sides, the sums differ in order (and in the
#: tensor cores' truncated adds, bounded by the promotion past 8192 terms)
F16_TILE_REL = 1e-4


@pytest.mark.h100
@pytest.mark.parametrize("m,k,n,ta,tb", F16_TILE_SHAPES)
def test_k1_float16_tile_matches_plain(h100, m, k, n, ta, tb):
    """float16 x float16 on K1's tile route (TMA in float16, f16 wgmma
    into f32, one product a term): within F16_TILE_REL of the largest
    entry of the plain version (the f32 product of the f16 values), a
    rerun gives the same bits, and ``apply`` routes the 2-D form to K1
    alone."""
    g = torch.Generator(device=h100).manual_seed(m + k + n)
    a = torch.randn(*((k, m) if ta else (m, k)), generator=g,
                    device=h100).half()
    b = (torch.randn(*((n, k) if tb else (k, n)), generator=g,
                     device=h100) * k ** -0.5).half()
    assert ops._route(a, b, ta, tb) == "tile"
    got = ops._product(a, b, ta, tb)
    again = ops._product(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 2
    want = ref.matmul(a, b, tb, transpose_a=ta)
    err = (got - want).abs().max().item()
    assert err <= F16_TILE_REL * want.abs().max().item(), err
    assert torch.equal(got, again)
    E = ops.E
    expr = E.inner("add", "mul",
                   E.transpose(E.arr("A", (k, m))) if ta else
                   E.arr("A", (m, k)),
                   E.transpose(E.arr("B", (n, k))) if tb else
                   E.arr("B", (k, n)))
    ops.reset_launches()
    out = ops.apply(expr, a, b, out_dtype=torch.float32)
    assert ops.LAUNCHES["K1"] == 1 and ops.LAUNCHES["K9"] == 0
    assert torch.equal(out, got)


def _reversed(E, i, ext, j, plus="add", times="mul"):
    """``A[i, a1..an] . B[an..a1, j]`` over (a1..an): no two contracted
    axes merge (as ``tests/test_torch_forms.py``'s)."""
    n = len(ext)
    at = E.transpose(E.arr("A", (i,) + tuple(ext)),
                     tuple(range(1, n)) + (0, n))
    bt = E.transpose(E.arr("B", tuple(reversed(ext)) + (j,)),
                     tuple(range(n - 1, -1, -1)) + (n,))
    expr = E.inner(plus, times, at, bt, batch=n - 1)
    for _ in range(n - 1):
        expr = E.reduce(plus, expr, 0)
    return expr, [(i,) + tuple(ext), tuple(reversed(ext)) + (j,)]


#: TILE over several contracted axes that do not merge: label -> (i,
#: extents, j, (plus, times), dtype); K = 256 split over blocks, a K of
#: 105 that no slab divides, 16-bit copies along K, 6 axes
WIDE_TILE_CASES = {
    "red4": (300, (4, 4, 4, 4), 300, ("add", "mul"), _F32),
    "red4_maxplus": (300, (4, 4, 4, 4), 300, ("max", "add"), _F32),
    "red4_int8": (300, (4, 4, 4, 4), 300, ("add", "mul"), torch.int8),
    "ragged3": (130, (3, 5, 7), 70, ("add", "mul"), _F32),
    "ragged3_minplus": (130, (3, 5, 7), 70, ("min", "add"), _F32),
    "ragged3_int8": (130, (3, 5, 7), 70, ("add", "mul"), torch.int8),
    "red3_bf16": (200, (2, 3, 8), 150, ("add", "mul"), _BF16),
    "red2_f16": (150, (5, 3), 130, ("add", "mul"), torch.float16),
    "red6": (64, (2, 3, 2, 2, 3, 2), 80, ("add", "mul"), _F32),
}


@pytest.mark.h100
@pytest.mark.parametrize("name", sorted(WIDE_TILE_CASES))
def test_k9_wide_tile_matches_plain(h100, name):
    """Two operands over 2-6 contracted axes that do not merge, on TILE
    (each slab's offsets decoded once into a shared table): (mul, add)
    within K9_SUM_REL of the plain version's sums, max-plus and min-plus
    bit for bit, int8 under int32 exactly; a rerun gives the same bits.
    The descriptor is K9's with the semiring's inert element
    (``emit.describe(None, nf)``): the tropical nests' derived schedule
    passes the card's shared memory, which K9 does not read."""
    from repro_torch.kernels import emit
    i, ext, j, (plus, times), dt = WIDE_TILE_CASES[name]
    expr, shapes = _reversed(ops.E, i, ext, j, plus, times)
    g = torch.Generator(device=h100).manual_seed(len(name))
    if dt == torch.int8:
        arrays = [torch.randint(-128, 128, s, generator=g, device=h100,
                                dtype=dt) for s in shapes]
        out_dt = torch.int32
    else:
        arrays = [torch.randn(*s, generator=g, device=h100).to(dt)
                  for s in shapes]
        out_dt = _F32
    nf = ops.E.normal_form(expr)
    launch = emit.describe(None, nf)
    assert launch.mode == emit.TILE and len(launch.red_ext) == len(ext)
    if name == "red4":
        assert launch.splits > 1
    got = ops.semiring_contract(launch, *arrays, out_dtype=out_dt)
    again = ops.semiring_contract(launch, *arrays, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] == 2
    with ops.reference_mode():
        want = ops.semiring_contract(launch, *arrays, out_dtype=out_dt)
    assert torch.equal(got, again)
    if plus != "add" or dt == torch.int8:
        assert torch.equal(got, want)
        return
    with ops.reference_mode():
        mag = ops.semiring_contract(launch, *(a.abs() for a in arrays))
    k = 1
    for e in ext:
        k *= e
    torch.testing.assert_close(got, want, rtol=0,
                               atol=K9_SUM_REL * k * mag.max().item())


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol,rel", [(_F32, 1e-5, 1e-4),
                                            (_BF16, 2e-2, 1e-2)])
@pytest.mark.parametrize("b,s,kv,g,hd,window,prefix", PREFIX_SHAPES)
def test_prefix_flash_kernels_match_plain(h100, dtype, atol, rel, b, s, kv,
                                          g, hd, window, prefix):
    """K2 (with and without its export), K3 and K4 with ``prefix_len``
    against their plain versions (the prefix-LM mask: every pair below the
    prefix re-admitted above the diagonal), held as the causal cases are;
    the export leaves the output's bits, K4's rerun gives the same bits,
    and the prefix is live (the output differs from the causal one's
    where a prefix row sees a later prefix key)."""
    q, k, v, do = _attn_case(h100, dtype, b, s, g, hd, 6, kv=kv)
    kw = dict(scale=hd ** -0.5, window=window, prefix_len=prefix)
    got = ops.attention(q, k, v, **kw)
    out, m, l = ops.attention_stats(q, k, v, **kw)
    args = _flash_bwd_args(q, k, v, do, out, m, l)
    dq = ops.flash_dq(*args, **kw)
    dk, dv = ops.flash_dkv(*args, **kw)
    dk2, dv2 = ops.flash_dkv(*args, **kw)
    causal = ops.attention(q, k, v, scale=hd ** -0.5, window=window)
    torch.cuda.synchronize()
    assert [ops.LAUNCHES[x] for x in ("K2", "K3", "K4")] == [3, 1, 2]
    assert torch.equal(got, out)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert (causal[:, 0].float() - got[:, 0].float()).abs().max() > 1e-3
    want = ref.attention_stats(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want[0].float(), rtol=0,
                               atol=atol)
    torch.testing.assert_close(m, want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(l, want[2], rtol=1e-4, atol=0)
    _held(dq, ref.flash_dq(*args, **kw), rel)
    for a, w in zip((dk, dv), ref.flash_dkv(*args, **kw)):
        _held(a, w, rel)


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("b,s,kv,g,hd,window",
                         [(2, 1000, 2, 16, 256, 300), (2, 1000, 2, 8, 128,
                                                       300),
                          (1, 4096, 1, 8, 256, 0), (2, 130, 1, 8, 256, 33)])
def test_prefix_of_one_is_the_causal_kernel_bit_for_bit(h100, dtype, b, s,
                                                        kv, g, hd, window):
    """``prefix_len = 1`` adds no visible pair (key 0 is query 0's own)
    and no key tile: K2, K3 and K4 give the causal call's bits, so the
    prefix's code leaves the causal and windowed forms (prefix 0) as they
    were."""
    q, k, v, do = _attn_case(h100, dtype, b, s, g, hd, 7, kv=kv)
    base = dict(scale=hd ** -0.5, window=window)
    runs = []
    for prefix in (0, 1):
        kw = dict(base, prefix_len=prefix)
        out, m, l = ops.attention_stats(q, k, v, **kw)
        args = _flash_bwd_args(q, k, v, do, out, m, l)
        runs.append((ops.attention(q, k, v, **kw), out, m, l,
                     ops.flash_dq(*args, **kw), *ops.flash_dkv(*args, **kw)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(*runs))


#: whisper-base's bidirectional attention: the encoder (Sq = Sk = 1500)
#: and the cross-attention (448 decoder rows over 1500 encoder rows), 8 KV
#: heads of 64, G = 1 (1500 is no multiple of any tile); a ragged Sq > Sk
NONCAUSAL_SHAPES = [(2, 1500, 1500, 8, 1, 64), (2, 448, 1500, 8, 1, 64),
                    (1, 130, 70, 2, 4, 128)]


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol,rel", [(_F32, 1e-5, 1e-4),
                                            (_BF16, 2e-2, 1e-2)])
@pytest.mark.parametrize("b,sq,sk,kv,g,hd", NONCAUSAL_SHAPES)
def test_noncausal_flash_kernels_match_plain(h100, dtype, atol, rel, b, sq,
                                             sk, kv, g, hd):
    """K2 (with and without its export), K3 and K4 with ``causal=False``
    at Sq = Sk and Sq != Sk against their plain versions (no mask: every
    key of Sk, the edges carried by the kernels' ``kp < Sk`` guards);
    K4's rerun gives the same bits."""
    gen = torch.Generator(device=h100).manual_seed(8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=h100).to(dtype)
    q, k, v, do = (rnd(b, sq, kv, g, hd), rnd(b, sk, kv, hd),
                   rnd(b, sk, kv, hd), rnd(b, sq, kv, g, hd))
    kw = dict(scale=hd ** -0.5, causal=False)
    got = ops.attention(q, k, v, **kw)
    out, m, l = ops.attention_stats(q, k, v, **kw)
    args = _flash_bwd_args(q, k, v, do, out, m, l)
    dq = ops.flash_dq(*args, **kw)
    dk, dv = ops.flash_dkv(*args, **kw)
    dk2, dv2 = ops.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert [ops.LAUNCHES[x] for x in ("K2", "K3", "K4")] == [2, 1, 2]
    assert torch.equal(got, out)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    want = ref.attention_stats(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want[0].float(), rtol=0,
                               atol=atol)
    torch.testing.assert_close(m, want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(l, want[2], rtol=1e-4, atol=0)
    _held(dq, ref.flash_dq(*args, **kw), rel)
    for a, w in zip((dk, dv), ref.flash_dkv(*args, **kw)):
        _held(a, w, rel)


@pytest.mark.h100
@pytest.mark.parametrize("t", [300, 896])
def test_whisper_head_on_unaligned_vocab_matches_plain(h100, t):
    """whisper-base's tied head at V = 51865 (no multiple of 8): the
    forward ``x table^T`` (tile route, an output row of 51865 f32) and
    its VJP forms ``dx = g table`` and ``dw = g^T x``, whose f32
    cotangent's stored row of 51865 TMA cannot read: the split route on
    its three bf16 parts, written pitched (made once, for both), each held
    to the plain product within 1e-4 of its largest entry and rerun to the
    same bits (896: a training microbatch's rows)."""
    gen = torch.Generator(device=h100).manual_seed(9)
    rnd = lambda *shape, sc=1.0: (torch.randn(*shape, generator=gen,
                                              device=h100) * sc)
    d, vocab = 512, 51865
    x = rnd(t, d).to(_BF16)
    table = rnd(vocab, d, sc=d ** -0.5).to(_BF16)
    g = rnd(t, vocab, sc=1e-3)
    parts = ops.split_bf16(g)
    forms = [(x, table, False, True, "tile", None),
             (g, table, False, False, "split", parts),
             (g, x, True, False, "split", parts)]
    for a, b_, ta, tb, route, split in forms:
        assert ops._route(a, b_, ta, tb) == route
        got = ops._gemm(a, b_, ta, tb, split)
        again = ops._gemm(a, b_, ta, tb)
        want = ref.matmul(a, b_, tb, transpose_a=ta)
        torch.cuda.synchronize()
        _held(got, want, 1e-4)
        assert torch.equal(got, again)
    assert ops.LAUNCHES["K1"] == 6


#: (b, sq, sk, kv, g, hd, vd, mask) of the flash kernels with a value width
#: apart from the q.k width: MLA's (96, 64), built as such, at minicpm3-4b's
#: prefill (40 KV heads of one query head each, two consumer warpgroups),
#: ragged at B = 2, G > 1 (8 and 16), a G that does not divide 64 (K4's
#: FMA form in bf16), windowed, prefix-LM, bidirectional at Sq != Sk; then
#: pairs that are not built, which ``ops`` zero-pads to the smallest built
#: pair that covers them: (80, 48) -> (96, 64), (96, 96) -> (128, 128),
#: (32, 160) -> (256, 256)
WIDTH_CASES = [
    (1, 4096, 4096, 40, 1, 96, 64, "causal"),
    (2, 300, 300, 40, 1, 96, 64, "causal"),
    (2, 1000, 1000, 2, 8, 96, 64, "causal"),
    (1, 513, 513, 1, 16, 96, 64, "window"),
    (1, 200, 200, 2, 5, 96, 64, "causal"),
    (2, 130, 130, 2, 4, 96, 64, "prefix"),
    (2, 448, 1500, 2, 1, 96, 64, "bidirectional"),
    (2, 130, 130, 2, 4, 80, 48, "causal"),
    (1, 300, 300, 2, 2, 96, 96, "window"),
    (1, 257, 257, 1, 8, 32, 160, "prefix"),
]
_WIDTH_MASKS = {"causal": {}, "window": dict(window=37),
                "prefix": dict(prefix_len=70),
                "bidirectional": dict(causal=False)}


def _width_case(dev, dtype, b, sq, sk, kv, g, hd, vd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=dev).to(dtype)
    return (rnd(b, sq, kv, g, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, vd),
            rnd(b, sq, kv, g, vd))


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol,rel", [(_F32, 1e-5, 1e-4),
                                            (_BF16, 2e-2, 1e-2)])
@pytest.mark.parametrize("b,sq,sk,kv,g,hd,vd,mask", WIDTH_CASES)
def test_apart_width_flash_kernels_match_plain(h100, dtype, atol, rel, b, sq,
                                               sk, kv, g, hd, vd, mask):
    """K2 (with and without its export), K3 and K4 with q, k of width hd
    and v, dO of width vd against their plain versions, held as the equal
    widths are: out and dv of width vd, dq and dk of width hd, K4's rerun
    the same bits, one launch a call whether the pair is built or
    padded."""
    q, k, v, do = _width_case(h100, dtype, b, sq, sk, kv, g, hd, vd, 9)
    kw = dict(scale=hd ** -0.5, **_WIDTH_MASKS[mask])
    got = ops.attention(q, k, v, **kw)
    out, m, l = ops.attention_stats(q, k, v, **kw)
    args = _flash_bwd_args(q, k, v, do, out, m, l)
    dq = ops.flash_dq(*args, **kw)
    dk, dv = ops.flash_dkv(*args, **kw)
    dk2, dv2 = ops.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert [ops.LAUNCHES[x] for x in ("K2", "K3", "K4")] == [2, 1, 2]
    assert got.shape == (b, sq, kv * g, vd)
    assert torch.equal(got, out)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    want = ref.attention_stats(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want[0].float(), rtol=0,
                               atol=atol)
    torch.testing.assert_close(m, want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(l, want[2], rtol=1e-4, atol=0)
    _held(dq, ref.flash_dq(*args, **kw), rel)
    for a, w in zip((dk, dv), ref.flash_dkv(*args, **kw)):
        _held(a, w, rel)


@pytest.mark.h100
@pytest.mark.parametrize("hd,vd", [(96, 64), (80, 48), (32, 160)])
def test_apart_width_attention_gradients_match_plain(h100, hd, vd):
    """``ops.attention``'s autograd path at a built and at padded pairs in
    bf16 (G = 4, a ragged length): one K2, K3 and K4 launch, the output
    and the gradients of q, k, v within 2e-2 of their largest plain entry
    (the flash kernels' bf16 tolerance), of their own widths."""
    q, k, v, do = _width_case(h100, _BF16, 2, 300, 300, 2, 4, hd, vd, 10)
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    dout = do.reshape(2, 300, 8, vd)
    results = []
    for plain in (False, True):
        ctx = ops.reference_mode() if plain else torch.enable_grad()
        with ctx:
            out = ops.attention(*ins, scale=hd ** -0.5)
            grads = torch.autograd.grad(out, ins, dout)
        results.append((out, *grads))
    torch.cuda.synchronize()
    assert [ops.LAUNCHES[x] for x in ("K2", "K3", "K4")] == [1, 1, 1]
    for got, want in zip(*results):
        assert got.shape == want.shape and got.dtype == _BF16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


#: remat "dots" at gemma-2b's full width (2 of its 18 layers, bf16): the
#: K1 forward products of a layer, each launched once under "dots"
GEMMA_LAYER_PRODUCTS = 6


def _gemma_dots_case(device, layers=2, s=256):
    from repro_torch.configs import gemma_2b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.models import transformer
    cfg = gemma_2b.full().with_(n_layers=layers)
    params = transformer.init_lm(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        trainable=True)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        PipelineConfig(cfg.vocab_size, s, 1)).global_batch(0).items()}
    return cfg, params, batch


@pytest.mark.h100
def test_remat_dots_launches_no_forward_product_in_its_backward(h100):
    """A "dots" step at gemma-2b's per-layer shapes launches K1 as often
    as remat off (the backward replays each layer's forward products),
    "full" 6 a layer more, and "dots"' loss and gradients equal "full"'s
    bit for bit (the kernels are deterministic and the replayed outputs
    are the forward's)."""
    from repro_torch.train import train_step as ts
    cfg, params, batch = _gemma_dots_case(h100)
    runs = {}
    for name, c in (("off", cfg.with_(remat=False)),
                    ("full", cfg.with_(remat_policy="full")),
                    ("dots", cfg.with_(remat_policy="dots"))):
        ops.reset_launches()
        loss, _, grads = ts.loss_and_grads(params, c, batch)
        torch.cuda.synchronize()
        runs[name] = (loss, grads, dict(ops.LAUNCHES))
    k1 = {n: r[2]["K1"] for n, r in runs.items()}
    assert k1["dots"] == k1["off"]
    assert k1["full"] - k1["dots"] == GEMMA_LAYER_PRODUCTS * cfg.n_layers
    assert runs["dots"][2]["K2"] == runs["full"][2]["K2"] == 2 * cfg.n_layers
    assert torch.equal(runs["dots"][0], runs["full"][0])
    for k, g in runs["full"][1].items():
        assert torch.equal(runs["dots"][1][k], g), k


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_grads_on_the_card_equals_the_cpu(h100, dtype):
    """``compress_grads`` on a leaf of 2^26 + 37 elements (two slices, the
    last one padded) and a small one, on the card and on CPU copies: the
    dequantized gradients and the error state equal bit for bit."""
    from repro_torch.distributed import compression
    cfg = compression.CompressionConfig(enabled=True, block_size=256)
    g = torch.Generator(device=h100).manual_seed(0)
    sizes = {"big": 2 ** 26 + 37, "small": 1000}
    grads = {k: (torch.randn(n, generator=g, device=h100) * 3).to(dtype)
             for k, n in sizes.items()}
    err = {k: torch.randn(n, generator=g, device=h100) * 1e-2
           for k, n in sizes.items()}
    cpu_g = {k: t.cpu() for k, t in grads.items()}
    cpu_e = {k: t.cpu() for k, t in err.items()}
    got_g, got_e = compression.compress_grads(cfg, grads, err)
    want_g, want_e = compression.compress_grads(cfg, cpu_g, cpu_e)
    torch.cuda.synchronize()
    for k in sizes:
        assert torch.equal(got_g[k].cpu(), want_g[k]), k
        assert torch.equal(got_e[k].cpu(), want_e[k]), k


@pytest.mark.h100
def test_embedding_backward_reruns_bit_for_bit(h100):
    """The token embedding's gradient (``layers.embed_tokens`` under
    autograd) at whisper-base's training shape, 1024 tokens with repeats
    over a 51865 x 512 bf16 table: two runs give the same bits with no
    host sync, and the sum equals ``index_add_``'s in f64 within bf16's
    rounding."""
    from repro_torch.models.layers import _EmbedRows
    g = torch.Generator(device=h100).manual_seed(0)
    idx = torch.randint(0, 300, (1024,), generator=g, device=h100)
    cot = torch.randn(1024, 512, generator=g, device=h100).bfloat16()
    table = torch.zeros(51865, 512, device=h100, dtype=torch.bfloat16,
                        requires_grad=True)
    runs = []
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")     # nothing read back
        try:
            runs.append(torch.autograd.grad(_EmbedRows.apply(table, idx),
                                            table, cot)[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(runs[0], runs[1])
    want = torch.zeros(51865, 512, device=h100, dtype=torch.float64)
    want.index_add_(0, idx, cot.double())
    torch.testing.assert_close(runs[0].double(), want, rtol=2 ** -8,
                               atol=1e-6)
