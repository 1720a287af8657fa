"""The host-side rules around K1 and K4 on the CPU: the plain version of
K1's three-part f32 split, K1's route rule and its decode split of k, and
K4's split of each key tile's row stream (the kernels themselves are held
against their plain versions on the card in ``test_torch_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

_F32, _BF16 = torch.float32, torch.bfloat16


def _wide_range(rng, shape):
    """f32 values over many binades (a cotangent's spread)."""
    return torch.from_numpy((rng.standard_normal(shape)
                             * np.exp(rng.standard_normal(shape) * 4))
                            .astype(np.float32))


@pytest.mark.parametrize("parts,bound", [(1, 2.0 ** -8), (2, 2.0 ** -16),
                                         (3, 2.0 ** -24)])
def test_split_bf16_reconstructs_within_its_bound(parts, bound):
    """hi, hi + mid and hi + mid + lo hold each element within 2^-8,
    2^-16 and 2^-24 of its magnitude; every part is bf16."""
    g = _wide_range(np.random.default_rng(0), (257, 129))
    split = ref.split_bf16(g)
    assert len(split) == 3 and all(p.dtype == _BF16 for p in split)
    approx = sum(p.double() for p in split[:parts])
    err = (g.double() - approx).abs()
    assert (err <= bound * g.double().abs()).all()


@pytest.mark.parametrize("transpose_b", [False, True])
def test_split_products_match_the_f32_product(transpose_b):
    """sum over the parts of part @ w (each product exact in f64 here, as
    bf16 x bf16 products are exact in the tensor cores' f32) is the f32
    operand's product within 2^-24 of sum |g| |w| a term."""
    rng = np.random.default_rng(1)
    g = _wide_range(rng, (33, 200))
    w = torch.from_numpy(rng.standard_normal(
        (72, 200) if transpose_b else (200, 72)).astype(np.float32)).to(_BF16)
    wl = (w.t() if transpose_b else w).double()
    got = sum(p.double() @ wl for p in ref.split_bf16(g))
    exact = g.double() @ wl
    scale = g.double().abs() @ wl.abs()
    assert ((got - exact).abs() <= 2.0 ** -24 * scale).all()
    # two parts miss that by 2^8
    two = sum(p.double() @ wl for p in ref.split_bf16(g)[:2])
    assert ((two - exact).abs() <= 2.0 ** -16 * scale).all()


def test_split_bf16_entry_takes_the_plain_version_on_the_cpu():
    g = torch.randn(5, 8)
    for got, want in zip(ops.split_bf16(g), ref.split_bf16(g)):
        assert torch.equal(got, want)


#: (m, n, k, a dtype, b dtype, transpose_a, transpose_b, route)
ROUTES = [
    (4, 2048, 2048, _BF16, _BF16, False, False, "gemv"),
    (4, 256000, 2048, _BF16, _BF16, False, True, "gemv"),
    (1, 50280, 1536, _BF16, _BF16, False, False, "gemv"),
    (16, 2048, 2048, _BF16, _BF16, False, False, "gemv"),
    (17, 2048, 2048, _BF16, _BF16, False, False, "tile"),
    (16, 2048, 2056, _BF16, _BF16, False, False, "tile"),  # k % 32 != 0
    (8, 2048, 2048, _BF16, _BF16, True, False, "tile"),    # transpose_a
    (4, 2048, 2048, _BF16, _BF16, True, False, "fma"),     # m % 8, ta
    (1024, 256000, 2048, _BF16, _BF16, False, True, "tile"),
    (4096, 4096, 4096, _BF16, _BF16, False, False, "tile"),
    (2048, 32768, 1024, _BF16, _F32, True, False, "split"),
    (1024, 2048, 256000, _F32, _BF16, False, False, "split"),
    (256000, 2048, 1024, _F32, _BF16, True, False, "split"),
    (4, 2048, 2048, _F32, _BF16, False, True, "split"),
    (1024, 2048, 2048, _F32, _F32, False, False, "fma"),
    (4, 8, 8, _F32, _F32, False, False, "fma"),
    (37, 130, 72, _BF16, _BF16, False, False, "wmma"),      # n % 8
    (37, 130, 72, _BF16, _BF16, False, True, "tile"),
    (37, 130, 72, _BF16, _BF16, True, True, "fma"),        # m % 8, ta
    (37, 130, 72, _F32, _BF16, False, True, "split"),
    (3, 129, 257, _BF16, _BF16, False, True, "wmma"),      # k % 8
    (130, 33, 5, _F32, _BF16, False, False, "fma"),       # bf16 row 33
    (8, 8, 0, _BF16, _BF16, False, False, "wmma"),         # k == 0
    # the f32 operand's parts are pitched: only the bf16 one must suit TMA
    (896, 512, 51865, _F32, _BF16, False, False, "split"),  # whisper dx
    (51865, 512, 896, _F32, _BF16, True, False, "split"),   # whisper dw
    (130, 40, 5, _F32, _BF16, False, False, "split"),
    (37, 130, 71, _F32, _BF16, False, True, "fma"),        # bf16 row 71
    (37, 136, 71, _BF16, _F32, False, False, "fma"),       # bf16 row 71
    (37, 136, 72, _BF16, _F32, False, False, "split"),
    (4, 50, 2048, _F32, _BF16, False, True, "split"),      # f32 row ok
    (7, 50, 0, _F32, _BF16, False, False, "fma"),          # k == 0
]


@pytest.mark.parametrize("m,n,k,a_dt,b_dt,ta,tb,route", ROUTES)
def test_gemm_route_rule(m, n, k, a_dt, b_dt, ta, tb, route):
    assert ops.gemm_route(m, n, k, a_dt, b_dt, ta, tb) == route


_F16 = torch.float16
#: float16 x float16 takes K1's tile route where TMA reads both operands
#: (rows of a multiple of 8 elements, 16-byte bases) and m > 16; K9 (None:
#: ``gemm_route`` raises) otherwise, and beside any other dtype
F16_ROUTES = [
    (4096, 4096, 4096, _F16, _F16, False, False, True, "tile"),
    (4096, 4096, 4096, _F16, _F16, False, True, True, "tile"),
    (4096, 4096, 4096, _F16, _F16, True, False, True, "tile"),
    (4096, 4096, 4096, _F16, _F16, True, True, True, "tile"),
    (1001, 520, 1032, _F16, _F16, False, False, True, "tile"),  # ragged m
    (1024, 512, 65536, _F16, _F16, False, False, True, "tile"),  # long k
    (17, 64, 64, _F16, _F16, False, False, True, "tile"),
    (16, 64, 64, _F16, _F16, False, False, True, None),    # m <= 16
    (4, 2048, 2048, _F16, _F16, True, False, True, None),  # m <= 16, ta
    (37, 45, 70, _F16, _F16, False, False, True, None),    # a row 70
    (64, 45, 64, _F16, _F16, False, False, True, None),    # b row 45
    (36, 64, 64, _F16, _F16, True, False, True, None),     # a row 36 (ta)
    (64, 64, 0, _F16, _F16, False, False, True, None),     # k == 0
    (64, 64, 64, _F16, _F16, False, False, False, None),   # base
    (64, 64, 64, _F16, _F32, False, False, True, None),    # mixed
    (64, 64, 64, _BF16, _F16, False, False, True, None),   # mixed
]


@pytest.mark.parametrize("m,n,k,a_dt,b_dt,ta,tb,aligned,route", F16_ROUTES)
def test_float16_route_rule(m, n, k, a_dt, b_dt, ta, tb, aligned, route):
    """``gemm_route`` gives a float16 pair the tile route by
    ``f16_route``'s rule and raises ``TypeError`` for every float16 form
    K1 does not take (``_plan`` sends those to K9)."""
    if a_dt == b_dt:
        assert ops.f16_route(m, n, k, ta, tb, aligned) == (route or "K9")
    if route is None:
        with pytest.raises(TypeError, match="float16"):
            ops.gemm_route(m, n, k, a_dt, b_dt, ta, tb, aligned, aligned)
    else:
        assert ops.gemm_route(m, n, k, a_dt, b_dt, ta, tb, aligned,
                              aligned) == route


_I8 = torch.int8
#: (e, cap, d, f, transpose_a, transpose_b, aligned) -> the route of an
#: int8 stack: the int8 tile at every shape, transpose and alignment (an
#: operand it cannot read in place is packed K-major first); never K9
INT8_STACK_ROUTES = [
    ((16, 1024, 1024, 1024, False, True, True), "int8_tile"),
    ((3, 130, 64, 70, False, True, True), "int8_tile"),    # ragged m, n
    ((3, 20, 16, 17, False, True, True), "int8_tile"),     # one k granule
    ((3, 20, 33, 17, False, True, True), "int8_tile"),     # k % 16
    ((3, 20, 40, 17, False, True, True), "int8_tile"),     # k % 16 (8)
    ((16, 1024, 1024, 1024, False, True, False), "int8_tile"),  # bases
    ((16, 1024, 1024, 1024, False, False, True), "int8_tile"),  # w (e, d, f)
    ((16, 1024, 1024, 1024, True, False, True), "int8_tile"),   # x (e, d, cap)
    ((16, 1024, 1024, 1024, True, True, True), "int8_tile"),
    ((3, 20, 33, 17, True, True, False), "int8_tile"),
]


@pytest.mark.parametrize("case,route", INT8_STACK_ROUTES)
def test_int8_stack_route_rule(case, route):
    """``ops.expert_route`` for int8 stacks of each transpose: K1's int8
    tile at every shape, transpose and alignment; no int8 stack is K9's.
    ``_plan`` takes the same route for the stack's normal form, with its
    transposes as K1's flags."""
    from repro_torch.core import expr as E
    e, cap, d, f, ta, tb, aligned = case
    got = ops.expert_route(e, cap, d, f, _I8, _I8, aligned, ta, tb)
    assert got == route and got in ops.K1_ROUTES
    x = E.arr("X", (e, d, cap) if ta else (e, cap, d))
    w = E.arr("W", (e, f, d) if tb else (e, d, f))
    expr = E.inner("add", "mul", E.transpose(x, (0, 2, 1)) if ta else x,
                   E.transpose(w, (0, 2, 1)) if tb else w, batch=1)
    plan = ops._plan(E.normal_form(expr), ("int8", "int8"), torch.int32,
                     ops.H100, None, "int32", aligned)
    assert plan == ("K1", ta, tb, True)


#: the non-int8 stacks with a transposed operand stay on K9 through
#: ``apply`` (bf16 x wᵀ, and the split VJP forms, which ``expert_route``
#: gives K1's split route for ``_ExpertMatmulF32``'s own launches)
@pytest.mark.parametrize("dts,ta,tb", [
    (("bfloat16", "bfloat16"), False, True),
    (("bfloat16", "bfloat16"), True, False),
    (("float32", "bfloat16"), False, True),
    (("bfloat16", "float32"), True, False),
    (("float32", "float32"), False, True)])
def test_transposed_stacks_but_int8_stay_on_k9(dts, ta, tb):
    from repro_torch.core import expr as E
    from repro_torch.kernels import emit
    e, cap, d, f = 8, 24, 136, 200
    x = E.arr("X", (e, d, cap) if ta else (e, cap, d))
    w = E.arr("W", (e, f, d) if tb else (e, d, f))
    nf = E.normal_form(E.inner(
        "add", "mul", E.transpose(x, (0, 2, 1)) if ta else x,
        E.transpose(w, (0, 2, 1)) if tb else w, batch=1))
    assert ops._k1_form(nf) == (ta, tb, True)
    plan = ops._plan(nf, dts, torch.float32, ops.H100, None, "float32")
    assert plan[0] == "K9" and isinstance(plan[1], emit.Launch)


#: (m, n, k, transpose_a, transpose_b, bases aligned): 2-D int8 products,
#: each the int8 tile's ("int8_tile"), however its operands lie
INT8_2D = [
    (4096, 4096, 4096, False, False, True),     # B stored (k, n): packed
    (4096, 4096, 4096, False, True, True),      # both K-major: in place
    (4096, 4096, 4096, True, False, True),      # both MN-major
    (4096, 4096, 4096, True, True, True),       # A stored (k, m)
    (1001, 999, 37, False, False, True),        # ragged, k % 16
    (37, 130, 72, True, True, True),            # k % 16 (8)
    (130, 33, 1, False, True, True),            # one k
    (40, 24, 4096, False, False, False),        # unaligned bases
    (3, 5, 0, False, True, True),               # k = 0: zeros, no launch
]


@pytest.mark.parametrize("m,n,k,ta,tb,aligned", INT8_2D)
def test_int8_2d_products_take_the_int8_tile(m, n, k, ta, tb, aligned):
    """``ops.gemm_route`` gives every 2-D int8 product K1's int8 tile
    (the ``mma.sync`` int8 form is no route); ``int8_reads_in_place``
    reads an operand as stored only where it is K-major (A untransposed,
    B stored (n, k)) with k a multiple of 16 and an aligned base, and
    ``_plan`` plans the product on K1 with its transposes."""
    from repro_torch.core import expr as E
    assert ops.gemm_route(m, n, k, _I8, _I8, ta, tb, aligned,
                          aligned) == "int8_tile"
    assert "int8" not in ops.K1_ROUTES and "int8_tile" in ops.K1_ROUTES
    for mn in (ta, not tb):
        assert ops.int8_reads_in_place(k, mn, aligned) == (
            not mn and k % 16 == 0 and aligned)
    if not k:                        # no expression has an empty axis
        return
    a = E.arr("A", (k, m) if ta else (m, k))
    b = E.arr("B", (n, k) if tb else (k, n))
    expr = E.inner("add", "mul", E.transpose(a) if ta else a,
                   E.transpose(b) if tb else b)
    plan = ops._plan(E.normal_form(expr), ("int8", "int8"), torch.int32,
                     ops.H100, None, "int32", aligned)
    assert plan == ("K1", ta, tb, False)


@pytest.mark.parametrize("shape,mn", [((37, 5), True), ((5, 37), False),
                                      ((2, 64, 130), True),
                                      ((2, 130, 48), False),
                                      ((3, 16, 7), True), ((1, 1), False)])
def test_pack_kmajor_int8_plain_version(shape, mn):
    """``ref.pack_kmajor_int8`` (the pack's plain version, which the CPU
    path of ``ops.pack_kmajor_int8`` returns) against numpy: the operand
    K-major, (..., rows, k_pad) with k_pad the next multiple of 16, the
    values where numpy's transpose puts them and zeros past k."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.integers(-128, 128, shape).astype(np.int8)
    kmaj = np.swapaxes(x, -1, -2) if mn else x
    k = kmaj.shape[-1]
    want = np.zeros(kmaj.shape[:-1] + (-(-k // 16) * 16,), np.int8)
    want[..., :k] = kmaj
    got = ops.pack_kmajor_int8(torch.from_numpy(x), mn)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.PACKED["int8"] == 0           # no launch on the CPU


@pytest.mark.parametrize("a_ok,b_ok", [(False, True), (True, False)])
@pytest.mark.parametrize("a_dt,b_dt", [(_BF16, _BF16), (_F32, _BF16),
                                       (_BF16, _F32)])
def test_gemm_route_needs_aligned_bases(a_ok, b_ok, a_dt, b_dt):
    """A bf16 operand's base off a 16-byte boundary keeps it off TMA
    (``gemm_bf16`` for bf16 x bf16, the FMA kernel for a mixed product);
    an f32 operand's base does not matter, since the split pass writes
    its parts to fresh, aligned rows."""
    bf16_ok = a_ok if a_dt == _BF16 else b_ok
    want = ("tile" if a_ok and b_ok else "wmma") if a_dt == b_dt else \
        ("split" if bf16_ok else "fma")
    assert ops.gemm_route(64, 64, 64, a_dt, b_dt, False, False, a_ok,
                          b_ok) == want


def test_gemm_route_reads_the_tensors():
    """``_route`` takes the stored shapes and the base addresses."""
    x = torch.zeros(64 * 104 + 1, dtype=_BF16)
    w = torch.zeros(104, 64, dtype=_BF16)
    assert ops._route(x[:64 * 104].view(64, 104), w, False, False) == "tile"
    assert ops._route(x[1:].view(64, 104), w, False, False) == "wmma"
    assert ops._route(x[:4 * 104].view(4, 104), w, False, False) == "tile"
    assert ops._route(torch.zeros(4, 128, dtype=_BF16),
                      torch.zeros(128, 64, dtype=_BF16), False,
                      False) == "gemv"


@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 256, 2048),
                                   (1, 50280, 1536), (4, 256000, 2048),
                                   (16, 2048, 16384), (3, 6448, 1536),
                                   (2, 4096, 12288), (1, 64, 32)])
def test_gemv_splits_partition_k(m, n, k):
    """The decode kernel's splits cover k's units of 32 exactly once, none
    empty, at least 4 units each where there are 4; no split where the
    columns alone fill four blocks a SM."""
    nsplit = ops.gemv_splits(m, n, k)
    units = k // ops.K1_GEMV_UNIT
    per = -(-units // nsplit)
    spans = [range(s * per, min(units, (s + 1) * per)) for s in range(nsplit)]
    assert all(len(r) > 0 for r in spans)
    assert sorted(u for r in spans for u in r) == list(range(units))
    if units >= 4:
        assert per >= 4
    if -(-n // 64) >= 4 * ops.SM_COUNT:
        assert nsplit == 1


#: (m, n, k, transpose_a, f32): the MoE routers (deepseek-moe-16b's 64
#: and llama4-scout's 16 experts at a 2048-token prefill and 2 decode
#: rows, deepseek's dw), a 4096^3 product, f32 at 128 and 4 rows, ragged
#: and mixed forms, and the row form below its split minimum
FMA_SHAPES = [(2048, 64, 2048, False, True), (2, 64, 2048, False, True),
              (2048, 64, 2048, True, True), (2048, 16, 5120, False, True),
              (2, 16, 5120, False, True), (4096, 4096, 4096, False, True),
              (128, 2048, 2048, False, True), (4, 256000, 2048, False, True),
              (1001, 37, 999, False, True), (13, 37, 999, True, True),
              (130, 33, 5, False, False), (5, 3, 300, False, True),
              (17, 9, 1, False, True), (2048, 2048, 64, False, True)]


@pytest.mark.parametrize("m,n,k,ta,f32", FMA_SHAPES)
def test_fma_splits_partition_k(m, n, k, ta, f32):
    """The FMA kernel's split covers its k units (k-steps of 32; the row
    form: single k) exactly once with no empty split, the kernel's own
    ``per = ceil(units / nsplit)``; where the form's blocks are fewer than
    the SMs and k allows, the split brings them to at least one a SM and
    at most about two; else no split."""
    form = ops.fma_form(m, n, ta, f32)
    tb = n == 256000
    nsplit = ops.fma_splits(m, n, k, ta, tb, f32)
    if form == ops.FMA_ROWS:
        assert m <= ops.K1_DECODE_ROWS and not ta
        assert nsplit <= ops.FMA_ROW_CLUSTER
        blocks, unit, least = -(-n // ops.FMA_ROW_COLS[tb]), 1, \
            ops.FMA_ROW_SPLIT_MIN
    else:
        bm, bn = ops.FMA_TILES[form]
        assert form == 3 or (f32 and n <= bn)
        blocks, unit, least = -(-m // bm) * -(-n // bn), ops.FMA_K, 2
    units = -(-k // unit)
    per = -(-units // nsplit)
    spans = [range(s * per, min(units, (s + 1) * per)) for s in range(nsplit)]
    assert all(len(r) > 0 for r in spans)
    assert sorted(u for r in spans for u in r) == list(range(units))
    if blocks >= ops.SM_COUNT or units < 2 * least:
        assert nsplit == 1
    else:
        assert per >= least
        assert ops.SM_COUNT <= blocks * nsplit <= 2 * ops.SM_COUNT + blocks \
            or nsplit in (units // least, ops.FMA_ROW_CLUSTER)


@pytest.mark.parametrize("m,n,form", [(2048, 64, 2), (2048, 16, 1),
                                      (2, 64, ops.FMA_ROWS),
                                      (2, 16, ops.FMA_ROWS),
                                      (4096, 4096, 3), (17, 65, 3)])
def test_fma_form_by_width(m, n, form):
    """128 x 64 tiles for deepseek's 64 router columns, 256 x 16 for
    llama4's 16, the row form for the decode rows, 128 x 128 otherwise
    (and for any bf16 or mixed product)."""
    assert ops.fma_form(m, n) == form
    assert ops.fma_form(m, n, f32=False) in (ops.FMA_ROWS, 3)


#: (b, sq, kv, g, causal, window) of the K4 split plans
DKV_PLANS = [(2, 512, 1, 8, True, 0), (1, 4096, 1, 16, True, 2048),
             (2, 70, 1, 8, True, 0), (2, 130, 1, 8, True, 33),
             (1, 513, 1, 16, True, 100), (2, 45, 1, 2, True, 7),
             (1, 300, 2, 4, False, 0), (4, 4200, 1, 2, True, 0)]


def _visible(sq, sk, g, causal, window):
    """(rows, keys) bool: row (pos, g) sees key j (the plain mask)."""
    if causal:
        vis = ref._mask(sq, sk, True, window, "cpu")
    else:
        vis = torch.ones(sq, sk, dtype=torch.bool)
    return vis.repeat_interleave(g, dim=0)


@pytest.mark.parametrize("b,sq,kv,g,causal,window", DKV_PLANS)
@pytest.mark.parametrize("nsplit", [None, 1, 3])
def test_dkv_split_plan_covers_every_visible_pair_once(b, sq, kv, g, causal,
                                                       window, nsplit):
    """Over all key tiles and their splits, the row tiles that K4's
    tensor-core blocks stream cover every visible (row, key) pair of the
    plain mask exactly once (``nsplit`` None: the plan's own count, two
    blocks a SM where the key tiles' rows allow)."""
    sk = sq
    if nsplit is None:
        nsplit = ops.dkv_splits(b, sq, sk, kv, g, causal, window)
        most = max(ops.dkv_row_tiles(j, sq, sk, g, causal, window)[1]
                   for j in range(0, sk, ops.DKV_KEYS))
        base = -(-sk // ops.DKV_KEYS) * kv * b
        assert nsplit == max(1, min(most, -(-2 * ops.SM_COUNT // base)))
    rows = sq * g
    hits = torch.zeros(rows, sk, dtype=torch.int32)
    for j0 in range(0, sk, ops.DKV_KEYS):
        first, count = ops.dkv_row_tiles(j0, sq, sk, g, causal, window)
        per = -(-count // nsplit)
        for s in range(nsplit):
            lo = first + s * per
            hi = first + min(count, (s + 1) * per)
            for t in range(lo, hi):
                r0 = t * ops.DKV_ROWS
                hits[r0:min(rows, r0 + ops.DKV_ROWS),
                     j0:min(sk, j0 + ops.DKV_KEYS)] += 1
    vis = _visible(sq, sk, g, causal, window)
    assert (hits[vis] == 1).all()
    assert int(hits.max()) <= 1


def test_flash_dkv_plain_version_on_the_cpu_counts_no_launch():
    """On the CPU the K4 wrapper computes its plain version (the plan is a
    card concern) and counts nothing."""
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v, do = t(1, 9, 1, 4, 64), t(1, 9, 1, 64), t(1, 9, 1, 64), \
        t(1, 9, 1, 4, 64)
    out, m, l = ops.attention_stats(q, k, v, scale=0.125)
    delta = (do * out.reshape(do.shape)).sum(-1).permute(0, 2, 3, 1)
    ops.reset_launches()
    dk, dv = ops.flash_dkv(q, k, v, do, m, l, delta.contiguous(),
                           scale=0.125)
    assert ops.LAUNCHES["K4"] == 0
    rk, rv = ref.flash_dkv(q, k, v, do, m, l, delta.contiguous(),
                           scale=0.125)
    assert torch.equal(dk, rk) and torch.equal(dv, rv)


@pytest.mark.parametrize("hd,vd,pair", [
    (64, 64, (64, 64)), (128, 128, (128, 128)), (256, 256, (256, 256)),
    (96, 64, (96, 64)), (32, 32, (64, 64)), (80, 64, (96, 64)),
    (96, 32, (96, 64)), (16, 64, (64, 64)), (64, 96, (128, 128)),
    (96, 96, (128, 128)), (128, 64, (128, 128)), (160, 128, (256, 256)),
    (256, 1, (256, 256)), (1, 256, (256, 256))])
def test_flash_width_rule_picks_the_smallest_built_pair(hd, vd, pair):
    """K2-K4's width rule (``ops.flash_widths``): a built pair runs as it
    is, any other pair with both widths <= 256 at the built pair of least
    hd + vd that covers it, zero-padded inside ``ops``."""
    assert ops.flash_widths(hd, vd) == pair
    assert pair in ops.FLASH_WIDTHS
    covering = [p for p in ops.FLASH_WIDTHS if p[0] >= hd and p[1] >= vd]
    assert sum(pair) == min(sum(p) for p in covering)


@pytest.mark.parametrize("hd,vd", [(257, 64), (96, 320), (512, 512),
                                   (0, 64)])
def test_flash_width_rule_raises_past_its_widths(hd, vd):
    with pytest.raises(ValueError, match="flash form"):
        ops.flash_widths(hd, vd)


def test_flash_plain_versions_take_apart_widths_on_the_cpu():
    """On the CPU the wrappers take the plain versions at any (hd, vd):
    MLA's (96, 64) attention and its K3 / K4 give widths hd for q, k, dq,
    dk and vd for v, out, dv, and count no launch."""
    ops.reset_launches()
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).requires_grad_(True)
    q, k, v = mk(2, 9, 3, 2, 96), mk(2, 9, 3, 96), mk(2, 9, 3, 64)
    out = ops.attention(q, k, v, scale=96 ** -0.5)
    assert out.shape == (2, 9, 6, 64)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape
    assert dv.shape == v.shape
    assert sum(ops.LAUNCHES.values()) == 0


#: (h, m, k, n, transpose_b, aligned, w dtype) -> the route of an int8
#: head form: K1's int8 decode rows ("gemv") at most 16 rows, k % 32 == 0,
#: n % 16 == 0 where w is stored (k, h, n), views it reads in place; K9
#: (its integer accumulator) past 16 rows, at a ragged k or n, on
#: unaligned views and beside another dtype
INT8_HEAD_ROUTES = [
    ((40, 1, 64, 256, True, True, _I8), "gemv"),       # minicpm3's q_lat
    ((40, 4, 64, 256, True, True, _I8), "gemv"),
    ((40, 16, 64, 256, True, True, _I8), "gemv"),
    ((40, 4, 256, 64, False, True, _I8), "gemv"),      # its out
    ((40, 4, 96, 64, True, True, _I8), "gemv"),        # a half unit of 64
    ((40, 17, 64, 256, True, True, _I8), "K9"),        # rows
    ((40, 4, 40, 256, True, True, _I8), "K9"),         # k % 32
    ((40, 4, 256, 72, False, True, _I8), "K9"),        # n % 16, w (k, h, n)
    ((40, 4, 64, 72, True, True, _I8), "gemv"),        # n free with tb
    ((40, 4, 64, 256, True, False, _I8), "K9"),        # views
    ((40, 4, 64, 256, True, True, torch.bfloat16), "K9"),   # int8 x bf16
]


@pytest.mark.parametrize("case,route", INT8_HEAD_ROUTES)
def test_int8_head_route_rule(case, route):
    """``ops.head_route`` for int8 head forms, and the plan of
    ``head_gemm_expr`` under int32: K1's head form (``("K1", False,
    transpose_b, "head")``) on the int8 decode rows, else K9's launch
    descriptor; the decode rows' split of k covers its units once."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import emit
    h, m, k, n, tb, aligned, w_dt = case
    assert ops.head_route(h, m, k, n, _I8, w_dt, tb, aligned) == route
    if w_dt != _I8:
        return
    nf = E.normal_form(E.head_gemm_expr(h, m, k, n, transpose_b=tb))
    plan = ops._plan(nf, ("int8", "int8"), torch.int32, ops.H100, None,
                     "int32", aligned)
    if route == "K9":
        assert plan[0] == "K9" and isinstance(plan[1], emit.Launch)
        return
    assert plan == ("K1", False, tb, "head")
    cols, unit = ops.K1_GEMV8[tb]
    nsplit = ops.gemv_splits(m, n, k, h, cols, unit)
    units = -(-k // unit)
    per = -(-units // nsplit)
    assert 1 <= nsplit <= units and (nsplit - 1) * per < units <= \
        nsplit * per
