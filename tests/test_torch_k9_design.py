"""K9's design on the CPU: which path ``emit._mode`` picks for each
expression family, the copy-width rule at its boundaries, K-split and
column-split coverage, and plain emulations of CHAIN's two contractions
and of REDUCE's split-and-fold order, held against ``ref.eval_nf`` (K9's
plain version) and, where a test needs it, the JAX ``ops.apply`` in
interpret mode (imported inside that test only).

Tolerances: (add, max) / (add, min) bit for bit (one rounding a term, an
order-free fold; a chain's factored form by monotone rounding); sums
within the card tests' ``K9_SUM_REL`` (1e-5) per contracted term of the
largest entry.
"""
import math
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import expr as E
from repro_torch.core import semiring
from repro_torch.kernels import emit, ops, ref

#: tests/test_torch_kernels.py's tolerance for K9's sums
K9_SUM_REL = 1e-5


def _families():
    """The expression families of tests/test_torch_moa.py (``_families``)
    over the port's expression module, with their storage shapes."""
    A = lambda n, s, layout="row": E.arr(n, s, layout)
    return {
        "matmul": (E.matmul_expr(13, 7, 9), [(13, 7), (7, 9)]),
        "matmul_tb": (E.matmul_expr(13, 7, 9, transpose_b=True),
                      [(13, 7), (9, 7)]),
        "matmul_ragged": (E.matmul_expr(37, 70, 130), [(37, 70), (70, 130)]),
        "col_leaf": (E.inner("add", "mul", A("A", (10, 6)),
                             A("B", (6, 8), "col")), [(10, 6), (8, 6)]),
        "psi_leaf": (E.inner("add", "mul", E.psi((2,), A("X", (3, 10, 7))),
                             A("B", (7, 9))), [(3, 10, 7), (7, 9)]),
        "psi_second": (E.inner("add", "mul", A("A", (10, 7)),
                               E.psi((1, 2), A("W", (2, 3, 7, 9)))),
                       [(10, 7), (2, 3, 7, 9)]),
        "batched": (E.inner("add", "mul", A("X", (3, 5, 6)),
                            A("W", (3, 6, 4)), batch=1),
                    [(3, 5, 6), (3, 6, 4)]),
        "hadamard": (E.combine("mul", A("A", (6, 9)), A("B", (6, 9))),
                     [(6, 9), (6, 9)]),
        "pointwise_add": (E.combine("add", A("A", (5, 11)), A("B", (5, 11))),
                          [(5, 11), (5, 11)]),
        "outer": (E.inner("add", "mul", A("A", (3, 4, 1)),
                          A("B", (1, 5, 2))), [(3, 4, 1), (1, 5, 2)]),
        "lone_max": (E.reduce("max", A("A", (5, 37)), 1), [(5, 37)]),
        "lone_min": (E.reduce("min", A("A", (5, 37)), 0), [(5, 37)]),
        "chain": (A("A", (3, 4)) @ A("B", (4, 5)) @ A("C", (5, 2)),
                  [(3, 4), (4, 5), (5, 2)]),
        "mul_over_reduce": (E.combine("mul", E.reduce("add", A("A", (3, 4)),
                                                     axis=1), A("B", (3,))),
                            [(3, 4), (3,)]),
        "add_add": (E.inner("add", "add", A("A", (5, 7)), A("B", (7, 6))),
                    [(5, 7), (7, 6)]),
        "max_plus": (E.inner("max", "add", A("A", (10, 7)), A("B", (7, 13))),
                     [(10, 7), (7, 13)]),
        "min_plus": (E.inner("min", "add", A("A", (9, 7)), A("B", (7, 13))),
                     [(9, 7), (7, 13)]),
        "max_plus_col": (E.inner("max", "add", A("A", (9, 7)),
                                 A("B", (7, 13), "col")),
                         [(9, 7), (13, 7)]),
        "min_plus_psi": (E.inner("min", "add",
                                 E.psi((1,), A("S", (3, 20, 30))),
                                 A("B", (30, 17))),
                         [(3, 20, 30), (30, 17)]),
        "tropical_chain": (E.inner("max", "add", E.inner(
            "max", "add", A("A", (4, 5)), A("B", (5, 6))), A("C", (6, 3))),
            [(4, 5), (5, 6), (6, 3)]),
    }


FAMILIES = _families()
#: the path each family takes: K1 for one 2-D (mul, add) product of stored
#: operands, else K9's mode
PATHS = {"matmul": "K1", "matmul_tb": "K1", "matmul_ragged": "K1",
         "col_leaf": "K1", "psi_leaf": emit.TILE, "psi_second": emit.TILE,
         "batched": emit.TILE, "hadamard": emit.MAP,
         "pointwise_add": emit.MAP, "outer": emit.MAP,
         "lone_max": emit.REDUCE, "lone_min": emit.REDUCE,
         "chain": emit.CHAIN, "mul_over_reduce": emit.REDUCE,
         "add_add": emit.TILE, "max_plus": emit.TILE,
         "min_plus": emit.TILE, "max_plus_col": emit.TILE,
         "min_plus_psi": emit.TILE, "tropical_chain": emit.CHAIN}


def _plan(expr, n_leaves=None, dtype="float32"):
    nf = E.normal_form(expr)
    return ops._plan(nf, (dtype,) * len(nf.leaves), torch.float32,
                     ops.H100, None, "float32")


def _mode_of(launch):
    return emit._mode(launch.out_ext, launch.red_ext, launch.operands,
                      launch.combine, launch.reduce_op)[0]


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_mode_of_every_family(name):
    """``emit._mode`` (through the memoised plan) for every family of
    tests/test_torch_moa.py: chains take CHAIN, lone reduces and mul over
    a reduce REDUCE, Hadamard, pointwise add and outer MAP."""
    plan = _plan(FAMILIES[name][0])
    if PATHS[name] == "K1":
        assert plan[0] == "K1"
        return
    assert plan[0] == "K9"
    assert plan[1].mode == _mode_of(plan[1]) == PATHS[name]


def test_mode_of_kron_and_of_a_two_axis_reduce():
    """``ops.kron``'s normal form (contracted extent 1, gamma-permuted
    output) takes MAP; a lone reduce over two adjacent axes, whose strides
    chain, merges them into one axis of 30 and takes REDUCE; over axes
    (0, 2), which do not chain, it stays on THREAD (its thread form below
    a warp's volume, its warp form from 32), as does a 3-operand nest
    that is no chain."""
    kron = E.transpose(ops._outer_expr(16, 24, 8, 12), (0, 2, 1, 3))
    assert _plan(kron)[1].mode == emit.MAP
    two = E.reduce("max", E.reduce("max", E.arr("A", (7, 6, 5)), 2), 1)
    launch = _plan(two)[1]
    assert launch.mode == emit.REDUCE and launch.red_ext == (30,)
    assert launch.operands[0].strides == (30, 1)
    apart = E.reduce("max", E.reduce("max", E.arr("A", (7, 6, 5)), 2), 0)
    launch = _plan(apart)[1]
    assert launch.mode == emit.THREAD and launch.red_ext == (7, 5)
    assert launch.rows                       # 35 contracted: a warp
    small = E.reduce("min", E.reduce("min", E.arr("A", (3, 6, 5)), 2), 0)
    assert not _plan(small)[1].rows          # 15 contracted: a thread
    # B walks an out axis: not a chain
    nochain = E.combine("mul", E.reduce("add", E.combine(
        "mul", E.arr("A", (4, 5)), E.arr("B", (4, 5))), 1), E.arr("C", (4,)))
    assert _plan(nochain)[1].mode != emit.CHAIN


@pytest.mark.parametrize("red,axes,shape", [
    ("max", (1, 2), (5, 8, 6)), ("min", (1, 2, 3), (3, 4, 5, 6)),
    ("add", (2, 3), (3, 4, 5, 6)), ("max", (0, 1), (4, 5, 7))])
def test_merged_nest_equals_the_unmerged_nest(red, axes, shape):
    """``emit.merge_contracted`` folds chaining contracted axes into one:
    the merged launch's plain executor (``run_descriptor``) equals the
    unmerged nest's (same operands, the axes kept apart) and
    ``ref.eval_nf`` bit for bit, for max and min, and within the K9 sum
    tolerance for add (the same elements, summed in the same order)."""
    expr = E.arr("A", shape)
    for ax in sorted(axes, reverse=True):
        expr = E.reduce(red, expr, ax)
    nf = E.normal_form(expr)
    launch = _plan(expr)[1]
    assert len(launch.red_ext) == 1
    assert launch.red_ext[0] == math.prod(shape[a] for a in axes)
    ext = nf.extent_map
    whole = emit.Launch(
        nf, tuple(nf.out_axes), tuple(ext[a] for a in nf.out_axes),
        tuple(nf.reduce_axes), tuple(ext[a] for a in nf.reduce_axes),
        emit._operands(nf), nf.combine, nf.reduce_op, launch.pad_value,
        emit.THREAD)
    x = torch.from_numpy(_inputs([shape], 11)[0])
    got = emit.run_descriptor(launch, x)
    want = emit.run_descriptor(whole, x)
    if red == "add":
        torch.testing.assert_close(got, want, rtol=0, atol=K9_SUM_REL * (
            launch.red_ext[0] * float(x.abs().max())))
    else:
        assert torch.equal(got, want)
        assert torch.equal(got, ref.eval_nf(nf, x))


def test_chain_roles_and_stages():
    """CHAIN's stages: T = A (x) B over j into a row-major (m, k) f32
    buffer, then T (x) C over k; batched chains keep their leading axis on
    both stages; a (mul, add) chain at 512 splits K on both stages (16
    tiles do not fill 132 SMs)."""
    launch = _plan(FAMILIES["chain"][0])[1]
    s1, s2 = launch.stages
    assert s1.mode == s2.mode == emit.TILE
    assert s1.out_ext == (3, 5) and s1.red_ext == (4,)
    assert s2.out_ext == (3, 2) and s2.red_ext == (5,)
    assert s2.operands[0].storage_shape == (3, 5)
    assert s2.operands[0].strides == (5, 0, 1)
    assert launch.tmp_elems == 15 and launch.work_elems == 0
    ds = launch.c_descs((torch.float32,) * 3, torch.bfloat16, (0, 0, 0))
    assert len(ds) == 2 and ds[0].dst == 1 and ds[1].dst == 0
    assert list(ds[1].src)[:2] == [emit.SRC_TMP, 2] and ds[0].out_dtype == 0
    assert ds[1].out_dtype == 1
    e, m = 3, 512
    batched = E.inner("add", "mul", E.inner(
        "add", "mul", E.arr("A", (e, 9, 10)), E.arr("B", (e, 10, 11)),
        batch=1), E.arr("C", (e, 11, 12)), batch=1)
    b1, b2 = _plan(batched)[1].stages
    assert b1.out_ext == (e, 9, 11) and b2.out_ext == (e, 9, 12)
    big = E.arr("A", (m, m)) @ E.arr("B", (m, m)) @ E.arr("C", (m, m))
    launch = _plan(big)[1]
    assert launch.mode == emit.CHAIN
    assert all(s.splits == 8 and s.k_split == 64 for s in launch.stages)
    assert launch.work_elems == 8 * m * m


@pytest.mark.parametrize("dt,per", [(torch.float32, 4),
                                    (torch.bfloat16, 8)])
def test_copy_width_rule_at_its_boundaries(dt, per):
    """16-byte copies only where the fast stride is 1, every other stride
    and the base are multiples of a 16-byte vector (4 f32, 8 bf16) and the
    pointer is 16-byte aligned: a row one element short or long, a row of
    4 bf16, a base off by one element or a pointer off 16 bytes each fall
    back to 4-byte copies (element loads for bf16)."""
    size = 16 // per
    assert emit.vector_ok(1, [8 * per], 0, 0, per, size)
    assert not emit.vector_ok(1, [8 * per + 1], 0, 0, per, size)
    assert not emit.vector_ok(1, [8 * per - 1], 0, 0, per, size)
    assert not emit.vector_ok(1, [8 * per], 1, 0, per, size)
    assert not emit.vector_ok(1, [8 * per], 0, size, per, size)
    assert not emit.vector_ok(2, [8 * per], 0, 0, per, size)
    assert emit.vector_ok(1, [8 * per, 0, 3 * per], 2 * per, 256, per, size)
    if dt == torch.bfloat16:
        assert not emit.vector_ok(1, [4], 0, 0, per, size)

    # A (150, k) is read along K, B (k, n) along N
    for k, ok in ((8 * per, True), (8 * per + 1, False), (8 * per - 2, False)):
        for n, b_ok in ((144, True), (8 * per + 2, False)):
            expr = E.inner("max", "add", E.arr("A", (150, k)),
                           E.arr("B", (k, n)))
            launch = _plan(expr, dtype=str(dt)[6:])[1]
            d = launch.c_struct((dt, dt), torch.float32, (0, 0))
            assert (d.k_fast[0], d.k_fast[1]) == (1, 0)
            assert (d.vec[0], d.vec[1]) == (int(ok), int(b_ok))
            d = launch.c_struct((dt, dt), torch.float32, (size, size))
            assert (d.vec[0], d.vec[1]) == (0, 0)       # pointers off 16 B
    # a col-layout B is read along K, a transposed A along M
    col = E.inner("max", "add", E.arr("A", (40, 8 * per)),
                  E.arr("B", (8 * per, 50), "col"))
    d = _plan(col, dtype=str(dt)[6:])[1].c_struct((dt, dt), torch.float32,
                                                       (0, 0))
    assert (d.k_fast[0], d.k_fast[1]) == (1, 1)
    assert (d.vec[0], d.vec[1]) == (1, 1)
    tr = E.inner("min", "add", E.transpose(E.arr("A", (30, 16 * per)),
                                           (1, 0)), E.arr("B", (30, 20)))
    d = _plan(tr, dtype=str(dt)[6:])[1].c_struct((dt, dt), torch.float32,
                                                       (0, 0))
    assert d.k_fast[0] == 0 and d.vec[0] == 1
    # a psi slab whose base is off a vector
    psi = E.inner("max", "add", E.psi((1,), E.arr("S", (3, 5, 8 * per + 1))),
                  E.arr("B", (8 * per + 1, 16)))
    d = _plan(psi, dtype=str(dt)[6:])[1].c_struct((dt, dt), torch.float32,
                                                       (0, 0))
    assert d.base[0] == 5 * (8 * per + 1) and d.vec[0] == 0


@pytest.mark.parametrize("lead,m,n,k", [(1, 512, 512, 512),
                                        (1, 100, 90, 3000),
                                        (1, 4096, 4096, 4096),
                                        (16, 1024, 1024, 1024),
                                        (3, 5, 7, 1), (2, 37, 45, 130)])
def test_tile_splits_cover_k_once(lead, m, n, k):
    """TILE splits K only where its tiles do not fill the SMs; the splits
    are slab multiples and cover [0, K) exactly once."""
    splits, k_split = emit.tile_splits(lead, m, n, k)
    tiles = lead * math.ceil(m / emit.TILE_M) * math.ceil(n / emit.TILE_M)
    assert (splits > 1) <= (tiles < emit.NUM_SM)
    if splits > 1:
        assert k_split % emit.TILE_K == 0
        assert k_split >= emit.TILE_SPLIT_MIN // 2
    seen = np.zeros(k, int)
    for s in range(splits):
        seen[s * k_split:min(k, (s + 1) * k_split)] += 1
    assert (seen == 1).all() and (splits - 1) * k_split < k
    assert lead * splits <= emit.GRID_YZ


@pytest.mark.parametrize("e,m,k,n,scale", [(2, 64, 128, 96, 1.0),
                                           (1, 128, 1024, 96, 1024 ** -0.5)])
def test_tile_split_products_hold_the_sum_tolerance(e, m, k, n, scale):
    """TILE's (mul, add) products on the tensor cores: each f32 operand as
    bf16 hi + lo, three products (hi.hi + hi.lo + lo.hi), emulated exactly
    in f64, stay under a hundredth of the card tests' K9_SUM_REL bound at
    the card test's and the smoke's depths; the hi part alone misses it
    at k = 128, which is why the lo parts are there."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(e, m, k, generator=g)
    w = torch.randn(e, k, n, generator=g) * scale

    def split(t):
        hi = t.to(torch.bfloat16).float()
        return hi.double(), (t - hi).to(torch.bfloat16).double()

    (xh, xl), (wh, wl) = split(x), split(w)
    want = x.double() @ w.double()
    tol = K9_SUM_REL * k * want.abs().max().item()
    three = xh @ wh + xh @ wl + xl @ wh
    assert (three - want).abs().max().item() <= tol / 100
    if k == 128:
        assert (xh @ wh - want).abs().max().item() > tol


def _tc_slabs(x, w, saturate=True):
    """TILE's (mul, add) tensor-core sum as mma_slab forms it, in f64 with
    f32 results: per 16-deep slab the three products hi.hi + hi.lo +
    lo.hi, added to the accumulator.  ``saturate``: split2 rounds the hi
    part to nearest and holds it at bf16's largest finite value (PTX
    ``cvt.rn.satfinite``), so an inf leaves inf in lo."""
    big = torch.finfo(torch.bfloat16).max

    def split(t):
        hi = t.to(torch.bfloat16).float()
        if saturate:
            hi = torch.where(torch.isinf(hi), torch.sign(t) * big, hi)
        return hi.double(), (t - hi).to(torch.bfloat16).double()

    (xh, xl), (wh, wl) = split(x), split(w)
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], 16):
        s = slice(k0, k0 + 16)
        acc = acc + (xl[:, s] @ wh[s] + xh[:, s] @ wl[s]
                     + xh[:, s] @ wh[s]).float()
    return acc


def test_tile_split_products_carry_inf_nan_and_large_values():
    """An inf, a NaN, infinities of both signs in one sum, an inf times 0
    and a finite value past bf16's range give, through the split
    products, the NaN, the signed inf and the finite sum of the f32
    products: with the hi part saturated, an inf is bf16's largest value
    in hi and inf in lo, so inf x y reaches the sum through lo.hi (NaN
    where y is 0), and the large value's excess is in lo.  Rounded to
    inf instead, hi.lo would pair inf with a lo of 0 into NaN, and the
    large value would overflow."""
    g = torch.Generator().manual_seed(47)
    x = torch.randn(8, 48, generator=g)
    w = torch.randn(48, 12, generator=g)
    x[1, 5] = math.inf
    x[2, 20] = math.nan
    w[30, 3] = -math.inf
    x[6, 2] = x[6, 40] = math.inf
    x[4, 33] = 3.4e38
    w[33] *= 1e-3
    w[[5, 2, 40, 33], 11] = 0.0          # inf x 0 in the plain product too
    w[5, 7] = 1.0                         # a bf16 value: its lo is 0
    want = (x.double()[:, :, None] * w.double()[None]).sum(1).float()
    got = _tc_slabs(x, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(fin[4, 4:].all()) and bool(torch.isinf(want[1, :3]).all())
    assert bool(torch.isinf(want[1, 7]) and torch.isnan(want[1, 11]))
    assert bool(torch.isnan(want[6]).any() and torch.isinf(want[6]).any())
    for r in range(x.shape[0]):
        keep = fin[r]
        if not keep.any():
            continue
        tol = K9_SUM_REL * 48 * want[r][keep].abs().max().item()
        assert (got[r][keep] - want[r][keep]).abs().max().item() <= tol
    rounded = _tc_slabs(x, w, saturate=False)
    assert bool(torch.isnan(rounded[1, 7])) and not bool(
        torch.isfinite(rounded[4, 4:]).all())


# ---------------------------------------------------------------------------
# plain emulations of the kernels' orders
# ---------------------------------------------------------------------------

def _chain_stages_plain(launch, *arrays):
    """CHAIN as the card runs it: stage 1 into the f32 scratch T, stage 2
    from T, each through the plain descriptor executor."""
    s1, s2 = launch.stages
    t = emit.run_descriptor(s1, arrays[0], arrays[1],
                            out_dtype=torch.float32)
    return emit.run_descriptor(s2, t.contiguous(), arrays[2],
                               out_dtype=torch.float32)


def _chain(plus, times, shapes):
    batch = int(len(shapes[0]) == 3)
    A, B, C = (E.arr(nm, s) for nm, s in zip("ABC", shapes))
    return E.inner(plus, times, E.inner(plus, times, A, B, batch=batch), C,
                   batch=batch)


CHAIN_SHAPES = [[(4, 5), (5, 6), (6, 3)], [(33, 10), (10, 6), (6, 40)],
                [(1, 2), (2, 2), (2, 1)], [(3, 7, 9), (3, 9, 4), (3, 4, 6)]]


@pytest.mark.parametrize("plus,times", [("max", "add"), ("min", "add"),
                                        ("add", "mul")])
@pytest.mark.parametrize("shapes", CHAIN_SHAPES)
def test_chain_emulation_matches_the_nest_and_jax(plus, times, shapes):
    """CHAIN's two contractions, emulated in plain PyTorch, against the
    nest (``ref.eval_nf``) and the JAX reference's Pallas kernel in
    interpret mode: bit for bit for the tropical pairs (rounding is
    monotone), within K9_SUM_REL for (mul, add)."""
    import jax.numpy as jnp
    from repro.core import expr as JE
    from repro.kernels import ops as jops
    expr = _chain(plus, times, shapes)
    launch = _plan(expr)[1]
    assert launch.mode == emit.CHAIN
    ins = _inputs(shapes, zlib.crc32(repr(shapes).encode()))
    ts = [torch.from_numpy(x) for x in ins]
    got = _chain_stages_plain(launch, *ts)
    nest = ref.eval_nf(launch.nf, *ts)
    jbatch = int(len(shapes[0]) == 3)
    JA, JB, JC = (JE.arr(nm, s) for nm, s in zip("ABC", shapes))
    jexpr = JE.inner(plus, times, JE.inner(plus, times, JA, JB,
                                           batch=jbatch), JC, batch=jbatch)
    want = torch.from_numpy(np.asarray(jops.apply(
        jexpr, *map(jnp.asarray, ins), interpret=True,
        out_dtype=jnp.float32)))
    assert got.shape == nest.shape == want.shape
    if plus in ("max", "min"):
        assert torch.equal(got, nest) and torch.equal(got, want)
    else:
        k = shapes[0][-1] * shapes[1][-1]
        tol = K9_SUM_REL * k * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
        torch.testing.assert_close(nest, want, rtol=0, atol=tol)


def test_chain_differs_from_the_nest_only_where_infinities_meet():
    """The one deliberate deviation (ROADMAP.md, Queue 3): a term of T at
    -inf from one j while another j wins, paired with C = +inf, is NaN in
    the nest (-inf + inf) and +inf in the factored form; infinities of one
    sign (no edge in a shortest-path product) stay bit for bit."""
    expr = _chain("max", "add", [(1, 2), (2, 1), (1, 1)])
    launch = _plan(expr)[1]
    a = torch.tensor([[float("-inf"), 0.0]])
    b = torch.tensor([[0.0], [0.0]])
    c = torch.tensor([[float("inf")]])
    nest = ref.eval_nf(launch.nf, a, b, c)
    got = _chain_stages_plain(launch, a, b, c)
    assert torch.isnan(nest).all() and torch.equal(
        got, torch.tensor([[float("inf")]]))
    # shortest paths with +inf for "no edge": every term one-signed
    g = torch.Generator().manual_seed(5)
    mins = _chain("min", "add", [(6, 7), (7, 8), (8, 5)])
    launch = _plan(mins)[1]
    xs = [torch.rand(s, generator=g) for s in ((6, 7), (7, 8), (8, 5))]
    for x in xs:
        x[torch.rand(x.shape, generator=g) < 0.4] = float("inf")
    assert torch.equal(_chain_stages_plain(launch, *xs),
                       ref.eval_nf(launch.nf, *xs))


def _fold_fn(op):
    return semiring.reduce_def(op).torch_fn


def _paired(launch, x):
    """A lone reduce's operand as K9 reads it: (outputs, K) f32."""
    (opn,) = launch.operands
    size = launch.out_ext + launch.red_ext
    v = torch.as_strided(x, size, opn.strides, opn.base).float()
    return v.reshape(-1, launch.red_ext[0])


def _reduce_cols_emulated(launch, x):
    """k9_reduce_cols's order: each split's range, its warps on rows
    w, w + 8, .. (each folded in order), the warps folded in order, then
    the splits folded in order (k9_fold)."""
    fold = _fold_fn(launch.reduce_op)
    v = _paired(launch, x)
    k = launch.red_ext[0]
    ident = torch.full(v.shape[:1], semiring.reduce_def(
        launch.reduce_op).identity)
    parts = []
    for s in range(launch.splits):
        lo, hi = s * launch.k_split, min(k, (s + 1) * launch.k_split)
        warps = []
        for w in range(emit.REDUCE_WARPS):
            acc = ident
            for kk in range(lo + w, hi, emit.REDUCE_WARPS):
                acc = fold(acc, v[:, kk])
            warps.append(acc)
        part = warps[0]
        for w in warps[1:]:
            part = fold(part, w)
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = fold(out, p)
    return out.reshape(launch.out_ext)


def _reduce_rows_emulated(launch, x):
    """k9_reduce_rows's order on a contiguous axis: lane q % 32 takes
    vector q (4 accumulators, one per element), the tail's scalars go to
    accumulator (i % 4) of their lane, each lane folds (a0 a1)(a2 a3),
    then the xor-shuffle tree 16, 8, 4, 2, 1."""
    fold = _fold_fn(launch.reduce_op)
    v = _paired(launch, x)
    k = launch.red_ext[0]
    ident = torch.full(v.shape[:1], semiring.reduce_def(
        launch.reduce_op).identity)
    acc = [[ident] * 4 for _ in range(32)]
    chunks = k // emit.RUN
    for q in range(chunks):
        lane = acc[q % 32]
        for e in range(emit.RUN):
            lane[e] = fold(lane[e], v[:, q * emit.RUN + e])
    tail = chunks * emit.RUN
    for kk in range(tail, k):
        lane, i = (kk - tail) % 32, (kk - tail) // 32
        acc[lane][i % 4] = fold(acc[lane][i % 4], v[:, kk])
    r = [fold(fold(a[0], a[1]), fold(a[2], a[3])) for a in acc]
    for s in (16, 8, 4, 2, 1):
        r = [fold(r[lane], r[lane ^ s]) for lane in range(32)]
    return r[0].reshape(launch.out_ext)


@pytest.mark.parametrize("op", ["max", "min", "add"])
@pytest.mark.parametrize("shape,axis,rows", [((1000, 50), 0, False),
                                             ((700, 9), 0, False),
                                             ((30, 1000), 1, True),
                                             ((9, 70), 1, True),
                                             ((5, 37), 0, False)])
def test_reduce_split_and_fold_order(op, shape, axis, rows):
    """REDUCE's variants and their fold orders, emulated in plain PyTorch
    against ``ref.eval_nf``: max / min bit for bit, sums within
    K9_SUM_REL; the column strips of a (1000, 50) array do not fill the
    card, so its axis splits (each k in one split, folded in order)."""
    expr = E.reduce(op, E.arr("A", shape), axis)
    launch = _plan(expr)[1]
    assert launch.mode == emit.REDUCE and launch.rows == rows
    k = shape[axis]
    if shape == (1000, 50):
        assert launch.splits > 1
    seen = np.zeros(k, int)
    for s in range(launch.splits):
        seen[s * launch.k_split:min(k, (s + 1) * launch.k_split)] += 1
    assert (seen == 1).all()
    g = torch.Generator().manual_seed(k)
    x = torch.randn(shape, generator=g)
    emulate = _reduce_rows_emulated if rows else _reduce_cols_emulated
    got = emulate(launch, x)
    want = ref.eval_nf(launch.nf, x)
    if op == "add":
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=K9_SUM_REL * k *
                                   want.abs().max().item())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape,x,k", [((16, 1, 8192), 8192, 16),
                                       ((1, 1, 64), 64, 8192)])
def test_reduce_splits_fill_the_card(shape, x, k):
    """Column strips split the contracted axis only while the strips do
    not fill 4 blocks a SM, and never below REDUCE_SPLIT_MIN a split."""
    lead = shape[0] * shape[1]
    splits, k_split = emit.reduce_splits(lead, x, k)
    strips = lead * math.ceil(x / emit.REDUCE_STRIP)
    assert (splits > 1) == (strips < 4 * emit.NUM_SM
                            and k >= 2 * emit.REDUCE_SPLIT_MIN)
    assert k_split >= emit.REDUCE_SPLIT_MIN or splits == 1
    assert (splits - 1) * k_split < k <= splits * k_split


# ---- MAP's span walk ----------------------------------------------------

def test_div_magic_reproduces_divmod():
    """``emit.div_magic``'s multiplier and shift give ``a // radix`` for
    every radix from 1 to 65536, at numerators next to each multiple the
    walk can meet (0, radix - 1, radix, 2^31 - 1 and around sampled
    multiples), and at the largest radices below 2^31."""
    i64 = torch.int64
    radix = torch.arange(1, 65537, dtype=i64)
    magic = [emit.div_magic(r) for r in range(1, 65537)]
    mul = torch.tensor([m for m, _ in magic], dtype=i64)
    shift = torch.tensor([s for _, s in magic], dtype=i64)
    assert int(mul.max()) < 2 ** 32
    top = 2 ** 31 - 1
    gen = torch.Generator().manual_seed(5)
    q = torch.randint(0, 2 ** 31, (65536, 8), generator=gen) // radix[:, None]
    a = torch.cat([torch.zeros(65536, 1, dtype=i64), radix[:, None] - 1,
                   radix[:, None], torch.full((65536, 1), top),
                   q * radix[:, None], q * radix[:, None] - 1,
                   q * radix[:, None] + radix[:, None] - 1], dim=1)
    a = a.clamp(0, top)
    got = (a * mul[:, None]) >> shift[:, None]
    assert torch.equal(got, a // radix[:, None])
    for r in (2 ** 31, 2 ** 31 - 1, 3 * 2 ** 29, 1000003):
        m, s = emit.div_magic(r)
        for x in (0, r - 1, r, top, top - top % r, top - top % r - 1):
            if 0 <= x <= top:
                assert (x * m) >> s == x // r


def _map_descriptor(expr, dtypes, out_dtype=torch.float32):
    plan = ops._plan(E.normal_form(expr), tuple(str(d)[6:] for d in dtypes),
                     out_dtype, ops.H100, None, "float32", False)
    launch = plan[1]
    assert launch.mode == emit.MAP
    return launch, launch.c_struct(dtypes, out_dtype, (0,) * len(dtypes))


def _map_exprs():
    """(label) -> (expr, dtypes): the [moa_path] MAP rows' descriptors
    (the 6-axis Kronecker product, kron 64, Hadamard), a ragged last axis
    and an operand broadcast along it."""
    A = E.arr
    f32 = torch.float32
    c = 16
    return {
        "kron6": (E.transpose(E.inner("add", "mul", A("A", (c, c, c, 1)),
                                      A("B", (1, c, c, c))),
                              (0, 3, 1, 4, 2, 5)), (f32, f32)),
        "kron64": (E.transpose(ops._outer_expr(64, 64, 64, 64),
                               (0, 2, 1, 3)), (f32, f32)),
        "hadamard": (E.hadamard_expr(1024, 1024), (f32, f32)),
        "ragged": (E.transpose(E.inner("add", "mul", A("A", (7, 9, 1)),
                                       A("B", (1, 11, 1001))),
                               (0, 2, 1, 3)), (f32, torch.bfloat16)),
        "broadcast": (ops._outer_expr(30, 5, 3, 130), (f32, f32)),
    }


def _direct_offsets(launch):
    """Each run's offsets decoded from its index, as the old walk did (a
    division a slot), in run order: a row per operand, then the output."""
    nout = len(launch.out_ext)
    ext = launch.out_ext
    per_row = -(-ext[-1] // emit.RUN)
    runs = math.prod(ext[:-1]) * per_row
    run = torch.arange(runs, dtype=torch.int64)
    xr, z = run % per_row, run // per_row
    coords = [xr * emit.RUN]
    for e in reversed(ext[:-1]):
        coords.append(z % e)
        z = z // e
    coords = coords[::-1]                      # out axes in order
    rows = []
    for opn in launch.operands:
        o = torch.full_like(run, opn.base)
        for ax in range(nout):
            o = o + coords[ax] * opn.strides[ax]
        rows.append(o)
    o = torch.zeros_like(run)
    for ax, st in enumerate(launch.out_strides):
        o = o + coords[ax] * st
    rows.append(o)
    return run, torch.stack(rows)


@pytest.mark.parametrize("name", sorted(_map_exprs()))
def test_map_span_walk_visits_every_output_once_in_order(name):
    """A plain model of ``k9_map``'s span walk on the host's descriptor
    (``emit.map_walk_offsets``: first runs by the multipliers, the rest by
    the step's digits with carries, 32-bit where the descriptor is
    narrow) visits every run exactly once, in order, at the offsets a
    full decode of each run gives; so every output element is written
    once (the runs of a row tile its last axis, the edge run its
    remainder), and the wide (64-bit, dividing) walk agrees with it."""
    launch, d = _map_descriptor(*_map_exprs()[name])
    runs, offsets = emit.map_walk_offsets(d)
    want_runs, want = _direct_offsets(launch)
    assert torch.equal(runs, want_runs)
    assert torch.equal(offsets, want)
    assert d.narrow == 1
    x = launch.out_ext[-1]
    cover = torch.zeros(math.prod(launch.out_ext), dtype=torch.int32)
    for e in range(emit.RUN):
        keep = (runs % -(-x // emit.RUN)) * emit.RUN + e < x
        cover.index_add_(0, offsets[-1][keep] + e,
                         torch.ones(int(keep.sum()), dtype=torch.int32))
    assert bool((cover == 1).all())
    d.narrow = 0
    runs64, offsets64 = emit.map_walk_offsets(d)
    assert torch.equal(runs64, want_runs) and torch.equal(offsets64, want)


def test_map_walk_width_streaming_and_digits():
    """The host's walk choices: the 6-axis Kronecker product takes the long
    walk (8 digits, a step of MAP_STEP = 256 runs is (0, 0, 4) over radices
    (4, 16, 16)), 32-bit, MAP_SPAN runs a thread, with streaming stores (67
    MB past the 50 MB L2); a small Hadamard (a decode of one division: one
    run a thread) stores plainly; an output of 2^32 cells is wide
    (64-bit)."""
    launch, d = _map_descriptor(*_map_exprs()["kron6"])
    assert list(d.walk_digit)[:3] == [0, 0, 4] and d.walk_top == 2
    assert d.narrow == 1 and d.stream_out == 1 and d.span == emit.MAP_SPAN
    assert list(d.walk_shift)[:3] == [33, 35, 35]
    _, small = _map_descriptor(E.hadamard_expr(64, 64),
                               (torch.float32, torch.float32))
    assert small.stream_out == 0 and small.narrow == 1 and small.span == 1
    _, big = _map_descriptor(ops._outer_expr(2 ** 16, 1, 1, 2 ** 16),
                             (torch.float32, torch.float32))
    assert big.narrow == 0 and big.stream_out == 1


def test_k9_descriptor_mirrors_the_kernels_struct():
    """``emit.K9Desc`` lists ``csrc/semiring.cu``'s ``struct Desc`` field
    for field, in order (the kernel reads it by value)."""
    import pathlib
    import re
    src = (pathlib.Path(emit.__file__).parent / "csrc" /
           "semiring.cu").read_text()
    body = src[src.index("struct Desc {"):]
    body = body[:body.index("};")]
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split("{", 1)[1].split(";"):
        decl = decl.strip()
        if decl:
            decl = re.sub(r"^(long long|int|unsigned)\s+", "", decl)
            names += [re.match(r"\w+", v.strip()).group(0)
                      for v in decl.split(",")]
    assert names == [n for n, _ in emit.K9Desc._fields_]
