"""The port's MoA expression pipeline against the JAX package on the CPU.

The same numpy inputs from a seed go through ``repro.kernels.ops`` (the
Pallas interpreter running the K1/K9 bodies, ``interpret=True``) and
through ``repro_torch.kernels.ops`` (the plain versions: ``ref.matmul``
for K1's forms, ``ref.eval_nf`` for K9's), and both are held against
``Onf.execute``.  The copied derivation (semiring registry, gamma layouts,
lifting, normal forms, schedules on the reference's ``cpu`` table,
``TPU_V5E``) is held to the reference's, and K9's launch descriptor is
driven through a plain ``torch.as_strided`` executor.

Tolerances: (max, add) / (min, add) bit for bit on any f32 input (one
rounding per term, an order-free fold); everything else within 5e-5 x the
contracted extent, as the reference's property tests.
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import expr as JE
from repro.core import hardware as jhw
from repro.core import lifting as jl
from repro.core import moa as jmoa
from repro.core import schedule as jsched
from repro.core import semiring as jsr
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import expr as PE
from repro_torch.core import lifting as pl_
from repro_torch.core import moa as pmoa
from repro_torch.core import onf as ponf
from repro_torch.core import schedule as psched
from repro_torch.core import semiring as psr
from repro_torch.hardware import H100, TPU_V5E
from repro_torch.kernels import emit, ops, ref

CPU = jhw.get_entry("cpu")


def _families(M):
    """name -> (expression, storage shapes of its leaves, contracted
    extent) over the module ``M`` (``repro.core.expr`` or its copy)."""
    A = lambda n, s, layout="row": M.arr(n, s, layout)
    return {
        "matmul": (M.matmul_expr(13, 7, 9), [(13, 7), (7, 9)], 7),
        "matmul_tb": (M.matmul_expr(13, 7, 9, transpose_b=True),
                      [(13, 7), (9, 7)], 7),
        "matmul_ragged": (M.matmul_expr(37, 70, 130), [(37, 70), (70, 130)],
                          70),
        "col_leaf": (M.inner("add", "mul", A("A", (10, 6)),
                             A("B", (6, 8), "col")), [(10, 6), (8, 6)], 6),
        "psi_leaf": (M.inner("add", "mul", M.psi((2,), A("X", (3, 10, 7))),
                             A("B", (7, 9))), [(3, 10, 7), (7, 9)], 7),
        "psi_second": (M.inner("add", "mul", A("A", (10, 7)),
                               M.psi((1, 2), A("W", (2, 3, 7, 9)))),
                       [(10, 7), (2, 3, 7, 9)], 7),
        "batched": (M.inner("add", "mul", A("X", (3, 5, 6)),
                            A("W", (3, 6, 4)), batch=1),
                    [(3, 5, 6), (3, 6, 4)], 6),
        "hadamard": (M.combine("mul", A("A", (6, 9)), A("B", (6, 9))),
                     [(6, 9), (6, 9)], 1),
        "pointwise_add": (M.combine("add", A("A", (5, 11)), A("B", (5, 11))),
                          [(5, 11), (5, 11)], 1),
        "outer": (M.inner("add", "mul", A("A", (3, 4, 1)),
                          A("B", (1, 5, 2))), [(3, 4, 1), (1, 5, 2)], 1),
        "lone_max": (M.reduce("max", A("A", (5, 37)), 1), [(5, 37)], 37),
        "lone_min": (M.reduce("min", A("A", (5, 37)), 0), [(5, 37)], 5),
        "chain": (A("A", (3, 4)) @ A("B", (4, 5)) @ A("C", (5, 2)),
                  [(3, 4), (4, 5), (5, 2)], 20),
        "mul_over_reduce": (M.combine("mul", M.reduce("add", A("A", (3, 4)),
                                                     axis=1), A("B", (3,))),
                            [(3, 4), (3,)], 4),
        "add_add": (M.inner("add", "add", A("A", (5, 7)), A("B", (7, 6))),
                    [(5, 7), (7, 6)], 7),
        "max_plus": (M.inner("max", "add", A("A", (10, 7)), A("B", (7, 13))),
                     [(10, 7), (7, 13)], 7),
        "min_plus": (M.inner("min", "add", A("A", (9, 7)), A("B", (7, 13))),
                     [(9, 7), (7, 13)], 7),
        "max_plus_col": (M.inner("max", "add", A("A", (9, 7)),
                                 A("B", (7, 13), "col")),
                         [(9, 7), (13, 7)], 7),
        "min_plus_psi": (M.inner("min", "add",
                                 M.psi((1,), A("S", (3, 20, 30))),
                                 A("B", (30, 17))),
                         [(3, 20, 30), (30, 17)], 30),
        "tropical_chain": (M.inner("max", "add", M.inner(
            "max", "add", A("A", (4, 5)), A("B", (5, 6))), A("C", (6, 3))),
            [(4, 5), (5, 6), (6, 3)], 30),
    }


J_FAM, P_FAM = _families(JE), _families(PE)
FAMILIES = sorted(J_FAM)
#: one (mul, add) 2-D product of stored operands, row- or col-read: K1
K1_FORMS = {"matmul", "matmul_tb", "matmul_ragged", "col_leaf"}
TROPICAL = {"max_plus", "min_plus", "max_plus_col", "min_plus_psi",
            "tropical_chain", "lone_max", "lone_min"}


def _inputs(name, seed=0):
    rng = np.random.default_rng(zlib.crc32(name.encode()) + seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in J_FAM[name][1]]


def _onf(name, ins):
    o = JE.normalize(J_FAM[name][0])
    n = int(np.prod(JE.normal_form(J_FAM[name][0]).out_shape()))
    return o.execute(o.init_out(n), *(x.ravel() for x in ins))


def _close(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if name in TROPICAL:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 5e-5 * J_FAM[name][2]


# ---------------------------------------------------------------------------
# the copied derivation against the reference's
# ---------------------------------------------------------------------------

def test_semiring_registry_and_pad_values_match():
    for name in ("mul", "add"):
        assert psr.combine_def(name).np_fn is jsr.combine_def(name).np_fn
    for name in ("add", "max", "min"):
        assert psr.reduce_def(name).identity == \
            jsr.reduce_def(name).identity
        assert psr.reduce_def(name).np_fn is jsr.reduce_def(name).np_fn
    assert psr._PAD_VALUES == jsr._PAD_VALUES
    for pair in [("mul", "add"), ("add", "max"), ("mul", "max")]:
        try:
            want = jsr.pad_value(*pair)
        except ValueError:
            with pytest.raises(ValueError, match="inert"):
                psr.pad_value(*pair)
        else:
            assert psr.pad_value(*pair) == want
    assert psr.registered_accums() == jsr.registered_accums()
    psr.check_accum("bfloat16", "bfloat16", "mul", "add")
    with pytest.raises(ValueError, match="only defined"):
        psr.check_accum("bfloat16", "bfloat16", "add", "max")
    with pytest.raises(ValueError, match="unknown combine"):
        psr.combine_def("xor")
    # the torch callables compute what the numpy ones do
    x = np.array([1.5, -2.0, np.inf], np.float32)
    y = np.array([0.5, np.nan, -1.0], np.float32)
    for name in ("mul", "add"):
        got = psr.combine_def(name).torch_fn(torch.tensor(x), torch.tensor(y))
        np.testing.assert_array_equal(got.numpy(),
                                      psr.combine_def(name).np_fn(x, y))
    for name in ("add", "max", "min"):
        got = psr.reduce_def(name).torch_fn(torch.tensor(x), torch.tensor(y))
        np.testing.assert_array_equal(got.numpy(),
                                      psr.reduce_def(name).np_fn(x, y))


@pytest.mark.parametrize("shape", [(4, 6), (3, 5, 2), (7,), (2, 3, 4, 5)])
def test_gamma_layouts_and_psi_match(shape):
    n = pmoa.pi(shape)
    assert n == jmoa.pi(shape)
    for off in range(n):
        idx = jmoa.gamma_row_inverse(off, shape)
        assert pmoa.gamma_row_inverse(off, shape) == idx
        assert pmoa.gamma_col_inverse(off, shape) == \
            jmoa.gamma_col_inverse(off, shape)
        assert pmoa.gamma_row(idx, shape) == jmoa.gamma_row(idx, shape)
        assert pmoa.gamma_col(idx, shape) == jmoa.gamma_col(idx, shape)
    if shape == (4, 6):
        for idx in map(tuple, pmoa.iota(shape).reshape(-1, 2)):
            assert pmoa.gamma_blocked(idx, shape, (2, 3)) == \
                jmoa.gamma_blocked(idx, shape, (2, 3))
    np.testing.assert_array_equal(pmoa.iota(shape), jmoa.iota(shape))
    x = np.arange(n).reshape(shape)
    np.testing.assert_array_equal(pmoa.psi((0,), x), jmoa.psi((0,), x))
    np.testing.assert_array_equal(pmoa.rav(x), jmoa.rav(x))


def test_lift_shape_matches():
    axes = [("i", 4096, [("data", 16)]), ("j", 4096, [("model", 16)]),
            ("k", 512, [("grid", 4)])]
    got = pl_.lift_shape(TPU_V5E, axes)
    want = jl.lift_shape(jl.TPU_V5E, axes)
    assert [a.factors for a in got.axes] == [a.factors for a in want.axes]
    assert got.grid() == want.grid()
    assert got.block_shape() == want.block_shape()
    assert got.local_shape() == want.local_shape()
    with pytest.raises(ValueError, match="does not"):
        pl_.lift("i", 100, [("data", 16)])


@pytest.mark.parametrize("name", FAMILIES)
def test_normal_form_and_onf_match(name):
    """The same normal-form key, the same loop nest, and ``Onf.execute``
    equal on the same flats."""
    jnf = JE.normal_form(J_FAM[name][0])
    pnf = PE.normal_form(P_FAM[name][0])
    assert pnf.key() == jnf.key()
    assert pnf.leaf_storage_shapes() == jnf.leaf_storage_shapes()
    assert pnf.onf().render_c() == jnf.onf().render_c()
    ins = _inputs(name)
    o = pnf.onf()
    n = int(np.prod(pnf.out_shape()))
    np.testing.assert_array_equal(
        o.execute(o.init_out(n), *(x.ravel() for x in ins)), _onf(name, ins))


def test_onf_lifting_and_paper_forms_match():
    from repro.core import onf as jonf
    for p, j in ((ponf.gemm_onf(4, 6, 5), jonf.gemm_onf(4, 6, 5)),
                 (ponf.hadamard_onf(3, 4), jonf.hadamard_onf(3, 4))):
        assert p.key() == j.key()
    lp = ponf.lift_loop(ponf.gemm_onf(8, 6, 4), "i", 2, "proc")
    lj = jonf.lift_loop(jonf.gemm_onf(8, 6, 4), "i", 2, "proc")
    assert lp.key() == lj.key() and lp.render_c() == lj.render_c()
    rp = ponf.reorder_loops(ponf.gemm_onf(4, 6, 5), ("i", "j", "k"))
    rj = jonf.reorder_loops(jonf.gemm_onf(4, 6, 5), ("i", "j", "k"))
    assert rp.innermost_strides() == rj.innermost_strides()


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_schedule_on_the_v5e_table_matches(name, dtype):
    """``get_schedule`` on the reference's ``cpu`` table: the same grid,
    dimension semantics, blocks, padded extents and pad value."""
    want = jsched.get_schedule(J_FAM[name][0], dtype=dtype, hardware=CPU)
    got = psched.get_schedule(P_FAM[name][0], dtype=dtype,
                              hardware=TPU_V5E)
    assert got.schedule.grid_extents == want.schedule.grid_extents
    assert got.schedule.dimension_semantics == \
        want.schedule.dimension_semantics
    assert [(o.axes, o.shape, o.block, o.grid_dims, o.offsets)
            for o in got.schedule.ins] == \
        [(o.axes, o.shape, o.block, o.grid_dims, o.offsets)
         for o in want.schedule.ins]
    assert (got.blocks and got.blocks.as_tuple()) == \
        (want.blocks and want.blocks.as_tuple())
    assert got.padded == want.padded and got.shapes == want.shapes
    assert psched.bundle_pad_value(got) == jsched.bundle_pad_value(want)


def test_schedule_cache_counts_and_h100_fit():
    psched.reset_schedule_cache()
    a, b = PE.arr("A", (32, 16)), PE.arr("B", (16, 24))
    for plus, times in (("add", "mul"), ("max", "add"), ("min", "add")):
        psched.get_schedule(PE.inner(plus, times, a, b), hardware=TPU_V5E)
    psched.get_schedule(PE.inner("max", "add", a, b), hardware=TPU_V5E)
    assert psched.schedule_cache_stats() == {"hits": 1, "misses": 3,
                                             "solves": 3}
    # on the H100's 227 KB a default block the reference would refuse is
    # halved until it fits: the elementwise (256, 256) and a chain's
    # un-lifted second contraction
    for e in (PE.hadamard_expr(8192, 8192),
              PE.arr("A", (512, 512)) @ PE.arr("B", (512, 512))
              @ PE.arr("C", (512, 512))):
        bundle = psched.get_schedule(e, dtype="float32", hardware=H100)
        assert bundle.schedule.working_set_bytes("float32") <= \
            H100.vmem.capacity_bytes
    with pytest.raises(ValueError, match="accumulation"):
        psched.get_schedule(PE.matmul_expr(8, 8, 8), dtype="bfloat16",
                            hardware=H100, acc_dtype="bfloat16")


# ---------------------------------------------------------------------------
# apply and its builders against the JAX entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_apply_matches_the_jax_kernels_and_the_oracle(name):
    ins = _inputs(name)
    want = jops.apply(J_FAM[name][0], *map(jnp.asarray, ins),
                      interpret=True, out_dtype=jnp.float32)
    for table in (TPU_V5E, H100):
        got = ops.apply(P_FAM[name][0], *map(torch.from_numpy, ins),
                        out_dtype=torch.float32, hardware=table)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(name, got, want)
    onf_out = _onf(name, ins).reshape(np.asarray(want).shape)
    _close(name, got, onf_out)
    # the direct (DNF) evaluator agrees with the reference's
    _close(name, ref.eval_expr(P_FAM[name][0], *map(torch.from_numpy, ins)),
           jref.eval_expr(J_FAM[name][0], *map(jnp.asarray, ins)))


@pytest.mark.parametrize("m,k,n", [(13, 7, 9), (100, 70, 30)])
@pytest.mark.parametrize("plus", ["max", "min"])
def test_semiring_matmul_and_moa_gemm_match(m, k, n, plus):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = ops.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              plus=plus, times="add")
    want = jops.semiring_matmul(jnp.asarray(a), jnp.asarray(b), plus=plus,
                                times="add", interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gm = ops.moa_gemm(torch.from_numpy(a), torch.from_numpy(b))
    wm = jops.moa_gemm(jnp.asarray(a), jnp.asarray(b), interpret=True)
    assert np.max(np.abs(gm.numpy() - np.asarray(wm))) <= 5e-5 * k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["K1", "K9"])
def test_apply_takes_strided_views(route, dtype, monkeypatch):
    """A transposed view and a column slice ``x[:, :k]`` of a wider array
    bind like their contiguous copies on both routes, and reach the kernel
    wrappers (``_product`` for K1, ``semiring_contract`` for K9) as
    contiguous buffers, which the card's kernels require; the results
    match the JAX entry on the same values."""
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.standard_normal((13, 7)).astype(np.float32))
    bt = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    wide = torch.from_numpy(rng.standard_normal((13, 12)).astype(np.float32))
    a, bt, wide = a.to(dtype), bt.to(dtype), wide.to(dtype)
    x = wide[:, :7]
    assert not bt.t().is_contiguous() and not x.is_contiguous()
    seen = []
    for name in ("_product", "semiring_contract"):
        def spy(*args, _fn=getattr(ops, name), **kw):
            seen.append(all(t.is_contiguous() for t in args
                            if isinstance(t, torch.Tensor)))
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    if route == "K1":
        call = lambda p, q: ops.moa_gemm(p, q, out_dtype=torch.float32)
        jcall = lambda p, q: jops.moa_gemm(p, q, interpret=True,
                                           out_dtype=jnp.float32)
    else:
        call = lambda p, q: ops.semiring_matmul(p, q, plus="max",
                                                times="add")
        jcall = lambda p, q: jops.semiring_matmul(p, q, plus="max",
                                                  times="add",
                                                  interpret=True)
    for lhs in (a, x):
        got = call(lhs, bt.t())
        assert torch.equal(got, call(lhs.contiguous(), bt.t().contiguous()))
        want = jcall(jnp.asarray(lhs.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
            jnp.asarray(bt.t().float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
        tol = 0.0 if route == "K9" else 5e-5 * 7
        assert np.max(np.abs(got.float().numpy() - np.asarray(
            want, dtype=np.float32))) <= tol
    assert len(seen) == 4 and all(seen)


@pytest.mark.parametrize("mode", ["ip", "op", "kp", "hp"])
def test_ipophp_outer_kron_hadamard_match(mode):
    rng = np.random.default_rng(7)
    shapes = {"ip": ((6, 5), (5, 7)), "hp": ((6, 5), (6, 5))}.get(
        mode, ((4, 3), (5, 2)))
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    got = ops.ipophp(torch.from_numpy(a), torch.from_numpy(b), mode)
    want = jops.ipophp(jnp.asarray(a), jnp.asarray(b), mode, interpret=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 5e-5 * 5 if mode == "ip" else 0.0
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= tol
    np.testing.assert_allclose(
        ref.ipophp_ref(torch.from_numpy(a), torch.from_numpy(b), mode),
        np.asarray(jref.ipophp_ref(jnp.asarray(a), jnp.asarray(b), mode)),
        rtol=0, atol=tol)
    if mode == "kp":            # written in place: one K9 normal form
        nf = PE.normal_form(PE.transpose(ops._outer_expr(4, 3, 5, 2),
                                         (0, 2, 1, 3)))
        assert ops._plan(nf, ("float32",) * 2, torch.float32, H100, None,
                         "float32")[0] == "K9"


def test_bf16_operands_and_out_dtype():
    """bf16 storage is widened exactly and the result cast once, as the
    reference's f32 accumulation: bit for bit on the tropical form."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((20, 30)).astype(np.float32)
    b = rng.standard_normal((30, 10)).astype(np.float32)
    ab, bb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = ops.semiring_matmul(ab, bb, plus="max", times="add")
    want = jops.semiring_matmul(jnp.asarray(a, jnp.bfloat16),
                                jnp.asarray(b, jnp.bfloat16), plus="max",
                                times="add", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    a2 = torch.from_numpy(rng.standard_normal((20, 30)).astype(np.float32))
    a2 = a2.to(torch.bfloat16)
    h = ops.hadamard(ab, a2)
    assert h.dtype == torch.bfloat16
    assert torch.equal(h, (ab.float() * a2.float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_errors_match_the_reference():
    rng = np.random.default_rng(5)
    aligned = PE.inner("max", "mul", PE.arr("A", (128, 128)),
                       PE.arr("B", (128, 128)))
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    got = ops.apply(aligned, torch.from_numpy(a), torch.from_numpy(b),
                    out_dtype=torch.float32, hardware=TPU_V5E)
    want = jops.apply(JE.inner("max", "mul", JE.arr("A", (128, 128)),
                               JE.arr("B", (128, 128))), jnp.asarray(a),
                      jnp.asarray(b), interpret=True, out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ragged = PE.inner("max", "mul", PE.arr("A", (100, 70)),
                      PE.arr("B", (70, 30)))
    with pytest.raises(ValueError, match="pad"):
        ops.apply(ragged, torch.zeros(100, 70), torch.zeros(70, 30),
                  hardware=TPU_V5E)
    with pytest.raises(ValueError, match="pad"):
        jops.apply(JE.inner("max", "mul", JE.arr("A", (100, 70)),
                            JE.arr("B", (70, 30))), jnp.zeros((100, 70)),
                   jnp.zeros((70, 30)), interpret=True)
    bad = PE.combine("add", PE.reduce("add", PE.arr("A", (3, 4)), axis=1),
                     PE.arr("B", (3,)))
    with pytest.raises(ValueError, match="distribute"):
        PE.normalize(bad)
    with pytest.raises(ValueError, match="mixes combine"):
        PE.normalize(PE.combine("add", PE.combine(
            "mul", PE.arr("A", (3, 4)), PE.arr("B", (3, 4))),
            PE.arr("A", (3, 4))))
    with pytest.raises(ValueError, match="contraction mismatch"):
        PE.inner("add", "mul", PE.arr("A", (3, 4)), PE.arr("B", (5, 2)))
    expr = PE.matmul_expr(4, 6, 5)
    with pytest.raises(ValueError, match="leaves"):
        ops.apply(expr, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="storage shape"):
        ops.apply(expr, torch.zeros(4, 6), torch.zeros(5, 6))
    col = PE.inner("add", "mul", PE.arr("A", (4, 6)),
                   PE.arr("B", (6, 8), layout="col"))
    with pytest.raises(ValueError, match="storage shape"):
        ops.apply(col, torch.zeros(4, 6), torch.zeros(6, 8))
    # the sharded path derives its per-shard blocks (the reference's
    # test_apply_rejects_blocks_on_sharded_path): pinned blocks raise
    with pytest.raises(ValueError, match="blocks"):
        ops.apply(expr, torch.zeros(4, 6), torch.zeros(6, 5), mesh=object(),
                  shard={"i": "x"}, blocks=(64, 64, 64))
    # apply(verify=) runs the static verifier (it raised before the port
    # had one): a sound derivation passes and the result is unchanged
    x, w = torch.arange(24.).reshape(4, 6), torch.arange(30.).reshape(6, 5)
    assert torch.equal(ops.apply(expr, x, w, verify=True),
                       ops.apply(expr, x, w))
    with pytest.raises(ValueError, match="accumulation"):
        ops.apply(expr, torch.zeros(4, 6, dtype=torch.bfloat16),
                  torch.zeros(6, 5, dtype=torch.bfloat16),
                  acc_dtype="bfloat16")


# ---------------------------------------------------------------------------
# K9's launch descriptor and the plain fold
# ---------------------------------------------------------------------------

def _launch(name):
    nf = PE.normal_form(P_FAM[name][0])
    plan = ops._plan(nf, ("float32",) * len(nf.leaves), torch.float32,
                     H100, None, "float32")
    return plan


@pytest.mark.parametrize("name", FAMILIES)
def test_descriptor_drives_a_strided_executor(name):
    """What K9 is given, run through ``torch.as_strided`` over exactly the
    logical extents (no padding, no copy), equals the reference's padded
    Pallas kernel; K1's forms route to K1."""
    plan = _launch(name)
    assert (plan[0] == "K1") == (name in K1_FORMS)
    if plan[0] == "K1":
        return
    launch = plan[1]
    ins = _inputs(name)
    got = emit.run_descriptor(launch, *map(torch.from_numpy, ins),
                              out_dtype=torch.float32)
    want = jops.apply(J_FAM[name][0], *map(jnp.asarray, ins),
                      interpret=True, out_dtype=jnp.float32)
    _close(name, got, want)
    d = launch.c_struct((torch.float32,) * len(ins), torch.float32,
                        (0,) * len(ins))
    assert d.n_in == len(ins) and d.n_red == len(launch.red_ext)


def test_descriptor_reads_col_and_psi_leaves_in_place():
    """A col-layout B carries its column-gamma coefficients (stride 1 on
    the contracted axis, k on the out axis), a psi slab its base offset,
    and the masking is past the logical extents (no block padding)."""
    col = _launch("max_plus_col")[1]
    assert col.out_axes == ("i", "j") and col.red_axes == ("k",)
    assert col.operands[1].strides == (0, 7, 1)      # B stored (13, 7)
    assert col.operands[0].strides == (7, 0, 1)
    assert col.mode == emit.TILE and col.roles == (0, 1)
    psi = _launch("min_plus_psi")[1]
    assert psi.operands[0].base == 1 * 20 * 30 and \
        psi.operands[0].strides == (30, 0, 1)
    assert psi.out_ext == (20, 17) and psi.red_ext == (30,)
    assert psi.pad_value == float("inf")             # padded on the v5e grid
    d = psi.c_struct((torch.float32, torch.float32), torch.bfloat16, (0, 0))
    assert list(d.out_ext) == [1, 1, 20, 17] and list(d.red_ext) == [1, 1, 30]
    assert d.base[0] == 600 and list(d.stride[0])[:7] == [0, 0, 30, 0, 0, 0, 1]
    assert d.out_dtype == 1
    chain = _launch("chain")[1]
    assert chain.mode == emit.CHAIN and len(chain.operands) == 3
    assert _launch("lone_max")[1].mode == emit.REDUCE
    assert _launch("lone_min")[1].mode == emit.REDUCE
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        col.c_struct((torch.float16, torch.float32), torch.float32, (0, 0))


@pytest.mark.parametrize("plus,times", [("max", "add"), ("min", "add"),
                                        ("add", "add"), ("max", "mul")])
@pytest.mark.parametrize("slab", [1, 7, 10**9])
def test_slab_fold_equals_the_whole_broadcast(plus, times, slab):
    """The plain fold walks the contraction in slabs so the card can hold
    it at 8192^3: any slab gives the unsliced broadcast (bit for bit for
    max / min, to rounding for add)."""
    g = torch.Generator().manual_seed(11)
    a, b = torch.randn(9, 23, generator=g), torch.randn(23, 6, generator=g)
    nf = PE.normal_form(PE.inner(plus, times, PE.arr("A", (9, 23)),
                                 PE.arr("B", (23, 6))))
    got = ref.eval_nf(nf, a, b, slab_elems=slab * 9 * 6)
    pair = a[:, :, None] + b[None] if times == "add" else a[:, :, None] * b[None]
    want = {"max": lambda x: x.amax(1), "min": lambda x: x.amin(1),
            "add": lambda x: x.sum(1)}[plus](pair)
    if plus == "add":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        assert torch.equal(got, want)
    chain = PE.inner("max", "add", PE.inner("max", "add",
                                            PE.arr("A", (9, 23)),
                                            PE.arr("B", (23, 6))),
                     PE.arr("C", (6, 4)))
    c = torch.randn(6, 4, generator=g)
    # joint axes (i, j, k, k1): A[i, k1] + B[k1, k], then + C[k, j]
    whole = ((a[:, None, None, :] + b.t()[None, None])
             + c.t()[None, :, :, None]).amax(dim=(2, 3))
    got = ref.eval_nf(PE.normal_form(chain), a, b, c, slab_elems=slab)
    assert torch.equal(got, whole)
