"""The forms K1 / K9 used to refuse, held to the JAX package on the CPU:
int8 operands under an int32 accumulator on every (mul, add) form that
K1's int8 form does not take (K9's integer accumulator), K9 past its old
rank limits (more out axes, more unmergeable contracted axes, more
operands), and float16 operands under the f32 accumulator.

Inputs are drawn from a seed with numpy; the reference runs its Pallas
kernels with ``interpret=True``.  Each form's launch descriptor
(``emit.Launch``) and its C struct build here without a card; the card's
kernels are held to their plain versions in ``tests/test_torch_kernels.py``
(``-k "int32 or wide or float16"``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import expr as JE  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import expr as PE  # noqa: E402
from repro_torch.hardware import H100  # noqa: E402
from repro_torch.kernels import emit, ops  # noqa: E402


def _int_forms(E):
    """(label) -> (expr, storage shapes, K9's path) of the (mul, add) forms
    whose int8 x int8 -> int32 product K9 takes."""
    A = E.arr
    return {
        "head": (E.head_gemm_expr(3, 5, 40, 17), [(5, 3, 40), (40, 3, 17)],
                 emit.TILE),
        "head_tb": (E.head_gemm_expr(3, 5, 40, 17, transpose_b=True),
                    [(5, 3, 40), (17, 3, 40)], emit.TILE),
        # a batched product with a transposed B: no form of K1's
        "batched": (E.inner("add", "mul", A("X", (3, 20, 33)),
                            E.transpose(A("W", (3, 17, 33)), (0, 2, 1)),
                            batch=1), [(3, 20, 33), (3, 17, 33)], emit.TILE),
        "hadamard": (E.hadamard_expr(37, 70), [(37, 70), (37, 70)],
                     emit.MAP),
        "kron": (E.transpose(E.inner("add", "mul", A("A", (3, 4, 1)),
                                     A("B", (1, 5, 6))), (0, 2, 1, 3)),
                 [(3, 4, 1), (1, 5, 6)], emit.MAP),
        "lone_sum_rows": (E.reduce("add", A("A", (9, 300)), 1), [(9, 300)],
                          emit.REDUCE),
        "lone_sum_cols": (E.reduce("add", A("A", (300, 9)), 0), [(300, 9)],
                          emit.REDUCE),
        "thread": (E.reduce("add", E.reduce("add", A("A", (6, 7, 40)), 2), 0),
                   [(6, 7, 40)], emit.THREAD),
        "chain": (A("A", (5, 6)) @ A("B", (6, 7)) @ A("C", (7, 8)),
                  [(5, 6), (6, 7), (7, 8)], emit.CHAIN),
        "psi": (E.inner("add", "mul", E.psi((1,), A("S", (3, 20, 30))),
                        A("B", (30, 17))), [(3, 20, 30), (30, 17)],
                emit.TILE),
    }


J_INT, P_INT = _int_forms(JE), _int_forms(PE)


def _ints(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-128, 128, s).astype(np.int8) for s in shapes]


def _plan(expr, dtypes, acc="float32", out=torch.float32):
    nf = PE.normal_form(expr)
    return nf, ops._plan(nf, tuple(dtypes), out, H100, None, acc)


@pytest.mark.parametrize("out", ["int32", "float32"])
@pytest.mark.parametrize("name", sorted(J_INT))
def test_int32_forms_match_the_reference_bit_for_bit(name, out):
    """int8 x int8 under an int32 accumulator on K9's paths: the port (its
    plain version here) equals the reference's interpret-mode kernel bit
    for bit, into int32 and into f32; K9's descriptor takes the integer
    accumulator, and run through ``torch.as_strided`` gives the same
    values."""
    expr_j, shapes, path = J_INT[name]
    expr_p = P_INT[name][0]
    ins = _ints(shapes, len(name))
    want = jops.apply(expr_j, *map(jnp.asarray, ins), acc_dtype="int32",
                      out_dtype=getattr(jnp, out), interpret=True)
    got = ops.apply(expr_p, *map(torch.from_numpy, ins), acc_dtype="int32",
                    out_dtype=getattr(torch, out), verify="kernel")
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nf, plan = _plan(expr_p, ["int8"] * len(ins), "int32",
                     getattr(torch, out))
    assert plan[0] == "K9" and plan[1].mode == path
    launch = plan[1]
    descs = launch.c_descs((torch.int8,) * len(ins), getattr(torch, out),
                           (0,) * len(ins))
    assert all(d.acc == 1 for d in descs)
    assert [d.out_dtype for d in descs][-1] == emit.DTYPE_CODE[
        getattr(torch, out)]
    if not launch.stages:
        run = emit.run_descriptor(launch, *map(torch.from_numpy, ins),
                                  out_dtype=torch.int32)
        # every sum here is below 2^24: exact in the f32 output too
        np.testing.assert_array_equal(
            run.reshape(nf.out_shape()).numpy().astype(np.float64),
            np.asarray(want).astype(np.float64))


def test_int32_chain_stages_through_an_int32_scratch():
    """The chain's two integer TILE stages meet through an int32 scratch;
    run stage by stage they give the reference's product exactly."""
    expr_j, shapes, _ = J_INT["chain"]
    ins = _ints(shapes, 3)
    nf, plan = _plan(P_INT["chain"][0], ["int8"] * 3, "int32", torch.int32)
    s1, s2 = plan[1].stages
    d1, d2 = plan[1].c_descs((torch.int8,) * 3, torch.int32, (0, 0, 0))
    assert d1.dst == 1 and d1.out_dtype == emit.DTYPE_CODE[torch.int32]
    assert list(d2.in_dtype)[:2] == [emit.DTYPE_CODE[torch.int32],
                                     emit.DTYPE_CODE[torch.int8]]
    a, b, c = map(torch.from_numpy, ins)
    t = emit.run_descriptor(s1, a, b, out_dtype=torch.int32)
    got = emit.run_descriptor(s2, t.contiguous(), c, out_dtype=torch.int32)
    want = jops.apply(expr_j, *map(jnp.asarray, ins), acc_dtype="int32",
                      out_dtype=jnp.int32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_overflow_raises_on_the_plain_version():
    """K1's int8 form's rule: the plain version checks its exact sums into
    int32 and raises past its range (the card's int32 sums wrap)."""
    big = torch.full((1, 2 ** 17 + 8), -128, dtype=torch.int8)
    with pytest.raises(OverflowError):
        ops.apply(PE.reduce("add", PE.hadamard_expr(1, 2 ** 17 + 8), 1),
                  big, big, acc_dtype="int32", out_dtype=torch.int32)


def test_int32_refused_off_mul_add():
    """An int32 accumulator is the (mul, add) semiring's only: a tropical
    int8 form raises the registry's error on both packages, a chain (which
    derives no schedule) too."""
    a = torch.zeros(4, 6, dtype=torch.int8)
    b = torch.zeros(6, 5, dtype=torch.int8)
    expr = PE.inner("max", "add", PE.arr("A", (4, 6)), PE.arr("B", (6, 5)))
    with pytest.raises(ValueError, match="only defined for the"):
        ops.apply(expr, a, b, acc_dtype="int32")
    chain = PE.inner("max", "add", PE.inner("max", "add", PE.arr("A", (4, 6)),
                                            PE.arr("B", (6, 5))),
                     PE.arr("C", (5, 3)))
    with pytest.raises(ValueError, match="only defined for the"):
        ops.apply(chain, a, b, torch.zeros(5, 3, dtype=torch.int8),
                  acc_dtype="int32")


# ---------------------------------------------------------------------------
# K9 past its old rank limits (4 out axes, 3 contracted axes, 3 operands)
# ---------------------------------------------------------------------------

def _wide_forms(E):
    """(label) -> (expr, storage shapes, (out axes, contracted axes,
    operands) of K9's descriptor, path)."""
    A = E.arr
    hada = lambda n, s: E.combine("mul", hada(n - 1, s) if n > 2 else
                                  A("H0", s), A(f"H{n - 1}", s))
    chain = lambda n, d: (A("M0", (d[0], d[1])) if n == 1 else
                          chain(n - 1, d) @ A(f"M{n - 1}", (d[n - 1], d[n])))
    # A[i, a, b, c, d] . B[d, c, b, a, j] over (a, b, c, d): a, b, c as
    # batch axes of an inner over d, then folded one by one
    at = E.transpose(A("A", (6, 3, 4, 5, 2)), (1, 2, 3, 0, 4))
    bt = E.transpose(A("B", (2, 5, 4, 3, 7)), (3, 2, 1, 0, 4))
    red4 = E.inner("add", "mul", at, bt, batch=3)
    for _ in range(3):
        red4 = E.reduce("add", red4, 0)
    nine = (2, 3, 2, 2, 3, 2, 2, 2, 3)
    return {
        # the outer product of (4, 5, 6) and (3, 2, 7), axes interleaved:
        # 6 out axes, none composing
        "kron6": (E.transpose(E.inner("add", "mul", A("A", (4, 5, 6, 1)),
                                      A("B", (1, 3, 2, 7))),
                              (0, 3, 1, 4, 2, 5)),
                  [(4, 5, 6, 1), (1, 3, 2, 7)], (6, 1, 2), emit.MAP),
        "red4": (red4, [(6, 3, 4, 5, 2), (2, 5, 4, 3, 7)], (2, 4, 2),
                 emit.THREAD),
        "chain4": (chain(4, (5, 6, 7, 8, 9)),
                   [(5, 6), (6, 7), (7, 8), (8, 9)], (2, 3, 4), emit.THREAD),
        "hadamard4": (hada(4, (13, 70)), [(13, 70)] * 4, (2, 0, 4),
                      emit.MAP),
        # past MAX_IN operands: two stages through the scratch
        "hadamard5": (hada(5, (13, 70)), [(13, 70)] * 5, (2, 0, 5),
                      emit.FACTOR),
        "chain5": (chain(5, (3, 4, 5, 6, 4, 3)),
                   [(3, 4), (4, 5), (5, 6), (6, 4), (4, 3)], (2, 1, 5),
                   emit.FACTOR),
        # past MAX_OUT out axes: a row-major pairing merges them into one
        "hadamard9d": (E.combine("mul", A("A", nine), A("B", nine)),
                       [nine, nine], (1, 0, 2), emit.MAP),
    }


J_WIDE, P_WIDE = _wide_forms(JE), _wide_forms(PE)
#: f32 sums in another order than XLA's einsum: relative to the largest
#: entry's sum of magnitudes
WIDE_REL = 1e-6


def _floats(shapes, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _run_stages(launch, arrays, out_dtype=torch.float32):
    """A staged launch (CHAIN, FACTOR) stage by stage through
    ``run_descriptor``: the first into T, the second from T and the
    rest."""
    if not launch.stages:
        return emit.run_descriptor(launch, *arrays, out_dtype=out_dtype)
    s1, s2 = launch.stages
    t = emit.run_descriptor(s1, *(arrays[s] for s in s1.srcs),
                            out_dtype=torch.float32).contiguous()
    bufs = {emit.SRC_TMP: t, **dict(enumerate(arrays))}
    return emit.run_descriptor(s2, *(bufs[s] for s in s2.srcs),
                               out_dtype=out_dtype)


@pytest.mark.parametrize("name", sorted(J_WIDE))
def test_wide_forms_match_the_reference(name):
    """K9's wide forms: the port's value equals the reference's within
    ``WIDE_REL``; the descriptor has the stated ranks after merging, takes
    the stated path, packs into the widened C struct (each stage of a
    staged one), and its ``torch.as_strided`` run gives the value too."""
    expr_j, shapes, ranks, path = J_WIDE[name]
    expr_p = P_WIDE[name][0]
    ins = _floats(shapes, len(name))
    want = np.asarray(jops.apply(expr_j, *map(jnp.asarray, ins),
                                 interpret=True, out_dtype=jnp.float32))
    mag = np.asarray(jops.apply(expr_j, *(jnp.abs(jnp.asarray(x))
                                          for x in ins),
                                interpret=True, out_dtype=jnp.float32))
    tol = WIDE_REL * max(float(mag.max()), 1.0) + 1e-6
    got = ops.apply(expr_p, *map(torch.from_numpy, ins),
                    out_dtype=torch.float32, verify="kernel")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    nf, plan = _plan(expr_p, ["float32"] * len(ins))
    launch = plan[1]
    assert plan[0] == "K9" and launch.mode == path
    top = launch.stages[-1] if launch.mode == emit.FACTOR else launch
    assert (len(top.out_ext), len(top.red_ext), len(launch.operands)) == \
        ranks
    descs = launch.c_descs((torch.float32,) * len(ins), torch.float32,
                           (0,) * len(ins), 0)
    assert len(descs) == (2 if launch.stages else 1)
    run = _run_stages(launch, [torch.from_numpy(x) for x in ins])
    np.testing.assert_allclose(run.reshape(want.shape).numpy(), want,
                               rtol=0, atol=tol)


def test_too_wide_a_form_raises_naming_it():
    """Past two stages (more than 2 MAX_IN - 1 operands), K9 refuses the
    form at launch, naming it; the CPU's plain version still computes
    it."""
    E = PE
    n = 2 * emit.MAX_IN
    expr = E.arr("H0", (3, 4))
    for i in range(1, n):
        expr = E.combine("mul", expr, E.arr(f"H{i}", (3, 4)))
    nf, plan = _plan(expr, ["float32"] * n)
    with pytest.raises(ValueError, match=repr(nf.name)):
        plan[1].c_descs((torch.float32,) * n, torch.float32, (0,) * n)
    ins = [torch.full((3, 4), 2.0)] * n
    assert torch.equal(ops.apply(expr, *ins), torch.full((3, 4), 2.0 ** n))


def _chain_expr(E, n, edge, plus="add", times="mul"):
    """An n-matrix chain of square (edge, edge) leaves under the semiring."""
    expr = E.arr("M0", (edge, edge))
    for i in range(1, n):
        expr = E.inner(plus, times, expr, E.arr(f"M{i}", (edge, edge)))
    return expr


def test_factor_first_stage_folds_what_the_rest_does_not_read():
    """A 5-matrix chain at a realistic edge (512): FACTOR's first stage
    folds the three contracted axes that only its four operands walk, so
    T is one (512, 512) matrix (not the 512^5 outer product), stage 2 is
    one TILE product of T and the last leaf, and the scratch fits the
    card (the descriptor without a derived schedule: the H100 table's
    derivation refuses this contracted volume before K9); the same chain
    at a small edge equals the reference."""
    n = 512
    launch = emit.describe(None, PE.normal_form(_chain_expr(PE, 5, n)))
    assert launch.mode == emit.FACTOR
    s1, s2 = launch.stages
    assert launch.tmp_elems == n * n and s1.out_ext == (n, n)
    assert s1.red_ext == (n, n, n) and s1.mode == emit.THREAD
    assert s2.mode == emit.TILE and s2.red_ext == (n,)
    emit.check_scratch(launch, H100.hbm.capacity_bytes)
    descs = launch.c_descs((torch.float32,) * 5, torch.float32, (0,) * 5, 0)
    assert [d.dst for d in descs] == [1, 0]
    ins = _floats([(4, 4)] * 5, 5)
    want = np.asarray(jops.apply(_chain_expr(JE, 5, 4), *map(jnp.asarray, ins),
                                 interpret=True, out_dtype=jnp.float32))
    small = _plan(_chain_expr(PE, 5, 4), ["float32"] * 5)[1][1]
    run = _run_stages(small, [torch.from_numpy(x) for x in ins])
    np.testing.assert_allclose(run.numpy(), want, rtol=0,
                               atol=WIDE_REL * float(np.abs(want).max()) * 16)


def test_factor_scratch_past_the_card_raises_naming_the_form():
    """Where the combine does not distribute over the reduce ((add, add)
    here), FACTOR's first stage folds nothing: T is the outer product of
    the axes its four operands walk.  A scratch past ``SCRATCH_SHARE`` of
    the card's memory (a 5-operand Hadamard of (2^17, 2^17): a 64 GiB T)
    is refused with a ``ValueError`` naming the form, before any
    allocation; at (2^12, 2^12) it is taken."""
    walk = lambda k: emit.Operand(f"X{k}", (64, 512), (512,) + tuple(
        1 if j == k else 0 for j in range(4)), 0)
    opers = tuple(walk(k) for k in range(4)) + (
        emit.Operand("X4", (64,), (1, 0, 0, 0, 0), 0),)
    flat = emit._describe_nest(None, ("i",), (64,), tuple("abcd"),
                               (512,) * 4, opers, "add", "add", 0.0)
    assert flat.mode == emit.FACTOR and flat.stages[0].red_ext == ()
    assert flat.tmp_elems == 64 * 512 ** 4
    big = 2 ** 17
    hada = lambda n, s: PE.combine("mul", hada(n - 1, s) if n > 2 else
                                   PE.arr("H0", s), PE.arr(f"H{n - 1}", s))
    nf = PE.normal_form(hada(5, (big, big)))
    launch = emit.describe(None, nf)
    assert launch.mode == emit.FACTOR and launch.tmp_elems == big * big
    with pytest.raises(ValueError, match=repr(nf.name)):
        emit.check_scratch(launch, H100.hbm.capacity_bytes)
    emit.check_scratch(emit.describe(None, PE.normal_form(
        hada(5, (2 ** 12, 2 ** 12)))), H100.hbm.capacity_bytes)


def test_merge_out_keeps_every_operands_access():
    """A row-major pairing past ``MAX_OUT`` out axes merges into one axis
    of stride 1 (its value is held in ``test_wide_forms_match_the_
    reference``), and axes that do not compose in one operand stay
    apart."""
    nine = (2, 3, 2, 2, 3, 2, 2, 2, 3)
    nf = PE.normal_form(P_WIDE["hadamard9d"][0])
    axes, ext, red_axes, red_ext, opers = emit._nest(nf)
    assert ext == (int(np.prod(nine)),) and opers[0].strides == (1,)
    o = (emit.Operand("A", (4, 5), (5, 0, 1), 0),
         emit.Operand("B", (5, 6), (0, 6, 1), 0))
    merged = emit.merge_out(("i", "j", "k"), (4, 6, 5), o)
    assert merged[1] == (4, 6, 5)            # nothing composes in both


# ---------------------------------------------------------------------------
# float16 operands under the f32 accumulator
# ---------------------------------------------------------------------------

def _f16_forms(E):
    A = E.arr
    return {
        "moa_gemm": (E.matmul_expr(37, 70, 45), [(37, 70), (70, 45)]),
        "max_plus": (E.inner("max", "add", A("A", (37, 70)),
                             A("B", (70, 45))), [(37, 70), (70, 45)]),
        "hadamard": (E.hadamard_expr(37, 70), [(37, 70), (37, 70)]),
        "lone_sum": (E.reduce("add", A("A", (9, 300)), 1), [(9, 300)]),
        "head": (E.head_gemm_expr(3, 5, 40, 17), [(5, 3, 40), (40, 3, 17)]),
    }


J_F16, P_F16 = _f16_forms(JE), _f16_forms(PE)
#: float16 values are exact in f32; the sums' order differs from XLA's:
#: relative to the largest entry's sum of magnitudes (and an f16 output's
#: own rounding, 2^-11)
F16_REL = 1e-6


@pytest.mark.parametrize("out", ["float32", "float16"])
@pytest.mark.parametrize("name", sorted(J_F16))
def test_float16_forms_match_the_reference(name, out):
    """float16 operands run under the f32 accumulator on K9 (``_plan``
    routes every float16 form there: K1 has no float16 form); the port
    equals the reference within ``F16_REL`` (max-plus bit for bit), and
    the descriptor loads float16 (dtype code 2)."""
    expr_j, shapes = J_F16[name]
    ins = _floats(shapes, len(name), np.float16)
    want = np.asarray(jops.apply(expr_j, *map(jnp.asarray, ins),
                                 interpret=True, out_dtype=getattr(jnp, out)))
    got = ops.apply(P_F16[name][0], *map(torch.from_numpy, ins),
                    out_dtype=getattr(torch, out), verify="kernel")
    assert got.dtype == getattr(torch, out)
    if name == "max_plus":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        mag = np.asarray(jops.apply(expr_j, *(jnp.abs(jnp.asarray(x))
                                              for x in ins),
                                    interpret=True, out_dtype=jnp.float32))
        tol = F16_REL * float(mag.max())
        if out == "float16":
            tol += 2.0 ** -11 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy().astype(np.float32),
                                   want.astype(np.float32), rtol=0, atol=tol)
    nf, plan = _plan(P_F16[name][0], ["float16"] * len(ins), "float32",
                     getattr(torch, out))
    assert plan[0] == "K9"
    d = plan[1].c_descs((torch.float16,) * len(ins), getattr(torch, out),
                        (0,) * len(ins))[0]
    assert list(d.in_dtype)[:len(ins)] == [2] * len(ins) and d.acc == 0
