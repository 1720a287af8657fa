"""The forms K1 / K9 used to refuse, held to the JAX package on the CPU:
int8 operands under an int32 accumulator on every (mul, add) form that
K1's int8 tile and int8 decode rows do not take (K9's integer
accumulator), and on the head form K1's int8 decode rows take, K9 past its old
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
    whose int8 x int8 -> int32 product K9 takes, and the forms K1 takes
    (its plan in place of a path): the stack with B transposed, and the
    head form at k = 64 (K1's int8 decode rows; at k = 40, no multiple of
    32, the head form stays on K9)."""
    A = E.arr
    return {
        "head": (E.head_gemm_expr(3, 5, 40, 17), [(5, 3, 40), (40, 3, 17)],
                 emit.TILE),
        "head_tb": (E.head_gemm_expr(3, 5, 40, 17, transpose_b=True),
                    [(5, 3, 40), (17, 3, 40)], emit.TILE),
        "head_k1": (E.head_gemm_expr(3, 4, 64, 32), [(4, 3, 64), (64, 3, 32)],
                    ("K1", False, False, "head")),
        "head_k1_tb": (E.head_gemm_expr(3, 4, 64, 17, transpose_b=True),
                       [(4, 3, 64), (17, 3, 64)],
                       ("K1", False, True, "head")),
        # a batched product with a transposed B: K1's int8 stack (on the
        # card the int8 tile, both operands packed to a pitch of 48, k =
        # 33 being no multiple of 16)
        "batched": (E.inner("add", "mul", A("X", (3, 20, 33)),
                            E.transpose(A("W", (3, 17, 33)), (0, 2, 1)),
                            batch=1), [(3, 20, 33), (3, 17, 33)],
                    ("K1", False, True, True)),
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
    values.  The stack with B transposed is planned on K1 (``("K1",
    False, True, True)``) and equals the reference all the same."""
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
    if isinstance(path, tuple):
        assert plan == path
        return
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


def _int8_stack(E, ta, tb, e=3, m=20, k=33, n=17):
    """An int8 stack ``op(X) (e, m, k) @ op(W) (e, k, n)`` with X stored
    ``(e, k, m)`` where ``ta`` and W ``(e, n, k)`` where ``tb``; its
    storage shapes."""
    xs, ws = (e, k, m) if ta else (e, m, k), (e, n, k) if tb else (e, k, n)
    x, w = E.arr("X", xs), E.arr("W", ws)
    return E.inner("add", "mul", E.transpose(x, (0, 2, 1)) if ta else x,
                   E.transpose(w, (0, 2, 1)) if tb else w, batch=1), [xs, ws]


@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_int8_stacks_take_k1_at_any_transpose(ta, tb, k):
    """Every int8 stack is K1's (``("K1", ta, tb, True)``): the port's
    ``apply`` (the plain version here) equals the reference's
    interpret-mode kernel bit for bit into int32, and the plan checks
    clean (``verify="kernel"``); on the card each is the int8 tile's
    (k = 64 with B transposed reads both operands in place, the others
    pack one or both K-major first)."""
    expr_j, shapes = _int8_stack(JE, ta, tb, k=k)
    expr_p = _int8_stack(PE, ta, tb, k=k)[0]
    ins = _ints(shapes, 7 + k)
    want = jops.apply(expr_j, *map(jnp.asarray, ins), acc_dtype="int32",
                      out_dtype=jnp.int32, interpret=True)
    got = ops.apply(expr_p, *map(torch.from_numpy, ins), acc_dtype="int32",
                    out_dtype=torch.int32, verify="kernel")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, plan = _plan(expr_p, ["int8"] * 2, "int32", torch.int32)
    assert plan == ("K1", ta, tb, True)
    route = ops.expert_route(3, 20, k, 17, "int8", "int8", True, ta, tb)
    assert route == "int8_tile"


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
                 emit.TILE),
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


def _f16_plan_forms(E):
    """(label) -> (expr, storage shapes, dtypes, plan head): float16 forms
    and the route ``_plan`` gives each (K1's form flags, or "K9")."""
    A = E.arr
    ta = E.inner("add", "mul", E.transpose(A("A", (64, 40))), A("B", (64, 48)))
    return {
        "moa_gemm": (E.matmul_expr(40, 64, 48), [(40, 64), (64, 48)],
                     ("float16",) * 2, ("K1", False, False, False)),
        "moa_gemm_tb": (E.matmul_expr(40, 64, 48, transpose_b=True),
                        [(40, 64), (48, 64)], ("float16",) * 2,
                        ("K1", False, True, False)),
        "moa_gemm_ta": (ta, [(64, 40), (64, 48)], ("float16",) * 2,
                        ("K1", True, False, False)),
        # a stored row of 70 elements: TMA cannot read it
        "unreadable_row": (E.matmul_expr(37, 70, 45), [(37, 70), (70, 45)],
                           ("float16",) * 2, "K9"),
        "rows16": (E.matmul_expr(16, 64, 48), [(16, 64), (64, 48)],
                   ("float16",) * 2, "K9"),
        "mixed_f32": (E.matmul_expr(40, 64, 48), [(40, 64), (64, 48)],
                      ("float16", "float32"), "K9"),
        "batched": (E.expert_gemm_expr(3, 40, 64, 48),
                    [(3, 40, 64), (3, 64, 48)], ("float16",) * 2, "K9"),
        "head": (E.head_gemm_expr(3, 40, 64, 48), [(40, 3, 64), (64, 3, 48)],
                 ("float16",) * 2, ("K1", False, False, "head")),
        "max_plus": (E.inner("max", "add", A("A", (40, 64)),
                             A("B", (64, 48))), [(40, 64), (64, 48)],
                     ("float16",) * 2, "K9"),
    }


J_F16P, P_F16P = _f16_plan_forms(JE), _f16_plan_forms(PE)


@pytest.mark.parametrize("name", sorted(J_F16P))
def test_float16_forms_take_k1_tile_or_k9_by_rule(name):
    """``_plan`` sends a 2-D (mul, add) product of two float16 operands
    that TMA reads (with or without transposes, more than 16 rows) to K1's
    tile route, the head form of two float16 operands TMA reads to K1's
    head tile (``ops.head_route`` "tile"), and every other float16 form (an
    unreadable row, m <= 16 in 2-D, float16 beside f32, batched, another
    semiring) to K9; each equals the reference within ``F16_REL`` (max-plus
    bit for bit), and the plan checks clean (``verify="kernel"``)."""
    expr_j, shapes, dtypes, route = J_F16P[name]
    expr_p = P_F16P[name][0]
    ins = [x.astype(np.float32 if dt == "float32" else np.float16)
           for x, dt in zip(_floats(shapes, len(name)), dtypes)]
    want = np.asarray(jops.apply(expr_j, *map(jnp.asarray, ins),
                                 interpret=True, out_dtype=jnp.float32))
    got = ops.apply(expr_p, *map(torch.from_numpy, ins),
                    out_dtype=torch.float32, verify="kernel")
    if name == "max_plus":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        mag = np.asarray(jops.apply(expr_j, *(jnp.abs(jnp.asarray(x))
                                              for x in ins),
                                    interpret=True, out_dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=F16_REL * float(mag.max()))
    nf, plan = _plan(expr_p, dtypes)
    assert plan[:4] == route if route != "K9" else plan[0] == "K9"
    if route != "K9" and route[3] == "head":
        (m, h, k), (_, _, n) = shapes
        assert ops.head_route(h, m, k, n, torch.float16, torch.float16,
                              route[2]) == "tile"
    elif route != "K9":
        k, m = shapes[0] if route[1] else shapes[0][::-1]
        n = shapes[1][0] if route[2] else shapes[1][1]
        assert ops.gemm_route(m, n, k, torch.float16, torch.float16,
                              route[1], route[2]) == "tile"
    # unaligned bases keep even a readable float16 product on K9
    if route != "K9":
        assert _plan_unaligned(expr_p, dtypes)[0] == "K9"


def _plan_unaligned(expr, dtypes):
    return ops._plan(PE.normal_form(expr), tuple(dtypes), torch.float32,
                     H100, None, "float32", False)


# ---------------------------------------------------------------------------
# TILE over several contracted axes that do not merge
# ---------------------------------------------------------------------------

def _reversed(E, i, ext, j, plus="add", times="mul"):
    """``A[i, a1..an] . B[an..a1, j]`` over (a1..an) under the semiring:
    a1..a(n-1) as batch axes of an inner over an, then folded one by one.
    No two contracted axes merge (B walks them in the reverse order)."""
    n = len(ext)
    at = E.transpose(E.arr("A", (i,) + tuple(ext)),
                     tuple(range(1, n)) + (0, n))
    bt = E.transpose(E.arr("B", tuple(reversed(ext)) + (j,)),
                     tuple(range(n - 1, -1, -1)) + (n,))
    expr = E.inner(plus, times, at, bt, batch=n - 1)
    for _ in range(n - 1):
        expr = E.reduce(plus, expr, 0)
    return expr, [(i,) + tuple(ext), tuple(reversed(ext)) + (j,)]


#: label -> (i, contracted extents, j, (plus, times), operand dtype)
WIDE_TILE = {
    "red4": (6, (3, 4, 5, 2), 7, ("add", "mul"), "float32"),
    "red4_maxplus": (4, (2, 3, 2, 2), 5, ("max", "add"), "float32"),
    "red4_int8": (6, (3, 4, 5, 2), 7, ("add", "mul"), "int8"),
    "red4_vec": (130, (4, 4, 4, 4), 140, ("add", "mul"), "float32"),
    "red4_bf16": (40, (2, 3, 8), 33, ("add", "mul"), "bfloat16"),
    "ragged3": (9, (3, 5, 7), 11, ("add", "mul"), "float32"),
    "ragged3_minplus": (9, (3, 5, 7), 11, ("min", "add"), "float32"),
    "red2": (20, (5, 3), 24, ("add", "mul"), "float16"),
    "red6": (5, (2, 3, 2, 2, 3, 2), 6, ("add", "mul"), "float32"),
}


@pytest.mark.parametrize("name", sorted(WIDE_TILE))
def test_wide_tile_forms_match_the_reference(name):
    """Two operands over 2-6 contracted axes that do not merge take TILE:
    K is the flattened contracted volume, split into whole slabs; the
    descriptor carries every contracted slot, and a 16-byte copy along K
    only where the innermost axis holds whole copies.  The port's value
    equals the reference (interpret mode; for max-plus and min-plus its
    normal form's own executor: the reference's interpret-mode schedule
    of such a nest passes its table's VMEM) within ``WIDE_REL`` (max-plus
    and min-plus bit for bit, int8 into int32 exactly), through ``apply``
    (``verify="kernel"``) and through the descriptor's ``torch.as_strided``
    run; ``conformance`` finds nothing."""
    from repro_torch.analysis import conformance
    i, ext, j, (plus, times), dt = WIDE_TILE[name]
    expr_j, shapes = _reversed(JE, i, ext, j, plus, times)
    expr_p, _ = _reversed(PE, i, ext, j, plus, times)
    if dt == "int8":
        ins, acc, out = _ints(shapes, len(name)), "int32", "int32"
    else:
        ins, acc, out = _floats(shapes, len(name)), "float32", "float32"
        if dt != "float32":
            # values the 16-bit type holds exactly, held as f32 for JAX
            ins = [torch.from_numpy(x).to(getattr(torch, dt)).float()
                   .numpy() for x in ins]
    tins = [torch.from_numpy(x).to(getattr(torch, dt)) for x in ins]
    if plus == "add":
        want = np.asarray(jops.apply(expr_j, *map(jnp.asarray, ins),
                                     interpret=True, acc_dtype=acc,
                                     out_dtype=getattr(jnp, out)))
    else:
        o = JE.normalize(expr_j)
        want = o.execute(o.init_out(i * j), *(x.ravel() for x in ins))
        want = want.reshape(i, j).astype(np.float32)
    got = ops.apply(expr_p, *tins, acc_dtype=acc,
                    out_dtype=getattr(torch, out), verify="kernel")
    nf, plan = _plan(expr_p, [dt] * 2, acc, getattr(torch, out))
    launch = plan[1]
    assert plan[0] == "K9" and launch.mode == emit.TILE
    # the normal form's order of the contracted axes, none merged
    red = launch.red_ext
    assert launch.roles == (0, 1) and sorted(red) == sorted(ext)
    volume = int(np.prod(ext))
    assert launch.splits * launch.k_split >= volume
    assert launch.splits == 1 or launch.k_split % emit.TILE_K == 0
    d = launch.c_descs((getattr(torch, dt),) * 2, getattr(torch, out),
                       (0, 0))[0]
    assert d.mode == emit.TILE and d.n_red == len(ext)
    assert list(d.red_ext) == [1] * (emit.MAX_RED - len(ext)) + list(red)
    assert d.k_split == launch.k_split and d.splits == launch.splits
    assert d.acc == int(dt == "int8")
    elems = 16 // emit.ELEM_BYTES[getattr(torch, dt)]
    for op in range(2):
        if d.k_fast[op] and d.vec[op]:
            assert red[-1] % elems == 0 and \
                d.stride[op][emit.MAX_OUT + emit.MAX_RED - 1] == 1
    run = emit.run_descriptor(launch, *tins, out_dtype=got.dtype)
    if plus != "add" or dt == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(run.numpy(), want)
    else:
        mag = np.asarray(jops.apply(expr_j, *(jnp.abs(jnp.asarray(x))
                                              for x in ins),
                                    interpret=True, out_dtype=jnp.float32))
        tol = WIDE_REL * max(float(mag.max()), 1.0) + 1e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(run.numpy(), want, rtol=0, atol=tol)
    bundle = ops.sched_mod.get_schedule(nf, dtype=dt, hardware=H100,
                                        acc_dtype=acc)
    assert conformance.plan_findings(plan, bundle, nf, (dt, dt), acc) == ()
    assert conformance.kernel_findings(bundle, nf, (dt, dt),
                                       acc_dtype=acc) == ()


def test_wide_tile_walk_checks_catch_a_bad_split_and_copy():
    """``conformance``'s walk over TILE's slabs: a split that leaves the
    flattened K's tail unfolded, and a 16-byte copy along a K whose
    innermost extent does not hold whole copies, are both errors."""
    import dataclasses

    from repro_torch.analysis import conformance
    expr, _ = _reversed(PE, 300, (4, 4, 4, 4), 300)
    nf, plan = _plan(expr, ["float32"] * 2)
    launch = plan[1]
    assert launch.splits > 1
    short = dataclasses.replace(launch, k_split=launch.k_split - emit.TILE_K)
    found = conformance._walk_findings("red4", short)
    assert found and found[0].rule == "coverage"
    assert conformance._walk_findings("red4", launch,
                                      ("float32", "float32")) == []
    # A's innermost contracted axis (stride 1) has extent 2: a vector rule
    # that forgot the extent would copy 4 f32 across two runs of it
    expr, _ = _reversed(PE, 300, (4, 4, 4, 2), 300)
    launch = _plan(expr, ["float32"] * 2)[1][1]
    assert conformance._walk_findings("red4", launch,
                                      ("float32", "float32")) == []
    vectors = emit.Launch._vectors

    def forgetful(self, in_dtypes, ptrs):
        k_fast, vec = vectors(self, in_dtypes, ptrs)
        return k_fast, [v or kf for v, kf in zip(vec, k_fast)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(emit.Launch, "_vectors", forgetful)
        found = conformance._walk_findings("red4", launch,
                                           ("float32", "float32"))
    assert [f.rule for f in found] == ["bounds"]
    assert "innermost" in found[0].message


@pytest.mark.parametrize("i,ext,j", [(6, (3, 4, 5, 2), 7),
                                     (5, (2, 3, 2, 2, 3, 2), 6)])
def test_wide_tropical_nest_past_the_derivation_runs_on_tile(i, ext, j):
    """A max-plus nest over 4 or 6 contracted axes whose derived schedule
    (the reference's nest model, its combine materialized) passes the
    H100's 227 KB: ``apply`` refuses it before any kernel on both
    packages' tables, as the reference does; K9 reads no schedule blocks,
    so its descriptor with the semiring's inert element
    (``emit.describe(None, nf)``) runs it on TILE through
    ``ops.semiring_contract``, bit for bit the reference's normal-form
    executor, and checks clean."""
    from repro_torch.analysis import conformance
    expr_j, shapes = _reversed(JE, i, ext, j, "max", "add")
    expr_p, _ = _reversed(PE, i, ext, j, "max", "add")
    ins = _floats(shapes, i + j)
    tins = [torch.from_numpy(x) for x in ins]
    with pytest.raises(ValueError, match="VMEM"):
        ops.apply(expr_p, *tins)
    with pytest.raises(ValueError, match="VMEM"):
        jops.apply(expr_j, *map(jnp.asarray, ins), interpret=True)
    o = JE.normalize(expr_j)
    want = o.execute(o.init_out(i * j), *(x.ravel() for x in ins))
    want = want.reshape(i, j).astype(np.float32)
    nf = PE.normal_form(expr_p)
    launch = emit.describe(None, nf)
    assert launch.mode == emit.TILE and len(launch.red_ext) == len(ext)
    np.testing.assert_array_equal(
        ops.semiring_contract(launch, *tins).numpy(), want)
    np.testing.assert_array_equal(
        emit.run_descriptor(launch, *tins).numpy(), want)
    assert conformance.plan_findings(("K9", launch), None, nf,
                                     ("float32", "float32")) == ()
