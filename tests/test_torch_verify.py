"""The port's static verifier (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU: known-good derivations verify
clean, each seeded defect is flagged under the reference's rule on the
same mutation, strict mode raises, ``apply(verify=...)`` caches, the
``verify_all`` sweep is clean on the H100 table and matches the
reference's v5e cases one for one, and the launch-plan conformance
(``analysis.conformance``) flags each mutated K9 descriptor under its
rule while the plans of every ``[moa_path]`` expression verify clean."""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import analysis as janalysis  # noqa: E402
from repro.core import expr as JE  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import semiring as jsemiring  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import conformance  # noqa: E402
from repro_torch.core import expr as PE  # noqa: E402
from repro_torch.core import schedule as psched  # noqa: E402
from repro_torch.core import semiring as psemiring  # noqa: E402
from repro_torch.hardware import H100, TPU_V5E  # noqa: E402
from repro_torch.kernels import emit, ops  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

JHW = jhw.get_entry("cpu")          # the reference's v5e-shaped entry
SIDES = {"port": (PE, psched, analysis, TPU_V5E),
         "ref": (JE, jsched, janalysis, JHW)}


def _rules(findings):
    return sorted({f.rule for f in findings if f.level == "error"})


def _bundle(side, make, dtype="float32", hardware=None):
    E, sched, _, hw = SIDES[side]
    return sched.get_schedule(make(E), dtype=dtype,
                              hardware=hardware or hw)


def _verify(side, bundle, **kw):
    _, _, an, hw = SIDES[side]
    return an.verify_bundle(bundle, hardware=kw.pop("hardware", hw), **kw)


def _gemm(E):
    # 300/200/160 are off every block multiple: padding on m, n AND k
    return E.matmul_expr(300, 200, 160)


def _min_plus(E):
    return E.inner("min", "add", E.arr("A", (100, 60)), E.arr("B", (60, 80)))


def _max_plus(E):
    return E.inner("max", "add", E.arr("A", (100, 60)), E.arr("B", (60, 80)))


KNOWN_GOOD = [
    lambda E: E.matmul_expr(300, 200, 160),
    lambda E: E.matmul_expr(300, 200, 160, transpose_b=True),
    lambda E: E.expert_gemm_expr(4, 60, 96, 72),
    lambda E: E.hadamard_expr(200, 300),
    lambda E: E.head_gemm_expr(4, 48, 32, 40),
    _max_plus, _min_plus,
    lambda E: E.attention_form(1, 2, 2, 300, 300, 64),
    lambda E: E.attention_stats_form(1, 1, 1, 300, 300, 64),
    lambda E: E.attention_dq_form(1, 1, 1, 300, 300, 64),
    lambda E: E.attention_dkv_form(1, 1, 1, 300, 300, 64),
    lambda E: E.ssd_form(1, 4, 64, 2, 16, 16),
    lambda E: E.ssd_bwd_form(1, 4, 64, 2, 16, 16),
    lambda E: E.rglru_form(1, 4, 64, 32),
]


@pytest.mark.parametrize("i", range(len(KNOWN_GOOD)))
@pytest.mark.parametrize("table", ["v5e", "h100"])
def test_known_good_forms_verify_clean(i, table):
    """The reference's known-good derivations verify clean on both of the
    port's tables, and with no finding at all where the reference has
    none on its v5e entry."""
    make = KNOWN_GOOD[i]
    hw = TPU_V5E if table == "v5e" else H100
    got = _verify("port", _bundle("port", make, hardware=hw), hardware=hw)
    assert not analysis.errors(got), [str(f) for f in got]
    if table == "v5e":
        want = _verify("ref", _bundle("ref", make))
        assert [(f.rule, f.level) for f in got] == \
            [(f.rule, f.level) for f in want]


# ---------------------------------------------------------------------------
# mutation tests: one seeded defect, the reference's rule on both sides
# ---------------------------------------------------------------------------

def _both(mutate, make=_gemm, bundle_kw=None, **kw):
    """Apply ``mutate(bundle)`` to the port's and the reference's bundle
    of the same form and return both sides' error rules."""
    out = []
    for side in ("port", "ref"):
        b = _bundle(side, make, **(bundle_kw or {}))
        out.append(_rules(_verify(side, mutate(b), **kw)))
    return out


def _shift_index_map(b):
    a0 = b.schedule.ins[0]                      # A's m dim is grid-driven
    mut = dataclasses.replace(a0, offsets=(1,) + a0.offsets[1:])
    return dataclasses.replace(b, schedule=dataclasses.replace(
        b.schedule, ins=(mut,) + b.schedule.ins[1:]))


def _drop_reduction(b):
    return dataclasses.replace(b, schedule=dataclasses.replace(
        b.schedule, reduce_grid_dim=None))


def _parallel_reduce_axis(b):
    kd = b.schedule.reduce_grid_dim
    grid = tuple(dataclasses.replace(g, semantics="parallel") if i == kd
                 else g for i, g in enumerate(b.schedule.grid))
    return dataclasses.replace(b, schedule=dataclasses.replace(
        b.schedule, grid=grid))


def _undersized_scratch(b):
    return dataclasses.replace(b, blocks=dataclasses.replace(
        b.blocks, vmem_bytes=64))


def _oversized_out(b):
    out = b.schedule.out
    fat = dataclasses.replace(
        out, block=(out.block[0] * 1024, out.block[1] * 1024),
        shape=(out.shape[0] * 1024, out.shape[1] * 1024))
    return dataclasses.replace(b, schedule=dataclasses.replace(
        b.schedule, out=fat))


@pytest.mark.parametrize("mutate,rule", [
    (_shift_index_map, ["coverage"]),
    (_drop_reduction, ["race"]),
    (_parallel_reduce_axis, ["race"]),
    (_undersized_scratch, ["scratch"]),
])
def test_schedule_mutation_is_flagged_as_in_the_reference(mutate, rule):
    port, ref = _both(mutate)
    assert port == ref == rule
    # on the H100 table too
    b = _bundle("port", _gemm, hardware=H100)
    assert _rules(_verify("port", mutate(b), hardware=H100)) == rule


def test_oversized_working_set_is_resource_defect():
    port, ref = _both(_oversized_out)
    assert "resource" in port and "resource" in ref and port == ref


def test_wrong_min_plus_pad_value_is_pad_value_defect(monkeypatch):
    for side, sr in (("port", psemiring), ("ref", jsemiring)):
        b = _bundle(side, _min_plus)
        assert b.padded != b.shapes                 # k = 60 is padded
        assert not _rules(_verify(side, b))
        # min-plus pads must be +inf; 0.0 contributes 0+0=0 to a min
        monkeypatch.setitem(sr._PAD_VALUES, ("add", "min"), 0.0)
        assert _rules(_verify(side, b)) == ["pad-value"]


def test_unregistered_pad_is_pad_guard_defect(monkeypatch):
    for side, sr in (("port", psemiring), ("ref", jsemiring)):
        b = _bundle(side, _max_plus)
        monkeypatch.delitem(sr._PAD_VALUES, ("add", "max"))
        assert _rules(_verify(side, b)) == ["pad-guard"]


def test_dropped_stream_pad_guard_is_pad_guard_defect():
    def drop(b):
        assert b.padded[-1] != b.shapes[-1]     # sk = 300 padded
        return dataclasses.replace(b, shapes=b.shapes[:-1] + (b.padded[-1],))
    port, ref = _both(drop, make=lambda E: E.attention_form(
        1, 1, 1, 300, 300, 64))
    assert port == ref == ["pad-guard"]


def test_strict_verification_raises_with_findings():
    b = _drop_reduction(_bundle("port", _gemm))
    with pytest.raises(analysis.VerificationError, match="race"):
        analysis.verify_bundle(b, hardware=TPU_V5E, strict=True)
    with pytest.raises(janalysis.VerificationError, match="race"):
        janalysis.verify_bundle(_drop_reduction(_bundle("ref", _gemm)),
                                hardware=JHW, strict=True)


def test_verify_expr_strict_passes_and_caches():
    analysis.reset_verification_cache()
    expr = PE.matmul_expr(300, 200, 160)
    assert not analysis.verify_expr(expr, dtype="float32", hardware=H100)
    s1 = analysis.verification_cache_stats()
    assert not analysis.verify_expr(expr, dtype="float32", hardware=H100)
    s2 = analysis.verification_cache_stats()
    assert s2["hits"] == s1["hits"] + 1 and s2["misses"] == s1["misses"]


@pytest.mark.parametrize("mode", [True, "kernel"])
def test_apply_verify_matches_and_caches(mode):
    """``apply(verify=...)`` returns the unverified result (and the
    reference's, within f32 summation order) and a second call is a cache
    hit."""
    analysis.reset_verification_cache()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 20)).astype(np.float32)
    w = rng.standard_normal((20, 40)).astype(np.float32)
    expr = PE.matmul_expr(30, 20, 40)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = ops.apply(expr, tx, tw, verify=mode)
    assert torch.equal(got, ops.apply(expr, tx, tw))
    want = jops.apply(JE.matmul_expr(30, 20, 40), jnp.asarray(x),
                      jnp.asarray(w), interpret=True, verify=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    before = analysis.verification_cache_stats()
    ops.apply(expr, tx, tw, verify=mode)
    after = analysis.verification_cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]


def test_chain_findings_cache_on_operand_dtypes_and_alignment():
    """A chain is verified by its launch plan, which reads the operands'
    dtypes and bases: without the plan checks too, other dtypes or an
    unaligned base are a cache miss, never another operand set's
    findings."""
    analysis.reset_verification_cache()
    c = 8
    chain = PE.arr("A", (c, c)) @ PE.arr("B", (c, c)) @ PE.arr("C", (c, c))
    calls = [dict(dtypes=("float32",) * 3),
             dict(dtypes=("bfloat16",) * 3),
             dict(dtypes=("float32",) * 3, aligned=False),
             dict(dtypes=("float32",) * 3)]
    stats = []
    for kw in calls:
        assert not analysis.errors(analysis.verify_expr(
            chain, dtype="float32", hardware=H100, **kw))
        stats.append(analysis.verification_cache_stats())
    assert [s["misses"] for s in stats] == [1, 2, 3, 3]
    assert stats[-1]["hits"] == stats[-2]["hits"] + 1


def test_apply_verify_raises_on_an_unsound_derivation(monkeypatch):
    """A seeded defect (min-plus padded with 0.0) makes ``apply(verify=
    True)`` raise before any launch, as the reference's does."""
    analysis.reset_verification_cache()
    psched.reset_schedule_cache()
    ops._PLANS.clear()
    monkeypatch.setitem(psemiring._PAD_VALUES, ("add", "min"), 0.0)
    a, b = torch.zeros(100, 60), torch.zeros(60, 80)
    with pytest.raises(analysis.VerificationError, match="pad-value"):
        ops.apply(_min_plus(PE), a, b, verify=True)
    # the findings of the patched table are cached: drop them with it
    ops._PLANS.clear()
    psched.reset_schedule_cache()
    analysis.reset_verification_cache()


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report(tmp_path_factory):
    from repro_torch.analysis import verify_all
    analysis.reset_verification_cache()
    out = tmp_path_factory.mktemp("verify") / "verify_all.json"
    assert verify_all.main(["--json", str(out)]) == 0
    return json.loads(out.read_text())


def test_verify_all_sweep_is_clean_on_the_h100_table(report):
    """Zero error findings; every form x dtype pair is reported, on both
    tables; the H100 table checks int8 + int32 where the (mul, add)
    semiring takes it and refuses every bf16 accumulation."""
    assert report["sweep"] == "verify_all"
    assert report["failed"] == 0 and report["findings"] == []
    assert report["hardware"] == ["h100", "tpu_v5e"]
    # 20 forms x 4 dtype pairs and the 9 distributed plans, on each table
    assert report["checked"] + report["refused"] == 2 * (20 * 4 + 9)
    assert len(report["cases"]) == 2 * (20 * 4 + 9)
    h = {c: st for c, st in report["cases"].items() if c.startswith("h100")}
    assert all(st == "refused" for c, st in h.items()
               if c.endswith("bfloat16+bfloat16"))
    assert h["h100/matmul/int8+int32"] == "checked"
    assert h["h100/expert_gemm/int8+int32"] == "checked"
    assert h["h100/ssd/int8+int32"] == "refused"        # floating state
    assert h["h100/attention/float32+float32"] == "checked"


def test_verify_all_v5e_cases_match_the_reference(report):
    """Each ``tpu_v5e/<form>/<dtype>+<acc>`` case is checked or refused
    exactly as the reference's sweep decides it on its ``tpu_v5e`` entry
    (its ``verify_expr`` per case), with the same error findings (none)."""
    from repro.analysis import verify_all as jva
    entry = jhw.get_entry("tpu_v5e")
    n = 0
    for label, form in jva._forms():
        for dtype, acc in jva._DTYPE_MATRIX:
            case = f"tpu_v5e/{label}/{dtype}+{acc}"
            try:
                findings = janalysis.verify_expr(
                    form, dtype=dtype, hardware=entry, acc_dtype=acc,
                    blocks=jva.BLOCK_OVERRIDES.get(label), strict=False)
                want = "checked"
                assert not janalysis.verify.errors(findings)
            except (ValueError, AssertionError):
                want = "refused"
            assert report["cases"][case] == want, case
            n += 1
    # the plan cases are held in tests/test_torch_mesh_plan.py
    assert n == sum(1 for c in report["cases"]
                    if c.startswith("tpu_v5e") and "/plan_" not in c)


# ---------------------------------------------------------------------------
# launch-plan conformance
# ---------------------------------------------------------------------------

def _plan(expr, dtypes=("float32", "float32"), acc="float32"):
    nf = PE.normal_form(expr)
    bundle = None if emit.is_chain(nf) else psched.get_schedule(
        nf, dtype=dtypes[0], hardware=H100, acc_dtype=acc)
    return nf, bundle, ops._plan(nf, dtypes, None, H100, None, acc, True)


def _k9_rules(nf, bundle, launch, dtypes=("float32", "float32"),
              acc="float32"):
    return _rules(conformance.plan_findings(("K9", launch), bundle, nf,
                                            dtypes, acc))


def test_conformance_flags_a_base_past_the_buffer():
    nf, bundle, plan = _plan(_max_plus(PE))
    launch = plan[1]
    assert not _k9_rules(nf, bundle, launch)
    opn = launch.operands[1]
    shifted = dataclasses.replace(opn, base=opn.base + 60 * 80)
    mut = dataclasses.replace(launch, operands=(launch.operands[0], shifted))
    assert _k9_rules(nf, bundle, mut) == ["bounds"]
    # a psi slab read past its pool
    stack = PE.inner("max", "add", PE.psi((3,), PE.arr("S", (4, 64, 48))),
                     PE.arr("B", (48, 32)))
    nf, bundle, plan = _plan(stack)
    assert plan[1].operands[0].base == 3 * 64 * 48
    assert not _k9_rules(nf, bundle, plan[1])
    opn = plan[1].operands[0]
    mut = dataclasses.replace(plan[1], operands=(
        dataclasses.replace(opn, base=4 * 64 * 48), plan[1].operands[1]))
    assert _k9_rules(nf, bundle, mut) == ["bounds"]


def test_conformance_flags_a_split_that_covers_a_slab_twice():
    """A TILE launch split over K: splits of a length that is not a
    multiple of the 16-deep slab make two splits stage and fold the same
    slab; too few splits leave K uncovered; an empty split folds a
    partial of nothing."""
    nf, bundle, plan = _plan(PE.inner("max", "add", PE.arr("A", (64, 4096)),
                                      PE.arr("B", (4096, 64))))
    launch = plan[1]
    assert launch.mode == emit.TILE and launch.splits > 1
    assert launch.k_split % emit.TILE_K == 0
    assert not _k9_rules(nf, bundle, launch)
    ks = launch.k_split - 8
    twice = dataclasses.replace(launch, k_split=ks, splits=-(-4096 // ks))
    assert _k9_rules(nf, bundle, twice) == ["coverage"]
    short = dataclasses.replace(launch, splits=launch.splits - 1)
    assert _k9_rules(nf, bundle, short) == ["coverage"]
    empty = dataclasses.replace(launch, splits=launch.splits + 1)
    assert "coverage" in _k9_rules(nf, bundle, empty)


def test_conformance_flags_a_wrong_pad():
    nf, bundle, plan = _plan(_min_plus(PE))
    assert psched.bundle_needs_padding(bundle)
    assert plan[1].pad_value == float("inf")
    mut = dataclasses.replace(plan[1], pad_value=0.0)
    assert _k9_rules(nf, bundle, mut) == ["pad-value"]


def test_conformance_flags_an_f32_plan_under_int32():
    """A K9 plan on f32 operands (its f32 accumulator) under an int32
    bundle is an acc-dtype defect, and so is an int8 plan (its int32
    accumulator) under an f32 one; the int8 product on K9 under int32 is
    clean (K9's integer accumulator), so is the K1 plan (its int8 form),
    and a K1 plan whose flags are not the normal form's is a route
    defect."""
    nf, bundle, plan = _plan(PE.matmul_expr(37, 53, 29), ("int8", "int8"),
                             "int32")
    assert plan == ("K1", False, False, False)
    assert not conformance.plan_findings(plan, bundle, nf, ("int8", "int8"))
    launch = emit.describe(bundle, nf)
    assert not _k9_rules(nf, bundle, launch, ("int8", "int8"), "int32")
    assert _k9_rules(nf, bundle, launch, ("float32", "float32"),
                     "int32") == ["acc-dtype"]
    assert _k9_rules(nf, None, launch, ("int8", "int8"),
                     "float32") == ["acc-dtype"]
    bad = ("K1", False, True, False)
    assert _rules(conformance.plan_findings(bad, bundle, nf,
                                            ("int8", "int8"))) == ["route"]


@pytest.mark.parametrize("m,tb", [(17, False), (64, True), (100, True)])
def test_conformance_passes_a_head_plan_on_the_tile(m, tb):
    """A bf16 head form past 16 rows is planned on K1's head form
    (``ops.head_route`` "tile"), and its plan has no error finding (the
    tile splits no k: nothing to cover); so is a float16 one (the head
    tile's float16 maps); a float16 activation against a bf16 weight,
    which the route refuses, is planned on K9, and the K1 plan forced onto
    it is a route defect."""
    k, n = (64, 256) if tb else (256, 64)
    expr = PE.head_gemm_expr(40, m, k, n, transpose_b=tb)
    nf, bundle, plan = _plan(expr, ("bfloat16", "bfloat16"))
    assert plan == ("K1", False, tb, "head")
    assert ops.head_route(40, m, k, n, "bfloat16", "bfloat16", tb) == "tile"
    assert not _rules(conformance.plan_findings(plan, bundle, nf,
                                                ("bfloat16", "bfloat16")))
    nf, bundle, f16 = _plan(expr, ("float16", "float16"))
    assert f16 == plan
    assert not _rules(conformance.plan_findings(f16, bundle, nf,
                                                ("float16", "float16")))
    nf, bundle, refused = _plan(expr, ("float16", "bfloat16"))
    assert refused[0] == "K9"
    assert _rules(conformance.plan_findings(plan, bundle, nf,
                                            ("float16", "bfloat16"))) == \
        ["route"]


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_conformance_judges_a_stack_by_its_transposes(ta, tb):
    """An int8 stack of each transpose is planned on K1 with its flags
    (``expert_route`` given them: the int8 tile for (False, True), else
    the int8 form) and checks clean; the same plan with its flags
    dropped is a route defect, and so is a K1 plan forced onto a bf16 or
    an (f32, bf16) stack with that transpose, which ``apply`` leaves on
    K9."""
    e, cap, d, f = 4, 60, 96, 72
    x = PE.arr("X", (e, d, cap) if ta else (e, cap, d))
    w = PE.arr("W", (e, f, d) if tb else (e, d, f))
    expr = PE.inner("add", "mul", PE.transpose(x, (0, 2, 1)) if ta else x,
                    PE.transpose(w, (0, 2, 1)) if tb else w, batch=1)
    i8 = ("int8", "int8")
    nf, bundle, plan = _plan(expr, i8, "int32")
    assert plan == ("K1", ta, tb, True)
    assert not _rules(conformance.plan_findings(plan, bundle, nf, i8,
                                                "int32"))
    if ta or tb:
        assert _rules(conformance.plan_findings(
            ("K1", False, False, True), bundle, nf, i8, "int32")) == \
            ["route"]
        for dts in (("bfloat16", "bfloat16"), ("float32", "bfloat16")):
            nf, bundle, k9 = _plan(expr, dts)
            assert k9[0] == "K9"
            assert _rules(conformance.plan_findings(plan, bundle, nf,
                                                    dts)) == ["route"]


def _moa_exprs(n=64):
    """Every expression ``chip_smoke.py``'s ``[moa_path]`` runs, at a small
    size: (expr, dtypes)."""
    f32, b16 = "float32", "bfloat16"
    m = n // 2
    out = [(PE.matmul_expr(n, n, n), (b16, b16)),
           (PE.matmul_expr(n, n, n), (f32, f32))]
    for plus in ("max", "min"):
        for shape, dt in (((n,) * 3, f32), ((2 * n,) * 3, f32),
                          ((37, 53, 29), f32), ((n,) * 3, b16)):
            a, k, nn = shape
            out.append((PE.inner(plus, "add", PE.arr("A", (a, k)),
                                 PE.arr("B", (k, nn))), (dt, dt)))
    out.append((PE.inner("add", "add", PE.arr("A", (m, m)),
                         PE.arr("B", (m, m))), (f32, f32)))
    out.append((PE.inner("add", "mul", PE.arr("X", (16, m, m)),
                         PE.arr("W", (16, m, m)), batch=1), (f32, f32)))
    c = n // 8
    out.append((PE.arr("A", (c, c)) @ PE.arr("B", (c, c))
                @ PE.arr("C", (c, c)), (f32,) * 3))
    out.append((PE.inner("max", "add", PE.inner(
        "max", "add", PE.arr("A", (c, c)), PE.arr("B", (c, c))),
        PE.arr("C", (c, c))), (f32,) * 3))
    out.append((PE.hadamard_expr(2 * n, 2 * n), (f32, f32)))
    for op, axis in (("max", 1), ("min", 0), ("add", 0)):
        out.append((PE.reduce(op, PE.arr("A", (2 * n, 2 * n)), axis), (f32,)))
    for axes, shape in (((1, 2), (n, 64, 64)), ((0, 2), (64, n, 64))):
        e = PE.arr("A", shape)
        for ax in sorted(axes, reverse=True):
            e = PE.reduce("max", e, ax)
        out.append((e, (f32,)))
    out.append((PE.inner("max", "add", PE.arr("A", (n, n)),
                         PE.arr("B", (n, n), layout="col")), (f32, f32)))
    out.append((PE.inner("max", "add", PE.psi((3,), PE.arr("S", (8, n, n))),
                         PE.arr("B", (n, n))), (f32, f32)))
    out.append((ops._kron_expr(8, 8, 8, 8), (f32, f32)))
    out.append((PE.matmul_expr(8, 8, 8, transpose_b=True), (f32, f32)))
    return out


@pytest.mark.parametrize("i", range(len(_moa_exprs())))
def test_moa_path_plans_verify_clean(i):
    """Each expression of ``[moa_path]`` passes ``verify_expr`` with and
    without the plan checks (a chain, which runs without a schedule, by
    its plan alone), and a second call is a cache hit."""
    expr, dtypes = _moa_exprs()[i]
    for kernel in (False, True):
        before = analysis.verification_cache_stats()
        findings = analysis.verify_expr(expr, dtype=dtypes[0],
                                        hardware=H100, kernel=kernel,
                                        dtypes=dtypes)
        assert not analysis.errors(findings), [str(f) for f in findings]
        analysis.verify_expr(expr, dtype=dtypes[0], hardware=H100,
                             kernel=kernel, dtypes=dtypes)
        after = analysis.verification_cache_stats()
        assert after["hits"] >= before["hits"] + 1


@pytest.mark.parametrize("ta,tb,k", [(False, False, 64), (False, True, 64),
                                     (True, True, 37), (False, True, 33)])
def test_conformance_checks_the_int8_pack(ta, tb, k, monkeypatch):
    """A 2-D int8 product is planned on K1's int8 tile at any transpose
    and k, and checks clean; an operand read in place that is MN-major or
    of a pitch TMA cannot take is a route defect (``int8_reads_in_place``
    mutated to read every operand in place), and a pack that leaves k
    unpadded or pads past the next 16 is a coverage defect
    (``ref.pack_kmajor_int8`` mutated)."""
    a = PE.arr("A", (k, 40) if ta else (40, k))
    b = PE.arr("B", (24, k) if tb else (k, 24))
    expr = PE.inner("add", "mul", PE.transpose(a) if ta else a,
                    PE.transpose(b) if tb else b)
    i8 = ("int8", "int8")
    nf, bundle, plan = _plan(expr, i8, "int32")
    assert plan == ("K1", ta, tb, False)
    assert not _rules(conformance.plan_findings(plan, bundle, nf, i8,
                                                "int32"))
    packs = not ops.int8_reads_in_place(k, ta, True) or \
        not ops.int8_reads_in_place(k, not tb, True)
    with monkeypatch.context() as mp:
        mp.setattr(ops, "int8_reads_in_place", lambda *a: True)
        assert _rules(conformance.plan_findings(plan, bundle, nf, i8,
                                                "int32")) == (
            ["route"] if packs else [])
    pack = pref.pack_kmajor_int8
    unpadded = lambda t, mn, granule=16: (
        t.transpose(-1, -2) if mn else t).contiguous()
    overpadded = lambda t, mn, granule=16: torch.nn.functional.pad(
        pack(t, mn, granule), (0, 16))
    for bad, want in ((unpadded, packs and k % 16 != 0),
                      (overpadded, packs)):
        with monkeypatch.context() as mp:
            mp.setattr(pref, "pack_kmajor_int8", bad)
            assert _rules(conformance.plan_findings(
                plan, bundle, nf, i8, "int32")) == (
                ["coverage"] if want else [])


def test_conformance_passes_an_int8_head_plan_on_the_decode_rows():
    """minicpm3-4b's int8 q_lat and out at 4 rows are planned on K1's int8
    decode rows (``ops.head_route`` "gemv") and check clean: the split of
    k in the int8 rows' own units (64 with w stored (n, h, k), 32 else)
    covers k once."""
    for tb, k, n in ((True, 64, 256), (False, 256, 64)):
        expr = PE.head_gemm_expr(40, 4, k, n, transpose_b=tb)
        nf, bundle, plan = _plan(expr, ("int8", "int8"), "int32")
        assert plan == ("K1", False, tb, "head")
        assert not _rules(conformance.plan_findings(
            plan, bundle, nf, ("int8", "int8"), "int32"))
