"""The port's mesh level of the lifting (``core.mesh``), its sharding rule
table (``distributed.sharding``), its distributed plans
(``distributed.plan``) and their static checks (``analysis.verify_plan`` /
``verify_sharded``) against the JAX package, in process: plans are pure
Python on both sides, so every field is compared.  The port's
``TPU_V5E`` copy is held against the reference's v5e-shaped ``cpu``
entry (their per-shard bundles compare field for field)."""
import dataclasses
import warnings

import pytest

jax = pytest.importorskip("jax")

from repro import analysis as janalysis  # noqa: E402
from repro.analysis import verify_all as jva  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.core import expr as JE  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import mesh as jmesh  # noqa: E402
from repro.core.lifting import TPU_V5E as J_TPU_V5E  # noqa: E402
from repro.distributed import plan as jplan  # noqa: E402
from repro.distributed import sharding as jsr  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import verify_all  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import expr as PE  # noqa: E402
from repro_torch.core import mesh as pmesh  # noqa: E402
from repro_torch.core import onf as ponf  # noqa: E402
from repro_torch.core import schedule as psched  # noqa: E402
from repro_torch.distributed import plan as pplan  # noqa: E402
from repro_torch.distributed import sharding as psr  # noqa: E402
from repro_torch.hardware import TPU_V5E  # noqa: E402
from repro_torch.models import registry as preg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

JCPU = jhw.get_entry("cpu")


def _plain(x):
    """A dataclass tree as nested (class name, (field, value)...) tuples,
    so the port's and the reference's classes compare field for field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ == "StateSpec":
            return ("StateSpec",) + x.key()
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def _mesh_pair(axes):
    return pmesh.MeshShape(axes), jmesh.MeshShape(axes)


def _summary(plan):
    """Every field of a plan but its normal form and bundle objects."""
    return (plan.name, plan.mesh.axes, plan.applied, plan.dropped,
            plan.in_entries, plan.out_entries,
            tuple((s.kind, s.mesh_axis, s.out_dim) for s in plan.collectives),
            plan.collective, plan.out_shape,
            tuple(sorted(plan.local_nf.extent_map.items())),
            plan.local_nf.key(), plan.local_out_shape(),
            plan.hbm_bytes_per_device(), plan.hbm_bytes_per_device("bfloat16"),
            plan.ici_bytes_per_device(),
            plan.ici_bytes_per_device("bfloat16", acc_bytes=2))


def _derive(dplan, build, hardware):
    """The plan ``build(dplan, hardware)`` derives, its warnings' classes
    and messages, or the error it raises (type and message).  The plan
    cache is emptied first: a cached plan warns no more (and another test
    of the process, the verifier's sweep, may have derived it)."""
    dplan.reset_plan_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            plan = build(dplan, hardware)
        except (ValueError, KeyError) as exc:
            return (type(exc).__name__, str(exc)), ()
    return plan, tuple((type(w.message).__name__, str(w.message))
                       for w in caught)


def _same(build):
    """Derive on both packages and hold every field (and the per-shard
    bundle) equal; returns the port's plan."""
    got, gw = _derive(pplan, build, TPU_V5E)
    want, jw = _derive(jplan, build, JCPU)
    assert gw == jw
    if isinstance(want, tuple):
        assert got == want
        return None
    assert _summary(got) == _summary(want)
    assert _plain(got.bundle) == _plain(want.bundle)
    return got


# ---------------------------------------------------------------------------
# the verifier's plan cases (verify_all._plan_cases)
# ---------------------------------------------------------------------------

PLAN_CASES = [c[0] for c in jva._plan_cases()]


@pytest.mark.parametrize("label", PLAN_CASES)
def test_plan_cases_match_reference(label):
    """Each ``_plan_cases`` entry (the port's list is the reference's)
    derives the same plan on both packages (specs, collectives, local
    extents, fallbacks and their warnings, modelled bytes, per-shard
    bundle), and ``verify_sharded`` gives the same findings."""
    (_, jform, jms, shard, kw), = [c for c in jva._plan_cases()
                                   if c[0] == label]
    (_, pform, pms, pshard, pkw), = [c for c in verify_all._plan_cases()
                                     if c[0] == label]
    assert pms.axes == jms.axes and pshard == shard and pkw == kw
    assert PE.normal_form(pform).key() == JE.normal_form(jform).key()
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")

    def build(dplan, hw):
        form = pform if dplan is pplan else jform
        ms = pms if dplan is pplan else jms
        return dplan.derive_plan(form, ms, shard=shard, hardware=hw,
                                 dtype=dtype, **kw)
    _same(build)

    def findings(an, form, ms, hw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                fs = an.verify_sharded(form, ms, shard, hardware=hw,
                                       dtype=dtype, strict=False, **kw)
            except ValueError as exc:
                return ("refused", str(exc))
        return tuple((f.rule, f.level, f.subject, f.message) for f in fs)
    assert findings(analysis, pform, pms, TPU_V5E) == \
        findings(janalysis, jform, jms, JCPU)


# ---------------------------------------------------------------------------
# the reference's in-process plan tests, case by case
# ---------------------------------------------------------------------------

MS8 = (("x", 8),)
MS42 = (("dx", 4), ("dy", 2))


def _matmul(m, k, n, axes, shard, **kw):
    def build(dplan, hw):
        ms = (pmesh if dplan is pplan else jmesh).MeshShape(axes)
        return dplan.matmul_plan(m, k, n, ms, shard=shard, hardware=hw, **kw)
    return build


def _expr(make, axes, shard, **kw):
    def build(dplan, hw):
        E = PE if dplan is pplan else JE
        ms = (pmesh if dplan is pplan else jmesh).MeshShape(axes)
        return dplan.derive_plan(make(E), ms, shard=shard, hardware=hw, **kw)
    return build


def _maxplus(E):
    return E.inner("max", "add", E.arr("A", (32, 32)), E.arr("B", (32, 32)))


def _psi_view(offset, shape, b):
    return lambda E: E.inner("add", "mul",
                             E.psi((offset,), E.arr("X", shape)),
                             E.arr("B", b))


BUILDS = {
    "row": _matmul(64, 48, 32, MS8, {"m": "x"}),
    "col": _matmul(64, 48, 32, MS8, {"n": "x"}),
    "sigma": _matmul(64, 48, 32, MS8, {"k": "x"}),
    "gather": _matmul(64, 48, 32, MS8, {"m": "x"}, replicate_out=True),
    "scatter": _matmul(64, 48, 32, MS8, {"k": "x"}, scatter_axis="m"),
    "both": _matmul(64, 48, 32, MS42, {"m": "dx", "n": "dy"}),
    "row_sigma": _matmul(64, 48, 32, MS42, {"m": "dx", "k": "dy"}),
    "transposed": _matmul(64, 32, 48, MS8, {"n": "x"}, transpose_b=True),
    "local_extents": _matmul(300, 200, 100, MS8, {"m": "x"}),
    "fallback": _matmul(30, 48, 32, (("x", 4),), {"m": "x"}),
    "noncommutative_sigma": _expr(_maxplus, (("x", 2),), {"k": "x"}),
    "noncommutative_out": _expr(_maxplus, (("x", 2),), {"i": "x"}),
    "bad_axis": _expr(lambda E: E.matmul_expr(8, 8, 8), MS8, {"z": "x"}),
    "bad_mesh_axis": _matmul(8, 8, 8, MS8, {"m": "nope"}),
    "two_axes": _matmul(64, 64, 64, MS8, {"m": "x", "n": "x"}),
    "scatter_without_sigma": _matmul(64, 48, 32, MS8, {"m": "x"},
                                     scatter_axis="m"),
    "scatter_not_output": _matmul(64, 48, 32, MS8, {"m": "x"},
                                  scatter_axis="k"),
    "expert": lambda dplan, hw: dplan.expert_plan(
        8, 16, 12, 10, (pmesh if dplan is pplan else jmesh).MeshShape(MS8),
        shard={"e": "x"}, hardware=hw),
    "psi_offset_rows": _expr(_psi_view(1, (2, 16, 16), (16, 8)), MS8,
                             {"i": "x"}),
    "psi_offset_sigma": _expr(_psi_view(1, (2, 16, 16), (16, 8)), MS8,
                              {"k": "x"}),
    "psi_zero_rows": _expr(_psi_view(0, (2, 8, 8), (8, 8)), MS8,
                           {"i": "x"}),
    "bf16_acc": _matmul(64, 96, 32, (("x", 2),), {"k": "x"},
                        dtype="bfloat16", acc_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_plans_match_reference(name):
    """The cases of ``tests/test_distributed_plan.py`` that need no
    device, on both packages: the same plan field for field (or the same
    refusal: a tropical sigma axis, an unknown axis, role or mesh axis,
    one mesh axis on two axes, a scatter with no sharded sigma or onto a
    non-output axis), the same fallback warning, and for the psi views
    the viewed operand's offset re-derived at local extents."""
    plan = _same(BUILDS[name])
    if name.startswith("psi_offset_rows"):
        spec = plan.bundle.schedule.ins[0]
        assert spec.is_psi_view and spec.offsets[0] == 1
    if name == "fallback":
        assert plan.dropped == (("i", "x"),) and plan.collective == "none"


def test_roles_and_tp_shard_helper_match_reference():
    with pytest.raises(KeyError, match="role"):
        pplan.matmul_plan(8, 8, 8, pmesh.MeshShape(MS8), shard={"rows": "x"})
    for axes, kind in [((("data", 4), ("model", 2)), "sigma"),
                       ((("data", 4), ("model", 2)), "col"),
                       ((("data", 4), ("model", 2)), "row"),
                       ((("model", 2),), "col")]:
        assert pplan.tp_matmul_shard(pmesh.MeshShape(axes), kind) == \
            jplan.tp_matmul_shard(jmesh.MeshShape(axes), kind)
    with pytest.raises(ValueError, match="data"):
        pplan.tp_matmul_shard(pmesh.MeshShape(MS8), "col")
    with pytest.raises(ValueError, match="row|col|sigma"):
        pplan.tp_matmul_shard(pmesh.MeshShape((("model", 2),)), "diag")


def test_plan_cache_hits_and_stats():
    pplan.reset_plan_cache()
    ms = pmesh.MeshShape(MS8)
    p0 = pplan.matmul_plan(300, 200, 100, ms, shard={"m": "x"})
    assert pplan.plan_cache_stats() == {"hits": 0, "misses": 1}
    assert pplan.matmul_plan(300, 200, 100, ms, shard={"m": "x"}) is p0
    assert pplan.plan_cache_stats() == {"hits": 1, "misses": 1}
    pplan.matmul_plan(300, 200, 100, ms, shard={"k": "x"})
    assert pplan.plan_cache_stats()["misses"] == 2


def test_mesh_shape_and_mesh_lift_match_reference():
    ps, js = _mesh_pair((("data", 4), ("model", 2)))
    assert (ps.axis_names, ps.shape, ps.n_devices, ps.axis_size("model")) \
        == (js.axis_names, js.shape, js.n_devices, js.axis_size("model"))
    with pytest.raises(KeyError):
        ps.axis_size("pod")
    with pytest.raises(ValueError, match="duplicate"):
        pmesh.MeshShape((("x", 2), ("x", 4)))
    with pytest.raises(ValueError, match="non-positive"):
        pmesh.MeshShape((("x", 0),))
    assert pmesh.MeshShape.from_hardware(TPU_V5E).axes == \
        jmesh.MeshShape.from_hardware(J_TPU_V5E).axes == (("data", 16),
                                                          ("model", 16))
    o = ponf.lift_loop(PE.normalize(PE.matmul_expr(8, 8, 8)), "j", 1, "proc")
    lifted = pmesh.mesh_lift(PE.normalize(PE.matmul_expr(8, 8, 8)), "i",
                             pmesh.MeshShape((("x", 2),)), "x")
    jl = jmesh.mesh_lift(JE.normalize(JE.matmul_expr(8, 8, 8)), "i",
                         jmesh.MeshShape((("x", 2),)), "x")
    assert [(l.index, l.extent, l.resource) for l in lifted.loops] == \
        [(l.index, l.extent, l.resource) for l in jl.loops]
    assert lifted.ins[0].coeffs == jl.ins[0].coeffs
    assert pmesh.mesh_axis_of("mesh:model") == "model"
    with pytest.raises(ValueError, match="mesh"):
        psched.derive_schedule(ponf.lift_loop(lifted, "j", 1, "proc"))
    assert o is not None


class _FakeDeviceMesh:
    """Duck-typed ``DeviceMesh`` (its dim names and shape)."""
    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def test_from_device_mesh_and_placements():
    fake = _FakeDeviceMesh({"data": 2, "model": 4})
    assert pmesh.from_device_mesh(fake).axes == (("data", 2), ("model", 4))
    plan = pplan.matmul_plan(64, 48, 32, fake, shard={"m": "data",
                                                      "k": "model"})
    x_pl, w_pl = plan.in_placements(fake)
    assert [str(p) for p in x_pl] == ["S(0)", "S(1)"]
    assert [str(p) for p in w_pl] == ["R", "S(0)"]
    assert [str(p) for p in plan.out_placements(fake)] == ["S(0)", "R"]


def test_hardware_tables_carry_the_reference_mesh_axes():
    """The port's tables declare the reference's mesh axes (``lifting``'s
    v5e, its 2-pod copy, A100 and V100)."""
    from repro.core import lifting as jl

    from repro_torch import hardware as ph
    for name in ("TPU_V5E", "TPU_V5E_2POD", "GPU_A100", "V100"):
        assert getattr(ph, name).mesh_axes == getattr(jl, name).mesh_axes


# ---------------------------------------------------------------------------
# the rule table on the reference's fake production mesh
# ---------------------------------------------------------------------------

class _FakeJaxMesh:
    """The reference tests' duck-typed mesh (axis_names, devices.shape)."""
    def __init__(self, sizes: dict):
        import numpy as np
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)
        self.empty = False


SIZES = {"pod": 2, "data": 16, "model": 16}


def _param_leaves(arch):
    cfg = get_config(arch)
    shapes = tt.param_shapes(cfg) if cfg.family != "audio" else \
        __import__("repro_torch.models.encdec",
                   fromlist=["x"]).param_shapes(cfg)
    axes = preg.param_axes(cfg)
    return [(f"{g}.{n}", spec[0], axes[g][n])
            for g, leaves in shapes.items() for n, spec in leaves.items()]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_specs_match_reference(arch):
    """Every leaf's logical axes equal the reference's ``Collector`` axes
    (same leaves, same order), and ``param_spec`` / ``act_spec`` on the
    fake (pod 2, data 16, model 16) mesh equal the reference's (its
    ``PartitionSpec`` padded to one entry a dim) at the full config's
    shapes."""
    _, jaxes = jreg.init(jconfig(arch, reduced=True), jax.random.PRNGKey(0))

    def flat(t, p=""):
        for k, v in t.items():
            n = f"{p}.{k}" if p else k
            if isinstance(v, dict):
                yield from flat(v, n)
            else:
                yield n, tuple(v)
    leaves = _param_leaves(arch)
    assert [(n, a) for n, _, a in leaves] == list(flat(jaxes))
    pm, jm = pmesh.MeshShape(tuple(SIZES.items())), _FakeJaxMesh(SIZES)
    for name, shape, axes in leaves:
        for port_fn, ref_fn in ((psr.param_spec, jsr.param_spec),
                                (psr.act_spec, jsr.act_spec)):
            got = port_fn(axes, shape, pm)
            want = tuple(ref_fn(axes, shape, jm))
            assert got == want + (None,) * (len(shape) - len(want)), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_axes_and_specs_match_reference(arch):
    """``registry.cache_logical_axes`` mirrors the decode cache as the
    reference's does (leaf for leaf, dicts in key order as ``jax.tree``
    flattens them), and ``act_spec`` places
    each leaf as the reference's on the fake production mesh."""
    import torch
    pcfg, jcfg = get_config(arch, reduced=True), jconfig(arch, reduced=True)
    pc = preg.init_cache(pcfg, 2, 16, dtype=torch.float32, device="cpu")
    jc = jreg.init_cache(jcfg, 2, 16)
    p_axes = preg.cache_logical_axes(pc)
    j_axes = jreg.cache_logical_axes(jc)

    def leaves(tree, axes):
        import torch as _t
        out = []
        if isinstance(tree, _t.Tensor):
            return [(tuple(tree.shape), axes)]
        items = (zip(tree._fields, tree, axes) if hasattr(tree, "_fields")
                 else [(k, tree[k], axes[k]) for k in sorted(tree)]
                 if isinstance(tree, dict)
                 else [(i, v, a) for i, (v, a) in enumerate(zip(tree, axes))])
        for _, v, a in items:
            out += leaves(v, a)
        return out
    got = leaves(pc, p_axes)
    want = [tuple(a) for a in jax.tree.leaves(
        j_axes, is_leaf=lambda x: isinstance(x, tuple) and all(
            e is None or isinstance(e, str) for e in x))]
    assert [a for _, a in got] == want
    pm, jm = pmesh.MeshShape(tuple(SIZES.items())), _FakeJaxMesh(SIZES)
    for shape, axes in got:
        want_spec = tuple(jsr.act_spec(axes, shape, jm))
        assert psr.act_spec(axes, shape, pm) == \
            want_spec + (None,) * (len(shape) - len(want_spec))


def test_state_logical_axes_mirror_the_parameters():
    import torch

    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.train import train_step as ts
    cfg = get_config("gemma-2b", reduced=True)
    params = preg.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = ts.init_state(cfg, params, "cpu", CompressionConfig(True))
    axes = ts.state_logical_axes(state, preg.param_axes(cfg))
    names = [n for n, _ in params.named_parameters()]
    assert sorted(axes.params) == sorted(names)
    assert axes.opt.master is axes.params and axes.err_fb is axes.params
    assert axes.params["layers.mlp.wi"] == ("layers", "d_model", "d_ff")


def test_constrain_is_a_checked_identity():
    import torch
    x = torch.zeros(4, 6)
    assert psr.constrain(x, "batch", None) is x
    with psr.use_mesh(pmesh.MeshShape((("data", 2), ("model", 2)))):
        assert psr.constrain(x, "batch", "vocab") is x
        with pytest.raises(ValueError, match="logical axes"):
            psr.constrain(x, "batch")


def test_production_mesh_needs_its_ranks():
    """``make_production_mesh`` raises, as the reference's, when the
    world has fewer ranks than 256 (or 512 over two pods)."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")


class _SizedFakeMesh(_FakeDeviceMesh):
    def size(self, i: int) -> int:
        return self.shape[i]


@pytest.mark.parametrize("arch,chunked", [
    ("gemma-2b", {"embed.table": ("R", "S(0)"),
                  "layers.mlp.wi": ("R", "S(2)"),
                  "layers.mlp.wo": ("R", "S(1)")}),
    ("stablelm-1.6b", {"embed.table": ("R", "S(0)"),
                       "unembed.w": ("R", "S(1)"),
                       "layers.mlp.wi": ("R", "S(2)"),
                       "layers.mlp.wo": ("R", "S(1)"),
                       "layers.mlp.bi": ("R", "S(1)")})])
def test_sharded_step_computes_tp_leaves_at_their_chunks(arch, chunked):
    """On (data 2, model 2) at the full config's shapes, the sharded step
    computes the MLP's weights, the embedding table and the untied head
    at their stored chunk over "model" (the tensor-parallel layers read
    them so) and every other leaf whole; over "data" every leaf is
    gathered."""
    from repro_torch.train import train_step as ts
    cfg = get_config(arch)
    fake = _SizedFakeMesh({"data": 2, "model": 2})
    shapes = {name: shape for name, shape, _ in _param_leaves(arch)}
    stored = psr.param_placements(shapes, preg.param_axes(cfg), fake)
    got = {}
    for name, pl in stored.items():
        want = ts._compute_placements(name, pl, fake, ("data",))
        if any(p.is_shard() for p in want):
            got[name] = tuple(str(p) for p in want)
            assert want[1] == pl[1], name
    assert got == chunked
