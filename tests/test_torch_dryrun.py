"""The dry-run's counterpart (``repro_torch.launch.dryrun``) and the pieces
it stands on, held to the JAX package's helpers: the shape cells, the
cell grid, ``input_specs``, ``param_count``, ``default_microbatches``,
``layer_variants``, ``model_flops_lm``, ``from_quantities`` and the rule
table's per-rank parameter bytes.  The reference's own dry-run lowers on
512 forced devices and is not run here; its two pure helpers are read out
of its source (importing the module would set its device-count flag)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core.lifting import TPU_V5E as J_TPU_V5E  # noqa: E402
from repro.distributed import sharding as jsr  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.core import cost as pcost  # noqa: E402
from repro_torch.hardware import TPU_V5E  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import registry as preg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = pconfigs.all_cells()


def _reference_helpers():
    """``default_microbatches`` and ``layer_variants`` of the reference's
    ``launch/dryrun.py``, compiled from its source alone."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    tree = ast.parse(src)
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("default_microbatches", "layer_variants")]
    ns = {"ArchConfig": jcommon.ArchConfig,
          "ShapeConfig": jcommon.ShapeConfig}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "dryrun", "exec"),
         ns)
    return ns["default_microbatches"], ns["layer_variants"]


J_MICRO, J_VARIANTS = _reference_helpers()


def test_shapes_and_cells_match_the_reference():
    assert list(pcommon.SHAPES) == list(jcommon.SHAPES)
    for name, shp in pcommon.SHAPES.items():
        j = jcommon.SHAPES[name]
        assert (shp.name, shp.seq_len, shp.global_batch, shp.kind,
                shp.tokens) == (j.name, j.seq_len, j.global_batch, j.kind,
                                j.tokens)
    assert pconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert pconfigs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert CELLS == jconfigs.all_cells() and len(CELLS) == 40
    for arch, shape in CELLS:
        assert pconfigs.cell_applicable(arch, shape) == \
            jconfigs.cell_applicable(arch, shape)


def _leaves(tree):
    """(shape, dtype name) of a cache's leaves, in ``jax.tree`` order
    (dicts by sorted key, NamedTuples by field)."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    nodes = tree.values() if isinstance(tree, dict) else tree
    return [t for v in nodes for t in _tensors(v)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Every cell's inputs, shapes and dtypes, on "meta" (the decode cache
    through ``init_cache``), equal the reference's ``ShapeDtypeStruct``s."""
    got = preg.input_specs(pconfigs.get_config(arch),
                           pcommon.SHAPES[shape])
    want = jreg.input_specs(jconfigs.get_config(arch), jcommon.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "cache":
            g = _leaves(got[key])
            w = [(tuple(x.shape), str(x.dtype))
                 for x in jax.tree.leaves(want[key])]
            assert g == w
            assert all(t.device.type == "meta" for t in _tensors(got[key]))
            continue
        items = got[key].items() if isinstance(got[key], dict) else \
            [(key, got[key])]
        wants = want[key] if isinstance(want[key], dict) else \
            {key: want[key]}
        assert sorted(k for k, _ in items) == sorted(wants)
        for k, t in items:
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
                (tuple(wants[k].shape), str(wants[k].dtype)), k


@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_counts_microbatches_variants_and_flops_match(arch):
    """``param_count``, ``default_microbatches`` (the train shape),
    ``layer_variants``' units and their configs' depths, and
    ``model_flops_lm`` equal the reference's."""
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    assert p.param_count() == j.param_count()
    # the train cells: both helpers round up to a divisor of the local
    # batch, which never ends for a decode cell's batch of 1 past budget
    for name, shp in pcommon.SHAPES.items():
        if shp.kind == "train":
            assert dryrun.default_microbatches(p, shp) == \
                J_MICRO(j, jcommon.SHAPES[name])
    (ps, pu), (pm, pu2) = dryrun.layer_variants(p)[0]
    (js, ju), (jm, ju2) = J_VARIANTS(j)[0]
    assert (pu, pu2, dryrun.layer_variants(p)[1]) == \
        (ju, ju2, J_VARIANTS(j)[1])
    for pc, jc in ((ps, js), (pm, jm)):
        assert (pc.n_layers, pc.encoder_layers, pc.scan_unroll) == \
            (jc.n_layers, jc.encoder_layers, jc.scan_unroll)
        assert pc.param_count() == jc.param_count()
    total, active = p.param_count()
    for training in (True, False):
        assert pcost.model_flops_lm(total, 12345, active_params=active,
                                    training=training) == \
            jcost.model_flops_lm(total, 12345, active_params=active,
                                 training=training)


def test_from_quantities_matches_the_reference_field_for_field():
    """The same per-device quantities on ``TPU_V5E`` give the reference's
    roofline, every field of its dict (the port's adds its table's
    peak)."""
    coll = {"all-reduce": 3.5e9, "all-gather": 1.25e9,
            "reduce-scatter": 7.0e8}
    kw = dict(n_chips=256, per_device_flops=4.2e14,
              per_device_hbm_bytes=9.1e11, model_flops=9.9e16)
    got = pcost.from_quantities(
        "cell", collective_stats=pcost.CollectiveStats(bytes_by_op=coll),
        hardware=TPU_V5E, **kw).to_dict()
    want = jcost.from_quantities(
        "cell", collective_stats=jcost.CollectiveStats(bytes_by_op=coll),
        hardware=J_TPU_V5E, **kw).to_dict()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    assert got["peak_flops"] == TPU_V5E.peak_flops


class _FakeJaxMesh:
    """The reference tests' duck-typed mesh (axis_names, devices.shape)."""
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)
        self.empty = False


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_per_rank_parameter_bytes_match_the_reference_rule_table(arch,
                                                                 multi):
    """The dry-run's per-rank parameter, master, m and v bytes on the
    sized production mesh equal the bytes the reference's rule table
    (``param_spec`` on its fake mesh) gives the same leaves."""
    cfg = pconfigs.get_config(arch)
    mesh = dryrun.production_mesh(multi)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    jm = _FakeJaxMesh(sizes)
    axes = dict(_flat(preg.param_axes(cfg)))
    want = {"params": 0, "f32": 0}
    for name, (shape, dt) in dryrun.param_leaves(cfg).items():
        spec = tuple(jsr.param_spec(axes[name], shape, jm))
        local = list(shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                local[d] //= sizes[a]
        n = int(np.prod(local))
        want["params"] += n * torch.empty((), dtype=dt).element_size()
        want["f32"] += n * 4
    got = dryrun.state_bytes(cfg, mesh)
    assert got["params"] == want["params"]
    assert got["master"] == got["m"] == got["v"] == want["f32"]
    assert dryrun.state_bytes(cfg, mesh, train=False) == \
        {"params": want["params"]}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def test_all_cells_both_meshes_write_80_records_without_jax(tmp_path):
    """``--all --mesh both`` in a fresh process: 80 records, 66 ``OK`` and
    14 ``SKIP`` (long_500k on the 7 archs outside ``SUBQUADRATIC``), none
    ``FAIL``, each marked ``"source": "model"``; no JAX module is
    imported."""
    code = ("import sys; from repro_torch.launch import dryrun; "
            f"rc = dryrun.main(['--all', '--mesh', 'both', '--out', "
            f"{str(tmp_path)!r}]); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; "
            "assert not bad, bad; sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 80
    status = [r["status"] for r in recs]
    assert status.count("OK") == 66 and status.count("SKIP") == 14
    assert all(r["source"] == "model" for r in recs)
    skip = {(r["arch"], r["shape"]) for r in recs if r["status"] == "SKIP"}
    assert skip == {(a, "long_500k") for a in pconfigs.ARCH_IDS
                    if a not in pconfigs.SUBQUADRATIC}
    for r in recs:
        if r["status"] != "OK":
            assert r["reason"] == jconfigs.cell_applicable(
                r["arch"], r["shape"])[1]
            continue
        assert r["n_chips"] == (512 if r["mesh"] == "multi" else 256)
        assert (r["params_total"], r["params_active"]) == \
            jconfigs.get_config(r["arch"]).param_count()
        assert ("microbatches" in r) == (r["kind"] == "train")
        assert r["roofline"]["model_flops"] > 0
        pr = r["per_rank_bytes"]
        assert pr["params"] > 0 and pr["activations"] > 0
        assert (pr["cache"] > 0) == (r["kind"] == "decode")
        assert set(r["collectives_bytes"]) <= {"all-reduce", "all-gather",
                                               "reduce-scatter"}


@pytest.mark.parametrize("mesh_kind,dp", [("single", 16), ("multi", 32)])
def test_collective_bytes_are_one_devices_by_hand(mesh_kind, dp):
    """gemma-2b train_4k's collective bytes, counted by hand for one
    device of the sharded step as it runs (bf16, remat "full", 2
    microbatches, each of 256 / 2 / dp sequences of 4096 rows, R rows):
    per layer (18) and microbatch, its weights (``layer``: both norms,
    wq / wo and wk / wv whole over "model", neither 8 heads nor 1 KV
    head dividing over 16, and the MLP's wi / wo at their "model"
    chunks) all-gathered over the dp data ranks twice (the forward and
    the remat rerun) and their gradients reduce-scattered once; the
    table (its "model" chunk) and the final norm gathered and
    reduce-scattered once a microbatch; per layer the MLP's input
    gradient (R x 2048 bf16) summed over "model" (16), its sigma psum of
    (R, 2048) f32 partial sums once (the rerun stops before a layer's
    last psum) and the whole wi (2048 x 32768 bf16) all-gathered over
    "model" three times (the forward, the rerun, its gradient); the
    embedding's psum of its rows and the head's input gradient (R x 2048
    bf16 each) and the vocabulary-parallel loss's three f32 row sums;
    every leaf sharded over the data axes, so no gradient all-reduce.
    The attention has no "model" collective: its heads are whole."""
    rec = dryrun.run_cell("gemma-2b", "train_4k", mesh_kind, None)
    mb = rec["microbatches"]
    assert mb == 2
    rows = 256 // mb // dp * 4096
    ring, data = 15 / 16, (dp - 1) / dp
    layer = 2 * (2 * 2048 + 2 * 2048 * 8 * 256 + 2 * 2048 * 256
                 + 2048 * 32768 // 16 + 16384 * 2048 // 16)
    outside = 2 * 256000 * 2048 // 16 + 2 * 2048
    wi = 2 * 2048 * 32768
    want = {
        "all-gather": mb * (18 * (2 * data * layer + 3 * ring * wi)
                            + data * outside),
        "reduce-scatter": mb * (18 * data * layer + data * outside),
        "all-reduce": mb * 2 * ring * (
            18 * (rows * 2048 * 2 + rows * 2048 * 4)
            + 2 * rows * 2048 * 2 + 3 * rows * 4)}
    assert rec["collectives_bytes"] == pytest.approx(want, rel=1e-12)
    assert rec["replication_fallbacks"] == []
    assert rec["not_modeled"] == []


def test_train_activations_count_the_gathered_weights_by_hand():
    """gemma-2b train_4k's per-rank activation bytes on the 16 x 16 mesh,
    counted by hand: each of 2 microbatches' 256 / 16 / 2 = 8 sequences
    of 4096 rows keeps a bf16 residual of 2048 a layer (18) and one more,
    the f32 logits and their gradient over the vocab's 256000 / 16
    columns, and the sharded step's gathered weights with their
    gradients: the largest layer's (both norms' 2 x 2048; wq and wo 2048
    x 8 x 256 each and wk and wv 2048 x 256 each, whole: neither 8 heads
    nor 1 KV head divide over 16; the MLP's wi 2048 x 32768 and wo 16384
    x 2048 over 16) and the table's 256000 x 2048 over 16, in bf16."""
    rec = dryrun.run_cell("gemma-2b", "train_4k", "single", None)
    rows = 8 * 4096
    layer = 2 * (2 * 2048 + 2 * 2048 * 8 * 256 + 2 * 2048 * 256
                 + 2048 * 32768 // 16 + 16384 * 2048 // 16)
    table = 2 * 256000 * 2048 // 16
    assert dryrun.gathered_bytes(get_config("gemma-2b"),
                                 dryrun.production_mesh(False)) == \
        (layer, table)
    want = rows * 2048 * 2 * 19 + 2 * rows * 16000 * 4 + 2 * (layer + table)
    assert rec["per_rank_bytes"]["activations"] == want


def test_hybrid_gathered_layers_by_hand():
    """recurrentgemma-9b on the 16 x 16 mesh, each layer's gathered bytes
    counted by hand in bf16, in the model's order (12 groups of two
    RG-LRU layers and a local attention layer, then 2 RG-LRU layers): an
    RG-LRU layer reads both norms' 2 x 4096 whole and its mixer at its
    "model" chunk of the 4096 channels (w_x, w_gate, wa and wi 4096 x
    4096 / 16 each, wa / wi with every row and their columns' chunk,
    w_out 4096 / 16 x 4096; conv_w 4 x 4096 / 16; conv_b, ba, bi and lam
    4096 / 16 each) and its MLP's wi 4096 x 24576 and wo 12288 x 4096
    over 16; a local layer reads its 16 query heads over 16 (wq 4096 x
    16 x 256 and wo 16 x 256 x 4096, one head a rank), its one KV head
    whole (wk and wv 4096 x 256 each) and the same MLP.  The table is
    256000 x 4096 over 16."""
    mlp = 4096 * 24576 // 16 + 12288 * 4096 // 16
    rec = 2 * (2 * 4096 + 5 * 4096 * 4096 // 16 + 4 * 4096 // 16
               + 4 * 4096 // 16 + mlp)
    local = 2 * (2 * 4096 + 2 * 4096 * 16 * 256 // 16 + 2 * 4096 * 256
                 + mlp)
    layers, table = dryrun.gathered_layers(get_config("recurrentgemma-9b"),
                                           dryrun.production_mesh(False))
    assert layers == (12 * [("rglru", rec), ("rglru", rec), ("local", local)]
                      + 2 * [("rglru", rec)])
    assert table == 2 * 256000 * 4096 // 16


def test_run_cell_records_a_failure(tmp_path, monkeypatch):
    """A cell whose model raises is written as ``FAIL`` with the error."""
    def boom(*a, **k):
        raise RuntimeError("no such model")
    monkeypatch.setattr(dryrun, "model_cell", boom)
    rec = dryrun.run_cell("gemma-2b", "train_4k", "single", str(tmp_path))
    assert rec["status"] == "FAIL" and "no such model" in rec["error"]
    assert (tmp_path / "gemma-2b__train_4k__single.json").is_file()
