"""The port's distributed layer run in real gloo worlds on the CPU, held
against the single-device port and the JAX package.

Two worlds, each started once for the file (``tests/_torch_dist_worker.py``
a rank, meeting on a ``file://`` store under the test's temporary
directory, never a fixed port): 2 ranks (a mesh ``("x", 2)``, and
``("data", "model")`` of (1, 2)) and 4 ranks (``("dx", "dy")`` and
``("data", "model")`` of (2, 2), then (4, 1)).  Every case runs inside
them; the reference's results are computed here with JAX.

Tolerances: f32 throughout, and the sharded results differ from the
single-device ones only in the order of their f32 sums (a k split summed
by a psum, gradients summed over ranks): ``TOL`` (1e-5, relative to the
largest magnitude) for products and their gradients, losses and
gradients; after AdamW steps ``_hold_update``'s bound (an update moves
each element by about the learning rate, so rounding differences in
small gradients show at the update's scale).  Checkpoints and the
compression's whole-leaf blocks are held bit for bit.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import verify_all as jva  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import expr as JE  # noqa: E402
from repro.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import Collector  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.analysis import verify_all  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed.compression import CompressionConfig  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
TOL = 1e-5
LR = 1e-3
#: the plan cases of one mesh axis run in the 2-rank world; the 2 x 2
#: one in the 4-rank world; the bf16-accumulation case is refused on the
#: H100 table (``test_torch_mesh_plan``) and runs nowhere
ONE_AXIS = [c[0] for c in jva._plan_cases()
            if len(c[2].axes) == 1 and c[0] != "plan_bf16_acc"]
TWO_AXES = [c[0] for c in jva._plan_cases() if len(c[2].axes) == 2]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        what, np.abs(got - want).max(), scale)


def _run_world(directory, world: int, jobs: list) -> dict:
    """Start ``world`` ranks on ``jobs``; rank 0's results, every rank
    having finished every job."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(directory),
                               str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for r in range(world):
        path = os.path.join(directory, f"out_{r}.pkl")
        assert os.path.exists(path), f"rank {r} wrote nothing:\n{logs[r]}"
        with open(path, "rb") as f:
            outs.append(pickle.load(f))
    for r, out in enumerate(outs):
        for name, (status, val) in out.items():
            assert status == "ok", f"rank {r}, {name}:\n{val}"
    return outs[0]


def _result(world, name):
    assert name in world, f"{name} did not run"
    return world[name][1]


# ---------------------------------------------------------------------------
# inputs and the reference's results
# ---------------------------------------------------------------------------

def _apply_inputs(label, seed):
    """The port's form of a plan case, the reference's normal form, the
    operands and the cotangent (numpy, seeded)."""
    (_, form, _, _, _), = [c for c in verify_all._plan_cases()
                           if c[0] == label]
    (_, jform, _, _, _), = [c for c in jva._plan_cases() if c[0] == label]
    nf = JE.normal_form(jform)
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in nf.leaf_storage_shapes()]
    g = rng.standard_normal(nf.out_shape()).astype(np.float32)
    return form, nf, arrays, g


def _reduced(arch):
    return get_config(arch, reduced=True)


def _jparams(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jreg.init(_reduced(arch), jax.random.PRNGKey(seed))[0])


def _moe_inputs():
    cfg = _reduced("deepseek-moe-16b")
    col = Collector(jax.random.PRNGKey(0), dtype=jnp.float32)
    jmoe.init_moe(col, "moe", cfg)
    params, _ = col.done()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, cfg.d_model), jnp.float32))
    return cfg, jax.tree.map(np.asarray, params["moe"]), x


def _batch(arch, seq=16, batch=4, step=0):
    return SyntheticLM(PipelineConfig(_reduced(arch).vocab_size, seq,
                                      batch), _reduced(arch)).global_batch(
        step)


def _compress_inputs():
    rng = np.random.default_rng(11)
    # (name, shard dim per mesh dim (data, model)): an aligned chunk (runs
    # of 2 x 256), a chunk whose runs (50 elements) cut the blocks, one
    # sharded on both mesh dims, and a replicated leaf
    specs = [("aligned", (0, None)), ("cut", (None, 1)), ("both", (0, 1)),
             ("replicated", (None, None))]
    shapes = {"aligned": (8, 128), "cut": (6, 100), "both": (4, 98),
              "replicated": (5, 77)}
    arrays = [(rng.standard_normal(shapes[n]) * 10 ** rng.uniform(
        -3, 1, shapes[n][:1])[:, None]).astype(np.float32) for n, _ in specs]
    errors = [rng.standard_normal(shapes[n]).astype(np.float32) * 1e-3
              for n, _ in specs]
    return specs, arrays, errors


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = []
    for i, label in enumerate(ONE_AXIS):
        _, _, arrays, g = _apply_inputs(label, i)
        jobs.append((label, "apply", (label, arrays, g, False)))
    _, _, arrays, g = _apply_inputs("plan_sigma", 0)
    jobs.append(("dtensor_sigma", "apply", ("plan_sigma", arrays, g, True)))
    rng = np.random.default_rng(5)
    ring = [rng.standard_normal(s).astype(np.float32)
            for s in ((16, 8), (8, 12), (24, 16), (16, 8))]
    jobs.append(("rings", "rings", (*ring, 2)))
    _, mp, x = _moe_inputs()
    jobs.append(("moe_1x2", "moe", ("deepseek-moe-16b", mp, x,
                                    (("data", 1), ("model", 2)))))
    return _run_world(tmp_path_factory.mktemp("world2"), 2, jobs)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    base = tmp_path_factory.mktemp("world4")
    m22 = (("data", 2), ("model", 2))
    jobs = []
    for label in TWO_AXES:
        _, _, arrays, g = _apply_inputs(label, 7)
        jobs.append((label, "apply", (label, arrays, g, False)))
    rng = np.random.default_rng(6)
    ring = [rng.standard_normal(s).astype(np.float32)
            for s in ((16, 8), (8, 12), (24, 16), (16, 8))]
    jobs.append(("rings", "rings", (*ring, 4)))
    jobs.append(("gemma_planned", "lm_planned",
                 ("gemma-2b", _jparams("gemma-2b"), _batch("gemma-2b"), m22)))
    _, mp, x = _moe_inputs()
    jobs.append(("moe_2x2", "moe", ("deepseek-moe-16b", mp, x, m22)))
    batches = [_batch("stablelm-1.6b", step=i) for i in range(3)]
    jobs.append(("train_stablelm", "train",
                 ("stablelm-1.6b", _jparams("stablelm-1.6b"), batches, m22,
                  False, LR)))
    jobs.append(("train_gemma_planned", "train_planned",
                 ("gemma-2b", _jparams("gemma-2b"),
                  [_batch("gemma-2b", step=i) for i in range(2)], m22, LR)))
    jobs.append(("compress", "compress", _compress_inputs()))
    jobs.append(("checkpoint", "checkpoint",
                 ("gemma-2b", str(base / "ckpt"))))
    out = _run_world(base / "run", 4, jobs)
    out["ckpt_dir"] = ("ok", str(base / "ckpt"))
    return out


# ---------------------------------------------------------------------------
# apply(mesh=) over every plan case
# ---------------------------------------------------------------------------

def _hold_apply(world, label, seed):
    form, nf, arrays, g = _apply_inputs(label, seed)
    out, grads, placements = _result(world, label)
    # the reference's oracle on one device, forward and gradient
    f = lambda *xs: jnp.sum(jref.eval_nf(nf, *xs) * g)
    want = np.asarray(jref.eval_nf(nf, *map(jnp.asarray, arrays)))
    jgrads = jax.grad(f, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    _close(out, want, what=(label, "out vs reference"))
    for got, w in zip(grads, jgrads):
        _close(got, np.asarray(w), what=(label, "grad vs reference"))
    # the single-device port
    ts_ = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = ops.apply(form, *ts_)
    (y * torch.tensor(g)).sum().backward()
    _close(out, y.detach().numpy(), what=(label, "out vs port"))
    for got, t in zip(grads, ts_):
        _close(got, t.grad.numpy(), what=(label, "grad vs port"))
    return placements


@pytest.mark.parametrize("label", ONE_AXIS)
def test_apply_mesh_one_axis_matches_single_device(world2, label):
    """Each plan over ("x", 2): the result and every operand's gradient
    (each collective's backward: the psum's identity, the scatter's
    gather, the gather's slice; a replicated operand's partial gradients
    summed) equal the single-device port's and ``ref.eval_nf``'s."""
    placements = _hold_apply(world2, label, ONE_AXIS.index(label))
    want = {"plan_row": ["S(0)"], "plan_col": ["S(1)"], "plan_sigma": ["R"],
            "plan_gather": ["R"], "plan_scatter": ["S(0)"],
            "plan_fallback": ["R"], "plan_expert": ["S(0)"]}[label]
    assert placements == want


@pytest.mark.parametrize("label", TWO_AXES)
def test_apply_mesh_two_axes_matches_single_device(world4, label):
    assert _hold_apply(world4, label, 7) == ["S(0)", "S(1)"]


def test_apply_mesh_takes_placed_dtensors(world2):
    form, nf, arrays, _ = _apply_inputs("plan_sigma", 0)
    out, _, placements = _result(world2, "dtensor_sigma")
    _close(out, np.asarray(jref.eval_nf(nf, *map(jnp.asarray, arrays))))
    assert placements == ["R"]


@pytest.mark.parametrize("world_name", ["world2", "world4"])
def test_collective_matmuls(world_name, request):
    """``ag_matmul`` (the ring of K1 products, point-to-point) and
    ``psum_matmul`` (row chunks, each all-reduce overlapping the next
    product) against the plain gather-then-multiply, multiply-then-reduce
    and the whole product."""
    world = request.getfixturevalue(world_name)
    ag, ag_ref, ps, ps_ref = _result(world, "rings")
    rng = np.random.default_rng(5 if world_name == "world2" else 6)
    x, w, x2, w2 = (rng.standard_normal(s).astype(np.float32)
                    for s in ((16, 8), (8, 12), (24, 16), (16, 8)))
    _close(ag, ag_ref)
    _close(ag, x @ w)
    _close(ps, ps_ref)
    _close(ps, x2 @ w2)


# ---------------------------------------------------------------------------
# the models under planned_mesh
# ---------------------------------------------------------------------------

def test_gemma_planned_loss_and_grads_match_reference(world4):
    """Reduced gemma-2b tensor-parallel over (data 2, model 2): the MLP's
    column / sigma plans and the vocab head's, each rank its rows; the
    global batch's loss and every gradient against the reference's
    single-device ``registry.loss``."""
    loss, grads = _result(world4, "gemma_planned")
    cfg = _reduced("gemma-2b")
    jp = jreg.init(cfg, jax.random.PRNGKey(0))[0]
    batch = jax.tree.map(jnp.asarray, _batch("gemma-2b"))
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jreg.loss(p, cfg, batch), has_aux=True)(jp)
    assert abs(loss - float(jloss)) <= TOL * abs(float(jloss))

    def flat(t, p=""):
        for k, v in t.items():
            n = f"{p}.{k}" if p else k
            if isinstance(v, dict):
                yield from flat(v, n)
            else:
                yield n, np.asarray(v)
    jg = dict(flat(jg))
    assert sorted(grads) == sorted(jg)
    for k, v in jg.items():
        _close(grads[k], v, what=k)


@pytest.mark.parametrize("case", ["moe_1x2", "moe_2x2"])
def test_moe_shardmap_matches_global_dispatch(world2, world4, case):
    """``_apply_moe_shardmap`` (token-local routing, 8 experts over the
    model axis, one psum) against the reference's and the port's global
    dispatch on the reference test's input: the same top-k, the output
    within 5e-6 relative, nothing dropped."""
    world = world2 if case == "moe_1x2" else world4
    y, idx, (aux, z, dropped) = _result(world, case)
    cfg, mp, x = _moe_inputs()
    jy, jst = jmoe._apply_moe_global(jax.tree.map(jnp.asarray, mp),
                                     jnp.asarray(x), cfg)
    ty, _ = moe._apply_moe_global({k: torch.tensor(v) for k, v in mp.items()},
                                  torch.tensor(x), port_config(
                                      "deepseek-moe-16b", reduced=True))
    tidx = moe.route({k: torch.tensor(v) for k, v in mp.items()},
                     torch.tensor(x).reshape(-1, x.shape[-1]), cfg)[3]
    assert np.array_equal(idx.reshape(-1, cfg.top_k), tidx.numpy())
    _close(y, np.asarray(jy), tol=5e-6)
    _close(y, ty.detach().numpy(), tol=5e-6)
    assert dropped == float(jst.dropped_frac) == 0.0
    if case == "moe_1x2":             # the whole batch on the one data rank
        assert abs(aux - float(jst.aux_loss)) <= TOL * float(jst.aux_loss)
        assert abs(z - float(jst.z_loss)) <= TOL * float(jst.z_loss)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_np(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _hold_update(got, start, want, lr_sum):
    """Each parameter's update against the reference's: within 1e-3 in
    relative norm per leaf, every element within 3e-2 of the summed
    learning rate (``tests/test_torch_train.py``'s bound).  The key
    biases are left out: their gradient is zero in exact arithmetic (a
    softmax does not see a shift of every score), so their update is
    AdamW normalising rounding noise (``tests/test_torch_encdec.py``
    leaves them out alike)."""
    for k, w in want.items():
        if k.endswith(".bk"):
            continue
        step, mine = w - start[k], got[k] - start[k]
        scale = np.linalg.norm(step)
        assert scale > 0, k
        assert np.linalg.norm(mine - step) <= 1e-3 * scale, k
        np.testing.assert_allclose(mine, step, rtol=0, atol=3e-2 * lr_sum,
                                   err_msg=k)


def test_sharded_train_steps_match_one_device(world4):
    """Three sharded AdamW steps of reduced stablelm-1.6b on (data 2,
    model 2), each rank its rows: every rank's parameters, masters, m and
    v hold exactly their rule-table chunks; the losses and gradient norms
    equal the single-device port's and the reference's jitted steps
    within ``TOL``; the parameters' updates hold to both within
    ``_hold_update``'s bound."""
    metrics, whole, placed = _result(world4, "train_stablelm")
    assert placed
    cfg = _reduced("stablelm-1.6b")
    opt = AdamWConfig(lr_peak=LR, warmup_steps=2, decay_steps=10)
    start = _jparams("stablelm-1.6b")
    batches = [_batch("stablelm-1.6b", step=i) for i in range(3)]
    # the reference's jitted step
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    jstate, _ = jts.init_state(cfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(cfg, JAdamWConfig(
        lr_peak=LR, warmup_steps=2, decay_steps=10)))
    jm = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jm.append({k: float(v) for k, v in m.items()})
    # the port on one device
    pcfg = port_config("stablelm-1.6b", reduced=True)
    params = params_from_numpy(start, device="cpu", trainable=True)
    st = ts.init_state(pcfg, params, "cpu")
    step = ts.make_train_step(pcfg, opt)
    pm = []
    for b in batches:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        pm.append({k: float(v) for k, v in m.items()})
    for got, want, port in zip(metrics, jm, pm):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= TOL * abs(want[key]), key
            assert abs(got[key] - port[key]) <= TOL * abs(port[key]), key
    lr_sum = sum(m["lr"] for m in jm)
    start = _flat_np(start)
    _hold_update(whole, start, _flat_np(jax.tree.map(np.asarray,
                                                     jstate.params)), lr_sum)
    _hold_update(whole, start, {k: p.detach().numpy()
                                for k, p in params.named_parameters()},
                 lr_sum)


def test_planned_train_step_matches_reference(world4):
    """``make_train_step(planned_mesh=)`` on (data 2, model 2), every rank
    the whole state (the reference's planned-mesh step): reduced
    gemma-2b's losses and gradient norms over 2 steps against the
    reference's jitted unplanned step within ``TOL``, its updates within
    ``_hold_update``'s bound."""
    metrics, params = _result(world4, "train_gemma_planned")
    cfg = _reduced("gemma-2b")
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    jstate, _ = jts.init_state(cfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(cfg, JAdamWConfig(
        lr_peak=LR, warmup_steps=2, decay_steps=10)))
    jm = []
    for i in range(2):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray,
                                               _batch("gemma-2b", step=i)))
        jm.append({k: float(v) for k, v in m.items()})
    for got, want in zip(metrics, jm):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= TOL * abs(want[key]), key
    _hold_update(params, _flat_np(_jparams("gemma-2b")),
                 _flat_np(jax.tree.map(np.asarray, jstate.params)),
                 sum(m["lr"] for m in jm))


def test_compress_sharded_leaves_match_whole_leaves(world4):
    """``compress_sharded`` on each rank's chunk equals ``compress_grads``
    on the whole leaf bit for bit, gradient and error state: a chunk of
    whole blocks compressed in place, a chunk whose runs cut the blocks
    (and one sharded over both mesh dims) through the whole leaf."""
    out = _result(world4, "compress")
    for name, (wg, we, sg, se) in out.items():
        assert np.array_equal(sg, wg), name
        assert np.array_equal(se, we), name


def test_launch_train_dp_tp_losses_equal_dp1():
    """``launch.train --dp 2 --tp 2`` (four self-spawned gloo ranks, the
    sharded step) gives the losses of ``--dp 1`` within ``TOL``."""
    argv = ["--arch", "gemma-2b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "16", "--device", "cpu", "--log-every", "1"]
    one = launch_train.main(argv)
    four = launch_train.main(argv + ["--dp", "2", "--tp", "2"])
    assert len(four) == len(one) == 3
    for a, b in zip(four, one):
        assert abs(a - b) <= TOL * abs(b)


# ---------------------------------------------------------------------------
# the re-meshed checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_remeshed_restores_bit_for_bit(world4):
    """A compressed sharded state saved at (data 2, model 2) restores at
    (data 4, model 1) bit for bit (parameters, masters, m, v, error
    state), and into plain chunks through ``restore(shardings=)``; the
    same checkpoint restores on one device in the port, and in the
    reference's ``Checkpointer``, bit for bit.  ``ElasticManager`` makes
    the (1, 4) mesh of ``best_mesh_shape(4)`` and reshards the restored
    parameters onto it by the rule table."""
    saved, restored, step, plain_equal, (elastic_shape, elastic) = \
        _result(world4, "checkpoint")
    assert step == 1
    assert plain_equal                 # restore(shardings=) into plain chunks
    assert elastic_shape == (1, 4) and elastic    # ElasticManager
    assert sorted(saved) == sorted(restored)
    for k in saved:
        assert np.array_equal(saved[k], restored[k]), k
    directory = _result(world4, "ckpt_dir")
    cfg = port_config("gemma-2b", reduced=True)
    comp = CompressionConfig(enabled=True)
    state = ts.init_state(cfg, registry.init(
        cfg, torch.Generator().manual_seed(8), "cpu", trainable=True),
        "cpu", comp)
    state, _ = Checkpointer(directory).restore(state)
    trees = {"params": dict(state.params.named_parameters()),
             "master": state.opt.master, "m": state.opt.m,
             "v": state.opt.v, "err": state.err_fb}
    for tree_name, tree in trees.items():
        for k, t in tree.items():
            t = t.detach()
            bits = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert np.array_equal(bits, saved[f"{tree_name}/{k}"]), k
    # the reference restores the same file into its own state
    jcfg = _reduced("gemma-2b")
    from repro.distributed.compression import \
        CompressionConfig as JCompressionConfig
    jstate, _ = jts.init_state(jcfg, jax.random.PRNGKey(5),
                               JCompressionConfig(enabled=True))
    jstate, _ = JCheckpointer(directory).restore(jstate)
    got = _flat_np(jax.tree.map(np.asarray, jstate.params))
    for k, v in got.items():
        want = saved[f"params/{k}"]
        if want.dtype == np.int16:
            v = np.asarray(v).view(np.int16) if v.dtype.itemsize == 2 else \
                np.asarray(jnp.asarray(v, jnp.bfloat16)).view(np.int16)
        assert np.array_equal(np.asarray(v), want), k
