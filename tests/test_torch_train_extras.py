"""The port's training extras against the JAX package on the CPU: the
resumable data shards (``repro_torch.data``), int8 gradient compression
with error feedback (``distributed.compression``) and the compressed train
step, ``remat_policy="dots"``, the step watchdog
(``distributed.fault``), the train and serve launchers (``launch``) and
the example twins (``repro_torch.examples``).  Inputs are seeded with
numpy; the models are the reduced configs in float32."""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.fault import (Coordinator,  # noqa: E402
                                           StepWatchdog, best_mesh_shape)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

#: f32 on both sides, differing only in summation order (and in the JAX
#: side's interpret-mode kernel blocks): the train-step tolerance of
#: tests/test_torch_train.py
REL = 1e-5
#: the error state, element by element: the gradients agree to ~1e-7 here
#: (f32, summation order), and an element whose ``g + e`` sits on a
#: rounding boundary of its block's int8 step may round the other way (a
#: "flip": the two errors then lie on either side of it, one step apart).
#: Measured: at most 14 flips in 65536 elements over two steps.
ERR_ATOL = 1e-6
MAX_FLIP_SHARE = 1e-3
#: under ``jax.jit`` XLA's CPU divides through a reciprocal, an ulp off
#: the division on some blocks: a dequantized value may differ by up to 2
#: f32 ulps, and a quotient on a rounding boundary may take the next int8
#: step (measured: 1 of 100003 elements); eager, the reference's division
#: is the port's, bit for bit.  More than one step apart is a fault.
JIT_RTOL = 2.0 ** -22
JIT_MAX_FLIP_SHARE = 1e-4
SEQ, BATCH = 16, 2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(jparams, trainable=True):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                             trainable=trainable)


def _hold_update(params, start, want, lr_sum):
    """Each parameter less its start against the reference's: per leaf
    within 1e-3 in relative norm, every element within 3e-2 of the summed
    learning rate (tests/test_torch_train.py's rule)."""
    for k, p in params.named_parameters():
        got = p.detach().numpy() - start[k]
        step = want[k] - start[k]
        scale = np.linalg.norm(step)
        assert scale > 0, k
        assert np.linalg.norm(got - step) <= 1e-3 * scale, k
        np.testing.assert_allclose(got, step, rtol=0, atol=3e-2 * lr_sum,
                                   err_msg=k)


def _hold_compressed_update(params, start, want, lr_sum):
    """:func:`_hold_update` where an int8 rounding flip (see ``ERR_ATOL``)
    can move one element's update: within 3e-2 of the summed learning
    rate but for at most ``MAX_FLIP_SHARE`` of a leaf, each of those
    within the summed rate (an AdamW step moves an element by at most
    about the rate), and per leaf within 1e-2 in relative norm (measured
    at most 0.16 of the summed rate on 2 of 32768 elements, 1.3e-3 in
    norm)."""
    for k, p in params.named_parameters():
        got = p.detach().numpy() - start[k]
        step = want[k] - start[k]
        scale = np.linalg.norm(step)
        assert scale > 0, k
        assert np.linalg.norm(got - step) <= 1e-2 * scale, k
        d = np.abs(got - step)
        assert (d > 3e-2 * lr_sum).sum() <= MAX_FLIP_SHARE * d.size + 2, k
        assert d.max() <= lr_sum, k


def _lr_sum(steps, opt=adamw.AdamWConfig()):
    return sum(float(adamw.schedule(opt, torch.tensor(i + 1)))
               for i in range(steps))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b", "whisper-base"])
def test_batches_shards_and_state_equal_the_reference(arch):
    """``global_batch`` and ``host_shard`` at 2 and 4 shards (with the vlm
    ``patches`` and the audio ``frames``) equal the reference's bit for
    bit; ``state_dict`` / ``from_state`` too."""
    cfg = get_config(arch, reduced=True)
    tcfg = port_config(arch, reduced=True)
    ours = SyntheticLM(PipelineConfig(cfg.vocab_size, 12, 4, seed=3), tcfg)
    theirs = JSyntheticLM(JPipelineConfig(cfg.vocab_size, 12, 4, seed=3), cfg)
    for step in (0, 7):
        pairs = [(ours.global_batch(step), theirs.global_batch(step))]
        for n in (2, 4):
            pairs += [(ours.host_shard(step, i, n),
                       theirs.host_shard(step, i, n)) for i in range(n)]
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert SyntheticLM.state_dict(9) == JSyntheticLM.state_dict(9) == {
        "data_step": 9}
    for state in ({"data_step": 9}, {}):
        assert SyntheticLM.from_state(state) == JSyntheticLM.from_state(state)


def test_deterministic_across_instances():
    a = SyntheticLM(PipelineConfig(1000, 16, 8, seed=3))
    b = SyntheticLM(PipelineConfig(1000, 16, 8, seed=3))
    for step in [0, 1, 17]:
        np.testing.assert_array_equal(a.global_batch(step)["tokens"],
                                      b.global_batch(step)["tokens"])


def test_different_steps_differ():
    p = SyntheticLM(PipelineConfig(1000, 16, 8))
    assert not np.array_equal(p.global_batch(0)["tokens"],
                              p.global_batch(1)["tokens"])


def test_host_shards_tile_the_global_batch():
    """Any sharding reproduces the same global batch; a count of shards
    that does not divide it raises."""
    p = SyntheticLM(PipelineConfig(997, 12, 8, seed=1))
    g = p.global_batch(5)["tokens"]
    for n_shards in [1, 2, 4, 8]:
        parts = [p.host_shard(5, i, n_shards)["tokens"]
                 for i in range(n_shards)]
        np.testing.assert_array_equal(np.concatenate(parts, 0), g)
    with pytest.raises(ValueError, match="divide"):
        p.host_shard(5, 0, 3)


def test_targets_are_shifted_tokens():
    b = SyntheticLM(PipelineConfig(50, 10, 4, noise=0.0)).global_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_learnable_structure():
    t = SyntheticLM(PipelineConfig(101, 32, 4, noise=0.0)).global_batch(0)[
        "tokens"]
    diff = (t[:, 1:] - 31 * t[:, :-1]) % 101
    assert (diff == diff[:, :1]).all()


def test_vocab_bounds():
    b = SyntheticLM(PipelineConfig(64, 16, 8)).global_batch(0)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 64
    assert b["tokens"].dtype == np.int32


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grad(rng, n, scale, zero_block=None, block=64):
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    if zero_block is not None:
        g[zero_block * block:(zero_block + 1) * block] = 0
    return g


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("n,block", [(4096, 64), (1000, 64), (777, 256),
                                     (100003, 256)])
def test_quant_dequant_equals_the_reference(n, block, jit):
    """Bit for bit against the eager reference (under ``jax.jit`` within
    ``JIT_RTOL`` but for rare one-step flips), at sizes that are and are not a multiple of the block,
    with an all-zero block (scale 1) and across scales."""
    rng = np.random.default_rng(n)
    qd = jax.jit(jcomp._quant_dequant, static_argnums=1) if jit \
        else jcomp._quant_dequant

    def check(g):
        want = np.asarray(qd(jnp.asarray(g), block)).reshape(-1)
        got = compression._quant_dequant(torch.from_numpy(g), block)
        assert got.shape == g.shape
        got = got.numpy().reshape(-1)
        if not jit:
            np.testing.assert_array_equal(got, want)
            return
        flat = np.pad(g.reshape(-1), (0, (-g.size) % block))
        step = (np.abs(flat).reshape(-1, block).max(1) / 127).repeat(block)
        step = step[:g.size]
        d = np.abs(got - want)
        near = d <= JIT_RTOL * np.abs(want)
        assert (~near).sum() <= JIT_MAX_FLIP_SHARE * g.size + 1
        np.testing.assert_allclose(d[~near], step[~near], rtol=1e-5)

    for scale in (1.0, 1e-3, 30.0):
        check(_grad(rng, n, scale, zero_block=1, block=block))
    check(_grad(rng, 6 * 7 * 5, 2.0).reshape(6, 7, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_equals_the_reference(dtype):
    """Two rounds of ``compress_grads`` (error fed back) on f32 and bf16
    gradients, leaves of 4096, 1000 (no multiple of the block) and 64
    elements (one all zero): the dequantized gradients and the error
    state equal the reference's bit for bit, and the inputs are the
    tensors returned (written in place)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (64, 64), "b": (10, 100), "z": (64,)}
    cfg = compression.CompressionConfig(enabled=True, block_size=64)
    jcfg = jcomp.CompressionConfig(enabled=True, block_size=64)
    jt = getattr(jnp, dtype)
    err = compression.init_error_state(
        {k: torch.zeros(s) for k, s in shapes.items()})
    jerr = jcomp.init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(2):
        g = {k: _grad(rng, int(np.prod(s)), 3.0).reshape(s)
             for k, s in shapes.items()}
        g["z"][:] = 0
        tg = {k: torch.tensor(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        got, err2 = compression.compress_grads(cfg, tg, err)
        assert err2 is err and all(got[k] is tg[k] for k in tg)
        want, jerr = jcomp.compress_grads(
            jcfg, {k: jnp.asarray(v).astype(jt) for k, v in g.items()}, jerr)
        for k in shapes:
            assert got[k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32),
                err_msg=k)
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]), err_msg=k)
        assert not err["z"].any() and not got["z"].float().any()


def test_sliced_path_equals_one_pass(monkeypatch):
    """With ``CHUNK`` patched small, a leaf quantized in block-aligned
    slices (the last one padded) equals one unsliced pass bit for bit."""
    rng = np.random.default_rng(2)
    cfg = compression.CompressionConfig(enabled=True, block_size=64)
    g = _grad(rng, 64 * 37 + 11, 5.0, zero_block=3)
    e = (rng.standard_normal(g.size) * 0.01).astype(np.float32)
    whole_g, whole_e = compression.compress_grads(
        cfg, {"w": torch.from_numpy(g.copy())},
        {"w": torch.from_numpy(e.copy())})
    for chunk in (64, 200, 64 * 5):
        monkeypatch.setattr(compression, "CHUNK", chunk)
        assert compression._slice_len(64) % 64 == 0
        sg, se = compression.compress_grads(
            cfg, {"w": torch.from_numpy(g.copy())},
            {"w": torch.from_numpy(e.copy())})
        assert torch.equal(sg["w"], whole_g["w"])
        assert torch.equal(se["w"], whole_e["w"])


def test_disabled_compression_passes_through():
    g, e = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    out = compression.compress_grads(compression.CompressionConfig(), g, e)
    assert out[0] is g and out[1] is e


def test_compression_quant_error_bounded():
    g = torch.from_numpy(_grad(np.random.default_rng(0), 1024, 3.0))
    err = (compression._quant_dequant(g, 256) - g).abs()
    scale = g.abs().reshape(-1, 256).amax(1).repeat_interleave(256)
    assert bool((err <= scale / 127.0 * 0.51 + 1e-7).all())


def test_compression_error_feedback_converges():
    """SGD on a quadratic with int8-compressed gradients and error
    feedback reaches the optimum (the residual does not accumulate)."""
    cfg = compression.CompressionConfig(enabled=True, block_size=64)
    w = torch.full((64,), 5.0)
    err = {"w": torch.zeros(64)}
    target = torch.linspace(-1, 1, 64)
    for _ in range(200):
        g2, err = compression.compress_grads(cfg, {"w": w - target}, err)
        w = w - 0.1 * g2["w"]
    assert float((w - target).abs().max()) < 1e-2


def test_compressed_bytes_accounting():
    assert compression.compressed_bytes(1024, 256) == 1024 + 16
    assert compression.compressed_bytes(10 ** 6) == \
        jcomp.compressed_bytes(10 ** 6)


# ---------------------------------------------------------------------------
# the compressed train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    cfg = get_config("gemma-2b", reduced=True)
    return cfg, port_config("gemma-2b", reduced=True)


def _batches(cfg, n=2):
    data = JSyntheticLM(JPipelineConfig(cfg.vocab_size, SEQ, BATCH))
    return [data.global_batch(i) for i in range(n)]


def test_compressed_train_step_matches_reference(gemma):
    """Two steps with ``CompressionConfig(enabled=True, block_size=64)``:
    the loss within ``REL``, the update held to the reference's
    (:func:`_hold_compressed_update`), and the
    error state element by element within ``ERR_ATOL`` but for rounding
    flips (at most ``MAX_FLIP_SHARE`` of a leaf, each within the two
    errors' sum: one int8 step)."""
    cfg, tcfg = gemma
    jc = jcomp.CompressionConfig(enabled=True, block_size=64)
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(0), jc)
    step = jax.jit(jts.make_train_step(cfg, comp=jc))
    comp = compression.CompressionConfig(enabled=True, block_size=64)
    tstate = ts.init_state(tcfg, _port(state.params), "cpu", comp)
    assert set(tstate.err_fb) == set(_flat(state.err_fb))
    tstep = ts.make_train_step(tcfg, comp=comp)
    jst = state
    for b in _batches(cfg):
        jst, jm = step(jst, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, _tensors(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=REL)
        jerr = _flat(jst.err_fb)
        for k, e in tstate.err_fb.items():
            got, want = e.numpy(), jerr[k]
            d = np.abs(got - want)
            flips = d > ERR_ATOL
            assert flips.sum() <= MAX_FLIP_SHARE * d.size + 2, k
            assert (d[flips] <= np.abs(got[flips]) + np.abs(want[flips])
                    + ERR_ATOL).all(), k
    _hold_compressed_update(tstate.params, _flat(state.params),
                            _flat(jst.params), _lr_sum(2))
    assert int(tstate.step) == 2


def test_compression_without_error_state_raises(gemma):
    _, tcfg = gemma
    cfg = get_config("gemma-2b", reduced=True)
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(0))
    tstate = ts.init_state(tcfg, _port(state.params), "cpu")
    assert tstate.err_fb is None
    step = ts.make_train_step(tcfg, comp=compression.CompressionConfig(True))
    with pytest.raises(ValueError, match="error"):
        step(tstate, _tensors(_batches(cfg, 1)[0]))


# ---------------------------------------------------------------------------
# remat "dots"
# ---------------------------------------------------------------------------

def _count_products(monkeypatch):
    """A counter of the 2-D K1 products (``ops._product``) run."""
    seen = {"n": 0}
    inner = ops._product

    def counting(*a, **kw):
        seen["n"] += 1
        return inner(*a, **kw)
    monkeypatch.setattr(ops, "_product", counting)
    return seen


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_remat_dots_matches_full_and_recomputes_no_product(arch,
                                                           monkeypatch):
    """Under "dots" the loss and every gradient equal "full"'s (and
    remat off's) bit for bit; the K1 products run equal remat off's, and
    "full" runs each layer's forward products once more: its count less
    "dots"' is the forward's products less the head's one."""
    cfg = get_config(arch, reduced=True)
    tcfg = port_config(arch, reduced=True)
    params, _ = jregistry.init(cfg, jax.random.PRNGKey(0))
    tp = _port(params)
    batch = _tensors(_batches(cfg, 1)[0])
    seen = _count_products(monkeypatch)
    with torch.no_grad():
        registry.loss(tp, tcfg, batch)
    forward = seen["n"]
    out = {}
    for name, c in (("off", tcfg.with_(remat=False)),
                    ("full", tcfg.with_(remat_policy="full")),
                    ("dots", tcfg.with_(remat_policy="dots"))):
        seen["n"] = 0
        loss, _, grads = ts.loss_and_grads(tp, c, batch)
        out[name] = (loss, grads, seen["n"])
    for other in ("full", "off"):
        assert torch.equal(out["dots"][0], out[other][0])
        for k, g in out[other][1].items():
            assert torch.equal(out["dots"][1][k], g), (other, k)
    assert out["dots"][2] == out["off"][2]
    assert out["full"][2] - out["dots"][2] == forward - 1


def test_remat_dots_bf16_matches_full(monkeypatch):
    """In bf16 too (the replayed outputs are the cast ones, their
    cotangents cast back to f32 as the cast's own backward does)."""
    cfg = get_config("gemma-2b", reduced=True)
    tcfg = port_config("gemma-2b", reduced=True).with_(dtype="bfloat16")
    params, _ = jregistry.init(cfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           dtype=torch.bfloat16, trainable=True)
    batch = _tensors(_batches(cfg, 1)[0])
    _, _, full = ts.loss_and_grads(tp, tcfg, batch)
    _, _, dots = ts.loss_and_grads(tp, tcfg.with_(remat_policy="dots"),
                                   batch)
    for k in full:
        assert torch.equal(dots[k], full[k]), k


def test_remat_dots_memo_refuses_a_modified_output():
    """A product's output changed in place between the forward and the
    recompute cannot be replayed: the backward raises."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)

    def body(x, w):
        y = ops.matmul(x, w)
        y.mul_(2)
        return y.sin()

    out = torch.utils.checkpoint.checkpoint(
        body, x, w, use_reentrant=False, context_fn=ops.dots_contexts)
    with pytest.raises(RuntimeError, match="in place"):
        out.sum().backward()


def test_remat_dots_train_step_matches_reference(gemma):
    """Three steps at ``remat_policy="dots"`` on both sides: each loss
    within ``REL`` and the update held to the reference's."""
    cfg, tcfg = gemma
    cfg, tcfg = (c.with_(remat_policy="dots") for c in (cfg, tcfg))
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(0))
    step = jax.jit(jts.make_train_step(cfg))
    tstate = ts.init_state(tcfg, _port(state.params), "cpu")
    tstep = ts.make_train_step(tcfg)
    jst = state
    for b in _batches(cfg, 3):
        jst, jm = step(jst, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, _tensors(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=REL)
    _hold_update(tstate.params, _flat(state.params), _flat(jst.params),
                 _lr_sum(3))


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    c = Coordinator()
    w = StepWatchdog(c, factor=3.0, slack_s=0.0)
    trace = [1.0] * 10 + [10.0] + [1.0] * 5      # one 10x step
    flags = [w.observe(i, t) for i, t in enumerate(trace)]
    assert sum(flags) == 1 and flags[10]
    assert w.stragglers == 1
    assert c.events and c.events[0]["kind"] == "straggler"
    assert c.events[0]["step"] == 10


def test_watchdog_adapts_to_drift():
    w = StepWatchdog(Coordinator(), factor=3.0, slack_s=0.0)
    assert not any(w.observe(i, 1.0 + 0.05 * i) for i in range(50))


def test_watchdog_start_stop_times_a_step():
    w = StepWatchdog(Coordinator())
    w.start()
    dt = w.stop(0)
    assert dt >= 0 and w.ema_s == dt


def test_best_mesh_shape_ladder():
    from repro.distributed.fault import best_mesh_shape as jbest
    for n in (512, 256, 24, 7, 1, 6):
        assert best_mesh_shape(n) == jbest(n)
    assert best_mesh_shape(512) == (32, 16)
    assert best_mesh_shape(7) == (7, 1)


def test_failure_reporting():
    c = Coordinator()
    c.report_failure(7, "host 3 lost heartbeat")
    assert c.events[0] == {"kind": "failure", "step": 7,
                           "detail": "host 3 lost heartbeat"}


# ---------------------------------------------------------------------------
# launchers and examples
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--seq",
              "16", "--log-every", "1"]


def test_train_launcher_matches_the_reference(monkeypatch, capsys):
    """Three steps of ``launch.train.main`` on both sides from the same
    initial parameters (the port's ``registry.init`` patched to return the
    reference's): the losses within ``REL``."""
    from repro.launch.train import main as jmain
    from repro_torch.launch import train
    want = jmain(TRAIN_ARGS + ["--steps", "3"])
    cfg = get_config("gemma-2b", reduced=True)
    jparams, _ = jregistry.init(cfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(registry, "init", lambda cfg, gen, device, trainable:
                        _port(jparams, trainable))
    got = train.main(TRAIN_ARGS + ["--steps", "3", "--device", "cpu"])
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=REL)
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} device=cpu" in out


def test_train_launcher_resume_equals_a_straight_run(tmp_path, capsys):
    """2 steps, then a restart that resumes to 4, equal 4 straight steps
    bit for bit (losses and every leaf of the final checkpoint), with
    compression on."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    args = TRAIN_ARGS + ["--device", "cpu", "--compress-grads",
                         "--ckpt-every", "2"]
    straight = train.main(args + ["--steps", "4", "--ckpt-dir",
                                  str(tmp_path / "a")])
    first = train.main(args + ["--steps", "2", "--ckpt-dir",
                               str(tmp_path / "b")])
    second = train.main(args + ["--steps", "4", "--ckpt-dir",
                                str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert first + second == straight
    a, b = (Checkpointer(str(tmp_path / d))._load_step(4) for d in "ab")
    assert a[1]["metadata"] == b[1]["metadata"] == {"data_step": 4}
    assert a[0].keys() == b[0].keys() and len(a[0]) == 52
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "4"]])
def test_train_launcher_refuses_a_mesh(flags):
    """A mesh of ranks on the card, asked for with no card, is refused
    before any rank starts (``--dp`` / ``--tp`` train on the CPU with
    ``--device cpu``: ``tests/test_torch_distributed.py``)."""
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(TRAIN_ARGS + ["--steps", "1"] + flags)


def test_train_launcher_needs_the_card_unless_asked():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(TRAIN_ARGS + ["--steps", "1"])


def test_serve_driver_end_to_end():
    from repro_torch.launch.serve import main
    results = main(["--arch", "gemma-2b", "--reduced", "--requests", "2",
                    "--prompt-len", "4", "--new-tokens", "4",
                    "--max-slots", "2", "--page", "4", "--device", "cpu"])
    assert len(results) == 2
    assert all(len(r["tokens"]) == 4 for r in results.values())


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--device", "cpu", "--steps", "2"]),
    ("serve_batch", ["--device", "cpu", "--new-tokens", "3"]),
    ("train_lm", ["--device", "cpu", "--small", "--steps", "2"]),
])
def test_example_twins_run_on_the_cpu(name, argv, monkeypatch, tmp_path):
    from repro_torch import configs
    monkeypatch.setattr(configs, "ARCHS", dict(configs.ARCHS))
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    out = mod.main(argv)
    assert out
    if name == "serve_batch":
        assert all(len(r["tokens"]) == 3 for r in out.values())
    else:
        assert all(np.isfinite(out))
    if name == "train_lm":
        assert "lm-tiny" in configs.ARCHS


# ---------------------------------------------------------------------------
# the embedding's deterministic backward
# ---------------------------------------------------------------------------

def test_embedding_backward_sums_each_token_once():
    """``layers._EmbedRows``' backward (each repeated token's rows summed
    in a fixed order, one ``index_add_`` row a token) against autograd
    through ``index_select``: bit for bit on integer-valued cotangents,
    within 1e-6 of the largest entry on normals (f32; the running f64 sum
    rounds once where ``index_add_`` rounds at every add)."""
    from repro_torch.models.layers import _EmbedRows
    rng = np.random.default_rng(0)
    for vocab, n, ints in ((20, 7, True), (50, 300, True), (50, 300, False)):
        idx = torch.from_numpy(rng.integers(0, vocab, n))
        g = rng.integers(-8, 8, (n, 4)) if ints else rng.standard_normal(
            (n, 4))
        g = torch.from_numpy(g.astype(np.float32))
        table = torch.zeros(vocab, 4, requires_grad=True)
        (ours,) = torch.autograd.grad(_EmbedRows.apply(table, idx), table, g)
        (want,) = torch.autograd.grad(table.index_select(0, idx), table, g)
        if ints:
            assert torch.equal(ours, want)
        else:
            torch.testing.assert_close(ours, want, rtol=0,
                                       atol=1e-6 * want.abs().max().item())
