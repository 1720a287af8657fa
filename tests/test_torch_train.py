"""The port's training path (``repro_torch.train``, ``optim``, ``data``,
``transformer.lm_loss``) against the JAX package's on the CPU: the same
numpy batches and the same weights (carried across with
``params_from_numpy``), reduced gemma-2b in float32."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

#: f32 on both sides, differing only in summation order (and in the JAX
#: side's interpret-mode kernel blocks): 1e-5 relative
REL = 1e-5
STEPS = 3
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


def _batches(cfg):
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, SEQ, BATCH))
    return [data.global_batch(i) for i in range(STEPS)]


def _port(jparams, trainable=True):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                             trainable=trainable)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _hold_update(params, start, want, lr_sum):
    """The update itself, each parameter less its start, against the
    reference's: per leaf within 1e-3 in relative norm, and every element
    within 3e-2 of the summed learning rate.  An AdamW step moves an
    element by about the learning rate whatever its gradient's size, so a
    wrong sign or scale shows here; what is left is f32 rounding (an ulp
    of a parameter is ~1e-3 of the summed rate)."""
    for k, p in params.named_parameters():
        got = p.detach().numpy() - start[k]
        step = want[k] - start[k]
        scale = np.linalg.norm(step)
        assert scale > 0, k
        assert np.linalg.norm(got - step) <= 1e-3 * scale, k
        np.testing.assert_allclose(got, step, rtol=0, atol=3e-2 * lr_sum,
                                   err_msg=k)


@pytest.fixture(scope="module")
def gemma():
    cfg = get_config("gemma-2b", reduced=True)
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(0))
    return cfg, state, port_config("gemma-2b", reduced=True)


@pytest.fixture(scope="module", params=["pallas", "xla"])
def jax_run(request, gemma):
    """Three JAX train steps: per-step losses, step-1 gradients and the
    final parameters."""
    cfg, state, _ = gemma
    jcfg = cfg.with_(attn_impl=request.param)
    batches = [jax.tree.map(jnp.asarray, b) for b in _batches(cfg)]
    loss_fn = lambda p, b: jts.registry.loss(p, jcfg, b)
    (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, batches[0])
    step = jax.jit(jts.make_train_step(jcfg))
    losses, st = [], state
    for b in batches:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return request.param, losses, _flat(grads), _flat(st.params)


@pytest.mark.parametrize("arch,reduced", [("gemma-2b", True),
                                          ("mamba2-780m", False)])
def test_synthetic_batches_match_reference(arch, reduced):
    """The numpy pipeline's batches, at the reduced gemma vocab and at
    mamba2-780m's full 50280, equal the reference's."""
    cfg = get_config(arch, reduced=reduced)
    for seed, seq, batch in ((0, 16, 2), (7, 33, 3)):
        ours = SyntheticLM(PipelineConfig(cfg.vocab_size, seq, batch,
                                          seed=seed))
        theirs = JSyntheticLM(JPipelineConfig(cfg.vocab_size, seq, batch,
                                              seed=seed), cfg)
        for step in (0, 5):
            a, b = ours.global_batch(step), theirs.global_batch(step)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_adamw_update_matches_reference():
    """Three updates on the same numpy gradients (one large enough to
    clip): parameters, masters, m, v, grad norm and lr within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(warmup_steps=2, decay_steps=5)
    jcfg = jadamw.AdamWConfig(warmup_steps=2, decay_steps=5)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tstate, jstate = adamw.init(tparams), jadamw.init(jparams)
    for i, scale in enumerate((1.0, 30.0, 0.1)):
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        tparams, tstate, tm = adamw.update(
            cfg, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
            tparams)
        jparams, jstate, jm = jadamw.update(
            jcfg, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jparams)
        assert int(tstate.step) == int(jstate.step) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        for k in shapes:
            for ours, theirs in ((tparams[k], jparams[k]),
                                 (tstate.master[k], jstate.master[k]),
                                 (tstate.m[k], jstate.m[k]),
                                 (tstate.v[k], jstate.v[k])):
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                           rtol=1e-6, atol=1e-7)


def test_lm_loss_matches_reference(gemma):
    cfg, state, tcfg = gemma
    batch = _batches(cfg)[0]
    jl, jm = jts.registry.loss(state.params, cfg,
                               jax.tree.map(jnp.asarray, batch))
    tl, tm = tt.lm_loss(_port(state.params, trainable=False), tcfg,
                        torch.from_numpy(batch["tokens"]),
                        torch.from_numpy(batch["targets"]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=REL)
    assert set(tm) == set(jm)


def test_train_step_matches_reference(gemma, jax_run):
    """Three port steps against three JAX ``make_train_step`` steps
    (``attn_impl`` "pallas" runs the reference's interpret-mode flash
    kernels and their derived backward, "xla" its jnp oracle): the loss of
    each step and the step-1 gradients within 1e-5 relative (per leaf, to
    its largest entry); the update after three steps held to the
    reference's (``_hold_update``)."""
    cfg, state, tcfg = gemma
    _, jlosses, jgrads, jfinal = jax_run
    batches = [_tensors(b) for b in _batches(cfg)]
    params = _port(state.params)
    _, _, grads = ts.loss_and_grads(params, tcfg, batches[0])
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        want = jgrads[k]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max())
    tstate = ts.init_state(tcfg, params, device="cpu")
    step = ts.make_train_step(tcfg)
    for b, want in zip(batches, jlosses):
        tstate, m = step(tstate, b)
        np.testing.assert_allclose(float(m["loss"]), want, rtol=REL)
    opt = adamw.AdamWConfig()
    lr_sum = sum(float(adamw.schedule(opt, torch.tensor(i + 1)))
                 for i in range(STEPS))
    _hold_update(tstate.params, _flat(state.params), jfinal, lr_sum)


def test_microbatches_and_remat_give_the_same_step(gemma):
    """Two microbatches take the same step as one (within 1e-6: the
    gradient is the mean of the halves' means, summed in another order),
    and rematerialization, whole layers or "dots", changes no gradient."""
    cfg, state, tcfg = gemma
    batch = _tensors(_batches(cfg)[0])
    results = []
    for mb in (1, 2):
        st = ts.init_state(tcfg, _port(state.params), device="cpu")
        st, m = ts.make_train_step(tcfg, microbatches=mb)(st, batch)
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        {k: p.detach().clone()
                         for k, p in st.params.named_parameters()}))
    (l1, n1, p1), (l2, n2, p2) = results
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    np.testing.assert_allclose(n2, n1, rtol=1e-5)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=1e-6)

    params = _port(state.params)
    assert tcfg.remat
    _, _, on = ts.loss_and_grads(params, tcfg, batch)
    _, _, off = ts.loss_and_grads(params, tcfg.with_(remat=False), batch)
    for k in on:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)
    _, _, dots = ts.loss_and_grads(params, tcfg.with_(remat_policy="dots"),
                                   batch)
    for k in on:
        torch.testing.assert_close(dots[k], on[k], rtol=0, atol=0)


@pytest.mark.parametrize("rows,microbatches", [(2, 3), (3, 2)])
def test_microbatches_that_do_not_divide_the_batch_raise(gemma, rows,
                                                         microbatches):
    """A ``microbatches`` that does not divide the batch's rows raises on
    both sides (the reference through its reshape, the port before it
    splits), before any parameter moves."""
    cfg, state, tcfg = gemma
    batch = {k: np.concatenate([v] * 2)[:rows]
             for k, v in _batches(cfg)[0].items()}
    with pytest.raises(Exception):
        jts.make_train_step(cfg, microbatches=microbatches)(
            state, jax.tree.map(jnp.asarray, batch))
    st = ts.init_state(tcfg, _port(state.params), device="cpu")
    before = {k: p.detach().clone() for k, p in st.params.named_parameters()}
    with pytest.raises(ValueError, match="do not divide"):
        ts.make_train_step(tcfg, microbatches=microbatches)(st,
                                                            _tensors(batch))
    for k, p in st.params.named_parameters():
        assert torch.equal(p.detach(), before[k]), k


def test_init_state_makes_params_trainable_on_the_asked_device(gemma):
    _, state, tcfg = gemma
    params = _port(state.params, trainable=False)
    st = ts.init_state(tcfg, params, device="cpu")
    assert all(p.requires_grad for p in st.params.parameters())
    assert int(st.step) == 0 and int(st.opt.step) == 0
    assert st.opt.master.keys() == dict(params.named_parameters()).keys()
    assert all(t.dtype == torch.float32 for t in st.opt.m.values())


@pytest.fixture(scope="module")
def mamba_run():
    """Reduced mamba2-780m: three JAX train steps (the reference's SSD
    kernel in interpret mode, its derived K7-equivalent backward), their
    losses, step-1 gradients and final parameters."""
    cfg = get_config("mamba2-780m", reduced=True)
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(1))
    batches = [jax.tree.map(jnp.asarray, b) for b in _batches(cfg)]
    loss_fn = lambda p, b: jts.registry.loss(p, cfg, b)
    (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, batches[0])
    step = jax.jit(jts.make_train_step(cfg))
    losses, st = [], state
    for b in batches:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return cfg, state, losses, _flat(grads), _flat(st.params)


def test_ssm_train_step_matches_reference(mamba_run):
    """The port's mamba2 train step (K1 products and their VJP, the SSD
    scan with its checkpoint export and reverse scan, remat per layer)
    against three JAX ``make_train_step`` steps, held as the gemma steps
    are (``test_train_step_matches_reference``); the loss is computed
    without the per-layer caches the reference's jit drops."""
    cfg, state, jlosses, jgrads, jfinal = mamba_run
    tcfg = port_config("mamba2-780m", reduced=True)
    assert tcfg.remat
    batches = [_tensors(b) for b in _batches(cfg)]
    params = _port(state.params)
    _, _, grads = ts.loss_and_grads(params, tcfg, batches[0])
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        want = jgrads[k]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max(), err_msg=k)
    tstate = ts.init_state(tcfg, params, device="cpu")
    step = ts.make_train_step(tcfg)
    for b, want in zip(batches, jlosses):
        tstate, m = step(tstate, b)
        np.testing.assert_allclose(float(m["loss"]), want, rtol=REL)
    opt = adamw.AdamWConfig()
    lr_sum = sum(float(adamw.schedule(opt, torch.tensor(i + 1)))
                 for i in range(STEPS))
    _hold_update(tstate.params, _flat(state.params), jfinal, lr_sum)
