"""The port's llama4 layout of the MoE family (``layer_pattern`` groups of
local and full attention layers, each with the MoE FFN) against the JAX
package on the CPU: reduced llama4-scout-17b-a16e in float32 (one group of
(local, local, local, full); d_model 128, 4 experts of width 128, top-1,
one shared expert, window 8), the same numpy inputs and the JAX
``init_lm`` weights carried across with ``params_from_numpy``.  Prefill
(S = 13 > the window), decode steps past position 8 (the local layers'
ring caches wrap), ``greedy_generate``, ``lm_loss`` and its gradients."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
#: f32 on both sides, summation order only: the logits, caches and
#: gradients to 1e-4 of their largest entry (the dense tests' tolerance),
#: the aux terms to 1e-5 relative
TOL = 1e-4
STAT_TOL = 1e-5


@pytest.fixture(scope="module")
def llama4():
    cfg = get_config(ARCH, reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config(ARCH, reduced=True), tp


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    """The config field for field, full and reduced."""
    assert dataclasses.asdict(port_config(ARCH, reduced)) == \
        dataclasses.asdict(get_config(ARCH, reduced))


def test_param_tree_follows_reference(llama4):
    """``init_lm``'s names and shapes are the reference's: ``groups.{ln1,
    ln2, attn, moe}`` stacked ``(groups, len(pattern))``, the router f32
    whatever the model's dtype; at full width ``groups.moe.wi`` is (12,
    4, 16, 5120, 16384)."""
    cfg, params, tcfg, _ = llama4
    shapes = tt.param_shapes(port_config(ARCH))
    assert shapes["groups.moe"]["wi"][0] == (12, 4, 16, 5120, 16384)
    assert shapes["groups.attn"]["wq"][0] == (12, 4, 5120, 40, 128)
    assert tt.moe_groups(port_config(ARCH)) == (12, 3, 1)
    tp = tt.init_lm(tcfg.with_(dtype="bfloat16"),
                    torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(t.shape) for k, t in tp.state_dict().items()}
    assert got == {k: v.shape for k, v in _flat(params).items()}
    assert tp["groups"]["moe"]["router"].dtype == torch.float32
    assert tp["groups"]["moe"]["wi"].dtype == torch.bfloat16


def test_params_from_numpy_carries_the_groups_tree(llama4):
    """The reference's ``groups/*`` tree converts as it is: every leaf's
    name, shape, dtype and values."""
    _, params, _, tp = llama4
    flat = _flat(jax.tree.map(np.asarray, params))
    state = tp.state_dict()
    assert set(state) == set(flat) and any(k.startswith("groups.moe.")
                                           for k in flat)
    for k, v in flat.items():
        assert str(state[k].dtype).removeprefix("torch.") == str(v.dtype)
        np.testing.assert_array_equal(state[k].numpy(), v)


def test_prefill_logits_cache_and_aux_match_reference(llama4):
    """``prefill`` at S = 13 (past the window of 8, so the local layers'
    mask cuts): the last position's logits, the K/V cache stacked ``(1, 4,
    B, S, KV, hd)`` as the reference's scanned groups stack it, and the
    forward's aux terms (the dropped share summed over a group's layers,
    as the reference's)."""
    cfg, params, tcfg, tp = llama4
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg, jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    _close(tl, jl, TOL)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (1, 4, 2, 13, 2, 32)
    _close(tc.k, jc.k, TOL)
    _close(tc.v, jc.v, TOL)
    _, _, jaux = jt.forward(params, cfg, jnp.asarray(tokens))
    _, _, taux = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                            want_cache=False, with_aux=True)
    for got, want in zip(taux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=STAT_TOL)


def test_window_changes_the_local_layers(llama4):
    """The local layers are windowed: with ``local_window`` raised past
    the sequence the logits move (so the test above would see a missing
    window)."""
    cfg, params, tcfg, tp = llama4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 13)))
    a, _ = tt.prefill(tp, tcfg, tokens)
    b, _ = tt.prefill(tp, tcfg.with_(local_window=64), tokens)
    assert (a - b).abs().max() > 1e-3


def test_decode_steps_wrap_the_ring_as_reference(llama4):
    """``init_cache`` (local ring caches of ``min(window, cache_len)`` = 8
    slots, the full layer's 16) and 12 ``decode_step``s from it at B = 2,
    the rows at other positions (up to 14: the rings wrap): logits and
    both caches after each step."""
    cfg, params, tcfg, tp = llama4
    rng = np.random.default_rng(6)
    jc = jt.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = tt.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.k.shape) for k, v in tc.items()} == \
        {k: tuple(v.k.shape) for k, v in jc.items()} == \
        {"local": (1, 3, 2, 8, 2, 32), "full": (1, 1, 2, 16, 2, 32)}
    for step in range(12):
        tok = rng.integers(0, cfg.vocab_size, 2)
        pos = np.array([step, step + 3], np.int32)
        jl, jc = jt.decode_step(params, cfg, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = tt.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        _close(tl, jl, TOL)
        for key in ("local", "full"):
            _close(tc[key].k, jc[key].k, TOL)
            _close(tc[key].v, jc[key].v, TOL)


def test_greedy_generate_tokens_equal_reference(llama4):
    """``greedy_generate`` ingests the prompt token by token (grouped ring
    caches have no forward->decode re-layout, as in the reference) and
    decodes past the window: the tokens equal the reference's."""
    cfg, params, tcfg, tp = llama4
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 6))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt), 8, 16)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 8,
                                     16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_loss_and_gradients_match_reference(llama4):
    """``lm_loss`` (``nll + 0.01 aux + 1e-3 z``) and its metrics, and
    every leaf's gradient (remat on: each layer rerun in the backward)
    against ``jax.value_and_grad`` of the reference's, the gradients
    within 1e-4 of each leaf's largest entry."""
    cfg, params, tcfg, _ = llama4
    assert tcfg.remat
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    targets = rng.integers(0, cfg.vocab_size, (2, 16))
    (jl, jm), jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(p, cfg, jnp.asarray(tokens),
                             jnp.asarray(targets)), has_aux=True)(params)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    tl, tm, grads = ts.loss_and_grads(
        tp, tcfg, {"tokens": torch.from_numpy(tokens),
                   "targets": torch.from_numpy(targets)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=STAT_TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STAT_TOL)
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        _close(g, jgrads[name], TOL)
