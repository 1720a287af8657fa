"""The port's MoE family (``repro_torch.models.moe``, K1's expert form in
``kernels.ops`` and ``kernels.ref``, the moe branches of
``models.transformer``, ``train.serve_step`` and ``serving``) against the
JAX package on the CPU: the same numpy inputs and the same weights
(carried across with ``params_from_numpy``), reduced deepseek-moe-16b in
float32 (3 layers: one dense, two MoE; d_model 128, 8 experts of width 64,
top-2, one shared expert).  Routing is held to the reference exactly: the
top-k indices are equal, ties going to the lower expert as in
``jax.lax.top_k``."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

ARCH = "deepseek-moe-16b"
#: f32 on both sides: the same products and sums in other orders, so the
#: MoE FFN agrees to 1e-5 of its largest output and the model's logits to
#: 1e-4 of the largest (the dense tests' tolerance); the stats (means of
#: f32 softmax terms, exact counts) to 1e-5 relative
MOE_TOL = 1e-5
TOL = 1e-4
STAT_TOL = 1e-5


@pytest.fixture(scope="module")
def deepseek():
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
            out[name] = v
    return out


def _moe_layer(params, tp, i):
    """MoE layer ``i``'s parameters on both sides."""
    return (jax.tree.map(lambda t: t[i], params["layers"]["moe"]),
            {k: v[i] for k, v in tp["layers"]["moe"].items()})


def _jax_route(lp, x, cfg):
    """The reference's top-k expert indices of ``x (B, S, d)``."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt @ lp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_and_param_tree_follow_reference(deepseek, reduced):
    """The config field for field; ``init_lm``'s names and shapes are the
    reference's (``dense_layers.*`` over the first dense layer,
    ``layers.moe.*`` over the rest); the router is f32 whatever the
    model's dtype, the experts take it."""
    assert dataclasses.asdict(port_config(ARCH, reduced)) == \
        dataclasses.asdict(get_config(ARCH, reduced))
    cfg, params, tcfg, _ = deepseek
    if not reduced:
        shapes = tt.param_shapes(port_config(ARCH))
        assert shapes["layers.moe"]["wi"][0] == (27, 64, 2048, 2816)
        assert shapes["dense_layers.mlp"]["wi"][0] == (1, 2048, 22528)
        return
    tp = tt.init_lm(tcfg.with_(dtype="bfloat16"),
                    torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(t.shape) for k, t in tp.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in _flat(params).items()}
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert (tp["dense_layers"]["ln1"]["scale"] == 1).all()


def test_params_from_numpy_carries_the_moe_tree(deepseek):
    """The reference's tree converts as it is: every leaf's name, shape,
    dtype (the f32 router included) and values."""
    _, params, _, tp = deepseek
    flat = _flat(jax.tree.map(np.asarray, params))
    state = tp.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        assert str(state[k].dtype).removeprefix("torch.") == str(v.dtype)
        np.testing.assert_array_equal(state[k].numpy(), v)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 1e-9])
def test_apply_moe_matches_reference(deepseek, layer, capacity_factor):
    """``apply_moe`` against ``_apply_moe_global`` on the same input: the
    output, the top-k indices (equal), the aux and z losses and the
    dropped share.  At ``capacity_factor=1e-9`` each expert keeps 8 of
    its assignments and most of the 2 x 40 tokens' drop."""
    cfg, params, tcfg, tp = deepseek
    cfg = cfg.with_(capacity_factor=capacity_factor)
    tcfg = tcfg.with_(capacity_factor=capacity_factor)
    jlp, tlp = _moe_layer(params, tp, layer)
    x = np.random.default_rng(layer).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    jy, jstats = jmoe._apply_moe_global(jlp, jnp.asarray(x), cfg)
    ty, tstats = moe.apply_moe(tlp, torch.from_numpy(x), tcfg)
    _close(ty, jy, MOE_TOL)
    idx = moe.route(tlp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                    tcfg)[3]
    np.testing.assert_array_equal(idx.numpy(), _jax_route(jlp, x, cfg))
    for got, want in zip(tstats, jstats):
        np.testing.assert_allclose(float(got), float(want), rtol=STAT_TOL)
    if capacity_factor < 1:
        assert moe.capacity(tcfg, 80) == 8 and float(tstats[2]) > 0.5
    else:
        assert moe.capacity(tcfg, 80) == 32


def test_top_k_ties_take_the_lower_expert(deepseek):
    """Integer-valued inputs on a router with repeated columns give equal
    probabilities: the port's stable sort picks the lower expert first,
    as ``jax.lax.top_k`` does, and the MoE output follows."""
    cfg, params, tcfg, tp = deepseek
    jlp, tlp = _moe_layer(params, tp, 0)
    router = np.asarray(jlp["router"]).copy()
    router[:, 1::2] = router[:, 0::2]           # experts 2i and 2i+1 tie
    router = np.round(router * 4)
    jlp = dict(jlp, router=jnp.asarray(router))
    tlp = dict(tlp, router=torch.from_numpy(router))
    x = np.random.default_rng(5).integers(-2, 3, (1, 24, cfg.d_model)
                                          ).astype(np.float32)
    idx = moe.route(tlp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                    tcfg)[3].numpy()
    want = _jax_route(jlp, x, cfg)
    np.testing.assert_array_equal(idx, want)
    assert (want[:, 0] % 2 == 0).all() and (want[:, 1] == want[:, 0] + 1).all()
    jy, _ = jmoe._apply_moe_global(jlp, jnp.asarray(x), cfg)
    ty, _ = moe.apply_moe(tlp, torch.from_numpy(x), tcfg)
    _close(ty, jy, MOE_TOL)


def test_apply_moe_rerun_is_bit_identical(deepseek):
    """Dispatch and combine are gathers and a fixed-order sum: two runs
    give the same bits (in bf16 too, where the k-sum rounds each add)."""
    _, params, tcfg, tp = deepseek
    _, tlp = _moe_layer(params, tp, 1)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 17, tcfg.d_model)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        lp = {k: v if k == "router" else v.to(dt) for k, v in tlp.items()}
        a, sa = moe.apply_moe(lp, x.to(dt), tcfg)
        b, sb = moe.apply_moe(lp, x.to(dt), tcfg)
        assert a.dtype == dt and torch.equal(a, b)
        assert all(torch.equal(p, q) for p, q in zip(sa, sb))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_plain_expert_gemm_matches_reference(dtype):
    """``ref.expert_gemm`` (and ``ops.expert_gemm`` / ``expert_matmul`` on
    CPU tensors) against the reference's ``ops.expert_gemm`` in the Pallas
    interpreter and its ``einsum``: f32 to 1e-5 of the largest entry, bit
    for bit on integers (every partial sum exact)."""
    rng = np.random.default_rng(4)
    if dtype == np.int8:
        x = rng.integers(-3, 4, (3, 8, 48)).astype(np.float32)
        w = rng.integers(-3, 4, (3, 48, 40)).astype(np.float32)
    else:
        x = rng.standard_normal((3, 8, 48)).astype(np.float32)
        w = rng.standard_normal((3, 48, 40)).astype(np.float32)
    want = np.asarray(jops.expert_gemm(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    ein = np.einsum("ecd,edf->ecf", x, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for got in (ref.expert_gemm(tx, tw), ops.expert_gemm(tx, tw),
                ops.expert_matmul(tx.bfloat16(), tw.bfloat16(),
                                  out_dtype=torch.float32)
                if dtype == np.int8 else ops.expert_matmul(tx, tw)):
        if dtype == np.int8:
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), ein)
        else:
            _close(got, want, MOE_TOL)
            _close(got, ein, MOE_TOL)


def test_expert_matmul_gradients_match_reference():
    """On the CPU, ``expert_matmul``'s backward (the plain forms of K1's
    expert VJP, ``dx = g wᵀ``, ``dw = xᵀ g``) against ``jax.grad`` of the
    reference's ``expert_matmul``."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((2, 16, 24)).astype(np.float32)
    g = rng.standard_normal((2, 8, 24)).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(
        jops.expert_matmul(a, b, out_dtype=jnp.float32) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (ops.expert_matmul(tx, tw, out_dtype=torch.float32)
     * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jdx, MOE_TOL)
    _close(tw.grad, jdw, MOE_TOL)


#: (e, cap, d, f, dtype, aligned) -> K1's route or K9: the decode rows at
#: cap <= 16 with d % 32 == 0, K1's tile for the other aligned bf16 forms,
#: K9's batched TILE for f32, rows of d or f not a multiple of 8, or an
#: unaligned base
ROUTES = [((64, 8, 2048, 2816, "bfloat16", True), "gemv"),
          ((64, 8, 1408, 2048, "bfloat16", True), "gemv"),
          ((64, 16, 2048, 2816, "bfloat16", True), "gemv"),
          ((64, 17, 2048, 2816, "bfloat16", True), "tile"),
          ((64, 240, 2048, 2816, "bfloat16", True), "tile"),
          ((8, 8, 200, 136, "bfloat16", True), "tile"),
          ((8, 24, 200, 136, "bfloat16", True), "tile"),
          ((8, 24, 201, 136, "bfloat16", True), "K9"),
          ((8, 24, 200, 138, "bfloat16", True), "K9"),
          ((64, 8, 2048, 2816, "bfloat16", False), "K9"),
          ((64, 8, 2048, 2816, "float32", True), "K9"),
          ((64, 240, 2048, 2816, "float32", True), "K9")]


@pytest.mark.parametrize("case,route", ROUTES)
def test_expert_plan_routes(case, route):
    """The memoised plan of ``expert_gemm_expr`` (a host function): K1 with
    the lifted expert axis where ``expert_route`` gives one of K1's
    routes, else K9's launch descriptor on its TILE path."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import emit
    e, cap, d, f, dt, aligned = case
    assert ops.expert_route(e, cap, d, f, dt, dt, aligned) == route
    nf = E.normal_form(E.expert_gemm_expr(e, cap, d, f))
    plan = ops._plan(nf, (dt, dt), torch.float32, ops.H100, None,
                     "float32", aligned)
    if route == "K9":
        assert plan[0] == "K9" and plan[1].mode == emit.TILE
    else:
        assert plan == ("K1", False, False, True)
    if route == "gemv":
        assert ops.gemv_splits(cap, f, d, e) == 1


def test_prefill_logits_and_cache_match_reference(deepseek):
    """``prefill``: the last position's logits and the ``{"dense",
    "moe"}`` K/V cache; the forward's aux terms as the reference's."""
    cfg, params, tcfg, tp = deepseek
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg, jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    _close(tl, jl, TOL)
    assert set(tc) == set(jc) == {"dense", "moe"}
    for key in ("dense", "moe"):
        _close(tc[key].k, jc[key].k, TOL)
        _close(tc[key].v, jc[key].v, TOL)
    _, _, jaux = jt.forward(params, cfg, jnp.asarray(tokens))
    _, _, taux = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                            want_cache=False, with_aux=True)
    for got, want in zip(taux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=STAT_TOL)


def test_decode_steps_match_reference(deepseek):
    """``init_cache`` and five ``decode_step``s from it (B = 3, rows at
    other positions): logits and both caches after each step."""
    cfg, params, tcfg, tp = deepseek
    rng = np.random.default_rng(6)
    jc = jt.init_cache(cfg, 3, 12, dtype=jnp.float32)
    tc = tt.init_cache(tcfg, 3, 12, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.k.shape) for k, v in tc.items()} == \
        {k: tuple(v.k.shape) for k, v in jc.items()}
    for step in range(5):
        tok = rng.integers(0, cfg.vocab_size, 3)
        pos = np.array([step, step + 2, 2 * step], np.int32)
        jl, jc = jt.decode_step(params, cfg, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = tt.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        _close(tl, jl, TOL)
        for key in ("dense", "moe"):
            _close(tc[key].k, jc[key].k, TOL)


def test_greedy_generate_tokens_equal_reference(deepseek):
    """``greedy_generate`` ingests the prompt token by token (no
    forward->decode re-layout for moe, as in the reference): the tokens
    equal the reference's."""
    cfg, params, tcfg, tp = deepseek
    assert not tt.has_prefill_decode_relayout(tcfg)
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        tt.prefill_cache_to_decode(tcfg, None, 16)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 6))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt), 5, 16)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 5,
                                     16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_loss_value_and_metrics_match_reference(deepseek):
    """``lm_loss``: ``nll + 0.01 aux + 1e-3 z`` and the reference's
    metrics (``nll``, ``moe_aux``, ``moe_z``, ``dropped``)."""
    cfg, params, tcfg, tp = deepseek
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    targets = rng.integers(0, cfg.vocab_size, (2, 16))
    jl, jm = jt.lm_loss(params, cfg, jnp.asarray(tokens),
                        jnp.asarray(targets))
    tl, tm = tt.lm_loss(tp, tcfg, torch.from_numpy(tokens),
                        torch.from_numpy(targets))
    np.testing.assert_allclose(float(tl), float(jl), rtol=STAT_TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STAT_TOL)
    assert float(tl) > float(tm["nll"])


def test_engine_refuses_moe_with_the_reference_reason(deepseek):
    """Neither engine serves moe: the reference's fails at admission (no
    forward->decode cache re-layout), the port's at construction with
    that reason, pointing at ``greedy_generate``."""
    cfg, params, tcfg, tp = deepseek
    with pytest.raises(NotImplementedError,
                       match="forward->decode.*greedy_generate"):
        ServeEngine(tcfg, tp, device="cpu")
    engine = JServeEngine(cfg, params, max_len=32)
    engine.submit([1, 2, 3], 2)
    with pytest.raises(NotImplementedError, match="forward->decode"):
        engine.step()


def test_layer_pattern_moe_raises(deepseek):
    """A moe config with a ``layer_pattern`` (llama4's grouped local and
    full layers) is not ported yet."""
    *_, tcfg, _ = deepseek
    with pytest.raises(NotImplementedError, match="layer_pattern.*ROADMAP"):
        tt.param_shapes(tcfg.with_(layer_pattern=("local", "full")))
