"""The port's hybrid family (``repro_torch.kernels.ref.gated_scan``,
``ops.gated_scan``, ``models.rglru``, the ring-cache decode, the hybrid
branches of ``models.transformer`` and ``train.serve_step``) against the
JAX package on the CPU, where the reference's ``ops.gated_scan`` runs the
Pallas K8 body in interpret mode: the same numpy inputs and the same
weights (carried across with ``params_from_numpy``), reduced
recurrentgemma-9b in float32 (5 layers: one (rglru, rglru, local) group
and a 2-layer RG-LRU tail, d_model 128, lru_width 128, window 8)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs import recurrentgemma_9b as jcfgs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import Collector  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import recurrentgemma_9b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers, rglru  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "recurrentgemma-9b"
#: f32 on both sides.  The reference's kernel scans each chunk
#: associatively and re-bases it on the carried state, the port walks the
#: sequence step by step: the same sums in another order, so the scans
#: agree to 1e-6 of the largest entry (bit for bit where log_a = 0 on
#: integers, as every partial sum is then an exact integer).  Through the
#: model (projections, norms, the conv, attention) the orders differ in
#: more places: 1e-4 of the largest logit, as the dense tests hold.
ULPS = 1e-6
TOL = 1e-4
#: the gradients of the scan: dbar, then products with the saved states
GRAD_TOL = 1e-5


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


def _scan_inputs(rng, b=2, s=24, w=5, integer=False, zero_log_a=False):
    """log_a, b, h0: integers (log_a in {0, -1, -2} or all 0, b and h0 in
    [-3, 3]) or normals (log_a = -0.5|N(0, 1)|, a 0.5-normal h0)."""
    if integer:
        la = -rng.integers(0, 3, (b, s, w)) * (not zero_log_a)
        out = (la, rng.integers(-3, 4, (b, s, w)),
               rng.integers(-3, 4, (b, w)))
    else:
        out = (-0.5 * np.abs(rng.standard_normal((b, s, w))),
               rng.standard_normal((b, s, w)),
               0.5 * rng.standard_normal((b, w)))
    return [np.asarray(a, np.float32) for a in out]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("zero_log_a", [True, False])
def test_gated_scan_matches_jax_kernel_on_integers(zero_log_a, with_h0):
    """``ops.gated_scan`` against the JAX kernel (interpret mode, chunk 8)
    on integer inputs: bit for bit where log_a = 0, else within ULPS."""
    la, b, h0 = _scan_inputs(np.random.default_rng(0), integer=True,
                             zero_log_a=zero_log_a)
    h0 = h0 if with_h0 else None
    hj, fj = jops.gated_scan(jnp.asarray(la), jnp.asarray(b),
                             init_state=None if h0 is None else
                             jnp.asarray(h0), chunk=8, interpret=True)
    h, f = ops.gated_scan(torch.from_numpy(la), torch.from_numpy(b),
                          init_state=None if h0 is None else
                          torch.from_numpy(h0))
    assert h.dtype == f.dtype == torch.float32 and h.shape == la.shape
    if zero_log_a:
        np.testing.assert_array_equal(h.numpy(), _np(hj))
        np.testing.assert_array_equal(f.numpy(), _np(fj))
    else:
        _close(h, hj, ULPS)
        _close(f, fj, ULPS)


@pytest.mark.parametrize("s", [21, 24])
def test_gated_scan_pad_contract_matches_jax(s):
    """Any length against the JAX kernel at chunk 8 (S = 21 pads its last
    chunk there; the port's walk has no chunk), with an entering state."""
    la, b, h0 = _scan_inputs(np.random.default_rng(1), s=s)
    hj, fj = jops.gated_scan(*map(jnp.asarray, (la, b)),
                             init_state=jnp.asarray(h0), chunk=8,
                             interpret=True)
    h, f = ops.gated_scan(*map(torch.from_numpy, (la, b)),
                          init_state=torch.from_numpy(h0))
    _close(h, hj, ULPS)
    _close(f, fj, ULPS)
    # the oracle the reference holds its kernel against, too
    ho, fo = jops._gated_oracle(*map(jnp.asarray, (la, b, h0)))
    _close(h, ho, ULPS)
    _close(f, fo, ULPS)


@pytest.mark.parametrize("zero_log_a", [True, False])
def test_reverse_walk_is_the_reference_backward_kind(zero_log_a):
    """The reverse form on forward-order operands equals the reference's
    ``gated_backward`` route: its forward kernel on the flipped,
    gate-shifted operands, flipped back (``ops._gated_kernel_bwd``)."""
    la, dy, _ = _scan_inputs(np.random.default_rng(2), s=21, integer=True,
                             zero_log_a=zero_log_a)
    shift = np.concatenate([la[:, 1:], np.zeros_like(la[:, :1])], axis=1)
    hj, fj = jops.gated_scan(jnp.asarray(shift[:, ::-1].copy()),
                             jnp.asarray(dy[:, ::-1].copy()), chunk=8,
                             interpret=True)
    h, f = ref.gated_scan(torch.from_numpy(la), torch.from_numpy(dy),
                          reverse=True)
    want = _np(hj)[:, ::-1]
    if zero_log_a:
        np.testing.assert_array_equal(h.numpy(), want)
        np.testing.assert_array_equal(f.numpy(), _np(fj))
    else:
        _close(h, want, ULPS)
        _close(f, fj, ULPS)
    # an entering state on the reverse walk enters at t = S-1 with a gate
    # of 1 (one past the end)
    h1, _ = ref.gated_scan(torch.from_numpy(la), torch.from_numpy(dy),
                           torch.ones(dy.shape[0], dy.shape[2]), reverse=True)
    assert torch.equal(h1[:, -1], torch.from_numpy(dy[:, -1]) + 1)


@pytest.mark.parametrize("with_h0", [True, False])
def test_gated_scan_grads_match_jax(with_h0):
    """Autograd through ``ops.gated_scan`` (the reverse walk and the
    per-token cotangents) against ``jax.grad`` through the reference's
    derived VJP, with cotangents on every step and on the final state
    (``gfin``), at a length that pads the reference's last chunk."""
    rng = np.random.default_rng(3)
    la, b, h0 = _scan_inputs(rng, s=21)
    gy = rng.standard_normal(la.shape).astype(np.float32)
    gf = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(a, bb, h):
        y, f = jops.gated_scan(a, bb, init_state=h, chunk=8, interpret=True)
        return jnp.sum(y * gy) + jnp.sum(f * gf)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (la, b, h0)))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (la, b, h0)]
    h, f = ops.gated_scan(tin[0], tin[1],
                          init_state=tin[2] if with_h0 else None)
    loss = (h * torch.from_numpy(gy)).sum() + (f * torch.from_numpy(gf)).sum()
    got = torch.autograd.grad(loss, tin[:3] if with_h0 else tin[:2])
    if not with_h0:
        want = jax.grad(lambda a, bb: jloss(a, bb, jnp.zeros_like(h0)),
                        argnums=(0, 1))(*map(jnp.asarray, (la, b)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL)


@pytest.fixture(scope="module")
def block():
    """One reduced RG-LRU block's parameters from the reference's
    ``init_rglru``, with non-trivial biases and decay, carried across."""
    cfg = get_config(ARCH, reduced=True)
    col = Collector(jax.random.PRNGKey(4), dtype=jnp.float32)
    jrglru.init_rglru(col, "r", cfg)
    jp = dict(col.params["r"])
    rng = np.random.default_rng(5)
    for k in ("conv_b", "ba", "bi", "lam"):
        jp[k] = jnp.asarray(0.5 * rng.standard_normal(jp[k].shape),
                            jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, port_config(ARCH, reduced=True), tp


def test_apply_and_decode_rglru_match_jax(block):
    """The full-sequence block (output and cache) and the decode step
    against the reference's; stepping the port's decode token by token
    reproduces its full-sequence block."""
    cfg, jp, tcfg, tp = block
    b, s = 2, 11
    x = (0.5 * np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)
    jy, jc = jrglru.apply_rglru(jp, jnp.asarray(x), cfg)
    ty, tc = rglru.apply_rglru(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, TOL)
    _close(tc.h, jc.h, TOL)
    _close(tc.conv, jc.conv, TOL)
    cache = rglru.init_rglru_cache(tcfg, b, dtype=torch.float32,
                                   device="cpu")
    jcache = jrglru.init_rglru_cache(cfg, b, dtype=jnp.float32)
    outs = []
    for t in range(s):
        xt = x[:, t:t + 1]
        o, cache = rglru.decode_rglru(tp, torch.from_numpy(xt), cache, tcfg)
        jo, jcache = jrglru.decode_rglru(jp, jnp.asarray(xt), jcache, cfg)
        _close(o, jo, TOL)
        outs.append(o)
    _close(cache.h, jcache.h, TOL)
    _close(torch.cat(outs, 1), ty, TOL)
    _close(cache.h, tc.h, TOL)
    _close(cache.conv, tc.conv, TOL)


@pytest.fixture(scope="module")
def hybrid():
    cfg = get_config(ARCH, reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config(ARCH, reduced=True), tp


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def test_params_from_numpy_carries_the_hybrid_tree(hybrid):
    """The three-level tree (``groups.rec.w_x``, ``tail.rec.*``, ...)
    arrives as it is, and the port's own init has its names and shapes."""
    _, params, tcfg, tp = hybrid
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    assert {"groups.rec.w_x", "groups.rec.lam", "groups.att.wq",
            "groups.rec_mlp.wi", "groups.att_ln2.scale", "tail.rec.w_out",
            "tail.mlp.wo", "tail.ln1.scale", "embed.table",
            "final_norm.scale"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    shapes = {k: tuple(t.shape) for k, t in tt.init_lm(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
        .state_dict().items()}
    assert shapes == {k: v.shape for k, v in want.items()}
    assert shapes["groups.rec.wa"] == (1, 2, 128, 128)
    assert shapes["groups.att.wq"] == (1, 1, 128, 4, 32)
    assert shapes["tail.rec.conv_w"] == (2, 4, 128)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_recurrentgemma_9b(reduced):
    """The config copy field for field, and (full) its 9,396,408,320
    parameters counted from ``param_shapes``."""
    ref_cfg = jcfgs.reduced() if reduced else jcfgs.full()
    cfg = recurrentgemma_9b.reduced() if reduced else recurrentgemma_9b.full()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    shapes = tt.param_shapes(cfg)
    n = sum(int(np.prod(s)) for g in shapes.values() for s, _ in g.values())
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda k: registry.init(ref_cfg, k)[0],
                       jax.random.PRNGKey(0))))
    assert n == want
    if not reduced:
        assert n == 9_396_408_320
        assert tt.hybrid_layout(cfg) == (12, 2, 2, 1)
        assert shapes["groups.rec"]["w_x"][0] == (12, 2, 4096, 4096)
        assert shapes["groups.att"]["wq"][0] == (12, 1, 4096, 16, 256)
        assert shapes["groups.att_mlp"]["wi"][0] == (12, 1, 4096, 24576)
        assert shapes["tail.rec"]["w_out"][0] == (2, 4096, 4096)


def _tree_close(got, want, rel):
    """A port cache (NamedTuples and dicts of tensors) against the
    reference's, leaf by leaf, in field order."""
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _tree_close(got[k], want[k], rel)
    elif isinstance(got, tuple):
        assert type(got)._fields == type(want)._fields
        for g, w in zip(got, want):
            _tree_close(g, w, rel)
    else:
        assert tuple(got.shape) == want.shape
        _close(got, want, rel)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_prefill_logits_and_cache_match_jax(hybrid, attn_impl):
    """``make_prefill`` over a prompt longer than the window (the local
    layer's mask cuts): last-position logits and the whole cache (each
    RG-LRU layer's state and conv history, the local layer's K/V, the
    tail's), against the reference's ``make_prefill``."""
    cfg, params, tcfg, tp = hybrid
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jserve.make_prefill(cfg.with_(attn_impl=attn_impl))(
        params, {"tokens": jnp.asarray(tokens)})
    tl, tc = serve_step.make_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, TOL)
    _tree_close(tc, jc, TOL)
    hidden, none = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                              want_cache=False)
    assert none is None
    _close(hidden[:, -1:], tt.forward(tp, tcfg, torch.from_numpy(tokens))[0]
           [:, -1:], 0)


def test_decode_steps_wrap_the_ring_and_match_jax(hybrid):
    """24 teacher-forced decode steps from a zero cache (``cache_len`` 16,
    so the window-8 ring wraps twice): each step's logits against the
    reference's ``decode_step`` and against the full-sequence forward's
    logits at that position; the final cache against the reference's."""
    cfg, params, tcfg, tp = hybrid
    b, s = 2, 24
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (b, s))
    hidden, _ = tt.forward(tp, tcfg, torch.from_numpy(tokens))
    full = layers.logits_from_hidden(tp, hidden, tcfg)
    cache = tt.init_cache(tcfg, b, 16, dtype=torch.float32, device="cpu")
    jcache = jt.init_cache(cfg, b, 16, dtype=jnp.float32)
    _tree_close(cache, jcache, 0)
    assert tuple(cache["att"].k.shape) == (1, 1, b, 8, 1, 32)
    jstep = jax.jit(jt.decode_step, static_argnums=1)
    for t in range(s):
        pos = np.full(b, t, np.int32)
        tl, cache = tt.decode_step(tp, tcfg, torch.from_numpy(tokens[:, t]),
                                   torch.from_numpy(pos), cache)
        jl, jcache = jstep(params, cfg, jnp.asarray(tokens[:, t]),
                           jnp.asarray(pos), jcache)
        _close(tl, jl, TOL)
        _close(tl, full[:, t], TOL)
    _tree_close(cache, jcache, TOL)


def test_greedy_generate_matches_jax(hybrid):
    """The same tokens as the reference's ``greedy_generate``: a 6-token
    prompt ingested token by token, then 12 new tokens with ``cache_len``
    16 (the window-8 ring wraps)."""
    cfg, params, tcfg, tp = hybrid
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  12, 16)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 12,
                                     16)
    assert got.shape == (2, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batches(cfg, batch, seq=16, steps=3):
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, seq, batch))
    return [data.global_batch(i) for i in range(steps)]


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_steps_match_jax(hybrid, microbatches):
    """Three AdamW steps (remat on) against the reference's
    ``make_train_step``: per-step losses, the final parameters and
    masters, on the same SyntheticLM batches (B = 4, S = 16, longer than
    the window).  The per-step updates are a few 1e-3 of the weights, so
    the final parameters sit within TOL of the reference's."""
    cfg, _, tcfg, _ = hybrid
    state, _ = jts.init_state(cfg, jax.random.PRNGKey(1))
    batches = _batches(cfg, 4)
    step = jax.jit(jts.make_train_step(cfg, microbatches=microbatches))
    jst, jlosses = state, []
    for bt in batches:
        jst, m = step(jst, jax.tree.map(jnp.asarray, bt))
        jlosses.append(float(m["loss"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, state.params),
                           device="cpu", trainable=True)
    tstate = ts.init_state(tcfg, tp, device="cpu")
    tstep = ts.make_train_step(tcfg, microbatches=microbatches)
    for bt, jl in zip(batches, jlosses):
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in bt.items()})
        assert abs(float(tm["loss"]) - jl) <= TOL * abs(jl)
    want = _flat(jst.params)
    got = {k: p.detach() for k, p in tstate.params.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], TOL)
    assert int(tstate.step) == int(jst.step) == 3


def test_train_step_gradients_match_jax(hybrid):
    """Step 1's loss and every gradient leaf (remat on) against
    ``jax.value_and_grad`` of the reference's loss."""
    cfg, params, tcfg, _ = hybrid
    bt = _batches(cfg, 2, steps=1)[0]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jts.registry.loss(p, cfg, b), has_aux=True))(
            params, jax.tree.map(jnp.asarray, bt))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    loss, _, grads = ts.loss_and_grads(tp, tcfg, {
        k: torch.from_numpy(v) for k, v in bt.items()})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want = _flat(jgrads)
    assert grads.keys() == want.keys()
    for k in want:
        _close(grads[k], want[k], TOL)


def test_engine_and_dense_generation_refuse_with_reasons(hybrid):
    """``ServeEngine`` refuses the hybrid family for the reference's own
    reason and points to ``greedy_generate``; ``greedy_generate`` runs the
    dense family (its contiguous decode); the hybrid has no prefill
    re-layout (None, as in the reference)."""
    from repro_torch.serving import ServeEngine
    *_, tcfg, tp = hybrid
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        ServeEngine(tcfg, tp, device="cpu")
    gcfg = port_config("gemma-2b", reduced=True)
    gp = tt.init_lm(gcfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.tensor([[1, 2, 3]])
    out = serve_step.greedy_generate(gp, gcfg, prompt, 2, 8)
    assert out.shape == (1, 5) and torch.equal(out[:, :3], prompt)
    assert ((out >= 0) & (out < gcfg.vocab_size)).all()
    assert tt.prefill_cache_to_decode(tcfg, None, 8) is None
