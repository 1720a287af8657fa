"""The port's SSM family (``repro_torch.kernels.ref`` SSD scans,
``ops.scan_ssd``, ``models.ssm``, the ssm branches of
``models.transformer``) against the JAX package on the CPU: the same numpy
inputs and the same weights (carried across with ``params_from_numpy``),
reduced mamba2-780m in float32 (2 layers, d_model 64, state 16, head_dim
16, chunk 8)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import hardware as hw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import Collector  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

HW = hw.get_entry("tpu_v5e")
#: f32 on both sides; the contractions sum in another order (XLA's CPU dot
#: is a sequential fused multiply-add fold, torch's einsum rounds each
#: product), so results differ in the last bits: 1e-6 relative to the
#: largest entry where the inputs are integers, 1e-5 on normal inputs
ULPS = 1e-6
TOL = 1e-5


def _np(t):
    return np.asarray(t)


def _ssd_inputs(rng, b=2, s=24, h=3, p=4, n=5, integer=False, zero_da=False):
    """The reference's ``tests/test_recurrence._ssd_inputs``, made with
    numpy: integers in [-3, 3] / [-2, 2] with a log decay in {0, -1, -2},
    or normals with a log decay of -0.3|N(0, 1)| and a 0.1-normal
    entering state."""
    if integer:
        out = (rng.integers(-3, 4, (b, s, h, p)),
               -rng.integers(0, 3, (b, s, h)) * (not zero_da),
               rng.integers(-2, 3, (b, s, n)), rng.integers(-2, 3, (b, s, n)),
               rng.integers(-2, 3, (b, h, p, n)))
    else:
        out = (rng.standard_normal((b, s, h, p)),
               -0.3 * np.abs(rng.standard_normal((b, s, h))),
               rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
               0.1 * rng.standard_normal((b, h, p, n)))
    return [np.asarray(a, np.float32) for a in out]


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("zero_da", [True, False])
def test_ssd_scan_matches_jax_kernel_on_integers(zero_da):
    """The plain scan against the JAX kernel in interpret mode on the
    reference's integer inputs.  With a zero log decay every intermediate
    is an integer below 2^24, so the two agree bit for bit whatever their
    summation order; a non-zero integer log decay makes exp() irrational
    and the two orders then differ in the last bits (``ULPS``)."""
    xdt, dA, B, C, h0 = _ssd_inputs(np.random.default_rng(0), integer=True,
                                    zero_da=zero_da)
    yj, fj = jops.scan_ssd(*map(jnp.asarray, (xdt, dA, B, C)),
                           init_state=jnp.asarray(h0), chunk=8,
                           interpret=True)
    y, f, h_in = ref.ssd_scan(*map(torch.from_numpy, (xdt, dA, B, C, h0)), 8,
                              export_h_in=True)
    assert torch.equal(h_in[:, 0], torch.from_numpy(h0))
    if zero_da:
        np.testing.assert_array_equal(y.numpy(), _np(yj))
        np.testing.assert_array_equal(f.numpy(), _np(fj))
    else:
        _close(y, yj, ULPS)
        _close(f, fj, ULPS)


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8), (5, 8), (16, 16)])
def test_scan_ssd_pad_contract_matches_jax(s, chunk):
    """``ops.scan_ssd`` at any length (padded tokens are the identity
    step) with a non-zero entering state, against the JAX kernel; the
    exported checkpoints against JAX's ``_ssd_kernel_fwd``."""
    xdt, dA, B, C, h0 = _ssd_inputs(np.random.default_rng(1), s=s)
    jin = list(map(jnp.asarray, (xdt, dA, B, C)))
    yj, fj = jops.scan_ssd(*jin, init_state=jnp.asarray(h0), chunk=chunk,
                           interpret=True)
    tin = list(map(torch.from_numpy, (xdt, dA, B, C, h0)))
    y, f = ops.scan_ssd(*tin[:4], init_state=tin[4], chunk=chunk)
    assert y.shape == xdt.shape
    _close(y, yj, TOL)
    _close(f, fj, TOL)
    q = min(chunk, s)
    _, resid = jops._ssd_kernel_fwd(*jin, jnp.asarray(h0), q, HW.name, True)
    pad = (-s) % q
    _, _, h_in = ops.ssd_scan_chunked(
        *[ops._pad_seq(t, pad) for t in tin[:4]], tin[4], q,
        export_h_in=True)
    _close(h_in, resid[4], TOL)


@pytest.mark.parametrize("zero_da", [True, False])
def test_ssd_bwd_matches_jax_reference_on_integers(zero_da):
    """The plain reverse scan, over operands in forward order, against
    ``ref.ssd_bwd_ref`` on the chunk-reversed operands of the reference's
    ``tests/test_backward_kernels.py`` (its integer inputs and its saved
    checkpoints); bit for bit where the log decay is zero (see
    ``test_ssd_scan_matches_jax_kernel_on_integers``)."""
    rng = np.random.default_rng(2)
    b, s, h, p, n, chunk = 2, 14, 2, 4, 4, 4
    nc = -(-s // chunk)
    sp = nc * chunk
    ints = lambda *shape: rng.integers(-2, 3, shape).astype(np.float32)
    xi, di, Bi, Ci = ints(b, s, h, p), -np.abs(ints(b, s, h)), \
        ints(b, s, n), ints(b, s, n)
    gy, gf, h0 = ints(b, s, h, p), ints(b, h, p, n), ints(b, h, p, n)
    if zero_da:
        di = np.zeros_like(di)
    _, resid = jops._ssd_kernel_fwd(*map(jnp.asarray, (xi, di, Bi, Ci, h0)),
                                    chunk, HW.name, True)
    hin = np.array(resid[4])

    def padded(a):
        return np.pad(a, ((0, 0), (0, sp - s)) + ((0, 0),) * (a.ndim - 2))

    def flipped(a):
        a = padded(a)
        return jnp.flip(jnp.asarray(a.reshape(b, nc, chunk, *a.shape[2:])),
                        axis=1)

    want = jref.ssd_bwd_ref(flipped(Ci), flipped(Bi), flipped(gy),
                            flipped(xi), flipped(di),
                            jnp.flip(jnp.asarray(hin), axis=1),
                            jnp.asarray(gf))
    got = ref.ssd_bwd(*[torch.from_numpy(padded(a))
                        for a in (Ci, Bi, gy, xi, di)],
                      torch.from_numpy(hin), torch.from_numpy(gf))
    for name, g, w in zip(("dX", "dh0", "dB", "dC", "ddA"), got, want):
        w = _np(w)
        if name != "dh0":               # back to forward order
            w = np.flip(w, axis=1).reshape(b, sp, *w.shape[3:])
        if zero_da:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            _close(g, w, ULPS)


def test_scan_ssd_grads_match_jax():
    """Autograd through ``ops.scan_ssd`` (the exported checkpoints and the
    reverse scan) against ``jax.grad`` through the reference's derived
    VJP in interpret mode, for all five inputs, at a ragged length with a
    non-zero final-state cotangent."""
    rng = np.random.default_rng(3)
    s, chunk = 21, 8
    xdt, dA, B, C, h0 = _ssd_inputs(rng, s=s)
    gy = rng.standard_normal(xdt.shape).astype(np.float32)
    gf = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(x, a, b_, c, h):
        y, f = jops.scan_ssd(x, a, b_, c, init_state=h, chunk=chunk,
                             interpret=True)
        return jnp.sum(y * gy) + jnp.sum(f * gf)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xdt, dA, B, C, h0)))
    tin = [torch.from_numpy(a).requires_grad_(True)
           for a in (xdt, dA, B, C, h0)]
    y, f = ops.scan_ssd(*tin[:4], init_state=tin[4], chunk=chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (f * torch.from_numpy(gf)).sum()
    got = torch.autograd.grad(loss, tin)
    for name, g, w in zip(("xdt", "dA", "B", "C", "h0"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, TOL)


@pytest.fixture(scope="module")
def mixer():
    """One reduced Mamba-2 mixer's parameters from the reference's
    ``init_mamba2`` (with non-trivial biases and decays), carried across."""
    cfg = get_config("mamba2-780m", reduced=True).with_(remat=False)
    col = Collector(jax.random.PRNGKey(5), dtype=jnp.float32)
    jssm.init_mamba2(col, "m", cfg)
    jp = dict(col.params["m"])
    rng = np.random.default_rng(6)
    for k in ("conv_b", "A_log", "dt_bias"):
        jp[k] = jnp.asarray(0.3 * rng.standard_normal(jp[k].shape),
                            jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, port_config("mamba2-780m", reduced=True), tp


def test_apply_and_decode_mamba2_match_jax(mixer):
    """The full-sequence block (output and cache) and the decode step
    against the reference's; stepping the port's decode token by token
    reproduces its prefill (the reference's
    ``test_mamba2_decode_matches_prefill``)."""
    cfg, jp, tcfg, tp = mixer
    b, s = 2, 10
    x = (0.5 * np.random.default_rng(7).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)
    jy, jc = jssm.apply_mamba2(jp, jnp.asarray(x), cfg)
    ty, tc = ssm.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, TOL)
    _close(tc.conv, jc.conv, TOL)
    _close(tc.state, jc.state, TOL)
    out, none = ssm.apply_mamba2(tp, torch.from_numpy(x), tcfg,
                                 want_cache=False)
    assert none is None and torch.equal(out, ty)

    cache = ssm.init_ssm_cache(tcfg, b, dtype=torch.float32, device="cpu")
    jcache = jssm.init_ssm_cache(cfg, b, dtype=jnp.float32)
    outs = []
    for t in range(s):
        xt = x[:, t:t + 1]
        o, cache = ssm.decode_mamba2(tp, torch.from_numpy(xt), cache, tcfg)
        jo, jcache = jssm.decode_mamba2(jp, jnp.asarray(xt), jcache, cfg)
        _close(o, jo, TOL)
        outs.append(o)
    _close(cache.state, jcache.state, TOL)
    # the reference's own decode-vs-prefill tolerance (2e-3): the dual
    # forms sum the same terms in different orders and groupings
    torch.testing.assert_close(torch.cat(outs, 1), ty, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(cache.state, tc.state, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(cache.conv, tc.conv, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("mamba2-780m", reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config("mamba2-780m", reduced=True), tp


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def test_params_from_numpy_carries_the_ssm_tree(mamba):
    _, params, tcfg, tp = mamba
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    assert {"layers.mixer.w_in", "layers.ln1.scale", "unembed.w",
            "final_norm.scale", "embed.table"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    shapes = {k: tuple(t.shape) for k, t in tt.init_lm(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
        .state_dict().items()}
    assert shapes == {k: v.shape for k, v in want.items()}


def test_full_config_is_mamba2_780m_full_width():
    from repro_torch.configs import mamba2_780m
    cfg = mamba2_780m.full()
    shapes = tt.param_shapes(cfg)
    assert shapes["layers.mixer"]["w_in"][0] == (48, 1536, 6448)
    assert shapes["layers.mixer"]["w_out"][0] == (48, 3072, 1536)
    assert shapes["unembed"]["w"][0] == (1536, 50280)
    assert (ssm.n_ssd_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state) == \
        (48, 64, 128)
    n = sum(np.prod(s) for g in shapes.values() for s, _ in g.values())
    assert abs(n / 1e6 - 857.4) < 1, n


def test_prefill_and_decode_step_match_jax(mamba):
    """``prefill`` (last-position logits and the per-layer cache, over a
    prompt longer than the chunk) and three ``decode_step``s from its
    cache, against the reference."""
    cfg, params, tcfg, tp = mamba
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg, jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    _close(tl, jl, TOL)
    _close(tc.conv, jc.conv, TOL)
    _close(tc.state, jc.state, TOL)
    jcache = jt.prefill_cache_to_decode(cfg, jc, 32)
    tcache = tt.prefill_cache_to_decode(tcfg, tc, 32)
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for step in range(3):
        pos = np.full(2, 13 + step, np.int32)
        jl, jcache = jt.decode_step(params, cfg, jnp.asarray(tok),
                                    jnp.asarray(pos), jcache)
        tl, tcache = tt.decode_step(tp, tcfg, torch.from_numpy(tok), None,
                                    tcache)
        _close(tl, jl, TOL)
        _close(tcache["layers"].state, jcache["layers"].state, TOL)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    zero = tt.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jzero = jt.init_cache(cfg, 2, 32, dtype=jnp.float32)
    for name in ("conv", "state"):
        assert tuple(getattr(zero["layers"], name).shape) == \
            getattr(jzero["layers"], name).shape


def test_greedy_generate_matches_jax(mamba):
    """``serve_step.greedy_generate`` (one prefill, its cache carried into
    the decode steps) gives the reference's tokens."""
    from repro.train import serve_step as jserve
    from repro_torch.train import serve_step
    cfg, params, tcfg, tp = mamba
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 11))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  6, 32)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 6,
                                     32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_other_families_still_raise(mamba):
    *_, tcfg, tp = mamba
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_paged_pools(tcfg, 8, device="cpu")
    # the dense decode_step is ported: contiguous caches
    gcfg = port_config("gemma-2b", reduced=True)
    gp = tt.init_lm(gcfg, torch.Generator().manual_seed(0), device="cpu")
    cache = tt.init_cache(gcfg, 1, 8, dtype=torch.float32, device="cpu")
    logits, cache = tt.decode_step(gp, gcfg, torch.tensor([3]),
                                   torch.tensor([0]), cache)
    assert logits.shape == (1, gcfg.vocab_size)
    assert cache["layers"].k.shape == (gcfg.n_layers, 1, 8, 1, 32)
    # scan_ssd(chunk=None) derives its chunk (it raised before the port
    # derived one): the H100 table's 16, clamped to S = 4 here
    args = [torch.ones(1, 4, 1, 4)] + [torch.full((1, 4, 1), -0.5)] \
        + [torch.ones(1, 4, 2)] * 2
    assert ops.default_ssd_chunk(4, 1, 4, 2) == 16
    for got, want in zip(ops.scan_ssd(*args), ops.scan_ssd(*args, chunk=4)):
        assert torch.equal(got, want)
