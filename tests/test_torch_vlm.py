"""The vlm family (paligemma-3b) in the port against the JAX package on the
CPU: reduced paligemma-3b (2 layers, d_model 128, 4 query heads over one
KV head of 32, 8 stub patches) in float32, on the same weights (carried
across with ``params_from_numpy``; the RMSNorm scales, ones at init,
redrawn as seeded normals on both sides) and the same numpy inputs.

The prefix-LM mask (the patches attend to each other both ways, the text
causally) is K2-K4's prefix form on the card; here the plain versions,
held to the reference's interpret-mode flash kernel, its oracle and its
blocked backward references.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.hardware import get_entry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import paligemma_3b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "paligemma-3b"
#: f32 on both sides, differing in summation order: 1e-4 absolute on
#: outputs, logits and caches; 1e-4 relative on the loss and on each
#: gradient leaf (to its largest entry)
TOL = 1e-4
REL = 1e-4
CPU = get_entry("cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _perturbed(tree, rng):
    """The reference's tree in numpy, each norm scale drawn as 1 + 0.1 N(0,
    1) in place of the init's ones."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v)
        if k == "scale":
            a = 1 + 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def vlm():
    """(reference cfg, JAX params, port cfg, port params) of reduced
    paligemma-3b with perturbed norm scales."""
    cfg = get_config(ARCH, reduced=True)
    params, _ = jreg.init(cfg, jax.random.PRNGKey(0))
    tree = _perturbed(jax.tree.map(np.asarray, params),
                      np.random.default_rng(0))
    return (cfg, jax.tree.map(jnp.asarray, tree), port_config(ARCH, True),
            params_from_numpy(tree, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=tol)


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    return tokens, patches


# -- the config and the parameters

def test_config_is_the_reference_field_for_field():
    """``full()`` and ``reduced()`` copy the reference's configs field for
    field; the full model has the reference's 2,508,587,008 parameters
    (``param_count``, which counts neither the norms nor the adapter)."""
    for fn in ("full", "reduced"):
        want = dataclasses.asdict(getattr(
            __import__("repro.configs.paligemma_3b", fromlist=[fn]), fn)())
        assert dataclasses.asdict(getattr(paligemma_3b, fn)()) == want
    full = paligemma_3b.full()
    assert full.param_count() == (2508587008, 2508587008)
    assert get_config(ARCH).param_count() == full.param_count()
    shapes = tt.param_shapes(full)
    count = sum(int(np.prod(shape)) for leaves in shapes.values()
                for shape, *_ in leaves.values())
    assert count == 2508587008 + (2 * 18 + 1) * 2048 + 2048 * 2048
    assert shapes["frontend"]["adapter"][0] == (2048, 2048)
    assert shapes["embed"]["table"][0] == (257216, 2048)


def test_param_tree_follows_reference(vlm):
    """``init_lm`` has the reference's names (``frontend.adapter`` beside
    the dense stack) and shapes; ``params_from_numpy`` carries every leaf
    across unchanged."""
    cfg, params, tcfg, tp = vlm
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    assert "frontend.adapter" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jinit = _flat(jreg.init(cfg, jax.random.PRNGKey(1))[0])
    init = registry.init(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    sd = init.state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == \
        {k: v.shape for k, v in jinit.items()}
    np.testing.assert_allclose(sd["frontend.adapter"].std().item(),
                               jinit["frontend.adapter"].std(), rtol=0.1)


# -- the prefix-LM mask

def _attn_inputs(rng, b, s, kv, g, hd):
    return (rng.standard_normal((b, s, kv, g, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


#: the reference's prefix cases (tests/test_recurrence.py:327; 32 and 24
#: past its key block), and a prefix at and past the sequence
PREFIX_CASES = [(0, 5), (9, 6), (0, 32), (9, 24), (0, 45), (4, 60)]


@pytest.mark.parametrize("window,prefix", PREFIX_CASES)
def test_prefix_attention_matches_jax_kernel_and_oracle(window, prefix):
    """``ops.attention`` with ``prefix_len`` at S = 45 (B 1, KV 2, G 2, hd
    8, the reference's own case) against the JAX flash kernel (interpret
    mode, 16-blocks: prefix blocks above the diagonal re-admitted) and
    its chunked oracle, within 3e-5."""
    rng = np.random.default_rng(7)
    q, k, v = _attn_inputs(rng, 1, 45, 2, 2, 8)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=0.3, causal=True,
                        window=window, prefix_len=prefix).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jops.attention(jq, jk, jv, scale=0.3, causal=True, window=window,
                          prefix_len=prefix, interpret=True, hardware=CPU,
                          blocks=(16, 16))
    oracle = jops._oracle_attention(jq, jk, jv, 0.3, True, window, prefix)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=3e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=0, atol=3e-5)
    if prefix:              # the prefix is live: a causal call differs
        causal = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale=0.3,
                               window=window).numpy()
        assert np.abs(causal[:, :min(prefix, 45) - 1] -
                      got[:, :min(prefix, 45) - 1]).max() > 1e-3


def _pad(a, axis, to):
    width = [(0, 0)] * a.ndim
    width[axis] = (0, to - a.shape[axis])
    return np.pad(a, width)


@pytest.mark.parametrize("s", [24, 40])
def test_prefix_backward_matches_jax_references(s):
    """The plain ``flash_dq`` / ``flash_dkv`` at the reference's ``(True,
    8, 4)`` mask (causal, window 8, prefix 4; ``tests/
    test_backward_kernels.py``) against its blocked references
    (``flash_dq_ref`` / ``flash_dkv_ref``, 8-blocks over the padded
    sequence, dk / dv summed over the group), within 1e-5 of the largest
    entry."""
    window, prefix = 8, 4
    b, kv, g, hd = 1, 2, 2, 8
    rng = np.random.default_rng(8)
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = 0.5
    _, m, l = ops.attention_stats(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale=scale,
                                  window=window, prefix_len=prefix)
    m, l = m.numpy(), l.numpy()
    delta = rng.standard_normal(m.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, do, m, l, delta)]
    kw = dict(scale=scale, window=window, prefix_len=prefix)
    dq = ops.flash_dq(*args, **kw).numpy()
    dk, dv = (t.numpy() for t in ops.flash_dkv(*args, **kw))
    sp = -(-s // 8) * 8
    pq, pk, pv, pdo = (_pad(a, 1, sp) for a in (q, k, v, do))
    pm, pdl = (_pad(a, 3, sp) for a in (m, delta))
    pl = np.concatenate([l, np.ones(l.shape[:3] + (sp - s,), np.float32)],
                        axis=3)
    jargs = list(map(jnp.asarray, (pq, pk, pv, pdo, pm, pl, pdl)))
    jdq = np.asarray(jref.flash_dq_ref(*jargs, scale=scale, causal=True,
                                       bq=8, bk=8, window=window,
                                       prefix_len=prefix, logical_k=s))
    jdk, jdv = jref.flash_dkv_ref(*jargs, scale=scale, causal=True, bj=8,
                                  bi=8, window=window, prefix_len=prefix,
                                  logical_q=s)
    want_dq = jdq.transpose(0, 3, 1, 2, 4)[:, :s]
    want_dk = np.asarray(jdk).sum(axis=2).transpose(0, 2, 1, 3)[:, :s]
    want_dv = np.asarray(jdv).sum(axis=2).transpose(0, 2, 1, 3)[:, :s]
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_prefix_attention_grads_match_jax_kernel():
    """dq, dk, dv of ``ops.attention`` with a prefix past its first block
    (K2 with export then K3 / K4 on the card; the plain versions here)
    against ``jax.vjp`` through the JAX flash kernel with its derived
    backward (interpret mode), within 1e-5 of the largest entry."""
    rng = np.random.default_rng(9)
    b, s, kv, g, hd, prefix = 1, 37, 1, 4, 16, 20
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    do = rng.standard_normal((b, s, kv * g, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.attention(tq, tk, tv, scale=0.25, prefix_len=prefix)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b_, c: jops.attention(
        a, b_, c, scale=0.25, causal=True, prefix_len=prefix,
        interpret=True, hardware=CPU, blocks=(16, 16)),
        *map(jnp.asarray, (q, k, v)))
    for a, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_prefix_without_causal_raises(vlm):
    """A prefix (or a window) refines the causal mask: without it the
    model's attention and every kernel entry raise the reference's
    ``ValueError`` (``attention.py:143-149``, ``emit.py:289-292``)."""
    _, _, tcfg, tp = vlm
    lp = {k: t[0] for k, t in tp["layers"]["attn"].items()}
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(ValueError, match="require causal"):
        attention.attention_fwd(lp, x, tcfg, positions=torch.arange(4)[None],
                                causal=False, prefix_len=2)
    q, k = torch.zeros(1, 4, 1, 2, 32), torch.zeros(1, 4, 1, 32)
    m = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError, match="require causal"):
        ops.attention_stats(q, k, k, scale=1.0, causal=False, prefix_len=2)
    with pytest.raises(ValueError, match="require causal"):
        ops.flash_dq(q, k, k, q, m, m, m, scale=1.0, causal=False,
                     prefix_len=2)
    with pytest.raises(ValueError, match="require causal"):
        ops.flash_dkv(q, k, k, q, m, m, m, scale=1.0, causal=False,
                      window=3)


def test_dkv_row_tiles_cover_the_prefix():
    """``ops.dkv_row_tiles`` (K4's row stream, the kernel's rule) with a
    prefix: every visible (row, key) pair of the prefix-LM mask lies in
    its key tile's row tiles, at prefixes below, at and past a 64-key
    tile and past the sequence, with and without a window; and
    ``prefix_len=0`` is the rule as it was."""
    from repro_torch.kernels import ref
    for s, g, window, prefix in [(300, 8, 0, 5), (300, 8, 0, 64),
                                 (300, 8, 0, 130), (200, 1, 40, 100),
                                 (130, 4, 0, 200)]:
        vis = ref._mask(s, s, True, window, "cpu", prefix).numpy()
        for j0 in range(0, s, ops.DKV_KEYS):
            first, count = ops.dkv_row_tiles(j0, s, s, g, True, window,
                                             prefix)
            rows = np.nonzero(vis[:, j0:j0 + ops.DKV_KEYS].any(1))[0]
            lo, hi = rows.min() * g, (rows.max() + 1) * g
            assert first * ops.DKV_ROWS <= lo, (s, g, window, prefix, j0)
            assert (first + count) * ops.DKV_ROWS >= hi
        assert ops.dkv_row_tiles(64, s, s, g, True, window, 0) == \
            ops.dkv_row_tiles(64, s, s, g, True, window)


# -- the model

@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_and_prefill_match_reference(vlm, attn_impl):
    """``forward`` with 8 patches before 13 tokens (21 positions, prefix
    8) and ``prefill`` through the registry: the hidden states, the
    stacked K/V (L, B, 21, KV, hd) and the last logits, against the
    reference at ``attn_impl`` "pallas" (its flash kernel in interpret
    mode) and "xla" (its einsums)."""
    cfg, params, tcfg, tp = vlm
    cfg = cfg.with_(attn_impl=attn_impl)
    tokens, patches = _inputs(cfg, 2, 13, 3)
    jh, jc, _ = jt.forward(params, cfg, jnp.asarray(tokens),
                           jnp.asarray(patches))
    th, tc = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                        patches=torch.from_numpy(patches))
    assert th.shape == (2, 21, cfg.d_model)
    assert tc.k.shape == (2, 2, 21, 1, 32)
    _close(th, jh)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    batch = {"tokens": tokens, "patches": patches}
    jl, _ = jreg.prefill(params, cfg, jax.tree.map(jnp.asarray, batch))
    tl, _ = serve_step.make_prefill(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (2, cfg.vocab_size)
    _close(tl, jl)


def test_patch_swap_changes_position_zero(vlm):
    """The reference's ``test_vlm_prefix_attention_is_bidirectional``:
    swapping patches 0 and 1 changes position 0's hidden state (it sees
    patch 1 through the prefix), as it does in the reference."""
    cfg, params, tcfg, tp = vlm
    tokens, patches = _inputs(cfg, 1, 16, 4)
    swapped = patches[:, [1, 0] + list(range(2, cfg.num_patches))]
    h1, _ = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                       patches=torch.from_numpy(patches))
    h2, _ = tt.forward(tp, tcfg, torch.from_numpy(tokens),
                       patches=torch.from_numpy(swapped))
    assert (h1[:, 0] - h2[:, 0]).abs().max() > 1e-3
    j2, _, _ = jt.forward(params, cfg, jnp.asarray(tokens),
                          jnp.asarray(swapped))
    _close(h2, j2)


def test_forward_needs_patches(vlm):
    _, _, tcfg, tp = vlm
    with pytest.raises(ValueError, match="patches"):
        tt.forward(tp, tcfg, torch.zeros(1, 4, dtype=torch.long))


def test_lm_loss_and_gradients_match_reference(vlm):
    """``lm_loss`` on the text positions only (targets of the 16 text
    tokens behind 8 patches) and every gradient leaf, the adapter's
    included, within REL of the reference's (``registry.loss``)."""
    cfg, params, tcfg, _ = vlm
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 2),
                        tcfg).global_batch(0)
    assert batch["patches"].shape == (2, 8, cfg.d_model)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jreg.loss(p, cfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    trainable = params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu", trainable=True)
    loss, metrics, grads = ts.loss_and_grads(
        trainable, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=REL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               rtol=REL)
    want = _flat(jg)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=k)


def test_decode_steps_match_reference(vlm):
    """The vlm family decodes as the dense one does (the reference's
    ``decode_step`` treats it so): 6 steps from ``registry.init_cache``
    at per-row positions, logits and caches at every step; there is no
    prefill re-layout, as in the reference."""
    cfg, params, tcfg, tp = vlm
    rng = np.random.default_rng(6)
    assert not tt.has_prefill_decode_relayout(tcfg)
    assert not jt.has_prefill_decode_relayout(cfg)
    jcache = jreg.init_cache(cfg, 2, 12, dtype=jnp.float32)
    tcache = registry.init_cache(tcfg, 2, 12, dtype=torch.float32,
                                 device="cpu")
    pos = np.array([0, 3], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, jcache = jreg.decode_step(params, cfg, jnp.asarray(tok),
                                      jnp.asarray(pos), jcache)
        tl, tcache = serve_step.make_decode(tcfg)(
            tp, torch.from_numpy(tok), torch.from_numpy(pos), tcache)
        _close(tl, jl)
        _close(tcache["layers"].k, jcache["layers"].k)
        pos = pos + 1


@pytest.mark.parametrize("arch,window", [
    ("deepseek-moe-16b", 0), (ARCH, 0), ("recurrentgemma-9b", 0),
    ("whisper-base", 0), ("stablelm-1.6b", 5)])
def test_prefill_cache_to_decode_is_none_where_reference_has_none(arch,
                                                                  window):
    """The moe, vlm, hybrid and audio families and a windowed dense model
    have no forward->decode re-layout: ``prefill_cache_to_decode`` returns
    None on both sides (callers ingest the prompt token by token)."""
    cfg = get_config(arch, reduced=True)
    tcfg = port_config(arch, True)
    if window:
        cfg, tcfg = (c.with_(local_window=window) for c in (cfg, tcfg))
    assert jt.prefill_cache_to_decode(cfg, None, 8) is None
    assert tt.prefill_cache_to_decode(tcfg, None, 8) is None
    assert not tt.has_prefill_decode_relayout(tcfg)


def _integer_params(tcfg, seed):
    """Port parameters of the reduced model drawn as integers in [-3, 3],
    the query projection's times 2^12: the attention scores then lie far
    more than f32's exp range apart, each softmax is one-hot on both the
    contiguous and the paged path, and the two steps can agree bit for
    bit."""
    tp = tt.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.from_numpy(
                rng.integers(-3, 4, p.shape).astype(np.float32)))
            if name.endswith("attn.wq"):
                p.mul_(4096)
    return tp


@pytest.mark.parametrize("batched", [False, True])
def test_paged_decode_equals_decode_step_bit_for_bit(batched):
    """The paged entries take the vlm family as the reference's do:
    token-by-token decode through scrambled page tables (single slot, or
    two live slots beside a dead one in the batched step) gives
    ``decode_step``'s logits bit for bit on integer-valued parameters and
    tokens, and the pools hold the contiguous cache's K/V rows."""
    tcfg = port_config(ARCH, True)
    tp = _integer_params(tcfg, 3)
    page, n = 4, 9
    rng = np.random.default_rng(4)
    tables = torch.tensor([[5, 2, 7], [1, 3, 4], [0, 0, 0]],
                          dtype=torch.int32)
    live = 2 if batched else 1
    prompts = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (live, n)))
    cache = registry.init_cache(tcfg, live, 16, dtype=torch.float32,
                                device="cpu")
    pools = tt.init_paged_pools(tcfg, 8 * page, device="cpu")
    for t in range(n):
        pos = torch.full((live,), t, dtype=torch.int32)
        want, cache = tt.decode_step(tp, tcfg, prompts[:, t], pos, cache)
        if batched:
            got = tt.decode_step_paged_batched(
                tp, tcfg, torch.cat([prompts[:, t], prompts[:1, t]]),
                torch.cat([pos, torch.tensor([-1], dtype=torch.int32)]),
                pools, tables=tables, page=page)[:live]
        else:
            got = tt.decode_step_paged(tp, tcfg, prompts[:, t], pos, pools,
                                       table=tables[0], page=page)
        assert torch.equal(got, want), t
    ar = torch.arange(n)
    for s in range(live):
        rows = tables[s].long()[ar // page] * page + ar % page
        for key, c in zip(("k", "v"), cache["layers"]):
            assert torch.equal(pools[key][:, rows], c[:, s, :n]), (s, key)


def test_paged_decode_matches_reference(vlm):
    """The single-slot and the batched paged step (a dead slot beside two
    live ones) against the reference's ``decode_step_paged`` /
    ``decode_step_paged_batched`` (interpret-mode kernel) over 3 steps
    after a token-by-token prompt: logits and pools within TOL."""
    cfg, params, tcfg, tp = vlm
    page, n = 4, 6
    rng = np.random.default_rng(9)
    tables = np.array([[4, 1, 5], [0, 2, 3], [0, 0, 0]], np.int32)
    pools = tt.init_paged_pools(tcfg, 6 * page, device="cpu")
    jpools = {k: jnp.asarray(t.numpy()) for k, t in pools.items()}
    bpools = {k: t.clone() for k, t in pools.items()}
    jbpools = dict(jpools)
    for t in range(n + 3):
        tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        pos = np.array([t, t, -1], np.int32)
        jl, jpools = jt.decode_step_paged(
            params, cfg, jnp.asarray(tok[:1]), jnp.asarray(pos[:1]), jpools,
            page_table=tuple(tables[0].tolist()), page=page, interpret=True)
        tl = tt.decode_step_paged(
            tp, tcfg, torch.from_numpy(tok[:1]), torch.from_numpy(pos[:1]),
            pools, table=torch.from_numpy(tables[0]), page=page)
        jbl, jbpools = jt.decode_step_paged_batched(
            params, cfg, jnp.asarray(tok), jnp.asarray(pos), jbpools,
            page_tables=tuple(map(tuple, tables.tolist())), page=page,
            interpret=True)
        tbl = tt.decode_step_paged_batched(
            tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), bpools,
            tables=torch.from_numpy(tables), page=page)
        if t >= n:
            _close(tl, jl)
            _close(tbl[:2], np.asarray(jbl)[:2])
    for key in ("k", "v"):
        _close(pools[key], jpools[key])
        _close(bpools[key], jbpools[key])


def test_greedy_generate_matches_reference(vlm):
    """Token-by-token ingestion from the empty cache (the reference's path
    for the vlm family, which passes no patches), then a decode step a
    token: the reference's tokens."""
    cfg, params, tcfg, tp = vlm
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 9))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  8, 24)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 8,
                                     24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(vlm, microbatches):
    """Three ``make_train_step`` steps (remat on) on ``SyntheticLM``
    batches with patches against the jitted reference's at
    ``microbatches``: each step's loss within REL, and the update after
    them per leaf within 1e-3 in relative norm and per element within
    3e-2 of the summed learning rate (``tests/test_torch_train.py``'s
    hold)."""
    cfg, params, tcfg, _ = vlm
    assert tcfg.remat
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 2), tcfg)
    batches = [data.global_batch(i) for i in range(3)]
    jstate = jts.TrainState(params, jts.adamw.init(params), None,
                            jnp.zeros((), jnp.int32))
    step = jax.jit(jts.make_train_step(cfg, microbatches=microbatches))
    tstate = ts.init_state(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu", trainable=True),
        device="cpu")
    tstep = ts.make_train_step(tcfg, microbatches=microbatches)
    for b in batches:
        jstate, jm = step(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=REL)
    opt = adamw.AdamWConfig()
    lr_sum = sum(float(adamw.schedule(opt, torch.tensor(i + 1)))
                 for i in range(3))
    start, final = _flat(params), _flat(jstate.params)
    for k, p in tstate.params.named_parameters():
        got = p.detach().numpy() - start[k]
        step_want = final[k] - start[k]
        scale = np.linalg.norm(step_want)
        assert scale > 0, k
        assert np.linalg.norm(got - step_want) <= 1e-3 * scale, k
        np.testing.assert_allclose(got, step_want, rtol=0,
                                   atol=3e-2 * lr_sum, err_msg=k)


def test_pipeline_patches_equal_reference():
    """``SyntheticLM`` with the vlm config: tokens, targets and the f32
    ``patches (rows, P, d)`` equal the reference's bit for bit, over two
    steps and two seeds."""
    from repro.data.pipeline import PipelineConfig as JPC
    from repro.data.pipeline import SyntheticLM as JSyn
    for seed in (0, 5):
        for step in (0, 3):
            want = JSyn(JPC(512, 12, 3, seed=seed),
                        get_config(ARCH, reduced=True)).global_batch(step)
            got = SyntheticLM(PipelineConfig(512, 12, 3, seed=seed),
                              port_config(ARCH, True)).global_batch(step)
            assert got.keys() == want.keys() == {"tokens", "targets",
                                                 "patches"}
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_attention_fwd_with_prefix_matches_reference(vlm):
    """One layer's ``attention_fwd`` with ``prefix_len`` 6 at S = 14 (the
    reference's einsum branch with its bidirectional block): the output
    and the K/V."""
    cfg, params, tcfg, tp = vlm
    x = np.random.default_rng(1).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32)
    pos = np.arange(14)[None, :]
    jp = jax.tree.map(lambda t: t[1], params["layers"]["attn"])
    lp = {k: t[1] for k, t in tp["layers"]["attn"].items()}
    want, wkv = jattn.attention_fwd(jp, jnp.asarray(x), cfg,
                                    positions=jnp.asarray(pos), prefix_len=6)
    got, gkv = attention.attention_fwd(lp, torch.from_numpy(x), tcfg,
                                       positions=torch.from_numpy(pos),
                                       prefix_len=6)
    _close(got, want)
    _close(gkv.k, wkv.k)
    _close(gkv.v, wkv.v)
