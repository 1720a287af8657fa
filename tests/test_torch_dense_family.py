"""The rest of the dense family in the port against the JAX package on the
CPU: reduced stablelm-1.6b (LayerNorm with biases, q/k/v/o and MLP biases,
rotary on a quarter of each head, multi-head attention: G = 1) and reduced
command-r-plus-104b (LayerNorm without biases, parallel attention + MLP
blocks, GQA G = 2, tied embeddings), in float32, on the same weights
(carried across with ``params_from_numpy``) and the same numpy inputs.

Both reduced configs draw their norm scales as ones and their biases as
zeros; the fixtures replace those leaves with seeded normals on both sides,
so every scale and bias is exercised.  Every dense serving path is held to
the reference's tokens: contiguous per-slot caches (stablelm), per-slot
paged decode (gemma-2b, ``batched=False``) and batched paged decode
(command-r); the single-slot paged decode (K5 at one slot) is held bit for
bit on integer inputs as ``tests/test_serving.py`` holds the reference's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serve import poisson_trace  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.hardware import get_entry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import command_r_plus_104b, stablelm_1_6b  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

#: f32 on both sides, differing in summation order only (and in the JAX
#: side's interpret-mode kernel blocks): 1e-4 absolute on logits, caches
#: and layer outputs; 1e-5 relative on losses and gradients
TOL = 1e-4
REL = 1e-5
STABLELM, CMDR = "stablelm-1.6b", "command-r-plus-104b"
CPU = get_entry("cpu")
_BIASES = ("bq", "bk", "bv", "bo", "bi", "bias")


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
    """The reference's parameter tree in numpy, each norm scale drawn as
    1 + 0.1 N(0, 1) and each bias as 0.1 N(0, 1) in place of the init's
    ones and zeros."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v)
        if k == "scale":
            a = 1 + 0.1 * rng.standard_normal(a.shape)
        elif k in _BIASES:
            a = 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


def _model(arch, seed=0):
    """(reference cfg, JAX params, port cfg, port params) of the reduced
    ``arch`` with perturbed scales and biases."""
    cfg = get_config(arch, reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(seed))
    tree = _perturbed(jax.tree.map(np.asarray, params),
                      np.random.default_rng(seed))
    return (cfg, jax.tree.map(jnp.asarray, tree),
            port_config(arch, reduced=True),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=[STABLELM, CMDR])
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def stablelm():
    return _model(STABLELM)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=tol)


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_reference(with_bias):
    """LayerNorm in f32 with the population variance (a shifted input, so
    the mean matters), with and without its bias leaf."""
    cfg = get_config(STABLELM, reduced=True)
    rng = np.random.default_rng(1)
    x = (3 + rng.standard_normal((2, 5, cfg.d_model))).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if with_bias:
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), port_config(STABLELM, True))
    _close(got, want, 1e-5)


def test_partial_rotary_matches_reference():
    """stablelm's rotary on the leading quarter of a 64-wide head (16
    dims rotated, 48 passed through) at positions 0..40."""
    cfg = stablelm_1_6b.full()
    hd = cfg.head_dim_
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 41, 3, hd)).astype(np.float32)
    pos = np.arange(41)[None, :]
    rot = int(hd * cfg.rope_pct)
    js, jc = jlayers.rope_tables(jnp.asarray(pos), rot, cfg.rope_theta)
    want = jlayers.apply_rope(jnp.asarray(x), js, jc, rot / hd)
    ts_, tc = layers.rope_tables(torch.from_numpy(pos), rot, cfg.rope_theta)
    got = layers.apply_rope(torch.from_numpy(x), ts_, tc,
                            attention._rope_pct(cfg, hd))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def test_mlp_with_biases_matches_reference(stablelm):
    cfg, params, tcfg, tp = stablelm
    x = np.random.default_rng(3).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda t: t[1], params["layers"]["mlp"])
    want = jlayers.apply_mlp(lp, jnp.asarray(x), cfg)
    got = layers.apply_mlp({k: t[1] for k, t in tp["layers"]["mlp"].items()},
                           torch.from_numpy(x), tcfg)
    _close(got, want)


def test_attention_fwd_with_biases_matches_reference(model):
    """One layer's attention (q/k/v/o biases for stablelm, none for
    command-r) under the reference's flash kernel in interpret mode: the
    output and the rotated K/V."""
    cfg, params, tcfg, tp = model
    x = np.random.default_rng(4).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda t: t[0], params["layers"]["attn"])
    pos = np.arange(11)[None, :]
    want, wkv = jattn.attention_fwd(lp, jnp.asarray(x),
                                    cfg.with_(attn_impl="pallas"),
                                    positions=jnp.asarray(pos))
    got, gkv = attention.attention_fwd(
        {k: t[0] for k, t in tp["layers"]["attn"].items()},
        torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos))
    _close(got, want)
    _close(gkv.k, wkv.k)
    _close(gkv.v, wkv.v)


# -- the model ------------------------------------------------------------------

def test_param_trees_follow_reference(model):
    """``init_lm`` has the reference's names and shapes, biases included
    (and no ln2 in command-r's parallel blocks); ``params_from_numpy``
    carries every leaf across unchanged."""
    cfg, params, tcfg, tp = model
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    init = tt.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(t.shape) for k, t in init.state_dict().items()} == \
        {k: v.shape for k, v in want.items()}
    has = lambda name: any(k.startswith(name) for k in want)
    assert has("layers.attn.bq") == has("layers.mlp.bi") == cfg.use_bias
    assert has("layers.ln1.bias") == cfg.use_bias
    assert has("layers.ln2") != cfg.parallel_block
    assert has("unembed") != cfg.tie_embeddings
    assert all((init.state_dict()[k] == 0).all() for k in want
               if k.rsplit(".", 1)[1] in _BIASES)


def test_full_configs_at_published_widths():
    """stablelm-1.6b: 1.645 B parameters (untied 100352 x 2048 tables);
    command-r-plus-104b: 104 B (tied 256000 x 12288 table), 6.29 B at the
    2 layers the card runs."""
    s, c = stablelm_1_6b.full(), command_r_plus_104b.full()
    count = lambda cfg: sum(int(np.prod(shape)) for leaves in
                            tt.param_shapes(cfg).values()
                            for shape, _ in leaves.values())
    assert tt.param_shapes(s)["layers.attn"]["bq"][0] == (24, 32, 64)
    assert tt.param_shapes(s)["layers.mlp"]["wi"][0] == (24, 2048, 11264)
    assert round(count(s) / 1e9, 3) == 1.645
    assert "layers.ln2" not in tt.param_shapes(c)
    assert round(count(c) / 1e9) == 104
    assert round(count(c.with_(n_layers=2)) / 1e9, 2) == 6.29


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_prefill_logits_and_cache_match_jax(model, attn_impl):
    cfg, params, tcfg, tp = model
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg.with_(attn_impl=attn_impl),
                        jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def test_lm_loss_and_gradients_match_jax(model):
    """The loss and every gradient leaf (biases and LayerNorm scales
    included) within REL of the largest entry of the JAX gradient."""
    cfg, params, tcfg, tp = model
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 2)).global_batch(0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.lm_loss(p, cfg, jnp.asarray(batch["tokens"]),
                             jnp.asarray(batch["targets"])), has_aux=True)(
        params)
    trainable = params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu", trainable=True)
    loss, _, grads = ts.loss_and_grads(
        trainable, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=REL)
    want = _flat(jg)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=k)


def test_decode_steps_match_jax(model):
    """A ragged prefill (rows of 9 and 13 tokens: the shorter row's
    padding is overwritten as it decodes) re-laid into caches of 24, then
    6 contiguous decode steps at per-row positions: logits and both caches
    at every step."""
    cfg, params, tcfg, tp = model
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (2, 13))
    _, jc = jt.prefill(params, cfg, jnp.asarray(prompt))
    _, tc = tt.prefill(tp, tcfg, torch.from_numpy(prompt))
    assert tt.has_prefill_decode_relayout(tcfg)
    jcache = jt.prefill_cache_to_decode(cfg, jc, 24)
    tcache = tt.prefill_cache_to_decode(tcfg, tc, 24)
    assert tcache["layers"].k.shape == jcache["layers"].k.shape
    pos = np.array([9, 13], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2)
        jl, jcache = jt.decode_step(params, cfg, jnp.asarray(tok),
                                    jnp.asarray(pos), jcache)
        tl, tcache = tt.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcache)
        _close(tl, jl)
        _close(tcache["layers"].k, jcache["layers"].k)
        _close(tcache["layers"].v, jcache["layers"].v)
        pos = pos + 1


def test_greedy_generate_matches_jax(model):
    """One prefill re-laid as the decode cache, then a decode step a
    token: the reference's tokens."""
    cfg, params, tcfg, tp = model
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 11))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  8, 32)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 8,
                                     32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_windowed_dense_decodes_from_ring_caches(stablelm):
    """A dense model with a local window (stablelm reduced, window 5)
    decodes from ring caches and has no prefill re-layout, as in the
    reference, whose dense ring is ``cache_len`` long: ``init_cache``'s
    shape, and ``greedy_generate`` (token by token ingestion) past the
    ring's length, its tokens equal to the reference's."""
    cfg, params, tcfg, tp = stablelm
    cfg, tcfg = cfg.with_(local_window=5), tcfg.with_(local_window=5)
    assert not tt.has_prefill_decode_relayout(tcfg)
    assert tt.prefill_cache_to_decode(tcfg, None, 16) is None
    assert jt.prefill_cache_to_decode(cfg, None, 16) is None
    cache = tt.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    assert cache["layers"].k.shape == (2, 2, 8, 4, 32)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 7))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  6, 8)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 6,
                                     8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- paged decode ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", CMDR])
def test_decode_step_paged_matches_jax(arch):
    """One sequence through its page table (scrambled slabs), on the
    paged-capable models (G >= 2: the reference pages no G = 1 model):
    the new K/V rows land in the pools in place, and logits and pools
    agree with the reference's ``decode_step_paged`` (interpret-mode
    kernel) over 3 steps."""
    cfg, params, tcfg, tp = _model(arch)
    page, pool_pages, n = 4, 6, 9
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, (1, n))
    table = [4, 1, 5]                    # covers positions 0..11
    _, cache = tt.prefill(tp, tcfg, torch.from_numpy(prompt))
    from repro_torch.serving import PagePool
    pool = PagePool(tcfg, pool_pages, page, device="cpu")
    pool.write_prefill(cache, table, n)
    jpools = {k: jnp.asarray(t.numpy()) for k, t in pool.pools.items()}
    k_before = pool.pools["k"]
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, 1)
        pos = np.array([n + step], np.int32)
        jl, jpools = jt.decode_step_paged(
            params, cfg, jnp.asarray(tok, jnp.int32), jnp.asarray(pos),
            jpools, page_table=tuple(table), page=page, interpret=True)
        tl = tt.decode_step_paged(
            tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
            pool.pools, table=torch.tensor(table, dtype=torch.int32),
            page=page)
        _close(tl, jl)
        for key in ("k", "v"):
            _close(pool.pools[key], jpools[key])
    assert pool.pools["k"] is k_before


def _paged_inputs(rng, slots, hkv, g, hd, page, pool_pages):
    """Integer-valued q and pools in [-3, 3], f32."""
    ints = lambda *s: torch.from_numpy(
        rng.integers(-3, 4, s).astype(np.float32))
    return (ints(slots, hkv, g, hd), ints(pool_pages * page, hkv, hd),
            ints(pool_pages * page, hkv, hd))


def test_paged_decode_single_slot_bit_identical_to_contiguous():
    """``ops.paged_decode`` (K5 at one slot) through an identity table on
    a contiguous pool and through a scrambled table on a scattered pool:
    bit for bit on integer inputs (tests/test_serving.py's check of the
    reference), and within 1e-5 of the reference's oracle and of its
    interpret-mode kernel."""
    hkv, g, hd, page, view = 2, 4, 16, 8, 2
    q, k, v = _paged_inputs(np.random.default_rng(0), 1, hkv, g, hd, page,
                            view)
    q = q[0]
    pos = torch.tensor([12], dtype=torch.int32)
    k2 = torch.zeros((4 * page, hkv, hd))
    v2 = torch.zeros_like(k2)
    perm = (3, 1)
    for vpg, slab in enumerate(perm):
        k2[slab * page:(slab + 1) * page] = k[vpg * page:(vpg + 1) * page]
        v2[slab * page:(slab + 1) * page] = v[vpg * page:(vpg + 1) * page]
    kw = dict(page=page, scale=hd ** -0.5)
    contig = ops.paged_decode(q, k, v, pos, torch.tensor([0, 1],
                                                         dtype=torch.int32),
                              **kw)
    paged = ops.paged_decode(q, k2, v2, pos, torch.tensor(perm,
                                                          dtype=torch.int32),
                             **kw)
    assert contig.shape == (hkv, g, hd) and contig.dtype == torch.float32
    assert torch.equal(contig, paged)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    jpos = jnp.asarray([[12, 0]], jnp.int32)
    _close(contig, jops._paged_oracle(jq, jk, jv, jpos, (0, 1), page,
                                      hd ** -0.5, 0), 1e-5)
    _close(contig, jops.paged_decode(jq, jk, jv, jpos, page_table=(0, 1),
                                     interpret=True, hardware=CPU, **kw),
           1e-5)
    with pytest.raises(ValueError, match="1-D table"):
        ops.paged_decode(q, k, v, pos, torch.tensor([[0, 1]]), **kw)


def test_batched_decode_bit_identical_to_per_slot():
    """One batched launch over 3 slots (one dead, its table row stale)
    against 3 single-slot calls on the same pools: live rows bit for bit
    on integer inputs, the dead row exact zeros (tests/test_serving.py's
    check of the reference), windowed."""
    slots, hkv, g, hd, page, pool_pages = 3, 2, 4, 16, 8, 8
    q, kp, vp = _paged_inputs(np.random.default_rng(2), slots, hkv, g, hd,
                              page, pool_pages)
    tables = torch.tensor([[5, 2], [0, 7], [3, 3]], dtype=torch.int32)
    pos = torch.tensor([11, 4, -1], dtype=torch.int32)
    kw = dict(page=page, scale=hd ** -0.5, window=6)
    got = ops.paged_decode_batched(q, kp, vp, pos, tables, **kw)
    assert not got[2].any()
    for s in range(2):
        one = ops.paged_decode(q[s], kp, vp, pos[s:s + 1], tables[s], **kw)
        assert torch.equal(got[s], one), s


# -- serving ----------------------------------------------------------------------

def _run(engine, reqs):
    rids = [engine.submit(p, n) for p, n in reqs]
    results = engine.run()
    return [results[r]["tokens"] for r in rids]


def _run_counting(engine, reqs):
    """``_run``, one iteration at a time: with no eviction, each reads the
    device once for its decode plus once per prompt it admits."""
    rids = [engine.submit(p, n) for p, n in reqs]
    while not engine.idle:
        waiting, before = len(engine._waiting), engine.host_transfers
        calls0 = engine.kernel_calls
        engine.step()
        admitted = waiting - len(engine._waiting)
        decoded = engine.kernel_calls - calls0
        assert engine.host_transfers - before == admitted + (decoded > 0)
    results = engine.results()
    assert not any(results[r]["request"].evictions for r in rids)
    return [results[r]["tokens"] for r in rids]


@pytest.mark.parametrize("arch,kw", [
    (STABLELM, {}),                                  # contiguous per slot
    ("gemma-2b", {"batched": False, "page": 8}),     # paged, per slot
    (CMDR, {"page": 8})])                            # paged, batched
def test_engine_tokens_match_reference_on_bench_trace(arch, kw):
    """bench_serve.py's seed-0 trace (10 requests, 4 slots, max_len 64)
    through each dense ``ServeEngine`` path: every request's greedy tokens
    equal the JAX engine's (its interpret-mode kernels on the paged
    paths); each iteration reads the device once for its decode plus once
    per prompt it admits, and the per-slot paths count one decode step a
    slot and iteration."""
    cfg, params, tcfg, tp = _model(arch)
    reqs = [(r["prompt"], r["max_new"]) for r in poisson_trace(cfg.vocab_size)]
    want = _run(JServeEngine(cfg, params, max_slots=4, max_len=64,
                             interpret=True, **kw), reqs)
    engine = ServeEngine(tcfg, tp, max_slots=4, max_len=64, device="cpu",
                         **kw)
    assert engine.paged == (arch != STABLELM)
    assert engine.batched == (arch == CMDR)
    got = _run_counting(engine, reqs)
    assert got == want
    slot_steps = sum(n - 1 for _, n in reqs)
    if engine.batched:
        assert engine.kernel_calls < slot_steps
    else:
        assert engine.kernel_calls == slot_steps


def test_per_slot_engine_evicts_under_pressure_as_the_reference():
    """gemma-2b with ``batched=False`` under page pressure (4 slots, 7
    pages of 4: tests/test_serving.py's setup): it evicts and still emits
    the JAX engine's tokens."""
    cfg, params, tcfg, tp = _model("gemma-2b")
    key = jax.random.PRNGKey(11)
    reqs = [(jax.random.randint(k, (n,), 0, cfg.vocab_size).tolist(), 5)
            for k, n in zip(jax.random.split(key, 4), (5, 6, 4, 7))]
    kw = dict(max_slots=4, max_len=16, page=4, pool_pages=7, batched=False)
    want = _run(JServeEngine(cfg, params, interpret=True, **kw), reqs)
    engine = ServeEngine(tcfg, tp, device="cpu", **kw)
    rids = [engine.submit(p, n) for p, n in reqs]
    results = engine.run()
    assert sum(results[r]["request"].evictions for r in rids) > 0
    assert [results[r]["tokens"] for r in rids] == want


def test_engine_refusals_that_stand(stablelm):
    """stablelm (G = 1) is not paged-capable, as in the reference: no pool,
    and ``batched=True`` raises."""
    *_, tcfg, tp = stablelm
    engine = ServeEngine(tcfg, tp, device="cpu")
    assert engine.pool is None and not engine.paged
    with pytest.raises(ValueError, match="serves contiguous"):
        ServeEngine(tcfg, tp, batched=True, device="cpu")


# -- training -------------------------------------------------------------------

def test_train_step_matches_reference(stablelm):
    """Two port train steps of stablelm (its 2 microbatches, remat) against
    the JAX ``make_train_step``'s: each step's loss within REL, and the
    parameters after them within the bound the summed learning rate gives
    (tests/test_torch_train.py)."""
    from repro_torch.optim import adamw
    cfg, params, tcfg, _ = stablelm
    assert tcfg.train_microbatches == 2 and tcfg.remat
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 2))
    batches = [data.global_batch(i) for i in range(2)]
    jstate = jts.TrainState(params, jts.adamw.init(params), None,
                            jnp.zeros((), jnp.int32))
    step = jax.jit(jts.make_train_step(cfg, microbatches=2))
    jlosses = []
    for b in batches:
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    state = ts.init_state(tcfg, tp, device="cpu")
    tstep = ts.make_train_step(tcfg, microbatches=2)
    for b, want in zip(batches, jlosses):
        state, m = tstep(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), want, rtol=REL)
    opt = adamw.AdamWConfig()
    lr_sum = sum(float(adamw.schedule(opt, torch.tensor(i + 1)))
                 for i in range(2))
    jfinal = _flat(jstate.params)
    for k, p in state.params.named_parameters():
        bound = 2 * lr_sum * (1 + opt.weight_decay * np.abs(jfinal[k]).max())
        np.testing.assert_allclose(p.detach().numpy(), jfinal[k], rtol=0,
                                   atol=bound + 1e-6, err_msg=k)
