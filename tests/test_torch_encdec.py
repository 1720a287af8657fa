"""The encoder-decoder (audio) family, whisper-base, in the port against the
JAX package on the CPU: reduced whisper-base (2 encoder and 2 decoder
layers, d_model 128, 4 heads of 32, 16 stub frames, LayerNorm with
biases, sinusoidal positions) in float32, on the same weights (carried
across with ``params_from_numpy``; the norm scales and every bias, ones
and zeros at init, redrawn as seeded normals on both sides) and the same
numpy inputs.

The encoder's and the cross-attention's bidirectional attention run on
K2's non-causal form (the reference computes them in einsums); here the
plain version.  The family dispatch of ``models.registry`` is held for
every family the port has.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.layers import logits_from_hidden as jlogits  # noqa: E402
from repro.models.layers import sinusoid_positions as jsinus  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import whisper_base  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import logits_from_hidden  # noqa: E402
from repro_torch.models.layers import sinusoid_positions  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "whisper-base"
#: f32 on both sides, differing in summation order: 1e-4 absolute on
#: outputs, logits and caches; 1e-4 relative on the loss and on each
#: gradient leaf (to its largest entry)
TOL = 1e-4
REL = 1e-4
_ONES = ("scale",)
_ZEROS = ("bias", "bq", "bk", "bv", "bo", "bi")


def _shift_free(name: str) -> bool:
    """The key biases: adding ``bk`` adds ``q . bk`` to every score of a
    query's row, which the softmax cancels, so their gradient is zero in
    exact arithmetic and both sides' are rounding noise (under 1e-6 where
    the other leaves' are 1e-3 and up); AdamW's update of such noise is
    noise as well, so they are held to be that small, not to agree."""
    return name.endswith(".bk")


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
    1) and each bias as 0.1 N(0, 1) in place of the init's ones and
    zeros."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v)
        if k in _ONES:
            a = 1 + 0.1 * rng.standard_normal(a.shape)
        elif k in _ZEROS:
            a = 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def whisper():
    """(reference cfg, JAX params, port cfg, port params) of reduced
    whisper-base with perturbed norms and biases."""
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
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return tokens, frames


# -- the config and the parameters

def test_config_is_the_reference_field_for_field():
    """``full()`` and ``reduced()`` copy the reference's configs field for
    field; the full model has the reference's 67,449,344 parameters
    (``param_count``'s own rule)."""
    for fn in ("full", "reduced"):
        want = dataclasses.asdict(getattr(
            __import__("repro.configs.whisper_base", fromlist=[fn]), fn)())
        assert dataclasses.asdict(getattr(whisper_base, fn)()) == want
    full = whisper_base.full()
    assert full.param_count() == (67449344, 67449344)
    assert get_config(ARCH).param_count() == full.param_count()
    shapes = encdec.param_shapes(full)
    assert shapes["frontend"]["adapter"][0] == (512, 512)
    assert shapes["decoder.cross_attn"]["wk"][0] == (6, 512, 8, 64)
    assert shapes["encoder.mlp"]["wi"][0] == (6, 512, 2048)
    assert shapes["embed"]["table"][0] == (51865, 512)


def test_param_tree_follows_reference(whisper):
    """``registry.init`` has the reference's ``init_encdec`` tree (the
    adapter, the encoder and decoder stacks, both norms) and shapes;
    ``params_from_numpy`` carries every leaf across unchanged."""
    cfg, params, tcfg, tp = whisper
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {k.split(".")[0] for k in got} == {
        "embed", "frontend", "encoder", "encoder_norm", "final_norm",
        "decoder"}
    assert {k.split(".")[1] for k in got if k.startswith("decoder")} == {
        "ln1", "ln_x", "ln2", "self_attn", "cross_attn", "mlp"}
    jinit = _flat(jreg.init(cfg, jax.random.PRNGKey(1))[0])
    sd = registry.init(tcfg, torch.Generator().manual_seed(0),
                       device="cpu").state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == \
        {k: v.shape for k, v in jinit.items()}
    for k in jinit:
        if k.endswith("scale"):
            assert (sd[k] == 1).all(), k
        elif k.rsplit(".", 1)[1] in _ZEROS:
            assert (sd[k] == 0).all(), k
        else:
            np.testing.assert_allclose(sd[k].std().item(), jinit[k].std(),
                                       rtol=0.1, err_msg=k)


def test_sinusoid_positions_match_reference():
    """``sinusoid_positions`` at whisper's widths, 1500 positions and a
    batch of decode positions: the reference's f32 table, within 1e-6
    plus two f32 ulps of each angle ``p f``.  The frequencies are one
    f32 ``exp`` each, which XLA's and PyTorch's CPU libraries round apart
    by an ulp for a few of them (both within an ulp of the exact value),
    and position 1499 carries that ulp into the angle: up to 1.2e-4 on
    the table at 1500 frames."""
    half_log = np.log(np.float32(10000.0)).astype(np.float32)
    for d, pos in ((512, np.arange(1500)), (128, np.array([[0], [7],
                                                           [447]]))):
        got = sinusoid_positions(torch.from_numpy(pos), d).numpy()
        want = np.asarray(jsinus(jnp.asarray(pos), d))
        assert got.dtype == np.float32 and got.shape == want.shape
        freqs = np.exp(-np.arange(d // 2) * (half_log / (d // 2 - 1)))
        ang = np.float32(pos[..., None] * freqs)
        tol = 1e-6 + 2 * np.concatenate([np.spacing(ang)] * 2, axis=-1)
        assert (np.abs(got - want) <= tol).all()


# -- bidirectional and cross-attention

@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 16), (23, 9)])
def test_noncausal_attention_matches_reference(sq, sk):
    """``ops.attention(causal=False)``, the encoder's (Sq = Sk) and the
    cross-attention's (Sq != Sk) form, against the reference's einsum
    path (``_attend`` with an all-true mask) and its chunked oracle."""
    from repro.kernels import ops as jops
    from repro.models import attention as jattn
    rng = np.random.default_rng(2)
    b, kv, g, hd = 2, 3, 2, 16
    q = rng.standard_normal((b, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=0.25, causal=False)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn._attend(jq, jk, jv, jnp.ones((1, 1, 1, sq, sk), bool), 0.25)
    oracle = jops._oracle_attention(jq, jk, jv, 0.25, False)
    assert got.shape == (b, sq, kv * g, hd)
    _close(got, want, 1e-5)
    _close(got, oracle, 1e-5)


def test_encode_matches_reference(whisper):
    """``encode``: the adapter, the sinusoids, the bidirectional layers,
    the encoder norm."""
    cfg, params, tcfg, tp = whisper
    _, frames = _inputs(cfg, 2, 4, 1)
    want = jed.encode(params, cfg, jnp.asarray(frames))
    got = encdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


def test_decoder_forward_matches_reference(whisper):
    """``decoder_forward`` over the encoded frames at S = 11: the hidden
    states and the self-attention K/V (L, B, S, KV, hd)."""
    cfg, params, tcfg, tp = whisper
    tokens, frames = _inputs(cfg, 2, 11, 2)
    enc = jed.encode(params, cfg, jnp.asarray(frames))
    jh, jkv = jed.decoder_forward(params, cfg, jnp.asarray(tokens), enc)
    th, tkv = encdec.decoder_forward(tp, tcfg, torch.from_numpy(tokens),
                                     torch.from_numpy(np.array(enc)))
    assert tkv.k.shape == (2, 2, 11, 4, 32)
    _close(th, jh)
    _close(tkv.k, jkv.k)
    _close(tkv.v, jkv.v)


def test_loss_and_gradients_match_reference(whisper):
    """``encdec_loss`` through ``registry.loss`` on a ``SyntheticLM``
    batch with frames, and every gradient leaf (adapter, encoder,
    decoder, both norms) within REL of the reference's."""
    cfg, params, tcfg, _ = whisper
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, 12, 2),
                        tcfg).global_batch(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jreg.loss(p, cfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    trainable = params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu", trainable=True)
    loss, metrics, grads = ts.loss_and_grads(
        trainable, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=REL)
    assert set(metrics) == set(jm) == {"nll"}
    want = _flat(jg)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        if _shift_free(k):
            assert np.abs(g.numpy()).max() < 1e-6, k
            assert np.abs(want[k]).max() < 1e-6, k
            continue
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=k)


def test_prefill_logits_and_cache_match_reference(whisper):
    """``make_prefill`` with frames and a 9-token prompt: the last
    logits and the ``EncDecCache`` (the prompt's self K/V, every layer's
    cross K/V over the 16 encoder rows)."""
    cfg, params, tcfg, tp = whisper
    tokens, frames = _inputs(cfg, 2, 9, 3)
    batch = {"tokens": tokens, "frames": frames}
    jl, jc = jreg.prefill(params, cfg, jax.tree.map(jnp.asarray, batch))
    tl, tc = serve_step.make_prefill(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert isinstance(tc, encdec.EncDecCache)
    assert tl.shape == (2, cfg.vocab_size)
    assert tc.self_kv.k.shape == (2, 2, 9, 4, 32)
    assert tc.cross_kv.k.shape == (2, 2, 16, 4, 32)
    _close(tl, jl)
    for got, want in zip((*tc.self_kv, *tc.cross_kv),
                         (*jc.self_kv, *jc.cross_kv)):
        _close(got, want)


def test_decode_matches_forward(whisper):
    """The reference's ``test_decode_matches_forward`` for whisper-base:
    ``init_cache`` with its cross K/V replaced by the encoder's, then
    token-by-token ``make_decode`` steps reproduce the teacher-forced
    logits (within 2e-2 there; 1e-4 here, f32 on both paths), and each
    step's logits and self cache are the reference's."""
    cfg, params, tcfg, tp = whisper
    b, s = 2, 16
    toks, frames = _inputs(cfg, b, s, 4)
    enc = jed.encode(params, cfg, jnp.asarray(frames))
    jh, _ = jed.decoder_forward(params, cfg, jnp.asarray(toks), enc)
    tenc = encdec.encode(tp, tcfg, torch.from_numpy(frames))
    th, _ = encdec.decoder_forward(tp, tcfg, torch.from_numpy(toks), tenc)
    full = logits_from_hidden(tp, th, tcfg)
    _close(full, jlogits(params, jh, cfg))
    jcache = jed.init_encdec_cache(cfg, b, s, dtype=jnp.float32)
    jcache = jcache._replace(cross_kv=jax.vmap(
        lambda lp: jed._cross_kv(lp, enc, cfg))(
        params["decoder"]["cross_attn"]))
    cache = registry.init_cache(tcfg, b, s, dtype=torch.float32,
                                device="cpu")
    cross = tt._stacked([encdec._cross_kv(lp["cross_attn"], tenc, tcfg)
                         for lp in tt._slices(tp["decoder"], 1)], (2,))
    cache = cache._replace(cross_kv=cross)
    decode = serve_step.make_decode(tcfg)
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        logits, cache = decode(tp, torch.from_numpy(toks[:, t]),
                               torch.from_numpy(pos), cache)
        jl, jcache = jed.encdec_decode_step(params, cfg,
                                            jnp.asarray(toks[:, t]),
                                            jnp.asarray(pos), jcache)
        _close(logits, full[:, t].detach())
        _close(logits, jl)
        _close(cache.self_kv.k, jcache.self_kv.k)
    assert cache.cross_kv is cross


def test_greedy_generate_matches_reference(whisper):
    """``greedy_generate`` from ``init_cache``'s zero cross K/V (the
    reference's token-by-token path, which passes no frames), then a
    decode step a token: the reference's tokens."""
    cfg, params, tcfg, tp = whisper
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 7))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  8, 24)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 8,
                                     24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(whisper, microbatches):
    """Three ``make_train_step`` steps (remat on, encoder and decoder) on
    ``SyntheticLM`` batches with frames against the jitted reference's at
    ``microbatches``: each step's loss within REL, and the update after
    them per leaf within 1e-3 in relative norm and per element within
    3e-2 of the summed learning rate."""
    cfg, params, tcfg, _ = whisper
    assert tcfg.remat
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, 12, 2), tcfg)
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
        if _shift_free(k):
            continue
        got = p.detach().numpy() - start[k]
        step_want = final[k] - start[k]
        scale = np.linalg.norm(step_want)
        assert scale > 0, k
        assert np.linalg.norm(got - step_want) <= 1e-3 * scale, k
        np.testing.assert_allclose(got, step_want, rtol=0,
                                   atol=3e-2 * lr_sum, err_msg=k)


def test_pipeline_frames_equal_reference():
    """``SyntheticLM`` with the audio config: tokens, targets and the f32
    ``frames (rows, encoder_seq, d)`` equal the reference's bit for bit;
    without an architecture, tokens and targets only."""
    from repro.data.pipeline import PipelineConfig as JPC
    from repro.data.pipeline import SyntheticLM as JSyn
    for seed, step in ((0, 0), (3, 2)):
        want = JSyn(JPC(512, 10, 2, seed=seed),
                    get_config(ARCH, reduced=True)).global_batch(step)
        got = SyntheticLM(PipelineConfig(512, 10, 2, seed=seed),
                          port_config(ARCH, True)).global_batch(step)
        assert got.keys() == want.keys() == {"tokens", "targets", "frames"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain = SyntheticLM(PipelineConfig(512, 10, 2)).global_batch(1)
    assert plain.keys() == {"tokens", "targets"}


# -- the registry and the engine

#: each ported family's registry routes, by architecture
FAMILIES = {"gemma-2b": tt, "minicpm3-4b": tt, "mamba2-780m": tt,
            "recurrentgemma-9b": tt, "deepseek-moe-16b": tt,
            "paligemma-3b": tt, "whisper-base": encdec}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_registry_dispatch(arch, monkeypatch):
    """``registry.init`` / ``loss`` / ``prefill`` / ``decode_step`` /
    ``init_cache`` reach ``encdec`` for the audio family and
    ``transformer`` for every other (recorded through stand-ins), with
    the batch's patches or frames passed on."""
    mod = FAMILIES[arch]
    names = (("init_encdec", "encdec_loss", "encdec_prefill",
              "encdec_decode_step", "init_encdec_cache") if mod is encdec
             else ("init_lm", "lm_loss", "prefill", "decode_step",
                   "init_cache"))
    calls = []
    for n in names:
        monkeypatch.setattr(mod, n, lambda *a, _n=n, **kw: calls.append(
            (_n, a, kw)) or _n)
    cfg = port_config(arch, True)
    batch = {"tokens": "t", "targets": "y", "patches": "p", "frames": "f"}
    got = [registry.init(cfg, None, "cpu"), registry.loss(None, cfg, batch),
           registry.prefill(None, cfg, batch),
           registry.decode_step(None, cfg, "t", "pos", "c"),
           registry.init_cache(cfg, 2, 8, device="cpu")]
    assert got == list(names)
    if mod is encdec:
        assert calls[1][1][2:] == ("f", "t", "y")
        assert calls[2][1][2:] == ("f", "t")
    else:
        assert calls[1][1][2:] == ("t", "y")
        assert calls[1][2] == {"patches": "p"}
        assert calls[2][2] == {"patches": "p"}


def test_engine_refuses_audio(whisper):
    """``ServeEngine`` refuses the audio family at construction: the
    reference's engine prefills with the tokens alone, so it cannot serve
    whisper either; the message names the entries that can."""
    _, _, tcfg, tp = whisper
    with pytest.raises(NotImplementedError,
                       match="frames.*make_prefill.*greedy_generate"):
        ServeEngine(tcfg, tp, device="cpu")
    assert "whisper-base" in ARCHS and "paligemma-3b" in ARCHS
