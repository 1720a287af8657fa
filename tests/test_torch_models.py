"""The port's dense LM (``repro_torch.models``) against the JAX package's
on the same weights (carried across with ``params_from_numpy``) and the
same numpy inputs, on the CPU, reduced gemma-2b in float32."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import gemma_2b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import PagePool  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def gemma():
    cfg = get_config("gemma-2b", reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port_config("gemma-2b", reduced=True), tp


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m",
                                  "recurrentgemma-9b", "stablelm-1.6b",
                                  "command-r-plus-104b", "deepseek-moe-16b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_arch_config_copy_matches_reference(reduced, arch):
    ref = get_config(arch, reduced=reduced)
    port = port_config(arch, reduced=reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.head_dim_ == ref.head_dim_


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_shapes(v, name))
        else:
            out[name] = tuple(v.shape)
    return out


def test_init_lm_names_shapes_and_scales_follow_reference(gemma):
    cfg, params, tcfg, _ = gemma
    tp = tt.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(t.shape) for k, t in tp.state_dict().items()}
    assert got == _flat_shapes(params)
    assert tp["layers"]["attn"]["wq"].dtype == torch.float32
    assert not any(p.requires_grad for p in tp.parameters())
    # the Collector's normal(0, fan-in^-1/2) scales; norms are ones
    d = tcfg.d_model
    assert abs(tp["layers"]["attn"]["wq"].std().item() - d ** -0.5) < 0.01
    assert abs(tp["embed"]["table"].std().item() - d ** -0.5) < 0.01
    assert (tp["final_norm"]["scale"] == 1).all()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "command-r-plus-104b"])
def test_init_lm_names_and_shapes_follow_reference_dense_family(arch):
    """The rest of the dense family: LayerNorm (with its bias leaf where
    ``use_bias``), the q/k/v/o and MLP biases, and no ``ln2`` in
    parallel blocks, under the reference's names and shapes; biases
    zeros, norm scales ones."""
    cfg = get_config(arch, reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tcfg = port_config(arch, reduced=True)
    tp = tt.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(t.shape) for k, t in tp.state_dict().items()}
    assert got == _flat_shapes(params)
    for k, t in tp.state_dict().items():
        leaf = k.rsplit(".", 1)[1]
        if leaf in ("bq", "bk", "bv", "bo", "bi", "bias"):
            assert (t == 0).all(), k
        elif leaf == "scale":
            assert (t == 1).all(), k


def test_full_config_is_gemma_2b_full_width():
    cfg = gemma_2b.full()
    shapes = tt.param_shapes(cfg)
    assert shapes["layers.attn"]["wq"][0] == (18, 2048, 8, 256)
    assert shapes["layers.mlp"]["wi"][0] == (18, 2048, 32768)
    assert shapes["embed"]["table"][0] == (256000, 2048)
    assert cfg.dtype == "bfloat16"


def test_other_families_raise(gemma):
    # the decoder-LM assembly lacks the audio family: that is the
    # encoder-decoder's (models.encdec, reached through models.registry)
    *_, tcfg, _ = gemma
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.param_shapes(tcfg.with_(family="audio"))


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_prefill_logits_and_cache_match_jax(gemma, attn_impl):
    cfg, params, tcfg, tp = gemma
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg.with_(attn_impl=attn_impl),
                        jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=0,
                               atol=TOL)


def test_decode_step_paged_batched_matches_jax(gemma):
    """Three live slots over scrambled slabs and one dead slot: logits and
    both pools (the new K/V rows written, the dead write dropped) within
    1e-4 of the JAX batched step (interpret-mode kernel)."""
    cfg, params, tcfg, tp = gemma
    page, pool_pages = 4, 12
    rng = np.random.default_rng(4)
    pool = PagePool(tcfg, pool_pages, page, device="cpu")
    slabs = [int(s) for s in rng.permutation(pool_pages)]   # scrambled
    prompts = {0: 6, 1: 9, 3: 3}                 # slot -> prompt length
    tables = np.zeros((4, 3), np.int32)
    toks, pos = np.zeros(4, np.int32), np.full(4, -1, np.int32)
    taken = 0
    for slot, n in prompts.items():
        prompt = rng.integers(0, cfg.vocab_size, (1, n))
        n_pg = -(-(n + 1) // page)
        own = slabs[taken:taken + n_pg]
        taken += n_pg
        _, cache = tt.prefill(tp, tcfg, torch.from_numpy(prompt))
        pool.write_prefill(cache, own, n)
        tables[slot, :n_pg] = own
        toks[slot] = rng.integers(0, cfg.vocab_size)
        pos[slot] = n
    jpools = {k: jnp.asarray(t.numpy()) for k, t in pool.pools.items()}
    jl, jp = jt.decode_step_paged_batched(
        params, cfg, jnp.asarray(toks), jnp.asarray(pos), jpools,
        page_tables=tuple(map(tuple, tables.tolist())), page=page,
        interpret=True)
    tl = tt.decode_step_paged_batched(
        tp, tcfg, torch.from_numpy(toks), torch.from_numpy(pos), pool.pools,
        tables=torch.from_numpy(tables), page=page)
    live = list(prompts)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=0, atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pool.pools[key].numpy(),
                                   np.asarray(jp[key]), rtol=0, atol=TOL)
