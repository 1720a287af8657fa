"""MLA (multi-head latent attention) and minicpm3-4b in the port against the
JAX package on the CPU: reduced minicpm3-4b (2 layers, d_model 128, 4
heads; MLA's latent widths as published: q rank 768, kv rank 256, nope 64,
rope 32, v 64) in float32, on the same weights (carried across with
``params_from_numpy``; the norm scales, ones at init, redrawn as seeded
normals on both sides) and the same numpy inputs.

The port runs MLA's full-sequence attention on K2 at its own widths, q.k
96 and v 64 (``attention.mla_attention``), where the reference uses
einsums below ``attn_chunk_min_seq`` and chunked attention above it: both
branches are compared.  The absorbed decode's two products go through
``ops.head_matmul`` (K1's head form on the card; here its plain version,
held to the reference's interpret-mode kernel).
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
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.layers import logits_from_hidden as jlogits  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.train import serve_step as jserve  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import minicpm3_4b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import expr as E  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import logits_from_hidden  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "minicpm3-4b"
#: f32 on both sides, differing in summation order (and in the JAX side's
#: interpret-mode kernel blocks): 1e-4 absolute on outputs, logits and
#: caches; 1e-4 relative on the loss and on each gradient leaf (to its
#: largest entry)
TOL = 1e-4
REL = 1e-4
CPU = get_entry("cpu")
_SCALES = ("scale", "q_norm", "kv_norm")


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
        if k in _SCALES:
            a = 1 + 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def mla():
    """(reference cfg, JAX params, port cfg, port params) of reduced
    minicpm3-4b with perturbed norm scales."""
    cfg = get_config(ARCH, reduced=True)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tree = _perturbed(jax.tree.map(np.asarray, params),
                      np.random.default_rng(0))
    return (cfg, jax.tree.map(jnp.asarray, tree), port_config(ARCH, True),
            params_from_numpy(tree, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=0, atol=tol)


def _layer(params, tp, i):
    """Layer ``i``'s attention parameters on both sides."""
    return (jax.tree.map(lambda t: t[i], params["layers"]["attn"]),
            {k: t[i] for k, t in tp["layers"]["attn"].items()})


# -- the config and the parameters ---------------------------------------------

def test_config_is_the_reference_field_for_field():
    """``full()`` and ``reduced()`` copy the reference's configs field for
    field; the full model has the reference's 4,261,519,360 parameters
    (``param_count``, which counts no norm), 1,880,104,960 at the 24
    layers the card trains."""
    import dataclasses
    for fn in ("full", "reduced"):
        want = dataclasses.asdict(getattr(
            __import__("repro.configs.minicpm3_4b", fromlist=[fn]), fn)())
        assert dataclasses.asdict(getattr(minicpm3_4b, fn)()) == want
    full = minicpm3_4b.full()
    assert full.param_count() == (4261519360, 4261519360)
    assert get_config(ARCH).param_count() == full.param_count()
    assert full.with_(n_layers=24).param_count()[0] == 1880104960
    shapes = tt.param_shapes(full)
    count = sum(int(np.prod(shape)) for leaves in shapes.values()
                for shape, *_ in leaves.values())
    norms = full.n_layers * (768 + 256 + 2 * 2560) + 2560
    assert count == 4261519360 + norms
    assert shapes["layers.attn"]["wkv_b"][0] == (62, 256, 40, 128)


def test_param_tree_follows_reference(mla):
    """``init_lm`` has the reference's ``init_mla`` names, shapes and
    scales; ``params_from_numpy`` carries every leaf across unchanged."""
    cfg, params, tcfg, tp = mla
    want = _flat(params)
    got = {k: t.numpy() for k, t in tp.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jinit, _ = registry.init(cfg, jax.random.PRNGKey(1))
    jinit = _flat(jinit)
    init = tt.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    sd = init.state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == \
        {k: v.shape for k, v in jinit.items()}
    assert sorted(k.rsplit(".", 1)[1] for k in sd
                  if k.startswith("layers.attn")) == sorted(
        ["kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"])
    for k in jinit:
        if k.endswith(("q_norm", "kv_norm", "scale")):
            assert (sd[k] == 1).all(), k
        else:              # the init scales: stds within 10% of each other
            np.testing.assert_allclose(sd[k].std().item(), jinit[k].std(),
                                       rtol=0.1, err_msg=k)


# -- the attention ------------------------------------------------------------------

@pytest.mark.parametrize("chunk_min", [None, 8])
def test_mla_fwd_matches_reference(mla, chunk_min):
    """One layer's ``mla_fwd`` at S = 16: the output and the ``MLACache``
    (the normed kv latent, the rotated shared key).  ``chunk_min`` = 8
    makes the reference take its chunked branch (the two score terms
    folded into one contraction, as the port's K2 call folds them)."""
    cfg, params, tcfg, tp = mla
    if chunk_min:
        cfg = cfg.with_(attn_chunk_min_seq=chunk_min, attn_chunk=4)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None, :]
    jp, lp = _layer(params, tp, 1)
    want, wc = jattn.mla_fwd(jp, jnp.asarray(x), cfg,
                             positions=jnp.asarray(pos))
    got, gc = attention.mla_fwd(lp, torch.from_numpy(x), tcfg,
                                positions=torch.from_numpy(pos))
    assert got.shape == (2, 16, cfg.d_model)
    assert gc.c_kv.shape == (2, 16, 256) and gc.k_pe.shape == (2, 16, 32)
    _close(got, want)
    _close(gc.c_kv, wc.c_kv)
    _close(gc.k_pe, wc.k_pe)


def test_mla_decode_steps_match_reference(mla):
    """Six absorbed ``mla_decode`` steps of one layer from a prefill's
    cache padded to 24, at per-row positions: the output and both latent
    caches at every step."""
    cfg, params, tcfg, tp = mla
    rng = np.random.default_rng(2)
    jp, lp = _layer(params, tp, 0)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10)[None, :]
    _, jc = jattn.mla_fwd(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos))
    pad = lambda t: np.pad(np.asarray(t), ((0, 0), (0, 14), (0, 0)))
    jc = jattn.MLACache(*(jnp.asarray(pad(t)) for t in jc))
    tc = attention.MLACache(*(torch.from_numpy(np.array(t)) for t in jc))
    p = np.array([10, 7], np.int32)
    for _ in range(6):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = jattn.mla_decode(jp, jnp.asarray(xd), jc, jnp.asarray(p),
                                    cfg)
        got, tc = attention.mla_decode(lp, torch.from_numpy(xd), tc,
                                       torch.from_numpy(p), tcfg)
        _close(got, want)
        _close(tc.c_kv, jc.c_kv)
        _close(tc.k_pe, jc.k_pe)
        p = p + 1


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("m", [6, 64])
def test_head_matmul_matches_reference(m, transpose_b):
    """``ops.head_matmul`` in both layouts (the weight a strided view of
    one head-middle table, as MLA's decode passes it) against the
    reference's ``head_matmul`` in interpret mode and the einsum, at 6
    rows (the decode rows' count) and 64 (past them: the tile's)."""
    rng = np.random.default_rng(3)
    b, s = (2, 3) if m == 6 else (8, 8)
    h, k, n = 4, 32, 24
    x = rng.standard_normal((b, s, h, k)).astype(np.float32)
    table = rng.standard_normal((64, h, 48)).astype(np.float32)
    if transpose_b:
        w = table[:n, :, :k]                          # (n, h, k)
        eq = "bshk,nhk->bshn"
    else:
        w = table[:k, :, 48 - n:]                     # (k, h, n)
        eq = "bshk,khn->bshn"
    tw = torch.from_numpy(table)[:n, :, :k] if transpose_b else \
        torch.from_numpy(table)[:k, :, 48 - n:]
    assert not tw.is_contiguous()
    got = ops.head_matmul(torch.from_numpy(x), tw, transpose_b=transpose_b,
                          out_dtype=torch.float32)
    want = jops.head_matmul(jnp.asarray(x), jnp.asarray(w),
                            transpose_b=transpose_b, interpret=True,
                            out_dtype=jnp.float32, hardware=CPU)
    assert got.shape == (b, s, h, n)
    _close(got, want, 1e-5)
    _close(got, np.einsum(eq, x, w), 1e-5)


#: (h, m, k, n, dtypes, transpose_b, aligned) -> route: K1's head form
#: where one head's product is K1's decode-row product ("gemv") or its
#: tile ("tile": past 16 rows, or k no multiple of 32; float16 at every m
#: where TMA reads the rows and k <= F16_PROMOTE_K), else K9
HEAD_ROUTES = [
    ((40, 1, 64, 256, "bfloat16", True, True), "gemv"),
    ((40, 4, 256, 64, "bfloat16", False, True), "gemv"),
    ((40, 16, 256, 64, "bfloat16", False, True), "gemv"),
    ((40, 17, 256, 64, "bfloat16", False, True), "tile"),    # rows
    ((40, 64, 64, 256, "bfloat16", True, True), "tile"),
    ((40, 4, 48, 64, "bfloat16", False, True), "tile"),      # k % 32
    ((40, 4, 256, 60, "bfloat16", False, True), "K9"),       # row of n
    ((40, 4, 256, 64, "bfloat16", False, False), "K9"),      # strides
    ((40, 4, 256, 64, "float32", False, True), "K9"),
    ((40, 100, 64, 256, "bfloat16", True, True), "tile"),
    ((40, 64, 64, 256, "float16", True, True), "tile"),      # float16
    ((40, 64, 64, 256, "bfloat16", True, False), "K9"),      # strides
    ((40, 4, 64, 256, "float16", True, True), "tile"),       # float16 m=4
    ((40, 1, 256, 64, "float16", False, True), "tile"),
    ((40, 64, 64, 256, "float16", True, False), "K9"),       # strides
    ((40, 4, 256, 60, "float16", False, True), "K9"),        # row of n
    ((40, 4, 60, 256, "float16", True, True), "K9"),         # row of k
    ((4, 4, 8192, 64, "float16", True, True), "tile"),       # k at the rule
    ((4, 4, 8200, 64, "float16", True, True), "K9"),         # k past it
]


@pytest.mark.parametrize("case,route", HEAD_ROUTES)
def test_head_route_rule(case, route):
    """``ops.head_route`` (a host rule) and the memoised plan of
    ``head_gemm_expr``: K1 with the lifted head axis (``("K1", False,
    transpose_b, "head")``) where the route is one of K1's (the decode
    rows or the tile), else K9's launch descriptor."""
    from repro_torch.kernels import emit
    h, m, k, n, dt, tb, aligned = case
    assert ops.head_route(h, m, k, n, dt, dt, tb, aligned) == route
    nf = E.normal_form(E.head_gemm_expr(h, m, k, n, transpose_b=tb))
    plan = ops._plan(nf, (dt, dt), torch.float32, ops.H100, None,
                     "float32", aligned)
    if route == "K9":
        assert plan[0] == "K9" and isinstance(plan[1], emit.Launch)
    else:
        assert plan == ("K1", False, tb, "head")


def test_head_aligned_reads_view_strides():
    """``ops.head_aligned``: slices of a bf16 (256, 40, 128) table at
    column 0 and 64 (16-byte rows and bases) qualify, a slice at column 1
    or a table whose rows are not a multiple of 8 elements does not, and
    the stride of an axis of one element is never read."""
    t = torch.zeros(256, 40, 128, dtype=torch.bfloat16)
    assert ops.head_aligned(t[..., :64], t[..., 64:])
    assert not ops.head_aligned(t[..., 1:65])
    assert not ops.head_aligned(torch.zeros(4, 40, 60,
                                            dtype=torch.bfloat16)[..., :32])
    one = torch.zeros(8, 40, 96, dtype=torch.bfloat16)[:1, :, :64]
    assert ops.head_aligned(one) and ops.head_aligned(one.transpose(0, 1)
                                                      .transpose(0, 1))


@pytest.mark.parametrize("case", ["f16_bf16", "f32", "unaligned"])
def test_head_matmul_takes_k9_where_k1_refuses(case):
    """A head form that K1 refuses (a float16 activation against a bf16
    table at 64 rows; f32; a bf16 view whose base is off 16 bytes) is
    planned on K9 from the operands as given, runs it (its plain version
    here) on their row-major copies, and agrees with the einsum."""
    rng = np.random.default_rng(9)
    m = 64 if case == "f16_bf16" else 4
    dt = {"f16_bf16": torch.float16, "f32": torch.float32}.get(
        case, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((m, 1, 40, 96)).astype(
        np.float32)).to(dt)[..., :64]
    table = torch.from_numpy(rng.standard_normal((256, 40, 128)).astype(
        np.float32)).to(torch.bfloat16 if case == "f16_bf16" else dt)
    if case == "unaligned":
        x = torch.cat([x, x[..., :1]], dim=-1)[..., 1:]
    x3 = x.reshape(m, 40, 64)
    assert ops.head_route(40, m, 64, 256, dt, table.dtype, True,
                          ops.head_aligned(x3, table[..., :64])) == "K9"
    nf = E.normal_form(E.head_gemm_expr(40, m, 64, 256, transpose_b=True))
    assert ops._plan(nf, (str(dt)[6:], str(table.dtype)[6:]),
                     torch.float32, ops.H100, None, "float32",
                     ops.head_aligned(x3, table[..., :64]))[0] == "K9"
    got = ops.head_matmul(x, table[..., :64], transpose_b=True,
                          out_dtype=torch.float32)
    want = torch.einsum("bshk,nhk->bshn", x.float(), table[..., :64].float())
    assert got.shape == (m, 1, 40, 256)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("m", [4, 64])
def test_head_matmul_float16_takes_k1_head_tile(m):
    """Two float16 operands (MLA's q_lat on a strided float16 table view)
    take K1's head tile at 4 and 64 rows (``ops.head_route`` "tile", the
    plan ``("K1", False, True, "head")``: there is no float16 decode-row
    kernel), and the port (its plain version here) agrees with the
    reference's ``head_matmul(interpret=True)`` and with the einsum on the
    f32 values within 1e-5 (every f16 product is exact in f32; the sums
    run in another order)."""
    rng = np.random.default_rng(10 + m)
    f16 = np.float16
    x = rng.standard_normal((m, 1, 40, 96)).astype(f16)[..., :64]
    table = (rng.standard_normal((256, 40, 128)) * 256 ** -0.5).astype(f16)
    tx, tt = torch.from_numpy(np.ascontiguousarray(x)), \
        torch.from_numpy(table)
    w = tt[..., :64]
    assert ops.head_aligned(tx.reshape(m, 40, 64), w)
    assert ops.head_route(40, m, 64, 256, torch.float16, torch.float16,
                          True) == "tile"
    nf = E.normal_form(E.head_gemm_expr(40, m, 64, 256, transpose_b=True))
    assert ops._plan(nf, ("float16", "float16"), torch.float32, ops.H100,
                     None, "float32") == ("K1", False, True, "head")
    got = ops.head_matmul(tx, w, transpose_b=True, out_dtype=torch.float32)
    want = jops.head_matmul(jnp.asarray(x), jnp.asarray(table[..., :64]),
                            transpose_b=True, interpret=True,
                            out_dtype=jnp.float32, hardware=CPU)
    assert got.shape == (m, 1, 40, 256)
    _close(got, want, 1e-5)
    _close(got, np.einsum("bshk,nhk->bshn", x.astype(np.float32),
                          table[..., :64].astype(np.float32)), 1e-5)


def test_padded_attention_is_the_unpadded_function():
    """``mla_attention`` (q'' and k'' of width 96, v of 64) gives the
    attention at those widths (scores at scale 96^-1/2, the materialised
    causal softmax) within 1e-5 with every gradient of its inputs, and the
    identity the width rule of ``ops`` pads by: q'' and k'' zero-padded
    from 96 to 128 and v from 64, through the flash entry's plain version,
    leave zeros in every padded column of the output and of the padded
    tensors' gradients."""
    rng = np.random.default_rng(4)
    b, s, h = 2, 9, 3
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_(True)
    ins = (mk(b, s, h, 64), mk(b, s, h, 32), mk(b, s, h, 64), mk(b, s, 32),
           mk(b, s, h, 64))
    dout = torch.from_numpy(rng.standard_normal((b, s, h, 64)).astype(
        np.float32))

    def unpadded(qn, qp, kn, kp, v):
        q = torch.cat([qn, qp], -1)
        k = torch.cat([kn, kp[:, :, None].expand(b, s, h, 32)], -1)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * 96 ** -0.5
        mask = torch.ones(s, s, dtype=torch.bool).tril()
        w = torch.softmax(torch.where(mask, sc, ref.MASK_NEG_INF), -1)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    got = attention.mla_attention(*ins, 96 ** -0.5)
    want = unpadded(*ins)
    _close(got, want.detach(), 1e-5)
    g_got = torch.autograd.grad(got, ins, dout)
    g_want = torch.autograd.grad(want, ins, dout)
    for a, w in zip(g_got, g_want):
        _close(a, w, 1e-5)
    # the padded tensors' own gradients: zero in every padded column
    q = torch.cat([ins[0], ins[1], torch.zeros(b, s, h, 32)], -1).detach()
    k = torch.cat([ins[2], ins[3][:, :, None].expand(b, s, h, 32),
                   torch.zeros(b, s, h, 32)], -1).detach()
    v = torch.cat([ins[4], torch.zeros(b, s, h, 64)], -1).detach()
    pad = [t.requires_grad_(True) for t in (q, k, v)]
    out = ops.attention(pad[0].reshape(b, s, h, 1, 128), pad[1], pad[2],
                        scale=96 ** -0.5)
    assert not out[..., 64:].any()
    dq, dk, dv = torch.autograd.grad(out[..., :64], pad, dout)
    assert not dq[..., 96:].any() and not dk[..., 96:].any()
    assert not dv[..., 64:].any()


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("chunk_min", [None, 8])
def test_prefill_logits_and_cache_match_reference(mla, chunk_min):
    """``prefill`` at S = 13 (the reference's einsum branch, or its chunked
    one below ``chunk_min``): the last position's logits and the stacked
    ``MLACache`` (L, B, S, rank)."""
    cfg, params, tcfg, tp = mla
    if chunk_min:
        cfg = cfg.with_(attn_chunk_min_seq=chunk_min, attn_chunk=4)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 13))
    jl, jc = jt.prefill(params, cfg, jnp.asarray(tokens))
    tl, tc = tt.prefill(tp, tcfg, torch.from_numpy(tokens))
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    assert isinstance(tc, attention.MLACache)
    assert tc.c_kv.shape == (2, 2, 13, 256) and tc.k_pe.shape == (2, 2, 13,
                                                                  32)
    _close(tl, jl)
    _close(tc.c_kv, jc.c_kv)
    _close(tc.k_pe, jc.k_pe)


def test_decode_steps_match_reference(mla):
    """A ragged prefill (rows of 9 and 13 tokens) re-laid into latent
    caches of 24 (``prefill_cache_to_decode`` pads the ``MLACache`` as the
    reference does), then 6 decode steps at per-row positions: logits and
    both caches at every step."""
    cfg, params, tcfg, tp = mla
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (2, 13))
    _, jc = jt.prefill(params, cfg, jnp.asarray(prompt))
    _, tc = tt.prefill(tp, tcfg, torch.from_numpy(prompt))
    assert tt.has_prefill_decode_relayout(tcfg)
    jcache = jt.prefill_cache_to_decode(cfg, jc, 24)
    tcache = tt.prefill_cache_to_decode(tcfg, tc, 24)
    assert tcache["layers"].c_kv.shape == jcache["layers"].c_kv.shape == \
        (2, 2, 24, 256)
    init = tt.init_cache(tcfg, 2, 24, dtype=torch.float32, device="cpu")
    assert [tuple(t.shape) for t in init["layers"]] == \
        [tuple(t.shape) for t in tcache["layers"]]
    pos = np.array([9, 13], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2)
        jl, jcache = jt.decode_step(params, cfg, jnp.asarray(tok),
                                    jnp.asarray(pos), jcache)
        tl, tcache = tt.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcache)
        _close(tl, jl)
        _close(tcache["layers"].c_kv, jcache["layers"].c_kv)
        _close(tcache["layers"].k_pe, jcache["layers"].k_pe)
        pos = pos + 1


def test_decode_matches_forward(mla):
    """The reference's ``test_decode_matches_forward`` for minicpm3-4b:
    token-by-token decode from an empty latent cache reproduces the
    teacher-forced logits of one forward (within 2e-2 there; 1e-4 here,
    f32 on both paths), and each step's logits are the reference's."""
    cfg, params, tcfg, tp = mla
    b, s = 2, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s))
    hidden, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    full = logits_from_hidden(tp, hidden, tcfg)
    jh, _, _ = jt.forward(params, cfg, jnp.asarray(toks))
    _close(full, jlogits(params, jh, cfg))
    cache = tt.init_cache(tcfg, b, s, dtype=torch.float32, device="cpu")
    jcache = jt.init_cache(cfg, b, s, dtype=jnp.float32)
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        logits, cache = tt.decode_step(tp, tcfg, torch.from_numpy(toks[:, t]),
                                       torch.from_numpy(pos), cache)
        jl, jcache = jt.decode_step(params, cfg, jnp.asarray(toks[:, t]),
                                    jnp.asarray(pos), jcache)
        _close(logits, full[:, t].detach())
        _close(logits, jl)


def test_greedy_generate_matches_reference(mla):
    """One prefill re-laid as the latent decode cache, then a decode step
    a token: the reference's tokens."""
    cfg, params, tcfg, tp = mla
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 11))
    want = jserve.greedy_generate(params, cfg, jnp.asarray(prompt, jnp.int32),
                                  8, 32)
    got = serve_step.greedy_generate(tp, tcfg, torch.from_numpy(prompt), 8,
                                     32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_tokens_match_reference_on_bench_trace(mla):
    """bench_serve.py's seed-0 trace (10 requests, 4 slots, max_len 64)
    through ``ServeEngine`` on contiguous per-slot latent caches: every
    request's greedy tokens equal the JAX engine's, one decode step a slot
    and iteration, and each iteration reads the device once for its
    decode plus once per prompt it admits."""
    cfg, params, tcfg, tp = mla
    reqs = [(r["prompt"], r["max_new"]) for r in poisson_trace(cfg.vocab_size)]
    jengine = JServeEngine(cfg, params, max_slots=4, max_len=64,
                           interpret=True)
    jrids = [jengine.submit(p, n) for p, n in reqs]
    jres = jengine.run()
    engine = ServeEngine(tcfg, tp, max_slots=4, max_len=64, device="cpu")
    assert engine.pool is None and not engine.paged and not engine.batched
    rids = [engine.submit(p, n) for p, n in reqs]
    while not engine.idle:
        waiting, before = len(engine._waiting), engine.host_transfers
        calls0 = engine.kernel_calls
        engine.step()
        admitted = waiting - len(engine._waiting)
        assert engine.host_transfers - before == admitted + \
            (engine.kernel_calls > calls0)
    res = engine.results()
    assert [res[r]["tokens"] for r in rids] == \
        [jres[r]["tokens"] for r in jrids]
    assert engine.kernel_calls == sum(n - 1 for _, n in reqs)


def test_paged_serving_of_mla_is_refused(mla):
    """As in the reference, MLA's latent cache has no paged view:
    ``init_paged_pools`` and both paged decode steps raise, and the engine
    refuses ``batched=True``."""
    cfg, params, tcfg, tp = mla
    with pytest.raises(ValueError, match="paged pools"):
        jt.init_paged_pools(cfg, 64)
    with pytest.raises(ValueError, match="paged pools"):
        tt.init_paged_pools(tcfg, 64, device="cpu")
    tok = torch.zeros(1, dtype=torch.long)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="paged pools"):
        tt.decode_step_paged(tp, tcfg, tok, pos, {}, table=pos, page=4)
    with pytest.raises(ValueError, match="paged pools"):
        tt.decode_step_paged_batched(tp, tcfg, tok, pos, {},
                                     tables=pos[None], page=4)
    with pytest.raises(ValueError, match="serves contiguous"):
        ServeEngine(tcfg, tp, batched=True, device="cpu")


# -- training ----------------------------------------------------------------------

def test_lm_loss_and_gradients_match_reference(mla):
    """``lm_loss`` and every gradient leaf (the latent norms included),
    through the padded attention's VJP, within REL of the reference's."""
    cfg, params, tcfg, _ = mla
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


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(mla, microbatches):
    """Three ``make_train_step`` steps (remat on) against the jitted
    reference's at ``microbatches``: each step's loss within REL, and the
    update itself after them (each parameter less its start) per leaf
    within 1e-3 in relative norm and per element within 3e-2 of the summed
    learning rate (``tests/test_torch_train.py``'s hold)."""
    cfg, params, tcfg, _ = mla
    assert tcfg.remat
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 2))
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
