"""The port's kernel entries (``repro_torch.kernels.ops``) against the JAX
package's ``repro.kernels.ops`` on the same numpy inputs, on the CPU (the
plain PyTorch versions).  The kernels themselves are held against their
plain versions on the card in ``test_torch_kernels.py``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.hardware import get_entry  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CPU = get_entry("cpu")


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("xs,ws,tb", [
    ((7, 33), (33, 21), False),
    ((2, 5, 64), (64, 3, 16), False),        # leading dims / trailing dims
    ((7, 33), (21, 33), True),               # the tied-head layout
    ((1, 3, 48), (40, 48), True),
])
def test_matmul_bit_exact_on_integer_inputs(xs, ws, tb):
    """Integer-valued f32 inputs: every partial sum is exact, so the port
    must equal both the JAX kernel (interpret mode) and its XLA oracle
    bit for bit, in the same f32 accumulate / out-dtype contract."""
    rng = np.random.default_rng(0)
    x, w = _ints(rng, xs), _ints(rng, ws)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                     transpose_b=tb, out_dtype=torch.float32).numpy()
    for interpret in (True, None):
        want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w),
                                      transpose_b=tb, out_dtype=jnp.float32,
                                      interpret=interpret))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_matmul_rejects_contraction_mismatch():
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.matmul(torch.zeros(2, 3), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="transpose_b"):
        ops.matmul(torch.zeros(2, 3), torch.zeros(4, 5), transpose_b=True)


def _attn_inputs(rng, b, s, kv, g, hd):
    return (rng.standard_normal((b, s, kv, g, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,kv,g,hd,window", [
    (1, 7, 1, 4, 32, 0),
    (2, 33, 2, 2, 16, 0),
    (1, 33, 1, 4, 32, 5),
])
def test_attention_matches_jax_kernel_and_oracle(b, s, kv, g, hd, window):
    """Causal and windowed masks at odd lengths: within 1e-5 of the JAX
    flash kernel (interpret mode on the cpu entry) and of its oracle."""
    rng = np.random.default_rng(1)
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    scale = hd ** -0.5
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=scale, causal=True,
                        window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jops.attention(jq, jk, jv, scale=scale, causal=True,
                          window=window, interpret=True, hardware=CPU)
    oracle = jops._oracle_attention(jq, jk, jv, scale, True, window)
    assert got.shape == (b, s, kv * g, hd)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=0, atol=1e-5)


def test_attention_contract_errors():
    q, k, v = (torch.zeros(1, 4, 1, 2, 8), torch.zeros(1, 4, 1, 8),
               torch.zeros(1, 4, 1, 8))
    # a prefix (the prefix-LM) or a window refines the causal mask: both
    # raise without it, as the reference's emit.py:289-292
    with pytest.raises(ValueError, match="prefix_len=2 require causal"):
        ops.attention(q, k, v, scale=1.0, causal=False, prefix_len=2)
    with pytest.raises(ValueError, match="causal"):
        ops.attention(q, k, v, scale=1.0, causal=False, window=2)


def _paged_inputs(rng, slots=4, kv=1, g=4, hd=32, page=4, pool_pages=12):
    q = rng.standard_normal((slots, kv, g, hd)).astype(np.float32)
    kp = rng.standard_normal((pool_pages * page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((pool_pages * page, kv, hd)).astype(np.float32)
    return q, kp, vp


@pytest.mark.parametrize("window", [0, 6])
def test_paged_decode_batched_matches_jax_kernel(window):
    """Scrambled tables, ragged positions and a dead slot: within 1e-5 of
    the JAX batched decode kernel (interpret mode); the dead row is
    exactly 0."""
    rng = np.random.default_rng(2)
    page = 4
    q, kp, vp = _paged_inputs(rng, page=page)
    slabs = rng.permutation(12)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :3] = slabs[:3]          # pos 10 -> pages 0..2
    tables[1, :1] = slabs[3:4]         # pos 2
    tables[3, :4] = slabs[4:8]         # pos 15 -> pages 0..3
    pos = np.array([10, 2, -1, 15], np.int32)
    scale = 32 ** -0.5
    got = ops.paged_decode_batched(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pos), torch.from_numpy(tables), page=page,
        scale=scale, window=window).numpy()
    pos_aux = np.stack([pos, np.zeros_like(pos)], axis=-1)
    want = np.asarray(jops.paged_decode_batched(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pos_aux), page_tables=tuple(map(tuple, tables.tolist())),
        page=page, scale=scale, window=window, interpret=True))
    assert got.shape == (4, 1, 4, 32) and got.dtype == np.float32
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    x = torch.ones(3, 8)
    ops.matmul(x, torch.ones(8, 5))
    ops.attention(torch.ones(1, 3, 1, 2, 8), torch.ones(1, 3, 1, 8),
                  torch.ones(1, 3, 1, 8), scale=1.0)
    w = torch.ones(8, 5, requires_grad=True)
    ops.matmul(x, w).sum().backward()
    q = torch.ones(1, 3, 1, 2, 8, requires_grad=True)
    ops.attention(q, torch.ones(1, 3, 1, 8), torch.ones(1, 3, 1, 8),
                  scale=1.0).sum().backward()
    xdt = torch.ones(1, 5, 2, 3, requires_grad=True)
    y, _ = ops.scan_ssd(xdt, -torch.ones(1, 5, 2), torch.ones(1, 5, 4),
                        torch.ones(1, 5, 4), chunk=2)
    y.sum().backward()
    la = -torch.ones(1, 5, 3, requires_grad=True)
    h, _ = ops.gated_scan(la, torch.ones(1, 5, 3))
    h.sum().backward()
    ops.semiring_matmul(x, torch.ones(8, 5), plus="max", times="add")
    ops.moa_gemm(x, torch.ones(8, 5))
    assert ops.LAUNCHES == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                            "K6": 0, "K7": 0, "K8": 0, "K9": 0}


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        ops.matmul(torch.ones(2, 3, device="meta"),
                   torch.ones(3, 4, device="meta"))


@pytest.mark.parametrize("xs,ws,tb", [
    ((7, 33), (33, 21), False),
    ((2, 5, 64), (64, 3, 16), False),
    ((7, 33), (21, 33), True),               # the tied-head layout
    ((1, 3, 48), (40, 48), True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_grads_bit_exact_on_integer_inputs(xs, ws, tb, dtype):
    """Both gradients of the f32 product against ``jax.vjp`` through the
    JAX kernel (interpret mode), bit for bit on integer-valued inputs: in
    f32, and with bf16 operands under the f32 cotangent that a training
    step feeds the VJP (the mixed (f32, bf16) products)."""
    rng = np.random.default_rng(5)
    x, w = _ints(rng, xs), _ints(rng, ws)
    g = _ints(rng, xs[:-1] + (ws[:-1] if tb else ws[1:]))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    ty = ops.matmul(tx, tw, transpose_b=tb, out_dtype=torch.float32)
    assert ty.dtype == torch.float32
    ty.backward(torch.from_numpy(g))
    jdt = getattr(jnp, dtype)
    jy, vjp = jax.vjp(lambda a, b: jops.matmul(
        a, b, transpose_b=tb, out_dtype=jnp.float32, interpret=True),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(g))
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(jdx, np.float32))
    np.testing.assert_array_equal(tw.grad.float().numpy(),
                                  np.asarray(jdw, np.float32))


def test_mixed_and_transposed_plain_products():
    """``transpose_a`` reads a stored (k, m) operand as its transpose, and
    a bf16 operand is widened to f32 exactly: the plain product equals
    the f64 product of the same values on integer inputs."""
    rng = np.random.default_rng(6)
    a, b = _ints(rng, (9, 5)), _ints(rng, (9, 4))
    got = ref.matmul(torch.from_numpy(a), torch.from_numpy(b).bfloat16(),
                     transpose_a=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a.T @ b)


_BWD_CASES = [(1, 7, 1, 4, 32, 0), (2, 33, 2, 2, 16, 0), (1, 33, 1, 4, 32, 5),
              (1, 20, 1, 8, 16, 3)]


@pytest.mark.parametrize("b,s,kv,g,hd,window", _BWD_CASES)
def test_attention_stats_match_jax_stats_executor(b, s, kv, g, hd, window):
    """The plain ``attention_stats`` against the JAX forward with its
    (m, l) export (``flash_attention._stats_executor``, interpret mode):
    the output and the logical rows of m and l within 1e-5."""
    rng = np.random.default_rng(7)
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    scale = hd ** -0.5
    out, m, l = ops.attention_stats(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale=scale,
                                    window=window)
    fn = jfa._stats_executor(b, kv, g, s, s, hd, hd, "float32", "float32",
                             "cpu", True, True, scale, None, window, 0)
    jo, jm, jl = fn(*map(jnp.asarray, (q, k, v)))
    assert m.shape == l.shape == (b, kv, g, s) and m.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jo).transpose(0, 3, 1, 2, 4).reshape(
            b, s, kv * g, hd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., :s], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., :s], rtol=1e-5)


def _pad(a, axis, to):
    width = [(0, 0)] * a.ndim
    width[axis] = (0, to - a.shape[axis])
    return np.pad(a, width)


@pytest.mark.parametrize("b,s,kv,g,hd,window", _BWD_CASES)
def test_flash_dq_dkv_match_jax_references(b, s, kv, g, hd, window):
    """The plain ``flash_dq`` / ``flash_dkv`` against the reference's
    blocked oracles (``flash_dq_ref`` / ``flash_dkv_ref``, blocks of 8 over
    sequences padded to a multiple of 8, the pad masked by the logical
    length; dk/dv summed over the group as ``_flash_grouped_bwd`` does),
    causal and windowed, at ragged lengths: within 1e-5 of the largest
    entry."""
    rng = np.random.default_rng(8)
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = hd ** -0.5
    _, m, l = ops.attention_stats(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale=scale,
                                  window=window)
    m, l = m.numpy(), l.numpy()
    delta = rng.standard_normal(m.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, do, m, l, delta)]
    dq = ops.flash_dq(*args, scale=scale, window=window).numpy()
    dk, dv = (t.numpy() for t in ops.flash_dkv(*args, scale=scale,
                                               window=window))
    sp = -(-s // 8) * 8
    pq, pk, pv, pdo = (_pad(a, 1, sp) for a in (q, k, v, do))
    pm, pdl = (_pad(a, 3, sp) for a in (m, delta))
    pl = np.concatenate([l, np.ones(l.shape[:3] + (sp - s,), np.float32)],
                        axis=3)
    jargs = list(map(jnp.asarray, (pq, pk, pv, pdo, pm, pl, pdl)))
    jdq = np.asarray(jref.flash_dq_ref(*jargs, scale=scale, causal=True,
                                       bq=8, bk=8, window=window,
                                       logical_k=s))
    jdk, jdv = jref.flash_dkv_ref(*jargs, scale=scale, causal=True, bj=8,
                                  bi=8, window=window, logical_q=s)
    want_dq = jdq.transpose(0, 3, 1, 2, 4)[:, :s]
    want_dk = np.asarray(jdk).sum(axis=2).transpose(0, 2, 1, 3)[:, :s]
    want_dv = np.asarray(jdv).sum(axis=2).transpose(0, 2, 1, 3)[:, :s]
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("b,s,kv,g,hd,window", _BWD_CASES)
def test_attention_grads_match_jax_kernel(b, s, kv, g, hd, window):
    """dq, dk, dv of ``ops.attention`` (K2 with export, then K3/K4 on the
    card; their plain versions here) against ``jax.vjp`` through the JAX
    flash kernel and its derived backward (interpret mode): within 1e-5 of
    the largest entry."""
    rng = np.random.default_rng(9)
    q, k, v = _attn_inputs(rng, b, s, kv, g, hd)
    do = rng.standard_normal((b, s, kv * g, hd)).astype(np.float32)
    scale = hd ** -0.5
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.attention(tq, tk, tv, scale=scale, window=window)
    out.backward(torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, bb, c: jops.attention(
        a, bb, c, scale=scale, causal=True, window=window, interpret=True,
        hardware=CPU), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad),
                         vjp(jnp.asarray(do))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_backward_contract_errors():
    q = torch.zeros(1, 4, 1, 2, 64)
    k = v = torch.zeros(1, 4, 1, 64)
    stats = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError, match="dO"):
        ops._bwd_args("flash_dq", q, k, v, torch.zeros(1, 4, 1, 64), stats,
                      stats, stats)
    with pytest.raises(ValueError, match="statistics"):
        ops._bwd_args("flash_dkv", q, k, v, torch.zeros_like(q),
                      stats.double(), stats, stats)
    with pytest.raises(TypeError, match="one of each"):
        ops._check_kernel_dtype("gemm", torch.zeros(2, 2, dtype=torch.half),
                                torch.zeros(2, 2), mixed=True)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check_kernel_dtype("flash_fwd", torch.zeros(2),
                                torch.zeros(2, dtype=torch.bfloat16))
