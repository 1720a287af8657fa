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
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.attention(q, k, v, scale=1.0, prefix_len=2)
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
    assert ops.LAUNCHES == {"K1": 0, "K2": 0, "K5": 0}


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        ops.matmul(torch.ones(2, 3, device="meta"),
                   torch.ones(3, 4, device="meta"))
