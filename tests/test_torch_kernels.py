"""Each CUDA kernel of the port against its plain PyTorch version on an
H100 (marked ``h100``; each test skips without such a card).  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m h100 tests/test_torch_kernels.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an H100 (compute capability 9.0)")
    ops.reset_launches()
    return torch.device("cuda")


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,tb", [(37, 72, 130, False),
                                      (4, 64, 300, True), (65, 48, 64, True),
                                      (5, 50, 33, False), (3, 50, 33, True)])
def test_gemm_kernel_matches_plain(h100, dtype, m, k, n, tb):
    g = torch.Generator(device=h100).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=h100).to(dtype)
    w = torch.randn(*((n, k) if tb else (k, n)), generator=g,
                    device=h100).to(dtype)
    got = ops.matmul(x, w, transpose_b=tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1
    want = ref.matmul(x, w, tb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,window", [(70, 0), (130, 33)])
def test_flash_kernel_matches_plain(h100, dtype, atol, s, window):
    g = torch.Generator(device=h100).manual_seed(1)
    q = torch.randn(1, s, 1, 8, 256, generator=g, device=h100).to(dtype)
    k = torch.randn(1, s, 1, 256, generator=g, device=h100).to(dtype)
    v = torch.randn(1, s, 1, 256, generator=g, device=h100).to(dtype)
    got = ops.attention(q, k, v, scale=256 ** -0.5, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K2"] == 1
    want = ref.attention(q, k, v, scale=256 ** -0.5, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("page,window", [(16, 0), (4, 0), (16, 40)])
def test_paged_decode_kernel_matches_plain(h100, dtype, atol, page, window):
    g = torch.Generator(device=h100).manual_seed(2)
    pool_pages = 64 // page * 4
    q = torch.randn(4, 1, 8, 256, generator=g, device=h100).to(dtype)
    kp = torch.randn(pool_pages * page, 1, 256, generator=g,
                     device=h100).to(dtype)
    vp = torch.randn(pool_pages * page, 1, 256, generator=g,
                     device=h100).to(dtype)
    perm = torch.randperm(pool_pages, generator=g, device=h100).int()
    tables = perm.reshape(4, -1).contiguous()        # 64 tokens per slot
    pos = torch.tensor([40, 3, -1, 63], dtype=torch.int32, device=h100)
    got = ops.paged_decode_batched(q, kp, vp, pos, tables, page=page,
                                   scale=256 ** -0.5, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K5"] == 1
    assert (got[2] == 0).all()
    want = ref.paged_decode_batched(q, kp, vp, pos, tables, page=page,
                                    scale=256 ** -0.5, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.h100
@pytest.mark.parametrize("ta,tb", [(True, False), (False, True),
                                   (False, False), (True, True)])
@pytest.mark.parametrize("a_dt,b_dt", [(_F32, _BF16), (_BF16, _F32),
                                       (_BF16, _BF16), (_F32, _F32)])
@pytest.mark.parametrize("m,k,n", [(37, 72, 130), (130, 5, 33),
                                   (3, 257, 129)])
def test_gemm_transposed_and_mixed_forms_match_plain(h100, ta, tb, a_dt,
                                                     b_dt, m, k, n):
    """K1's VJP forms: ``transpose_a`` (a stored (k, m) read as its
    transpose), ``transpose_b`` and the plain form, with (f32, bf16)
    mixed operands, at ragged m, n, k (edges of the 128x128 tile)."""
    g = torch.Generator(device=h100).manual_seed(3)
    a = torch.randn(*((k, m) if ta else (m, k)), generator=g,
                    device=h100).to(a_dt)
    b = torch.randn(*((n, k) if tb else (k, n)), generator=g,
                    device=h100).to(b_dt)
    got = ops._gemm(a, b, ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == 1 and got.dtype == torch.float32
    want = ref.matmul(a, b, tb, transpose_a=ta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _attn_case(dev, dtype, b, s, g, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=dev).to(dtype)
    return (rnd(b, s, 1, g, hd), rnd(b, s, 1, hd), rnd(b, s, 1, hd),
            rnd(b, s, 1, g, hd))


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("s,window", [(70, 0), (130, 33)])
def test_flash_export_leaves_output_unchanged(h100, dtype, s, window):
    q, k, v, _ = _attn_case(h100, dtype, 2, s, 8, 256, 4)
    plain_out = ops.attention(q, k, v, scale=256 ** -0.5, window=window)
    out, m, l = ops.attention_stats(q, k, v, scale=256 ** -0.5,
                                    window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K2"] == 2
    assert torch.equal(out, plain_out)
    _, rm, rl = ref.attention_stats(q, k, v, scale=256 ** -0.5,
                                    window=window)
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-4)
    # l sums p in f32 online (kernel) or at once (plain): order only
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)


@pytest.mark.h100
@pytest.mark.parametrize("dtype,rel", [(_F32, 1e-4), (_BF16, 1e-2)])
@pytest.mark.parametrize("s,g,hd,window", [(70, 8, 256, 0), (130, 8, 256, 33),
                                           (37, 4, 64, 0), (45, 2, 128, 7)])
def test_flash_backward_kernels_match_plain(h100, dtype, rel, s, g, hd,
                                            window):
    """K3 and K4 against their plain versions at ragged lengths, causal
    and windowed, from the kernel's own (m, l) and delta.  Tolerance
    relative to the largest entry: f32 differs in summation order only;
    bf16 rounds the outputs (2^-8) and K4 sums the group in another
    order."""
    q, k, v, do = _attn_case(h100, dtype, 2, s, g, hd, 5)
    scale = hd ** -0.5
    out, m, l = ops.attention_stats(q, k, v, scale=scale, window=window)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    args = (q, k, v, do, m, l, delta)
    dq = ops.flash_dq(*args, scale=scale, window=window)
    dk, dv = ops.flash_dkv(*args, scale=scale, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K3"] == 1 and ops.LAUNCHES["K4"] == 1
    want = (ref.flash_dq(*args, scale=scale, window=window),
            *ref.flash_dkv(*args, scale=scale, window=window))
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == exp.shape
        err = (got.float() - exp.float()).abs().max().item()
        assert err <= rel * exp.float().abs().max().item(), err
