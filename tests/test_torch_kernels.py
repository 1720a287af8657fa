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
