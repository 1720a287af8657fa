"""Quickstart: the MoA pipeline end to end in a minute.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Derive the paper's ONF for a GEMM and dimension-lift it (figs 3-5).
2. Solve block sizes statically from the hardware tables (§3.4).
3. Run the MoA GEMM (K1) and a Kronecker product (K9) against the plain
   versions, on the card by default.
4. Train a small assigned-architecture LM for a few steps.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import blocking, onf
from repro_torch.device import resolve_device
from repro_torch.hardware import H100, V100
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. the algebra ------------------------------------------------------
    m, n, p = 8, 16, 8
    print("== MoA ONF (paper eq. 3) ==")
    print(onf.gemm_onf(m, n, p).render_c())
    lifted = onf.gemm_fully_lifted(m, n, p, procs=2, bk=8, bn=4)
    print("\n== dimension-lifted (figs 4/5) ==")
    print(lifted.render_c())
    a = np.random.default_rng(0).standard_normal((m, n))
    b = np.random.default_rng(1).standard_normal((n, p))
    got = lifted.execute(np.zeros(m * p), a.ravel(), b.ravel())
    assert np.allclose(got.reshape(m, p), a @ b)
    print("\nlifted ONF == linear algebra: OK")

    # -- 2. static blocking --------------------------------------------------
    print("\n== block solver ==")
    print("V100 (paper):", blocking.solve_blocks_square(V100, "float64"),
          "^2 doubles per block")
    bc = blocking.solve_blocks(4096, 4096, 4096, "bfloat16", hardware=H100)
    print("H100 bf16 4096^3:", bc.as_tuple(),
          f"on-chip {bc.vmem_bytes // 2**10} KiB",
          f"AI {bc.arithmetic_intensity:.0f} flops/B")

    # -- 3. the kernels ------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(0)
    A = torch.randn(256, 192, generator=gen, device=device)
    B = torch.randn(192, 128, generator=gen, device=device)
    C = ops.moa_gemm(A, B)
    err = (C - ref.gemm_ref(A, B)).abs().max().item()
    print(f"\nMoA GEMM on {device} vs the plain product: max err {err:.2e}")
    K = ops.kron(torch.eye(2, device=device), A[:4, :4].contiguous())
    print("ipophp kron through the same pipeline:", tuple(K.shape))

    # -- 4. a small assigned arch --------------------------------------------
    print(f"\n== {args.steps}-step training run (gemma-2b reduced) ==")
    return train_main(["--arch", "gemma-2b", "--reduced", "--steps",
                       str(args.steps), "--batch", "4", "--seq", "32",
                       "--log-every", "2", "--device", str(device)])


if __name__ == "__main__":
    main()
