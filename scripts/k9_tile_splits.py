"""Time K9's TILE on one descriptor at several splits of its K (card
only), to see how the split rule (``emit.tile_splits``) trades blocks
against waves.

    python scripts/k9_tile_splits.py [--n 1024] [--r 4]

The form is ``A[i, a, b, c, d] B[d, c, b, a, j]`` over its four
contracted axes (no two merge: TILE over the flattened K), i = j = n,
a..d = r, in (mul, add) and in max-plus.  The descriptor is K9's
(``emit.describe(None, nf)``) with ``splits`` and ``k_split`` replaced,
each a whole number of slabs; every split count is held to the plain
version and timed as ten calls captured in one CUDA graph and replayed
(device time), three times, beside ``torch.einsum`` in a graph.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--r", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    from repro_torch.core import expr as E
    from repro_torch.kernels import emit, ops
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[k9_tile_splits] {smi}", flush=True)
    n, r = args.n, args.r
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(n, r, r, r, r, generator=g, device="cuda") * r ** -2
    b = torch.randn(r, r, r, r, n, generator=g, device="cuda")
    volume = r ** 4
    for plus, times in (("add", "mul"), ("max", "add")):
        x = E.inner(plus, times,
                    E.transpose(E.arr("A", (n, r, r, r, r)), (1, 2, 3, 0, 4)),
                    E.transpose(E.arr("B", (r, r, r, r, n)), (3, 2, 1, 0, 4)),
                    batch=3)
        for _ in range(3):
            x = E.reduce(plus, x, 0)
        base = emit.describe(None, E.normal_form(x))
        with ops.reference_mode():
            want = ops.semiring_contract(base, a, b)
        for splits in range(1, 5):
            k_split = -(-volume // splits)
            k_split = -(-k_split // emit.TILE_K) * emit.TILE_K
            if -(-volume // k_split) != splits:
                continue
            launch = dataclasses.replace(base, splits=splits,
                                         k_split=k_split, _descs={})
            fn = lambda launch=launch: ops.semiring_contract(launch, a, b)
            err = (fn() - want).abs().max().item()
            ms = [chip_smoke.graph_ms(torch, fn) for _ in range(3)]
            rule = " (tile_splits' own)" if splits == base.splits else ""
            print(f"[k9_tile_splits] ({plus}, {times}) n={n} r={r} "
                  f"splits={splits}{rule} k_split={k_split} max_abs_err="
                  f"{err:.2e} graph_ms=" + " / ".join(f"{v:.4f}" for v in ms),
                  flush=True)
    lib = lambda: torch.einsum("iabcd,dcbaj->ij", a, b)
    print(f"[k9_tile_splits] torch.einsum graph_ms="
          f"{chip_smoke.graph_ms(torch, lib):.4f}", flush=True)


if __name__ == "__main__":
    main()
