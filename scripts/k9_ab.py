"""Time K9's paths (``csrc/semiring.cu``), the head form in bf16, float16
and int8, and the int8 products and stacks (K9, or K1's head tile, int8
decode rows and int8 tile, ``csrc/gemm.cu``) of two source trees on one
card, in the order A B B A, so that a change to the kernel is read beside
the build it changes and not across calls or hosts.

    python scripts/k9_ab.py OTHER_TREE [--out FILE]

``OTHER_TREE`` is a second checkout of the repository (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory);
this script's own tree is the other side.  Each side runs in a process of
its own (both packages are named ``repro_torch``), builds its K9 library
into its own ``build/``, and times each case through the user entry that
reaches it: device time as ten calls captured in one CUDA graph and
replayed (the host's launch path drops out), and the mean of ten calls by
CUDA events.  Each case makes one launch, of K9 or of K1 (the int8
tile's K-major pack of an operand is its input stage, not a K1 launch).
Beside them each side times the one PyTorch call that computes each
function it can (``torch.kron``, ``torch.einsum``, ``torch._int_mm`` on
the same storage), the same in both trees.  The table gives every run's
graph ms and the change over the two runs of each side.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

#: the child: build K9, then time each case (``sys.argv``: tree, mode)
CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.core import expr as E
from repro_torch.kernels import build, ops
t0 = time.time()
build.build(["semiring", "gemm"])
if sys.argv[2] == "build":
    print(json.dumps({"build_s": time.time() - t0}))
    sys.exit(0)
g = torch.Generator(device="cuda").manual_seed(31)
rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
m, n, kron = 8192, 2048, 64
a, b = rnd(m, m), rnd(m, m)
ka, kb = rnd(kron, kron), rnd(kron, kron)
ta, tb = rnd(n, n), rnd(n, n)
cube = rnd(64, m, 64)
lone = lambda op, ax, shape: E.reduce(op, E.arr("A", shape), ax)
mx02 = E.reduce("max", E.reduce("max", E.arr("A", (64, m, 64)), 2), 0)
c = 16
k3a, k3b = rnd(c, c, c), rnd(c, c, c)
kron6 = E.transpose(E.inner("add", "mul", E.arr("A", (c, c, c, 1)),
                            E.arr("B", (1, c, c, c))), (0, 3, 1, 4, 2, 5))
i8a = torch.randint(-100, 100, (m, m), generator=g, device="cuda",
                    dtype=torch.int8)
i8b = torch.randint(-100, 100, (m, m), generator=g, device="cuda",
                    dtype=torch.int8)
bf = torch.bfloat16
table = (rnd(256, 40, 128) * 256 ** -0.5).to(bf)
q, ctx = rnd(64, 1, 40, 96).to(bf), rnd(64, 1, 40, 256).to(bf)
qn, w_uk, w_uv = q[..., :64], table[..., :64], table[..., 64:]
f16 = torch.float16
table16 = table.to(f16)
q16, ctx16 = q.to(f16), ctx.to(f16)
qn16, w_uk16, w_uv16 = q16[..., :64], table16[..., :64], table16[..., 64:]
qn16_4 = rnd(4, 1, 40, 96).to(f16)[..., :64]
ie, i_n = 16, 1024
i8x = torch.randint(-128, 128, (ie, i_n, i_n), generator=g, device="cuda",
                    dtype=torch.int8)
i8wt = torch.randint(-128, 128, (ie, i_n, i_n), generator=g, device="cuda",
                     dtype=torch.int8)
stack_bt = E.inner("add", "mul", E.arr("X", (ie, i_n, i_n)),
                   E.transpose(E.arr("W", (ie, i_n, i_n)), (0, 2, 1)),
                   batch=1)
stack_b = E.inner("add", "mul", E.arr("X", (ie, i_n, i_n)),
                  E.arr("W", (ie, i_n, i_n)), batch=1)
n2, rag = 4096, (1001, 37, 999)
i8 = lambda *s: torch.randint(-128, 128, s, generator=g, device="cuda",
                              dtype=torch.int8)
a2, b2 = i8(n2, n2), i8(n2, n2)
ra, rb = i8(rag[0], rag[1]), i8(rag[1], rag[2])
i8table = i8(256, 40, 128)
i8q = {r: i8(r, 40, 64) for r in (1, 2, 4)}
i8ctx, i8w_uv = i8(4, 40, 256), i8(256, 40, 128)[..., 64:]
int32 = lambda expr, *a: (lambda: ops.apply(expr, *a, acc_dtype="int32",
                                            out_dtype=torch.int32))
f32 = torch.float32
cases = {
    "MAP kron (16,16,16) (x) (16,16,16)": lambda: ops.apply(
        kron6, k3a.reshape(c, c, c, 1), k3b.reshape(1, c, c, c)),
    "MAP int8 Hadamard 8192^2 acc int32": lambda: ops.apply(
        E.hadamard_expr(m, m), i8a, i8b, acc_dtype="int32",
        out_dtype=torch.int32),
    "HEAD q_lat m=64 (head_matmul)": lambda: ops.head_matmul(
        qn, w_uk, transpose_b=True, out_dtype=f32),
    "HEAD out m=64 (head_matmul)": lambda: ops.head_matmul(
        ctx, w_uv, out_dtype=f32),
    "HEAD float16 q_lat m=64 (head_matmul)": lambda: ops.head_matmul(
        qn16, w_uk16, transpose_b=True, out_dtype=f32),
    "HEAD float16 out m=64 (head_matmul)": lambda: ops.head_matmul(
        ctx16, w_uv16, out_dtype=f32),
    "HEAD float16 q_lat m=4 (head_matmul)": lambda: ops.head_matmul(
        qn16_4, w_uk16, transpose_b=True, out_dtype=f32),
    "INT8 stack e=16 1024^3 B transposed (apply, acc int32)":
        int32(stack_bt, i8x, i8wt),
    "INT8 stack e=16 1024^3 w stored (e, k, n) (apply, acc int32)":
        int32(stack_b, i8x, i8wt),
    "INT8 2-D 4096^3 B stored (k, n) (apply, acc int32)":
        int32(E.matmul_expr(n2, n2, n2), a2, b2),
    "INT8 2-D 4096^3 B stored (n, k) (apply, acc int32)":
        int32(E.matmul_expr(n2, n2, n2, transpose_b=True), a2, b2),
    "INT8 2-D ragged 1001x37x999 (apply, acc int32)":
        int32(E.matmul_expr(*rag), ra, rb),
    **{f"HEAD int8 q_lat m={r} (apply, acc int32)": int32(
        E.head_gemm_expr(40, r, 64, 256, transpose_b=True), q,
        i8table[..., :64]) for r, q in i8q.items()},
    "HEAD int8 out m=4 (apply, acc int32)": int32(
        E.head_gemm_expr(40, 4, 256, 64), i8ctx, i8w_uv),
    "MAP kron 64x64 (x) 64x64": lambda: ops.ipophp(ka, kb, "kp"),
    "MAP Hadamard 8192^2": lambda: ops.hadamard(a, b),
    "REDUCE lone min axis 0 8192^2":
        lambda: ops.apply(lone("min", 0, (m, m)), a),
    "REDUCE lone max axis 1 8192^2":
        lambda: ops.apply(lone("max", 1, (m, m)), a),
    "THREAD warp lone max axes (0, 2) of (64, 8192, 64)":
        lambda: ops.apply(mx02, cube),
    "TILE max-plus 2048^3":
        lambda: ops.semiring_matmul(ta, tb, plus="max", times="add"),
}


def events_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph):
            for _ in range(10):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = min(events_ms(graph.replay) for _ in range(3)) / 10
    del graph
    return ms


library = {
    "MAP kron (16,16,16) (x) (16,16,16)": lambda: torch.kron(k3a, k3b),
    "MAP kron 64x64 (x) 64x64": lambda: torch.kron(ka, kb),
    "HEAD q_lat m=64 (head_matmul)": lambda: torch.einsum(
        "bshk,nhk->bshn", qn, w_uk),
    "HEAD out m=64 (head_matmul)": lambda: torch.einsum(
        "bshk,khn->bshn", ctx, w_uv),
    "HEAD float16 q_lat m=64 (head_matmul)": lambda: torch.einsum(
        "bshk,nhk->bshn", qn16, w_uk16),
    "HEAD float16 out m=64 (head_matmul)": lambda: torch.einsum(
        "bshk,khn->bshn", ctx16, w_uv16),
    "HEAD float16 q_lat m=4 (head_matmul)": lambda: torch.einsum(
        "bshk,nhk->bshn", qn16_4, w_uk16),
    "INT8 2-D 4096^3 B stored (k, n) (apply, acc int32)":
        lambda: torch._int_mm(a2, b2),
    "INT8 2-D 4096^3 B stored (n, k) (apply, acc int32)":
        lambda: torch._int_mm(a2, b2.t()),
}
out = {}
for label, fn in cases.items():
    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] + ops.LAUNCHES["K1"] == 1, (
        label, dict(ops.LAUNCHES))
    kid = "K9" if ops.LAUNCHES["K9"] else "K1"
    out[label] = {"graph_ms": graph_ms(fn), "ms": events_ms(fn),
                  "kernel": kid}
    if label in library:
        out[label]["library_graph_ms"] = graph_ms(library[label])
        out[label]["library_ms"] = events_ms(library[label])
print(json.dumps(out))
"""


def _child(tree: Path, mode: str) -> dict:
    run = subprocess.run([sys.executable, "-c", CHILD, str(tree), mode],
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise SystemExit(f"{tree} ({mode}) failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree (e.g. the parent commit)")
    ap.add_argument("--out", help="also write the runs as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k9_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = {"A": Path(args.other).resolve(), "B": HERE}
    # both builds at once (one nvcc each), then A B B A
    procs = {k: subprocess.Popen([sys.executable, "-c", CHILD, str(t),
                                  "build"], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, t in trees.items()}
    for k, p in procs.items():
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            raise SystemExit(f"build of {trees[k]} failed:\n{err[-4000:]}")
        print(f"[k9_ab] {k} = {trees[k]}: K9 built in "
              f"{json.loads(out.strip().splitlines()[-1])['build_s']:.1f} s")
    runs = [(k, _child(trees[k], "time")) for k in "ABBA"]
    print(f"[k9_ab] {smi}; graph ms (device time) per run, order A B B A")
    for label in runs[0][1]:
        g = [r[label]["graph_ms"] for _, r in runs]
        a_mean, b_mean = (g[0] + g[3]) / 2, (g[1] + g[2]) / 2
        lib = [r[label].get("library_graph_ms") for _, r in runs]
        lib_ms = [r[label].get("library_ms") for _, r in runs]
        libs = "" if lib[0] is None else (
            f"; library graph ms {' / '.join(f'{x:.4f}' for x in lib)}, "
            f"events ms {' / '.join(f'{x:.4f}' for x in lib_ms)}")
        print(f"[k9_ab] {label}: A ({runs[0][1][label]['kernel']}) "
              f"{g[0]:.4f} / {g[3]:.4f}, B ({runs[1][1][label]['kernel']}) "
              f"{g[1]:.4f} / {g[2]:.4f}; B / A {b_mean / a_mean:.3f}; "
              f"events ms A {runs[0][1][label]['ms']:.4f} / "
              f"{runs[3][1][label]['ms']:.4f}, B "
              f"{runs[1][1][label]['ms']:.4f} / "
              f"{runs[2][1][label]['ms']:.4f}{libs}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "trees": {k: str(t) for k, t in
                                                trees.items()},
                       "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
