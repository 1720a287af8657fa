"""Time K9's paths (``csrc/semiring.cu``) of two source trees on one card,
in the order A B B A, so that a change to the kernel is read beside the
build it changes and not across calls or hosts.

    python scripts/k9_ab.py OTHER_TREE [--out FILE]

``OTHER_TREE`` is a second checkout of the repository (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory);
this script's own tree is the other side.  Each side runs in a process of
its own (both packages are named ``repro_torch``), builds its K9 library
into its own ``build/``, and times each case through the user entry that
reaches it: device time as ten calls captured in one CUDA graph and
replayed (the host's launch path drops out), and the mean of ten calls by
CUDA events.  Only cases both trees take are timed.  The table gives
every run's graph ms and the change over the two runs of each side.
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
build.build(["semiring"])
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
cases = {
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


out = {}
for label, fn in cases.items():
    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K9"] == 1, (label, dict(ops.LAUNCHES))
    out[label] = {"graph_ms": graph_ms(fn), "ms": events_ms(fn)}
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
        print(f"[k9_ab] {label}: A {g[0]:.4f} / {g[3]:.4f}, B {g[1]:.4f} / "
              f"{g[2]:.4f}; B / A {b_mean / a_mean:.3f}; events ms A "
              f"{runs[0][1][label]['ms']:.4f} / {runs[3][1][label]['ms']:.4f}"
              f", B {runs[1][1][label]['ms']:.4f} / "
              f"{runs[2][1][label]['ms']:.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "trees": {k: str(t) for k, t in
                                                trees.items()},
                       "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
