"""Time K9's MAP walk (``csrc/semiring.cu``'s ``k9_map``) on one card at
each span (runs a thread) and with and without streaming stores, on the
MAP rows of ``chip_smoke.py``'s ``[moa_path]`` / ``[derive_path]``, to
read the host's choice (``kernels/emit.py``: ``MAP_SPAN``, ``L2_BYTES``)
beside the alternatives.

    python scripts/k9_map_walk.py [--out FILE]

Each row's descriptor is the one ``ops.apply`` runs, with only its
``span`` and ``stream_out`` fields changed; each setting's device time
is ten calls captured in one CUDA graph and replayed (the best of three
replays), and every setting's output must equal the default's bit for
bit.  Settings are timed in turns (the default first and last).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def events_ms(torch, fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(torch, fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph):
            for _ in range(10):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = min(events_ms(torch, graph.replay) for _ in range(3)) / 10
    del graph
    return ms


def rows(torch, E, ops):
    """(label) -> (expr, operands, out dtype, acc dtype)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    c, m = 16, 8192
    i8 = lambda: torch.randint(-100, 100, (m, m), generator=g,
                               device="cuda", dtype=torch.int8)
    f32 = torch.float32
    return {
        "kron (16,16,16) (x) (16,16,16)": (
            E.transpose(E.inner("add", "mul", E.arr("A", (c, c, c, 1)),
                                E.arr("B", (1, c, c, c))),
                        (0, 3, 1, 4, 2, 5)),
            (rnd(c, c, c, 1), rnd(1, c, c, c)), f32, "float32"),
        "kron 64x64 (x) 64x64": (
            E.transpose(ops._outer_expr(64, 64, 64, 64), (0, 2, 1, 3)),
            (rnd(64, 64, 1), rnd(1, 64, 64)), f32, "float32"),
        "Hadamard 8192^2 f32": (E.hadamard_expr(m, m), (rnd(m, m),
                                                        rnd(m, m)),
                                f32, "float32"),
        "Hadamard 8192^2 int8 -> int32": (E.hadamard_expr(m, m),
                                          (i8(), i8()), torch.int32,
                                          "int32"),
        "Hadamard 2048^2 f32 (in the L2)": (
            E.hadamard_expr(2048, 2048), (rnd(2048, 2048),
                                          rnd(2048, 2048)), f32, "float32"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the table as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k9_map_walk: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import expr as E
    from repro_torch.kernels import emit, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[k9_map_walk] {smi}; graph ms (device time)")
    table = {}
    for label, (expr, arrays, out_dt, acc) in rows(torch, E, ops).items():
        nf = E.normal_form(expr)
        dts = tuple(str(a.dtype)[6:] for a in arrays)
        launch = ops._plan(nf, dts, out_dt, ops.H100, None, acc, True)[1]
        assert launch.mode == emit.MAP, label
        ptrs = [a.data_ptr() for a in arrays]
        descs = launch.c_descs(tuple(a.dtype for a in arrays), out_dt, ptrs)
        d = descs[0]
        default = (d.span, d.stream_out)
        call = lambda: ops.semiring_contract(launch, *arrays,
                                             out_dtype=out_dt)
        want = call()
        settings = [default] + [(s, c) for s in (1, 2, 4, 8)
                                for c in (0, 1) if (s, c) != default] + \
            [default]
        got = {}
        for span, stream in settings:
            d.span, d.stream_out = span, stream
            out = call()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (label, span, stream)
            got.setdefault(f"span {span} stream {stream}", []).append(
                graph_ms(torch, call))
        d.span, d.stream_out = default
        table[label] = {"default": f"span {default[0]} stream "
                                   f"{default[1]}", "graph_ms": got,
                        "narrow": d.narrow}
        print(f"[k9_map_walk] {label} (narrow {d.narrow}, default span "
              f"{default[0]} stream {default[1]}): " + "; ".join(
                  f"{k} {' / '.join(f'{v:.4f}' for v in vs)}"
                  for k, vs in got.items()), flush=True)
        del arrays, want
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
