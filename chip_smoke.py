#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

    python3 chip_smoke.py

Fourteen phases; any failure exits non-zero before the result line:

1. device   the card's name, power limit and compute capability (9, 0).
2. build    nvcc builds every kernel under src/repro_torch/kernels/csrc/
            into build/kernels/, all sources in parallel.
3. kernels  each kernel (K1 gemm with its VJP forms, K2 flash_fwd with
            and without its (m, l) export, K3/K4 flash_bwd, K5
            paged_decode, K6 ssd_scan with and without its per-chunk
            state export, K7 ssd_bwd, K8 gated_scan forward and reverse)
            against its plain PyTorch version on the same card inputs, at
            gemma-2b, mamba2-780m and recurrentgemma-9b full-width serving
            and training shapes (K2-K4 also at recurrentgemma-9b's window
            2048 over S=4096 with 16 query heads), with the tolerance
            stated; kernel, plain and library times (CUDA events) and the
            roofline bound of each case.  Each K1 row prints its route
            (ops.gemm_route), its device time in a CUDA graph (graph_ms)
            and the time of K1's first kernels on the same operands
            (old_ms); gemma-2b's six per-layer decode
            products at 4 rows and the decode step's K1 total; K5 also at
            gemma-2b's whole 8192-token context (4 slots); each K5 and K8
            row prints its split count or chunk length and its CUDA-graph
            time (graph_ms); K4, K5, K8 and the split-k decode rows are
            rerun and must give the same bits.  The rest of the dense
            family's shapes: K2-K4 at stablelm-1.6b's training attention
            (32 KV heads of 64, G = 1), K1 at its served and trained
            products, K2 at command-r-plus-104b's prefill (8 KV heads of
            128, G = 12), K5 there at 4 slots and at one, K1 at its decode
            products (d 12288, the tied 256000-row head), and K5 at one
            slot at gemma-2b's shape (ops.paged_decode).  K1's expert
            form at deepseek-moe-16b's expert GEMMs (E=64: wi and wo at
            decode, cap 8, on the gemv route; at an S=2048 prefill, cap
            240, on the tile route) and at a ragged stack (E=8, cap 24,
            d 200, f 136), each with torch.bmm's time, K9's on the same
            operands and a bit-identical rerun; K2 at its prefill (16 KV
            heads of 128, G = 1, S=2048).
4. path     gemma-2b at full width (18 layers, bf16, random weights from a
            seeded generator) served by ServeEngine(max_slots=4,
            max_len=512) over 6 requests; every kernel of the path must
            have launched, K5 once per layer per decode iteration; one
            prefill and one batched decode step are recomputed through the
            plain versions and must agree.  The same requests then go
            through ServeEngine(batched=False): one decode_step_paged a
            slot, K5 at one slot; derived launches, one per-slot step
            against the plain path, a 4-slot iteration under sync debug
            mode "error" against 4 slot-steps' weight bytes.
5. train    gemma-2b at full width (bf16, seeded weights) takes 3 AdamW
            steps of make_train_step on SyntheticLM batches (B=2, S=512,
            seed 0), remat on; step 1's loss and gradients are first held
            against the plain path; every kernel of the path must have
            launched its derived number of times; the third step runs
            under sync debug mode "error"; one step is profiled.
6. stablelm_path stablelm-1.6b at full width (24 layers, 32 heads of 64
            over 32 KV heads, LayerNorm and biases, rotary on a quarter of
            each head, bf16, 1.645 B seeded parameters) served by
            ServeEngine(max_slots=4, max_len=512) over 6 requests through
            contiguous per-slot caches (G = 1 is not paged-capable, as in
            the reference): derived K1 / K2 launches; prefill and
            contiguous decode logits against the plain path; a decode step
            under sync debug mode "error", timed against the bytes it must
            read, and a 4-slot iteration.
7. stablelm_train stablelm-1.6b takes 3 AdamW steps at B=2 S=2048 in its
            2 microbatches, remat on; step 1's loss and gradients against
            the plain path in f32 (the same weights) and in bf16; K1-K4
            launch their derived counts; step 3 under sync debug "error".
8. cmdr_path command-r-plus-104b at full width with its depth cut to 2 of
            64 layers (6.29 B parameters; the whole model does not fit
            one card): 4 requests through the batched paged ServeEngine
            (G = 12), then greedy_generate at B=1, 64 + 16 tokens; derived
            launches; prefill, contiguous and batched decode logits
            against the plain path.
9. ssm_path mamba2-780m at full width (48 layers, bf16, seeded weights)
            served by ServeEngine(max_slots=4, max_len=512) over 6
            requests, one prompt over 256 tokens (its prefill carries the
            state across a chunk boundary and pads its last chunk), the
            others a ragged chunk; K6 must launch 48 times per prompt and
            K1 its derived count; one prefill and one decode step agree
            with the plain path (in f32 on the same weights end to end;
            in bf16 layer by layer, and end to end beside the plain bf16
            path's own distance from f32); a decode iteration (4 slots)
            runs under sync debug mode "error".
10. ssm_train mamba2-780m at full width takes 3 AdamW steps (B=2, S=2048:
            8 chunks of 256 a sequence, remat on); step 1's loss and
            gradients against the plain path (as the prefill's, with
            each layer's VJP); K1, K6 (twice a layer: the
            remat rerun) and K7 launch their derived counts; step 3 under
            sync debug mode "error"; one step is profiled.
11. hybrid_path recurrentgemma-9b at full width and depth (38 layers,
            bf16, 9.40 B seeded parameters): make_prefill on B=1 S=4096
            (K8 26 launches, K2 12, K1 its derived count) and
            greedy_generate on B=2 prompts of 64 tokens plus 32 new,
            cache_len 128 (token-by-token ingestion as in the reference:
            K1 only); one prefill and one decode step agree with the plain
            path as mamba2's do (f32 end to end, bf16 layer by layer and
            beside the plain bf16 path's distance from f32); a decode step
            under sync debug mode "error"; prefill and decode profiled.
12. hybrid_train recurrentgemma-9b at full widths, depth cut to 5 layers
            (one (rglru, rglru, local) group and the 2-layer tail, 2.17 B
            parameters), 3 AdamW steps at B=4 S=4096 in 4 microbatches,
            remat on (the window cuts in K2-K4); step 1's loss and
            gradients against the plain path as mamba2's; K1-K4 and K8
            launch their derived counts; step 3 under sync debug mode
            "error"; one step is profiled.
13. moa_path the MoA expression pipeline (ops.apply -> normal form ->
            derived schedule on the H100 table -> K1 or K9) through its
            user entries: moa_gemm at 4096^3 (bf16, f32; K1), max-plus and
            min-plus at 4096^3, 8192^3, ragged 4000x3000x5000 and bf16
            4096^3 (K9, bit for bit against the plain version), and
            through apply (K9): (add, add) 2048^3, a batched (mul, add)
            e=16 1024^3, the chains A@B@C ((mul, add) and max-plus) over
            512^4 points (contracted pairwise), Hadamard 8192^2, the lone
            max along rows, min along columns and sum along columns of
            8192^2, the lone max over the last two axes of (4096, 64, 64),
            max-plus with a col-layout B and with a psi-view A
            (the profiler must list K9 alone: no operand copy), max-plus
            2048^3 on strided views (a column slice of a wider A and a
            transposed B, which apply copies first), and
            examples/kron_compress.py at 64x64 (x) 64x64 (kron on K9, the
            compressed apply on two K1 products, |Wx - vec(B X A^T)| <=
            1e-3).  K1 and K9 launch their derived counts; one apply runs
            under sync debug mode "error"; each case prints kernel, plain
            and library ms (CUDA events), the bound and the error.
14. moe_path deepseek-moe-16b at full width and depth (28 layers: one
            dense, 27 with 64 routed experts top-6 and 2 shared, bf16,
            16.38 B seeded parameters): make_prefill B=1 S=2048 (K1 250
            launches, 54 of them the expert form, K2 28) timed by events
            against its bound, rerun bit for bit, its routings against the
            plain path's counted; every layer against its plain version on
            the same input (attention and K/V; the MoE FFN with the
            routing held to the plain router's, at the prefill's 2048
            tokens and at 2 decode rows; the router logits; the routings
            that differ counted); greedy_generate B=2, 64 prompt tokens
            ingested one by one + 16 new (K1 250 a step); a decode step
            under sync debug mode "error", timed against every weight byte
            and against the active parameters' bytes; profiles.

Each path phase resets the peak memory statistics before it runs.  The
last two lines before the final one are the kernels' JSON record and
the card's ``nvidia-smi`` name and power limit; the final line is
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: each kernel case passes when max|kernel - plain| <= tol * max|plain|.
#: f32: both sides accumulate in f32 and differ only in summation order.
#: bf16: K1's products are exact in f32 on both sides (order only); K2 and
#: K5 cast p to bf16 relative to the running max (kernel) or the final max
#: (plain), a relative difference up to 2^-8 per probability, and K2 also
#: rounds its output to bf16.
#: K3/K4 bf16: the same p difference through dS, and outputs rounded to
#: bf16 (2^-8); K4 also sums the G heads in another order.
#: K6/K7 (f32 only, by the reference's contract): summation order and the
#: kernels' split products (each f32 operand as bf16 hi + lo, 2^-16 of it
#: dropped; ~1e-5 of max|plain| measured, test_torch_ssd_design.py).
#: K8 (f32 only): the plain walk's steps, the multiply and the add rounded
#: separately on both sides; exp() may differ in a bit, and each chunk's
#: entering state is folded from the chunks' aggregates rather than walked
#: step by step, a last-bit difference that the gates decay.
TOL = {("K1", "bfloat16"): 1e-4, ("K1", "float32"): 1e-4,
       ("K2", "bfloat16"): 2e-2, ("K2", "float32"): 1e-4,
       ("K3", "bfloat16"): 2e-2, ("K3", "float32"): 1e-4,
       ("K4", "bfloat16"): 2e-2, ("K4", "float32"): 1e-4,
       ("K5", "bfloat16"): 2e-2, ("K5", "float32"): 1e-4,
       ("K6", "float32"): 1e-4, ("K7", "float32"): 1e-4,
       ("K8", "float32"): 1e-6}
#: the served path's logits (kernels vs plain versions, 18 bf16 layers):
#: per-layer bf16 rounding differences compound through the residual stream
PATH_TOL = 5e-2
#: the training step's loss and each gradient leaf (kernels vs plain
#: versions, 18 bf16 layers forward and back): bf16 rounding of the
#: activations and of every gradient, at other places in the two paths
#: (e.g. p in V's dtype in K2 only), compounds through the layers; the
#: loss is a mean over 1024 tokens and moves far less.
LOSS_TOL = 5e-3          # |loss_k - loss_p| / |loss_p|
GRAD_TOL = 5e-2          # ||g_k - g_p|| / ||g_p|| per leaf
#: mamba2-780m against the plain path, on the 300-token prompt (prefill
#: and decode logits, state, conv tail) and on the B=2 S=2048 batch (loss,
#: gradients).  f32 (the served model's bf16 weights, exact in float32:
#: K1's f32 path and K6/K7's split products): summation order and the
#: split's 2^-16 differ, so the
#: whole 48-layer path is held tightly: SSM_F32_TOL x max|plain|, and the
#: loss and every gradient leaf as gemma's.
SSM_F32_TOL = 5e-3
#: bf16 (the served model), layer by layer: each layer is fed the plain
#: path's input on both sides, so nothing compounds.  K1's sums differ
#: from the plain product's by ~1e-5 relative (its kernel cases), which
#: flips a bf16 rounding (2^-8) here and there: each layer's output, state,
#: conv tail and decode step agree within SSM_LAYER_TOL x max|plain| (5
#: bf16 ulps at the max; 6.9e-3 at worst on an H100 80GB HBM3), and each
#: leaf of its VJP within SSM_LAYER_GRAD_TOL in relative norm (3.3e-3 at
#: worst there).
SSM_LAYER_TOL = 2e-2
SSM_LAYER_GRAD_TOL = 1e-2
#: bf16, end to end: each rounding flip grows through 48 random-weight
#: layers, and the plain bf16 path itself sits 0.33 of the largest logit
#: and 0.12-0.65 in gradient norm from the f32 function of the same weights
#: (H100 80GB HBM3).  That plain path is the witness: the kernels' bf16
#: logits, state, conv tail and gradients must sit no farther from the f32
#: function than SSM_BF16_RATIO x its distance (0.81-1.10 measured there).
SSM_BF16_RATIO = 1.25
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 512, 3
#: mamba2-780m's training shape: the context Mamba-2 was trained at
#: (arXiv:2405.21060), 8 chunks of 256 a sequence
SSM_B, SSM_S = 2, 2048
#: recurrentgemma-9b: the prefill and training sequence (twice the 2048
#: window, so the window cuts), the training batch in 4 microbatches, the
#: depth the training state fits one card at (5 of 38 layers: one group
#: and the tail), and greedy_generate's batch, prompt, new tokens and cache
HYB_S, HYB_B, HYB_MB, HYB_TRAIN_LAYERS = 4096, 4, 4, 5
GEN_B, GEN_PROMPT, GEN_NEW, GEN_CACHE = 2, 64, 32, 128
#: the prompt tokens ingested (plain f32) into the decode cache that the
#: decode-step agreement starts from
HYB_DECODE_CTX = 16
#: stablelm-1.6b's training batch (2 sequences of 2048, its 2 microbatches)
STABLELM_B, STABLELM_S = 2, 2048
#: command-r-plus-104b's depth on one card (2 of its 64 layers: 6.29 B
#: parameters, 12.6 GB in bf16; the whole model is ~208 GB) and its
#: greedy_generate prompt, new tokens and cache length
CMDR_LAYERS = 2
CMDR_PROMPT, CMDR_NEW, CMDR_CACHE = 64, 16, 128
#: deepseek-moe-16b: the prefill sequence, and greedy_generate's batch,
#: prompt, new tokens and cache length
MOE_S = 2048
MOE_GEN_B, MOE_PROMPT, MOE_NEW, MOE_CACHE = 2, 64, 16, 128
#: deepseek-moe-16b's expert GEMMs (E=64, d 2048, f 1408: wi to 2f, wo
#: back) at decode (2 tokens: cap 8) and at the S=2048 prefill (cap 240),
#: and a ragged stack whose k, row and column edges fall inside tiles
MOE_EXPERT_CASES = (("decode wi", 64, 8, 2048, 2816),
                    ("decode wo", 64, 8, 1408, 2048),
                    ("prefill wi", 64, 240, 2048, 2816),
                    ("prefill wo", 64, 240, 1408, 2048),
                    ("ragged", 8, 24, 200, 136))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` warm calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    t_ops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100.hbm.bandwidth_Bps * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {smi_line} | capability {cap} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    require(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")
    return smi_line


def phase_build():
    from repro_torch.kernels import build
    secs, reports = build.build_all()
    print(f"[build] {len(build.sources())} kernels ready in {secs:.1f} s "
          f"(built now: {sorted(reports)})", flush=True)
    for name, text in sorted(reports.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _parts(x):
    return x if isinstance(x, tuple) else (x,)


def _case(torch, rec, name, dtype, tol_key, kern, plain, library, flops,
          nbytes, shape, extra=None, bnd=None):
    """Hold ``kern`` against ``plain`` (each returns a tensor or a tuple
    of tensors, each part held to the tolerance relative to its own
    largest plain entry), time kernel, plain and library calls, and
    record the case under ``rec[name][shape]``.  ``extra`` (K1's route,
    the first kernel's time, ...) is printed after the shape and
    recorded; ``bnd`` a ``(ms, by)`` bound given by the caller instead of
    ``bound(flops, nbytes, dtype)``."""
    out = _parts(kern())
    torch.cuda.synchronize()
    ref = _parts(plain())
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(o.float()).all()) for o in out),
            f"{shape}: non-finite")
    errs = [(o.float() - r.float()).abs().max().item()
            for o, r in zip(out, ref)]
    scales = [r.float().abs().max().item() for r in ref]
    del out, ref
    err = max(errs)
    rel = max(e / sc for e, sc in zip(errs, scales))
    tol = TOL[tol_key]
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    lib_ms = time_ms(torch, library) if library is not None else None
    b_ms, b_by = bnd if bnd is not None else bound(flops, nbytes, dtype)
    ok = all(e <= tol * sc for e, sc in zip(errs, scales))
    note = "".join(f" {k}={v:.4f}" if isinstance(v, float) else f" {k}={v}"
                   for k, v in (extra or {}).items())
    print(f"[kernels] {shape}{note}: max_abs_err={err:.3e} max_rel_err="
          f"{rel:.3e} (tol {tol:g} x max|plain|) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"{shape}: kernel disagrees with its plain version")
    rec.setdefault(name, {})[shape] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)
    rec[name][shape].update(extra or {})


def _route(ops, a, b, ta, tb) -> str:
    """K1's route for ``op(a) @ op(b)`` (``ops.gemm_route``), with the
    decode path's split of k."""
    route = ops._route(a, b, ta, tb)
    if route == "gemv":
        m = a.shape[0]
        n = b.shape[0] if tb else b.shape[1]
        return f"gemv split-k={ops.gemv_splits(m, n, a.shape[1])}"
    return route


def graph_ms(torch, fn) -> float:
    """``fn``'s device time: ten calls captured in one CUDA graph and
    replayed (``time_ms`` of a replay / 10), so the host's Python and
    launch path drop out of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph):
            for _ in range(10):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = time_ms(torch, graph.replay) / 10
    del graph
    return ms


def _k1_extra(torch, ops, a, b, ta, tb, old=True, call=None) -> dict:
    """K1's route; (``old``) the time of its first kernels on the same
    operands (``gemm_bf16`` / ``gemm_fma``, PRs 11-12, kept for the shapes
    TMA cannot read): the same call's before-and-after on this card; and
    (``call``, the timed entry) its device time in a CUDA graph."""
    extra = {"path": _route(ops, a, b, ta, tb)}
    if call is not None:
        extra["graph_ms"] = graph_ms(torch, call)
    if old:
        k, m = a.shape if ta else a.shape[::-1]
        n = b.shape[0] if tb else b.shape[1]
        out = torch.empty((m, n), device=a.device, dtype=torch.float32)
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(ta),
                int(tb), ops._DTYPE_CODE[a.dtype], ops._DTYPE_CODE[b.dtype],
                int(ops._aligned16(a, m if ta else k)),
                int(ops._aligned16(b, k if tb else n)))
        extra["old_ms"] = time_ms(torch, lambda: ops._launch("repro_gemm",
                                                             *args))
        del out
    return extra


def _rerun_equal(torch, fn, what: str) -> None:
    """Two runs of ``fn`` give the same bits (no atomics in its sums)."""
    first, again = _parts(fn()), _parts(fn())
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            f"{what}: reruns differ (its partial sums must be summed in a "
            f"fixed order)")
    print(f"[kernels] {what}: rerun bit-identical", flush=True)


#: gemma-2b's per-layer products at decode (the 4 slots' rows): q, k, v,
#: o, the fused GeGLU input (2 x 16384) and the MLP output
GEMMA_DECODE = (("wq", 2048, 2048), ("wk", 2048, 256), ("wv", 2048, 256),
                ("wo", 2048, 2048), ("wi", 2048, 32768),
                ("wo_mlp", 16384, 2048))


def _gemm_decode_cases(torch, rec, gen):
    """K1 at gemma-2b's six per-layer decode products (m = 4 slots, bf16,
    weights (k, n)), each held to its plain version, split over k where
    the columns do not fill the card (a rerun is the same bits); then the
    decode step's K1 total, 18 layers of the six and the tied head."""
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    total = bound_total = 0.0
    for name, k, n in GEMMA_DECODE:
        x = torch.randn(4, k, generator=gen, device="cuda").to(bf)
        w = (torch.randn(k, n, generator=gen, device="cuda")
             * k ** -0.5).to(bf)
        shape = f"K1 bfloat16 decode {name} m=4 k={k} n={n}"
        call = lambda: ops.matmul(x, w, out_dtype=torch.float32)
        _case(torch, rec, "K1", "bfloat16", ("K1", "bfloat16"), call,
              lambda: ref.matmul(x, w), lambda: torch.matmul(x, w),
              2.0 * 4 * n * k, (4 * k + n * k) * 2 + 4 * n * 4, shape,
              _k1_extra(torch, ops, x, w, False, False, call=call))
        if ops.gemv_splits(4, n, k) > 1:
            _rerun_equal(torch, lambda: ops.matmul(
                x, w, out_dtype=torch.float32), f"K1 split-k {name}")
        total += 18 * rec["K1"][shape]["ms"]
        bound_total += 18 * rec["K1"][shape]["bound_ms"]
        del x, w
    head = rec["K1"]["K1 bfloat16 m=4 k=2048 n=256000 tb=1"]
    print(f"[kernels] K1 gemma-2b decode step: 18 x 6 layer products + the "
          f"head = {total + head['ms']:.4f} ms (bound "
          f"{bound_total + head['bound_ms']:.4f} ms, bytes)", flush=True)


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"
    rec = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).removeprefix("torch.")
        es = torch.tensor([], dtype=dt).element_size()
        randn = lambda *s, sc=1.0: (torch.randn(
            *s, generator=gen, device=dev) * sc).to(dt)
        # K1: the projections, the MLP and the tied head, at prefill (128)
        # and decode (4 slots) row counts
        for m in (128, 4):
            for k, n, tb in ((2048, 2048, False), (2048, 32768, False),
                             (16384, 2048, False), (2048, 256000, True)):
                x = randn(m, k)
                w = randn(n, k, sc=k ** -0.5) if tb else randn(k, n,
                                                               sc=k ** -0.5)
                wl = w.t() if tb else w
                _case(torch, rec, "K1", dname, ("K1", dname),
                      lambda: ops.matmul(x, w, transpose_b=tb,
                                         out_dtype=torch.float32),
                      lambda: ref.matmul(x, w, tb),
                      lambda: torch.matmul(x, wl),
                      2.0 * m * n * k, (m * k + n * k) * es + m * n * 4,
                      f"K1 {dname} m={m} k={k} n={n} tb={int(tb)}",
                      _k1_extra(torch, ops, x, w, False, tb,
                                old=dt != torch.float32,
                                call=lambda: ops.matmul(
                                    x, w, transpose_b=tb,
                                    out_dtype=torch.float32)))
        # K2: causal prefill attention, one KV head under 8 query heads
        for s in (128, 512):
            q = randn(1, s, 1, 8, 256)
            kk, vv = randn(1, s, 1, 256), randn(1, s, 1, 256)
            qs = q.reshape(1, s, 8, 256).transpose(1, 2)
            ks, vs = kk.transpose(1, 2), vv.transpose(1, 2)
            pairs = s * (s + 1) // 2
            _case(torch, rec, "K2", dname, ("K2", dname),
                  lambda: ops.attention(q, kk, vv, scale=256 ** -0.5),
                  lambda: ref.attention(q, kk, vv, scale=256 ** -0.5),
                  lambda: F.scaled_dot_product_attention(
                      qs, ks, vs, is_causal=True, enable_gqa=True),
                  4.0 * pairs * 8 * 256, (8 * s + 2 * s + 8 * s) * 256 * es,
                  f"K2 {dname} B=1 S={s} KV=1 G=8 hd=256 causal")
        _attention_training_cases(torch, rec, gen, dt, dname, es)
        # K5: 4 slots, ragged positions, one dead slot, page 16, scrambled
        # slabs of a pool sized for max_len 512
        _decode_case(torch, rec, gen, dt, [200, 37, -1, 511], 4 * 32)
    # K5 at gemma-2b's whole context: 4 slots at position 8191
    _decode_case(torch, rec, gen, torch.bfloat16, [8191] * 4, 4 * 512)
    _gemm_decode_cases(torch, rec, gen)
    _gemm_training_cases(torch, rec, gen)
    _ssm_gemm_cases(torch, rec, gen)
    _ssd_cases(torch, rec, gen)
    # recurrentgemma-9b's local layers: window 2048 over S=4096, 16 query
    # heads over one KV head
    _attention_training_cases(torch, rec, gen, torch.bfloat16, "bfloat16",
                              2, b=1, s=HYB_S, g=16, window=2048)
    _gated_cases(torch, rec, gen)
    _dense_family_cases(torch, rec, gen)
    _expert_cases(torch, rec, gen)
    _prefill_attention_case(torch, rec, gen, torch.bfloat16, MOE_S, kv=16,
                            g=1, hd=128)
    return rec


def _expert_cases(torch, rec, gen):
    """K1's expert form (``ops.expert_gemm``, bf16, f32 out) at
    ``MOE_EXPERT_CASES``, each held to ``ref.expert_gemm``, with its route,
    its CUDA-graph time, ``torch.bmm``'s time (the library row, bf16 out),
    K9's time and error on the same operands (its batched TILE, the route
    ``apply`` took before), and a rerun that must give the same bits."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    for name, e, cap, d, f in MOE_EXPERT_CASES:
        x = torch.randn(e, cap, d, generator=gen, device="cuda").to(bf)
        w = (torch.randn(e, d, f, generator=gen, device="cuda")
             * d ** -0.5).to(bf)
        call = lambda: ops.expert_gemm(x, w, out_dtype=torch.float32)
        k9 = ops._plan(E.normal_form(E.expert_gemm_expr(e, cap, d, f)),
                       ("bfloat16",) * 2, torch.float32, ops.H100, None,
                       "float32", False)[1]
        k9_call = lambda: ops.semiring_contract(k9, x, w,
                                                out_dtype=torch.float32)
        k9_err = (k9_call() - ref.expert_gemm(x, w)).abs().max().item()
        extra = {"path": ops.expert_route(e, cap, d, f, bf, bf),
                 "graph_ms": graph_ms(torch, call),
                 "k9_ms": time_ms(torch, k9_call), "k9_err": f"{k9_err:.3e}"}
        _case(torch, rec, "K1", "bfloat16", ("K1", "bfloat16"), call,
              lambda: ref.expert_gemm(x, w), lambda: torch.bmm(x, w),
              2.0 * e * cap * d * f, (e * cap * d + e * d * f) * 2
              + e * cap * f * 4,
              f"K1 bfloat16 expert {name} E={e} cap={cap} d={d} f={f}",
              extra)
        _rerun_equal(torch, call, f"K1 expert {name}")
        del x, w


def _dense_family_cases(torch, rec, gen):
    """The rest of the dense family's kernel shapes.  stablelm-1.6b: K2-K4
    at its training attention (32 KV heads of 64, G = 1, one microbatch
    B=1 S=2048; bf16 and f32), K1 at its served and trained products.
    command-r-plus-104b: K2 at a 512-token prefill (8 KV heads of 128, G =
    12), K5 at 4 slots and at one, K1 at its decode products (d 12288).
    gemma-2b: K5 at one slot (ServeEngine(batched=False))."""
    bf = torch.bfloat16
    mb = STABLELM_B // 2
    for dt in (bf, torch.float32):
        dname = str(dt).removeprefix("torch.")
        _attention_training_cases(torch, rec, gen, dt, dname,
                                  torch.tensor([], dtype=dt).element_size(),
                                  b=mb, s=STABLELM_S, g=1, kv=32, hd=64)
    proj, wi, wo, head = (2048, 2048), (2048, 11264), (5632, 2048), \
        (2048, 100352)
    _gemm_forms(torch, rec, gen, "K1 stablelm serve",
                [("fwd", (m, k), bf, (k, n), bf, False, False)
                 for m in (1, 128) for k, n in (proj, wi, wo, head)])
    _gemm_training_cases(torch, rec, gen, "stablelm ", mb * STABLELM_S,
                         (proj, wi, wo, head), None)
    _prefill_attention_case(torch, rec, gen, bf, 512, kv=8, g=12, hd=128)
    _decode_case(torch, rec, gen, bf, [200, 37, -1, 511], 4 * 32, kv=8,
                 g=12, hd=128)
    _decode_case(torch, rec, gen, bf, [200], 32, kv=8, g=12, hd=128)
    _decode_case(torch, rec, gen, bf, [300], 32)
    d = 12288
    forms = [("fwd", (m, k), bf, (k, n), bf, False, False)
             for m in (1, 4) for k, n in ((d, d), (d, 1024), (d, 67584),
                                          (33792, d))]
    forms += [("fwd head", (m, d), bf, (256000, d), bf, False, True)
              for m in (1, 4)]
    _gemm_forms(torch, rec, gen, "K1 command-r serve", forms)


def _prefill_attention_case(torch, rec, gen, dt, s, kv, g, hd, b=1):
    """K2 without its export (the prefill's form), causal, at ``kv`` KV
    heads of ``hd`` under ``g`` query heads each, against SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dname = str(dt).removeprefix("torch.")
    es = torch.tensor([], dtype=dt).element_size()
    randn = lambda *shape: torch.randn(*shape, generator=gen,
                                       device="cuda").to(dt)
    q, k, v = randn(b, s, kv, g, hd), randn(b, s, kv, hd), randn(b, s, kv,
                                                                 hd)
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    args = dict(scale=hd ** -0.5)
    _case(torch, rec, "K2", dname, ("K2", dname),
          lambda: ops.attention(q, k, v, **args),
          lambda: ref.attention(q, k, v, **args),
          lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True),
          4.0 * b * kv * g * _pairs(s) * hd,
          (b * s * g * 2 + 2 * b * s) * kv * hd * es,
          f"K2 {dname} B={b} S={s} KV={kv} G={g} hd={hd} causal")


def _decode_case(torch, rec, gen, dt, positions, pool_pages, page=16, kv=1,
                 g=8, hd=256):
    """K5 over one slot a position of ``positions`` (-1: dead), scrambled
    slabs of a pool of ``pool_pages``, ``kv`` KV heads of ``hd`` under
    ``g`` query heads each (gemma-2b's 1, 8, 256 by default): its split
    count, its time in a CUDA graph, and a rerun.  One slot goes through
    the single-sequence entry ``ops.paged_decode``."""
    from repro_torch.kernels import ops, ref
    dname = str(dt).removeprefix("torch.")
    es = torch.tensor([], dtype=dt).element_size()
    slots = len(positions)
    perm = torch.randperm(pool_pages, generator=gen, device="cuda")
    width = max(p // page + 1 for p in positions)
    tables = torch.zeros((slots, width), dtype=torch.int32, device="cuda")
    used = 0
    for i, p in enumerate(positions):
        n_pg = p // page + 1 if p >= 0 else 0
        tables[i, :n_pg] = perm[used:used + n_pg].int()
        used += n_pg
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    q = randn(slots, kv, g, hd)
    kp, vp = randn(pool_pages * page, kv, hd), randn(pool_pages * page, kv,
                                                     hd)
    live_keys = sum(p + 1 for p in positions if p >= 0)
    args = dict(page=page, scale=hd ** -0.5)
    plain = lambda: ref.paged_decode_batched(q, kp, vp, pos, tables, **args)
    if slots == 1:
        call = lambda: ops.paged_decode(q[0], kp, vp, pos, tables[0], **args)
        plain_one = plain
        plain = lambda: plain_one()[0]
    else:
        call = lambda: ops.paged_decode_batched(q, kp, vp, pos, tables,
                                                **args)
        out = call()
        require(all(bool((out[i] == 0).all())
                    for i, p in enumerate(positions) if p < 0),
                "K5 dead slot row is not zero")
    heads = "" if kv == 1 else f" KV={kv}"
    shape = (f"K5 {dname} slots={slots} pos={positions} page={page}{heads} "
             f"G={g} hd={hd}")
    extra = {"splits": ops.decode_splits(slots, kv, width),
             "graph_ms": graph_ms(torch, call)}
    _case(torch, rec, "K5", dname, ("K5", dname), call, plain,
          None, 4.0 * live_keys * kv * g * hd,
          live_keys * kv * 2 * hd * es + slots * kv * g * hd * (es + 4)
          + slots * 4 + tables.numel() * 4, shape, extra)
    _rerun_equal(torch, call, shape)


def ssd_work(b, s, h, p, n, q):
    """``(flops, f32 elements of the chunk-shaped operands)`` of one SSD
    scan that this data needs: per chunk of ``m <= q`` real tokens the
    causal half of the scores (``m (m + 1) n``, once for all heads) and
    of P.X, the readout and the state update per head.  Returns the
    forward's and the reverse scan's flops: the latter replays the scores
    and the readout and adds dP, P'dY, dG.B, dG'.C and four (q, p, n)
    products a head."""
    fwd = bwd = 0.0
    for c0 in range(0, s, q):
        m = min(q, s - c0)
        pairs = m * (m + 1) / 2
        fwd += b * (2 * pairs * n + h * (2 * pairs * p + 4 * m * p * n))
        bwd += b * (3 * 2 * pairs * n + h * (2 * 2 * pairs * p
                                             + 5 * 2 * m * p * n))
    return fwd, bwd


def _ssd_bounds(torch, flops, nbytes, call):
    """K6 / K7's bound and extras: the design's work is three bf16
    tensor-core products a f32 product (``ops.SSD_SPLIT_PARTS`` = 2 parts
    an operand), bound at the bf16 peak or by the bytes; beside it the f32
    FMA bound of the exact products, and the call's device time in a CUDA
    graph."""
    bnd = bound(3 * flops, nbytes, "bfloat16")
    return bnd, {"fma_bound_ms": bound(flops, nbytes, "float32")[0],
                 "graph_ms": graph_ms(torch, call)}


def _ssd_cases(torch, rec, gen):
    """K6 (with and without its h_in export) and K7 at mamba2-780m's
    shapes (48 heads of 64, state 128): the training step's B=2 S=2048
    q=256, a prefill of 175 tokens (q = 175, one ragged chunk) and one of
    300 (q = 256, a padded second chunk, through the ops-level pad/slice
    of ``ops.scan_ssd`` on both sides); and the training shape again with
    a state of 64, another state width.  No single PyTorch call computes
    the SSD scan, so neither has a library time; reruns of K6 and K7 give
    the same bits."""
    from repro_torch.kernels import ops, ref
    h, p = 48, 64
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for b, s, q, n in ((SSM_B, SSM_S, 256, 128), (1, 175, 175, 128),
                       (1, 300, 256, 128), (SSM_B, SSM_S, 256, 64)):
        x, B, C = randn(b, s, h, p), randn(b, s, n), randn(b, s, n)
        dA, h0 = -0.3 * randn(b, s, h).abs(), 0.1 * randn(b, h, p, n)
        nc = -(-s // q)
        fwd, bwd = ssd_work(b, s, h, p, n, q)
        io = 4 * (2 * b * s * n + 2 * b * s * h * p + b * s * h
                  + 2 * b * h * p * n)
        if s % q:
            call = lambda: ops.scan_ssd(x, dA, B, C, init_state=h0, chunk=q)
            bnd, extra = _ssd_bounds(torch, fwd, io, call)
            _case(torch, rec, "K6", "float32", ("K6", "float32"), call,
                  lambda: _plain(ops, ops.scan_ssd, x, dA, B, C,
                                 init_state=h0, chunk=q),
                  None, fwd, io,
                  f"K6 float32 B={b} S={s} (padded) q={q} h={h} p={p} n={n}",
                  extra, bnd)
            continue
        for export in (False, True):
            call = lambda: ops.ssd_scan_chunked(x, dA, B, C, h0, q,
                                                export)[:2 + export]
            nbytes = io + export * 4 * b * nc * h * p * n
            bnd, extra = _ssd_bounds(torch, fwd, nbytes, call)
            _case(torch, rec, "K6", "float32", ("K6", "float32"), call,
                  lambda: ref.ssd_scan(x, dA, B, C, h0, q,
                                       export)[:2 + export],
                  None, fwd, nbytes,
                  f"K6 float32 B={b} S={s} q={q} h={h} p={p} n={n}"
                  + (" export" if export else ""), extra, bnd)
        if b == SSM_B:
            _rerun_equal(torch, lambda: ops.ssd_scan_chunked(
                x, dA, B, C, h0, q, True), f"K6 n={n}")
            _, _, h_in = ops.ssd_scan_chunked(x, dA, B, C, h0, q, True)
            dy, dhf = randn(b, s, h, p), randn(b, h, p, n)
            args = (C, B, dy, x, dA, h_in, dhf)
            call = lambda: ops.ssd_bwd_chunked(*args)
            nbytes = 4 * (4 * b * s * n + 3 * b * s * h * p + 2 * b * s * h
                          + 2 * b * h * p * n + b * nc * h * p * n)
            bnd, extra = _ssd_bounds(torch, bwd, nbytes, call)
            _case(torch, rec, "K7", "float32", ("K7", "float32"), call,
                  lambda: ref.ssd_bwd(*args), None, bwd, nbytes,
                  f"K7 float32 B={b} S={s} q={q} h={h} p={p} n={n}", extra,
                  bnd)
            _rerun_equal(torch, call, f"K7 n={n} (its head sums)")
            del h_in, dy, dhf, args
        del x, B, C, dA, h0


def _plain(ops, fn, *args, **kw):
    with ops.reference_mode():
        return fn(*args, **kw)


def _pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal (windowed) mask keeps over ``s``
    positions."""
    w = min(window, s) if window else s
    return w * (w + 1) // 2 + (s - w) * w


def _attention_training_cases(torch, rec, gen, dt, dname, es, b=TRAIN_B,
                              s=TRAIN_S, g=8, window=0, kv=1, hd=256):
    """K2 with its (m, l) export, then K3 and K4, at a training shape (by
    default gemma-2b's: q (2, 512, 1, 8, 256), k/v (2, 512, 1, 256),
    m/l/delta (2, 1, 8, 512)); with a ``window``, K2 without the export
    too (the prefill's form).  The library yardstick of K3 and K4 is one
    pair: the backward alone of SDPA (enable_gqa, the window as a boolean
    mask) through torch.autograd.grad."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    scale = hd ** -0.5
    randn = lambda *shape: torch.randn(*shape, generator=gen,
                                       device="cuda").to(dt)
    q, k, v, do = (randn(b, s, kv, g, hd), randn(b, s, kv, hd),
                   randn(b, s, kv, hd), randn(b, s, kv, g, hd))
    pairs = b * kv * g * _pairs(s, window)
    qkv_bytes = (2 * b * s * g + 2 * b * s) * kv * hd * es
    stat_bytes = b * kv * g * s * 4
    args = dict(scale=scale, causal=True, window=window)
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = ref._mask(s, s, True, window, "cuda") if window else None
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
    tag = f"window={window}" if window else "causal"
    shape = f"B={b} S={s} KV={kv} G={g} hd={hd} {tag}"
    if window:
        _case(torch, rec, "K2", dname, ("K2", dname),
              lambda: ops.attention(q, k, v, **args),
              lambda: ref.attention(q, k, v, **args),
              lambda: sdpa(qs, ks, vs), 4.0 * pairs * hd,
              (b * s * g * 2 + 2 * b * s) * kv * hd * es,
              f"K2 {dname} {shape}")
    _case(torch, rec, "K2", dname, ("K2", dname),
          lambda: ops.attention_stats(q, k, v, **args),
          lambda: ref.attention_stats(q, k, v, **args),
          lambda: sdpa(qs, ks, vs),
          4.0 * pairs * hd, (b * s * g * 2 + 2 * b * s) * kv * hd * es
          + 2 * stat_bytes, f"K2 {dname} {shape} export")
    out, m, l = ops.attention_stats(q, k, v, **args)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    bwd = (q, k, v, do, m, l, delta)
    qg = qs.detach().requires_grad_(True)
    kg = ks.detach().requires_grad_(True)
    vg = vs.detach().requires_grad_(True)
    og = sdpa(qg, kg, vg)
    dos = do.reshape(b, s, kv * g, hd).transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), dos,
                                           retain_graph=True)
    _case(torch, rec, "K3", dname, ("K3", dname),
          lambda: ops.flash_dq(*bwd, **args),
          lambda: ref.flash_dq(*bwd, **args), sdpa_bwd,
          2.0 * 3 * pairs * hd, qkv_bytes + 3 * stat_bytes
          + b * s * kv * g * hd * es, f"K3 {dname} {shape}")
    nsplit = ops.dkv_splits(b, s, s, kv, g, True, window)
    _case(torch, rec, "K4", dname, ("K4", dname),
          lambda: ops.flash_dkv(*bwd, **args),
          lambda: ref.flash_dkv(*bwd, **args), sdpa_bwd,
          2.0 * 4 * pairs * hd, qkv_bytes + 3 * stat_bytes
          + 2 * b * s * kv * hd * es, f"K4 {dname} {shape}",
          {"path": "tc" if dt == torch.bfloat16 else "fma",
           "row_splits": nsplit if dt == torch.bfloat16 else 1})
    _rerun_equal(torch, lambda: ops.flash_dkv(*bwd, **args),
                 f"K4 {dname} {shape}")


def _gated_cases(torch, rec, gen):
    """K8's forward and reverse walks at recurrentgemma-9b's lru width
    (4096): the prefill's and a training microbatch's B=1 S=4096, with and
    without an entering state, and a ragged B=2 S=300.  It reads log_a and
    b and writes h (12 B an element; h0 read and the final state written
    besides), 3 f32 operations an element (exp, multiply, add).  No single
    PyTorch call computes the scan: no library time.  Each row prints its
    chunk length and its time in a CUDA graph, and is rerun for the same
    bits."""
    from repro_torch.kernels import ops, ref
    w = 4096
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for b, s in ((1, HYB_S), (2, 300)):
        la, bb = -0.5 * randn(b, s, w).abs(), randn(b, s, w)
        h0 = 0.5 * randn(b, w)
        for reverse in (False, True):
            for with_h0 in ((False, True) if b == 1 else (True,)):
                hh = h0 if with_h0 else None
                call = lambda: ops.gated_recurrence(la, bb, hh, reverse)
                shape = (f"K8 float32 B={b} S={s} w={w}"
                         + " reverse" * reverse + " h0" * with_h0)
                extra = {"chunk": ops.gated_chunks(b, s, w),
                         "graph_ms": graph_ms(torch, call)}
                _case(torch, rec, "K8", "float32", ("K8", "float32"), call,
                      lambda: ref.gated_scan(la, bb, hh, reverse), None,
                      3.0 * b * s * w,
                      4 * (3 * b * s * w + (1 + with_h0) * b * w), shape,
                      extra)
                _rerun_equal(torch, call, shape)
        del la, bb, h0


def _gemm_training_cases(torch, rec, gen, label="", t=TRAIN_B * TRAIN_S,
                         weights=((2048, 2048), (2048, 32768),
                                  (16384, 2048)), tied_head=(2048, 256000)):
    """K1 at a training step's ``t`` rows (gemma-2b's T = 1024 by
    default): the bf16 forward products and the VJP forms, whose cotangent
    is f32 under bf16 weights and activations (mixed operands), of each
    ``(k, n)`` weight ``y = x w`` and of a tied head ``y = x table^T``
    (``(d, V)``, or None).  The library yardstick of a mixed product is
    torch.matmul on f32 copies of both operands, made outside the timed
    call."""
    bf, f32 = torch.bfloat16, torch.float32
    # (label, a shape, a dtype, b shape, b dtype, transpose_a, transpose_b)
    forms = [("fwd", (t, k), bf, (k, n), bf, False, False)
             for k, n in weights]
    if tied_head:
        d, v = tied_head
        forms.append(("fwd", (t, d), bf, (v, d), bf, False, True))
    for k, n in weights:
        # y = x w: dx = g w^T (transpose_b), dw = x^T g (transpose_a)
        forms.append(("dx", (t, n), f32, (k, n), bf, False, True))
        forms.append(("dw", (t, k), bf, (t, n), f32, True, False))
    if tied_head:
        # the tied head y = x table^T: dx = g table, dw = g^T x
        forms.append(("dx head", (t, v), f32, (v, d), bf, False, False))
        forms.append(("dw head", (t, v), f32, (t, d), bf, True, False))
    _gemm_forms(torch, rec, gen, f"K1 {label}train", forms)


def _gemm_forms(torch, rec, gen, prefix, forms):
    """Each K1 form ``(label, a shape, a dtype, b shape, b dtype,
    transpose_a, transpose_b)`` against its plain version, at the bf16
    tolerance."""
    from repro_torch.kernels import ops, ref
    f32 = torch.float32
    randn = lambda *shape, dt, sc=1.0: (torch.randn(
        *shape, generator=gen, device="cuda") * sc).to(dt)
    for label, ash, adt, bsh, bdt, ta, tb in forms:
        a = randn(*ash, dt=adt)
        b = randn(*bsh, dt=bdt, sc=ash[0 if ta else 1] ** -0.5)
        m, k = (ash[1], ash[0]) if ta else ash
        n = bsh[0] if tb else bsh[1]
        a32, b32 = a.float(), b.float()
        al = a32.t() if ta else a32
        bl = b32.t() if tb else b32
        mixed = adt != bdt
        nbytes = a.numel() * a.element_size() + \
            b.numel() * b.element_size() + m * n * 4
        extra = _k1_extra(torch, ops, a, b, ta, tb,
                          call=lambda: ops._gemm(a, b, ta, tb))
        bnd = None
        if extra["path"] == "split":
            # the split design's work: three bf16 products at the tensor
            # cores' peak, and the split's bytes (the f32 operand read, its
            # three bf16 parts written and read back); beside it the f32
            # FMA bound of the exact f32 product
            f_elems = (a if adt == f32 else b).numel()
            bnd = bound(3 * 2.0 * m * n * k, nbytes + 12 * f_elems,
                        "bfloat16")
            extra["fma_bound_ms"] = bound(2.0 * m * n * k, nbytes,
                                          "float32")[0]
        peak = "float32" if adt == bdt == f32 else "bfloat16"
        _case(torch, rec, "K1", peak, ("K1", "bfloat16"),
              lambda: ops._gemm(a, b, ta, tb),
              lambda: ref.matmul(a, b, tb, transpose_a=ta),
              (lambda: torch.matmul(al, bl)) if mixed else
              (lambda: torch.matmul(a.t() if ta else a, b.t() if tb else b)),
              2.0 * m * n * k, nbytes,
              f"{prefix} {label} {str(adt)[6:]}x{str(bdt)[6:]} m={m} k={k} "
              f"n={n} ta={int(ta)} tb={int(tb)}", extra, bnd)
        del a, b, a32, b32, al, bl


def _ssm_gemm_cases(torch, rec, gen):
    """K1 at mamba2-780m's products: w_in (1536, 6448), w_out (3072,
    1536) and the untied head (1536, 50280), bf16, at the served rows (1
    a slot's decode step, 3 the conv tail, 175 and 300 two prefills; the
    head reads the last position only) and at the training step's 4,096
    rows with the VJP forms."""
    bf = torch.bfloat16
    w_in, w_out, head = (1536, 6448), (3072, 1536), (1536, 50280)
    forms = [("fwd", (m, k), bf, (k, n), bf, False, False)
             for m, ws in ((1, (w_in, w_out, head)), (3, (w_in,)),
                           (175, (w_in, w_out)), (300, (w_in, w_out)))
             for k, n in ws]
    _gemm_forms(torch, rec, gen, "K1 mamba2 serve", forms)
    _gemm_training_cases(torch, rec, gen, "mamba2 ", SSM_B * SSM_S,
                         (w_in, w_out, head), None)


def _model(torch, module, n_layers=None, trainable=False):
    """A config module's full-width config (``n_layers`` cuts its depth)
    and its bf16 parameters from seed 0."""
    from repro_torch.models import transformer
    cfg = module.full()
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    params = transformer.init_lm(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        trainable=trainable)
    return cfg, params


def phase_path(torch, card):
    import numpy as np
    from repro_torch.configs import gemma_2b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, gemma_2b)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[path] gemma-2b full width: {n_params / 1e9:.3f} B params bf16, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    reqs = _dense_reqs(cfg, 6)
    print(f"[path] page={engine.page} (derived on the H100 table) "
          f"pool_pages={engine.pool.pool_pages} prompts="
          f"{[len(p) for p, _ in reqs]} max_new={[n for _, n in reqs]}",
          flush=True)

    run = _run_engine(torch, engine, reqs)
    rids, results, launches = run[:3]
    _serve_line(torch, np, "path", reqs, *run, engine)
    decode_steps = engine.kernel_calls
    prefills = len(rids) + sum(results[r]["request"].evictions for r in rids)
    require(all(launches[k] > 0 for k in ("K1", "K2", "K5")),
            f"a kernel of the path never launched: {launches}")
    require(launches["K3"] == launches["K4"] == launches["K7"] == 0,
            f"serving launched a backward kernel: {launches}")
    require(launches["K6"] == launches["K8"] == launches["K9"] == 0,
            f"gemma serving launched K6, K8 or K9: {launches}")
    require(launches["K5"] == cfg.n_layers * decode_steps,
            f"K5 launches {launches['K5']} != n_layers x decode steps")
    require(launches["K2"] == cfg.n_layers * prefills,
            f"K2 launches {launches['K2']} != n_layers x prefills")

    # hold one prefill and one batched decode step against the plain path
    with torch.inference_mode():
        prompt = torch.tensor([reqs[0][0]], device="cuda")
        lk, _ = transformer.prefill(params, cfg, prompt)
        with ops.reference_mode():
            lr, _ = transformer.prefill(params, cfg, prompt)
        err = (lk - lr).abs().max().item()
        scale = lr.abs().max().item()
        require(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        require(int(lk[0].argmax()) == results[rids[0]]["tokens"][0],
                "engine's first token differs from a fresh prefill's")
        print(f"[path] prefill logits (1, {lk.shape[-1]}) vs plain: "
              f"max_abs_err={err:.3e} (tol {PATH_TOL:g} x {scale:.3g})",
              flush=True)
        require(err <= PATH_TOL * scale, "prefill disagrees with plain")

        pool, tables, toks, poss, live, b_ms = _batched_decode_check(
            torch, "path", cfg, params, reqs, engine.page, card)
    per_slot = _per_slot_paged_path(torch, cfg, params, reqs, results, rids,
                                    pool, tables, toks, poss, live, b_ms,
                                    card)
    return launches, per_slot


def _batched_decode_check(torch, tag, cfg, params, reqs, page, card):
    """One batched paged decode step over 3 live slots (the first three
    prompts of ``reqs``, prefilled into scrambled slabs) and a dead one:
    its logits and pool writes against the plain path, then the step under
    sync debug mode "error", timed against every weight byte read once
    (the tied table counted once), and profiled.  Returns ``(pool,
    tables, toks, poss, live slots, bound ms)``."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import PagePool, pages_needed
    with torch.inference_mode():
        pool = PagePool(cfg, 4 * pages_needed(512, page), page,
                        torch.bfloat16, "cuda")
        live = [0, 1, 3]                 # slot 2 is dead
        tables = torch.zeros((4, pages_needed(201, page)),
                             dtype=torch.int32, device="cuda")
        toks, poss = [0] * 4, [-1] * 4
        for slot, (p, _) in zip(live, reqs):
            slabs = pool.alloc(pages_needed(len(p) + 1, page))
            lgt, cache = transformer.prefill(
                params, cfg, torch.tensor([p], device="cuda"))
            pool.write_prefill(cache, slabs, len(p))
            tables[slot, :len(slabs)] = torch.tensor(slabs)
            toks[slot], poss[slot] = int(lgt[0].argmax()), len(p)
        toks = torch.tensor(toks, dtype=torch.int32, device="cuda")
        poss = torch.tensor(poss, dtype=torch.int32, device="cuda")
        pools_r = {k: t.clone() for k, t in pool.pools.items()}
        dk = transformer.decode_step_paged_batched(
            params, cfg, toks, poss, pool.pools, tables=tables, page=page)
        with ops.reference_mode():
            dr = transformer.decode_step_paged_batched(
                params, cfg, toks, poss, pools_r, tables=tables, page=page)
        dk, dr = dk[live], dr[live]
        err = (dk - dr).abs().max().item()
        scale = dr.abs().max().item()
        require(bool(torch.isfinite(dk).all()), "decode logits not finite")
        for key in ("k", "v"):
            a, b = pool.pools[key].float(), pools_r[key].float()
            require((a - b).abs().max().item() <= PATH_TOL * b.abs().max()
                    .item(), f"decode {key} pool writes disagree with plain")
        del pools_r
        print(f"[{tag}] batched decode logits {tuple(dk.shape)} (3 live "
              f"slots + 1 dead) vs plain: max_abs_err={err:.3e} (tol "
              f"{PATH_TOL:g} x {scale:.3g})", flush=True)
        require(err <= PATH_TOL * scale, "batched decode disagrees with plain")

        # one batched decode step (3 live slots + 1 dead) against its bound:
        # every weight byte read once (the tied table counted once)
        step = lambda: transformer.decode_step_paged_batched(
            params, cfg, toks, poss, pool.pools, tables=tables, page=page)
        # the step reads nothing back to the host: any synchronizing call
        # inside it raises under the "error" sync debug mode
        step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print(f"[{tag}] decode step ran with no host sync (sync debug mode "
              f"'error')", flush=True)
        step_ms = time_ms(torch, step)
        w_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        b_ms, _ = bound(0.0, w_bytes, "bfloat16")
        print(f"[{tag}] decode step: {step_ms:.3f} ms; weight bytes "
              f"{w_bytes / 1e9:.3f} GB -> bound {b_ms:.3f} ms ({card})",
              flush=True)
        profile_step(torch, step)
    return pool, tables, toks, poss, live, b_ms


def _run_engine(torch, engine, reqs):
    """Submit ``reqs`` at t = 0 and step the engine until idle, with the
    launch counts from 0: ``(rids, results, launches, wall s, iterations,
    {rid: first-token time}, [decode-only iteration s])``."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0
    rids = [engine.submit(p, n, now=0.0) for p, n in reqs]
    iters, first_seen, decode_only = 0, {}, []
    while not engine.idle:
        waiting, t_it = len(engine._waiting), time.perf_counter()
        emitted = engine.step(clock())   # ends in the iteration's host read
        if len(engine._waiting) == waiting:      # admitted nothing
            decode_only.append(time.perf_counter() - t_it)
        iters += 1
        for rid, _ in emitted:
            first_seen.setdefault(rid, clock())
    torch.cuda.synchronize()
    wall = clock()
    launches = dict(ops.LAUNCHES)
    results = engine.results()
    require(all(len(results[r]["tokens"]) == n for r, (_, n)
                in zip(rids, reqs)), "a request did not get max_new tokens")
    return rids, results, launches, wall, iters, first_seen, decode_only


def _serve_line(torch, np, tag, reqs, rids, results, launches, wall, iters,
                first_seen, decode_only, engine) -> None:
    n_tok = sum(len(results[r]["tokens"]) for r in rids)
    ttft = [first_seen[r] for r in rids]      # all submitted at t = 0
    print(f"[{tag}] {n_tok} tokens in {wall:.3f} s over {iters} iterations: "
          f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(ttft, 50):.4f}"
          f" s max {max(ttft):.4f} s; decode-only iterations "
          f"{len(decode_only)}, mean "
          f"{1e3 * sum(decode_only) / max(1, len(decode_only)):.3f} ms (host "
          f"clock); decode steps {engine.kernel_calls}; evictions "
          f"{sum(results[r]['request'].evictions for r in rids)}; launches "
          f"{launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def _per_slot_paged_path(torch, cfg, params, reqs, batched_results,
                         batched_rids, pool, tables, toks, poss, live,
                         slot_bound_ms, card):
    """gemma-2b's requests once more through ServeEngine(batched=False):
    each slot decodes alone through decode_step_paged, K5 at one slot (two
    kernels a layer: the split blocks and their combine).  Its launches
    are derived; one slot's decode step (from the batched check's pool)
    agrees with the plain path; a 4-slot iteration of per-slot steps is
    timed against 4 slot-steps' weight bytes."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine, pages_needed
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512,
                         batched=False)
    require(engine.paged and not engine.batched,
            "batched=False must decode one paged slot at a time")
    run = _run_engine(torch, engine, reqs)
    rids, results, launches = run[:3]
    _serve_line(torch, np, "path", reqs, *run, engine)
    prefills = len(rids) + sum(results[r]["request"].evictions for r in rids)
    L = cfg.n_layers
    want = _zero_launches(K1=(prefills + engine.kernel_calls) * (6 * L + 1),
                          K2=L * prefills, K5=L * engine.kernel_calls)
    print(f"[path] batched=False: launches {launches} (derived {want}); "
          f"K5 at one slot, {L} launches a slot's decode step", flush=True)
    require(launches == want, "per-slot paged launches differ from the "
            "derived counts")
    same = sum(results[a]["tokens"] == batched_results[b]["tokens"]
               for a, b in zip(rids, batched_rids))
    print(f"[path] batched=False tokens equal to the batched engine's for "
          f"{same} of {len(rids)} requests (K5 splits a slot's keys by the "
          f"slot count, so the two sum them in other orders)", flush=True)

    with torch.inference_mode():
        slot = live[0]
        n_pg = pages_needed(int(poss[slot]) + 1, engine.page)
        one = dict(table=tables[slot, :n_pg].contiguous(), page=engine.page)
        args = (toks[slot:slot + 1], poss[slot:slot + 1])
        pools_r = {k: t.clone() for k, t in pool.pools.items()}
        dk = transformer.decode_step_paged(params, cfg, *args, pool.pools,
                                           **one)
        with ops.reference_mode():
            dr = transformer.decode_step_paged(params, cfg, *args, pools_r,
                                               **one)
        err = (dk - dr).abs().max().item()
        scale = dr.abs().max().item()
        require(bool(torch.isfinite(dk).all()), "per-slot decode logits not "
                "finite")
        print(f"[path] per-slot paged decode logits {tuple(dk.shape)} vs "
              f"plain: max_abs_err={err:.3e} (tol {PATH_TOL:g} x "
              f"{scale:.3g})", flush=True)
        require(err <= PATH_TOL * scale, "per-slot decode disagrees with "
                "plain")
        # one iteration of 4 per-slot steps: the 3 live slots of the
        # batched check and a fourth on the same pool
        extra = pool.alloc(pages_needed(len(reqs[3][0]) + 1, engine.page))
        lgt, cache = transformer.prefill(
            params, cfg, torch.tensor([reqs[3][0]], device="cuda"))
        pool.write_prefill(cache, extra, len(reqs[3][0]))
        dev = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")
        steps = [(toks[s:s + 1], poss[s:s + 1], tables[s, :pages_needed(
            int(poss[s]) + 1, engine.page)].contiguous()) for s in live]
        steps.append((lgt.argmax(-1), dev([len(reqs[3][0])]), dev(extra)))

        def iteration():
            return torch.cat([torch.argmax(transformer.decode_step_paged(
                params, cfg, t, p, pool.pools, table=tb, page=engine.page),
                dim=-1) for t, p, tb in steps])

        iteration()
        torch.cuda.set_sync_debug_mode("error")
        try:
            iteration()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        it_ms = time_ms(torch, iteration)
        print(f"[path] batched=False decode iteration (4 slots, per-slot "
              f"steps, no host sync under sync debug 'error'): {it_ms:.3f} "
              f"ms; bound 4 x {slot_bound_ms:.3f} = {4 * slot_bound_ms:.3f} "
              f"ms (each slot-step reads every weight byte once; {card})",
              flush=True)
        profile_step(torch, iteration, what="per-slot paged decode")
    return launches


def _batches(torch, cfg):
    from repro_torch.data import PipelineConfig, SyntheticLM
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                      seed=0))
    return [{k: torch.from_numpy(v).cuda() for k, v in
             data.global_batch(i).items()} for i in range(TRAIN_STEPS)]


def phase_train(torch):
    from repro_torch.configs import gemma_2b
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    cfg, params = _model(torch, gemma_2b, trainable=True)
    require(cfg.remat, "gemma-2b trains with remat on")
    batches = _batches(torch, cfg)
    n_params = sum(p.numel() for p in params.parameters())
    tokens = TRAIN_B * TRAIN_S

    # step 1's loss and gradients, through the kernels and through the
    # plain versions, before the optimizer state exists
    loss_k, _, grads_k = ts.loss_and_grads(params, cfg, batches[0])
    with ops.reference_mode():
        loss_p, _, grads_p = ts.loss_and_grads(params, cfg, batches[0])
    lk, lp = loss_k.item(), loss_p.item()
    print(f"[train] step-1 loss kernels {lk:.6f} plain {lp:.6f} rel "
          f"{abs(lk - lp) / abs(lp):.3e} (tol {LOSS_TOL:g})", flush=True)
    require(abs(lk - lp) <= LOSS_TOL * abs(lp), "loss disagrees with plain")
    worst = 0.0
    for name in grads_k:
        gk, gp = grads_k[name].float(), grads_p[name].float()
        require(bool(torch.isfinite(gk).all()), f"{name}: non-finite grad")
        rel = ((gk - gp).norm() / gp.norm()).item()
        err = (gk - gp).abs().max().item()
        worst = max(worst, rel)
        print(f"[train]   grad {name} {tuple(gk.shape)}: rel norm err "
              f"{rel:.3e} max_abs_err {err:.3e} max|plain| "
              f"{gp.abs().max().item():.3e}", flush=True)
        require(rel <= GRAD_TOL, f"{name}: gradient disagrees with plain")
        del gk, gp
    print(f"[train] step-1 gradients vs plain: worst rel norm err "
          f"{worst:.3e} (tol {GRAD_TOL:g}) over {len(grads_k)} leaves",
          flush=True)
    del grads_k, grads_p

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg)
    # the f32 masters must move; a bf16 parameter moves only where the
    # update exceeds half its ulp (warmup's lr is 3e-6 a step)
    before = {k: t.reshape(-1)[:4096].clone()
              for k, t in state.opt.master.items()}
    before_bf16 = {k: p.detach().clone() for k, p in
                   params.named_parameters() if p.numel() <= 2**24}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rows = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        last = i == len(batches) - 1
        if last:      # from device batch to updated state, no host sync
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            state, metrics = step(state, batch)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        rows.append((ms, loss, gnorm))
        print(f"[train] step {i + 1}: {ms:.3f} ms, {tokens / ms * 1e3:.1f} "
              f"tok/s, loss {loss:.6f}, grad_norm {gnorm:.6f}, lr "
              f"{metrics['lr'].item():.3e}", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"step {i + 1}: loss or grad norm not finite")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("[train] step 3 ran with no host sync (sync debug mode 'error')",
          flush=True)
    # the same kernels on the same weights and batch: the same loss
    require(abs(rows[0][1] - lk) <= 1e-6 * abs(lk), f"step 1's loss "
            f"{rows[0][1]} != the kernels' loss_and_grads {lk}")
    changed = sum(not torch.equal(before[k], t.reshape(-1)[:4096])
                  for k, t in state.opt.master.items())
    require(changed == len(before), f"only {changed} of {len(before)} "
            f"f32 master leaves changed")
    moved = {k: (dict(params.named_parameters())[k].detach() != t).float()
             .mean().item() for k, t in before_bf16.items()}
    print(f"[train] all {changed} f32 master leaves changed; share of bf16 "
          f"entries changed after {TRAIN_STEPS} steps: "
          f"{ {k: round(v, 4) for k, v in moved.items()} }", flush=True)
    del before_bf16
    L, n = cfg.n_layers, TRAIN_STEPS
    # K1 per step: 6 products a layer + the head forward, the 6 L again
    # under remat, and 2 VJP products for each of the 6 L + 1
    want = _zero_launches(K1=n * (6 * L + 1 + 6 * L + 2 * (6 * L + 1)),
                          K2=n * 2 * L, K3=n * L, K4=n * L)
    print(f"[train] launches over {n} steps {launches} (derived {want})",
          flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")

    # the step's bound, in two parts: the model's products and attention
    # (3x the forward: forward, and two VJP products each) at the bf16
    # tensor-core peak, and AdamW's bytes (read g bf16, m, v, master;
    # write m, v, master, the bf16 parameter: 28 B a parameter)
    d, hd, g = cfg.d_model, cfg.head_dim_, cfg.n_heads
    mm_params = n_params - (2 * L + 1) * d       # all but the norm scales
    pairs = TRAIN_B * TRAIN_S * (TRAIN_S + 1) // 2
    flops = 3 * (2 * tokens * mm_params + L * 4 * pairs * g * hd)
    bytes_opt = n_params * (2 + 12 + 12 + 2)
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = bytes_opt / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[train] gemma-2b full width, {n_params / 1e9:.3f} B params, "
          f"B={TRAIN_B} S={TRAIN_S}: step ms {[round(r[0], 3) for r in rows]}"
          f" (steps 2-3 mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} "
          f"tok/s); peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[train] bound: products {flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s = {ops_ms:.3f} ms + AdamW {bytes_opt / 1e9:.3f} GB at "
          f"3.35 TB/s = {opt_ms:.3f} ms = {ops_ms + opt_ms:.3f} ms", flush=True)
    profile_step(torch, lambda: step(state, batches[0]), n=1, what="train")
    return launches


def _dense_reqs(cfg, n: int):
    """``n`` requests from seed 0: prompts of 32-200 tokens (51-175 for
    the first six), 16-32 new tokens, as gemma-2b's ``[path]`` draws
    them."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(32, 201))
                          ).tolist(), int(rng.integers(16, 33)))
            for _ in range(n)]


def _agree(torch, tag, what, kern, plain) -> None:
    """``kern`` within PATH_TOL x max|plain| of ``plain``."""
    require(bool(torch.isfinite(kern).all()), f"{tag}: {what} not finite")
    err = (kern.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    print(f"[{tag}] {what} {tuple(kern.shape)} vs plain: max_abs_err="
          f"{err:.3e} (tol {PATH_TOL:g} x {scale:.3g})", flush=True)
    require(err <= PATH_TOL * scale, f"{tag}: {what} disagrees with plain")


def _step_bytes(params, cfg) -> int:
    """The weight bytes a decode step must read: every parameter, but of
    an untied embedding table the token's row only (a tied table is read
    whole by the head)."""
    total = sum(p.numel() * p.element_size() for p in params.parameters())
    if not cfg.tie_embeddings:
        t = params["embed"]["table"]
        total -= (t.shape[0] - 1) * t.shape[1] * t.element_size()
    return total


def phase_stablelm_path(torch, card):
    """stablelm-1.6b at full width served through contiguous per-slot
    caches (G = 1 is not paged-capable, as in the reference)."""
    import numpy as np
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, stablelm_1_6b)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    all_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[stablelm_path] stablelm-1.6b full width: {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f} s", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    require(engine.pool is None and not engine.paged, "stablelm (G = 1) "
            "must serve through contiguous per-slot caches")
    reqs = _dense_reqs(cfg, 6)
    print(f"[stablelm_path] contiguous per-slot caches of 512; prompts "
          f"{[len(p) for p, _ in reqs]} max_new {[n for _, n in reqs]}",
          flush=True)
    run = _run_engine(torch, engine, reqs)
    rids, results, launches = run[:3]
    _serve_line(torch, np, "stablelm_path", reqs, *run, engine)
    L, prefills = cfg.n_layers, len(rids)
    # K1: q, k, v, o, wi, wo a layer and the head, in a prefill and in a
    # slot's decode step; K2 a layer in a prefill; the decode attends in
    # plain PyTorch, as the reference's attention_decode does in jnp
    want = _zero_launches(K1=(prefills + engine.kernel_calls) * (6 * L + 1),
                          K2=L * prefills)
    print(f"[stablelm_path] launches {launches} (derived {want})", flush=True)
    require(launches == want, "stablelm serving launches differ from the "
            "derived counts")

    with torch.inference_mode():
        prompt = torch.tensor([reqs[0][0]], device="cuda")
        lk, ck = transformer.prefill(params, cfg, prompt)
        with ops.reference_mode():
            lr, cr = transformer.prefill(params, cfg, prompt)
        _agree(torch, "stablelm_path", "prefill logits", lk, lr)
        require(int(lk[0].argmax()) == results[rids[0]]["tokens"][0],
                "engine's first token differs from a fresh prefill's")
        tok = lk.argmax(-1)
        pos = torch.tensor([prompt.shape[1]], dtype=torch.int32,
                           device="cuda")
        cache = transformer.prefill_cache_to_decode(cfg, ck, 512)
        dk, _ = transformer.decode_step(params, cfg, tok, pos, cache)
        with ops.reference_mode():
            dr, _ = transformer.decode_step(
                params, cfg, tok, pos,
                transformer.prefill_cache_to_decode(cfg, cr, 512))
        _agree(torch, "stablelm_path", "contiguous decode logits", dk, dr)
        del ck, cr

        step = lambda: transformer.decode_step(params, cfg, tok, pos, cache)
        step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        step_ms = time_ms(torch, step)
        w_bytes = _step_bytes(params, cfg)
        c_bytes = 2 * cache["layers"].k.numel() * 2
        b_ms, _ = bound(0.0, w_bytes + c_bytes, "bfloat16")
        print(f"[stablelm_path] decode step (1 slot, cache of 512), no host "
              f"sync under sync debug 'error': {step_ms:.3f} ms; bound "
              f"{b_ms:.3f} ms: weights {w_bytes / 1e9:.3f} GB (every "
              f"parameter {all_bytes / 1e9:.3f} GB less the untied "
              f"embedding table but one row) + K/V cache "
              f"{c_bytes / 1e9:.3f} GB, at 3.35 TB/s ({card})", flush=True)
        slots = []
        for p, _ in reqs[1:5]:
            lg, c = transformer.prefill(params, cfg,
                                        torch.tensor([p], device="cuda"))
            slots.append((lg.argmax(-1), torch.tensor(
                [len(p)], dtype=torch.int32, device="cuda"),
                transformer.prefill_cache_to_decode(cfg, c, 512)))

        def iteration():
            return torch.cat([torch.argmax(transformer.decode_step(
                params, cfg, t, p, c)[0], dim=-1) for t, p, c in slots])

        it_ms = time_ms(torch, iteration)
        print(f"[stablelm_path] decode iteration (4 slots, per-slot steps): "
              f"{it_ms:.3f} ms; bound 4 x {b_ms:.3f} = {4 * b_ms:.3f} ms "
              f"({card})", flush=True)
        profile_step(torch, step, what="stablelm decode")
    return launches


def _dense_grad_agreement(torch, tag, cfg, params, batch):
    """Step 1's loss and gradients through the kernels against the plain
    versions, in f32 (the same weights, exact in f32) and in bf16, each
    held as ``[train]`` holds gemma-2b's bf16 step: the loss within
    LOSS_TOL, each gradient leaf within GRAD_TOL in relative norm.
    Returns the bf16 kernels' loss."""
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts
    for dtype in ("float32", "bfloat16"):
        c = cfg.with_(dtype=dtype)
        prm = _f32_copy(params, trainable=True) if dtype == "float32" \
            else params
        loss_k, _, gk = ts.loss_and_grads(prm, c, batch)
        with ops.reference_mode():
            loss_p, _, gp = ts.loss_and_grads(prm, c, batch)
        lk, lp = loss_k.item(), loss_p.item()
        print(f"[{tag}] {dtype} step-1 loss kernels {lk:.6f} plain {lp:.6f} "
              f"rel {abs(lk - lp) / abs(lp):.3e} (tol {LOSS_TOL:g})",
              flush=True)
        require(abs(lk - lp) <= LOSS_TOL * abs(lp), f"{dtype} loss "
                f"disagrees with plain")
        worst = 0.0
        for name in gk:
            require(bool(torch.isfinite(gk[name]).all()),
                    f"{name}: non-finite {dtype} grad")
            rel = _rel(torch, gk[name], gp[name], norm=True)
            worst = max(worst, rel)
            print(f"[{tag}]   {dtype} grad {name} {tuple(gk[name].shape)}: "
                  f"rel norm err {rel:.3e}", flush=True)
            require(rel <= GRAD_TOL, f"{name}: {dtype} gradient disagrees "
                    f"with plain")
        print(f"[{tag}] {dtype} step-1 gradients vs plain: worst rel norm "
              f"err {worst:.3e} (tol {GRAD_TOL:g}) over {len(gk)} leaves",
              flush=True)
        del gk, gp, prm
    return lk


def phase_stablelm_train(torch, card):
    """stablelm-1.6b at full width: 3 AdamW steps of make_train_step at
    B=2 S=2048 in its 2 microbatches, remat on."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    cfg, params = _model(torch, stablelm_1_6b, trainable=True)
    mb = cfg.train_microbatches
    require(cfg.remat and mb == 2, "stablelm-1.6b trains in 2 microbatches "
            "with remat on")
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, STABLELM_S, STABLELM_B,
                                      seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    n_params = sum(p.numel() for p in params.parameters())
    tokens = STABLELM_B * STABLELM_S
    lk = _dense_grad_agreement(torch, "stablelm_train", cfg, params,
                               batches[0])
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=mb)
    before = {k: t.reshape(-1)[:4096].clone()
              for k, t in state.opt.master.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rows = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if i == len(batches) - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            state, metrics = step(state, batch)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        rows.append((ms, loss, gnorm))
        print(f"[stablelm_train] step {i + 1}: {ms:.3f} ms, "
              f"{tokens / ms * 1e3:.1f} tok/s, loss {loss:.6f}, grad_norm "
              f"{gnorm:.6f}", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"step {i + 1}: loss or grad norm not finite")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("[stablelm_train] step 3 ran with no host sync (sync debug mode "
          "'error')", flush=True)
    # the step's loss is the mean of its microbatches' means: the whole
    # batch's mean up to the order of the f32 sums
    require(abs(rows[0][1] - lk) <= 1e-5 * abs(lk), f"step 1's loss "
            f"{rows[0][1]} != the kernels' loss_and_grads {lk}")
    changed = sum(not torch.equal(before[k], t.reshape(-1)[:4096])
                  for k, t in state.opt.master.items())
    require(changed == len(before), f"only {changed} of {len(before)} f32 "
            f"master leaves changed")
    L, n = cfg.n_layers, TRAIN_STEPS * mb
    # per microbatch, as gemma-2b's [train]: K1 6 products a layer + the
    # head, the 6 L again under remat, 2 VJP products for each of the
    # 6 L + 1; K2 a layer forward and in its remat rerun; K3, K4 a layer
    want = _zero_launches(K1=n * (6 * L + 1 + 6 * L + 2 * (6 * L + 1)),
                          K2=n * 2 * L, K3=n * L, K4=n * L)
    print(f"[stablelm_train] launches over {TRAIN_STEPS} steps of {mb} "
          f"microbatches {launches} (derived {want})", flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")
    # the bound as [train]'s: the products (3x the forward's) and the
    # attention at the bf16 peak, AdamW's 28 B a parameter at 3.35 TB/s
    mm_params = sum(p.numel() for name, p in params.named_parameters()
                    if name.endswith(("wq", "wk", "wv", "wo", "wi",
                                      "unembed.w")))
    pairs = STABLELM_B * STABLELM_S * (STABLELM_S + 1) // 2
    flops = 3 * (2 * tokens * mm_params
                 + L * 4 * pairs * cfg.n_heads * cfg.head_dim_)
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[stablelm_train] stablelm-1.6b full width, {n_params / 1e9:.3f} "
          f"B params, B={STABLELM_B} S={STABLELM_S} in {mb} microbatches: "
          f"step ms {[round(r[0], 3) for r in rows]} (steps 2-3 mean "
          f"{mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} tok/s); peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[stablelm_train] bound: products {flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s = {ops_ms:.3f} ms + AdamW {n_params * 28 / 1e9:.3f} GB at "
          f"3.35 TB/s = {opt_ms:.3f} ms = {ops_ms + opt_ms:.3f} ms ({card})",
          flush=True)
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="stablelm train")
    return launches


def phase_cmdr_path(torch, card):
    """command-r-plus-104b at full width, cut to CMDR_LAYERS layers: the
    batched paged ServeEngine (G = 12), then greedy_generate at B=1."""
    import numpy as np
    from repro_torch.configs import command_r_plus_104b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, command_r_plus_104b, CMDR_LAYERS)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[cmdr_path] command-r-plus-104b full width, {CMDR_LAYERS} of 64 "
          f"layers: {n_params / 1e9:.3f} B params bf16 (the tied 256000 x "
          f"12288 table {cfg.vocab_size * cfg.d_model / 1e9:.3f} B), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    require(engine.batched, "command-r (G = 12) must serve batched paged")
    reqs = _dense_reqs(cfg, 4)
    print(f"[cmdr_path] page={engine.page} prompts "
          f"{[len(p) for p, _ in reqs]} max_new {[n for _, n in reqs]}",
          flush=True)
    run = _run_engine(torch, engine, reqs)
    rids, results, launches = run[:3]
    _serve_line(torch, np, "cmdr_path", reqs, *run, engine)
    L = cfg.n_layers
    prefills = len(rids) + sum(results[r]["request"].evictions for r in rids)
    want = _zero_launches(K1=(prefills + engine.kernel_calls) * (6 * L + 1),
                          K2=L * prefills, K5=L * engine.kernel_calls)
    print(f"[cmdr_path] launches {launches} (derived {want})", flush=True)
    require(launches == want, "command-r serving launches differ from the "
            "derived counts")

    # greedy_generate B=1: one prefill re-laid as the contiguous decode
    # cache, then a decode step a token (K1 only; attention in plain
    # PyTorch, as the reference's attention_decode in jnp)
    prompt = torch.tensor([reqs[0][0][:CMDR_PROMPT]], device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = serve_step.greedy_generate(params, cfg, prompt, CMDR_NEW,
                                         CMDR_CACHE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen = dict(ops.LAUNCHES)
    want_gen = _zero_launches(K1=(1 + CMDR_NEW) * (6 * L + 1), K2=L)
    print(f"[cmdr_path] greedy_generate B=1 prompt {CMDR_PROMPT} + "
          f"{CMDR_NEW} new, cache {CMDR_CACHE}: {gen_s:.3f} s "
          f"({CMDR_NEW / gen_s:.1f} tok/s, host clock); launches {gen} "
          f"(derived {want_gen})", flush=True)
    require(out.shape == (1, CMDR_PROMPT + CMDR_NEW)
            and torch.equal(out[:, :CMDR_PROMPT], prompt),
            "greedy_generate's output is not the prompt and its new tokens")
    require(gen == want_gen, "greedy_generate launches differ from the "
            "derived counts")
    for k, v in gen.items():
        launches[k] += v

    with torch.inference_mode():
        lk, ck = transformer.prefill(params, cfg, prompt)
        with ops.reference_mode():
            lr, cr = transformer.prefill(params, cfg, prompt)
        _agree(torch, "cmdr_path", "prefill logits", lk, lr)
        require(int(lk[0].argmax()) == int(out[0, CMDR_PROMPT]),
                "greedy_generate's first token differs from a fresh "
                "prefill's")
        tok = lk.argmax(-1)
        pos = torch.tensor([CMDR_PROMPT], dtype=torch.int32, device="cuda")
        dk, _ = transformer.decode_step(
            params, cfg, tok, pos,
            transformer.prefill_cache_to_decode(cfg, ck, CMDR_CACHE))
        with ops.reference_mode():
            dr, _ = transformer.decode_step(
                params, cfg, tok, pos,
                transformer.prefill_cache_to_decode(cfg, cr, CMDR_CACHE))
        _agree(torch, "cmdr_path", "contiguous decode logits "
               "(greedy_generate's step)", dk, dr)
        del ck, cr, lr, dr
    _batched_decode_check(torch, "cmdr_path", cfg, params, reqs,
                          engine.page, card)
    print(f"[cmdr_path] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


def phase_ssm_path(torch):
    import numpy as np
    from repro_torch.configs import mamba2_780m
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, mamba2_780m)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[ssm_path] mamba2-780m full width: {n_params / 1e6:.1f} M params "
          f"bf16, init {time.perf_counter() - t0:.1f} s", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    rng = np.random.default_rng(0)
    # one prompt over one chunk (256): its prefill crosses a chunk boundary
    # and pads its last chunk; the others are one ragged chunk each
    lens = [300] + [int(n) for n in rng.integers(32, 201, 5)]
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(),
             int(rng.integers(16, 33))) for n in lens]
    print(f"[ssm_path] prompts {[len(p) for p, _ in reqs]} max_new "
          f"{[n for _, n in reqs]}", flush=True)

    run = _run_engine(torch, engine, reqs)
    rids, results, launches = run[:3]
    _serve_line(torch, np, "ssm_path", reqs, *run, engine)
    prefills = len(rids)
    slot_steps = engine.kernel_calls
    L = cfg.n_layers
    # K1 a prefill: w_in, w_out and the conv tail's w_in a layer, and the
    # head; a slot's decode step: w_in and w_out a layer, and the head
    want = _zero_launches(K1=prefills * (3 * L + 1) + slot_steps * (2 * L + 1),
                          K6=L * prefills)
    print(f"[ssm_path] launches {launches} (derived {want})", flush=True)
    require(launches == want, "ssm serving launches differ from the derived "
            "counts")

    with torch.inference_mode():
        # the 300-token prompt (two chunks, the second padded)
        prompt = torch.tensor([reqs[0][0]], device="cuda")
        tok = torch.tensor([results[rids[0]]["tokens"][0]], device="cuda")
        _ssm_agreement(torch, cfg, params, prompt, tok)
        _ssm_layers(torch, cfg, params, prompt, tok)
        torch.cuda.empty_cache()

        # one decode iteration of 4 slots (the engine's per-slot loop
        # without its host read) under the "error" sync debug mode
        slots = []
        for p, _ in reqs[1:5]:
            lg, c = transformer.prefill(params, cfg,
                                        torch.tensor([p], device="cuda"))
            slots.append([lg.argmax(-1),
                          transformer.prefill_cache_to_decode(cfg, c, 512)])

        def iteration():
            picks = []
            for sl in slots:
                logits, sl[1] = transformer.decode_step(params, cfg, sl[0],
                                                        None, sl[1])
                sl[0] = torch.argmax(logits, dim=-1)
                picks.append(sl[0])
            return torch.cat(picks)

        iteration()
        torch.cuda.set_sync_debug_mode("error")
        try:
            iteration()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("[ssm_path] decode iteration (4 slots) ran with no host sync "
              "(sync debug mode 'error')", flush=True)
        it_ms = time_ms(torch, iteration)
        b_ms, _ = bound(0.0, w_bytes, "bfloat16")
        print(f"[ssm_path] decode iteration (4 slots, per-slot steps): "
              f"{it_ms:.3f} ms; weight bytes {w_bytes / 1e9:.3f} GB -> "
              f"bound {b_ms:.3f} ms (read once), {4 * b_ms:.3f} ms (once a "
              f"slot)", flush=True)
        profile_step(torch, iteration, what="ssm decode")
    return launches


def _f32_copy(params, trainable=False):
    """The same weights in float32 (every bf16 value is exact in f32)."""
    from repro_torch.models import transformer
    tensors = {}
    for name, p in params.named_parameters():
        group, leaf = name.rsplit(".", 1)
        tensors.setdefault(group, {})[leaf] = p.detach().float()
    return transformer.build_params(tensors, trainable)


def _plain_if(ops, plain):
    return ops.reference_mode() if plain else contextlib.nullcontext()


def _rel(torch, a, b, norm=False):
    """max|a - b| / max|b| (or the ratio of the norms)."""
    a, b = a.float(), b.float()
    if norm:
        return ((a - b).norm() / b.norm()).item()
    return ((a - b).abs().max() / b.abs().max()).item()


def _ratio(kern, wit):
    return kern / wit if wit else (0.0 if not kern else math.inf)


def _ssm_agreement(torch, cfg, params, prompt, tok):
    """One prefill (logits, state, conv tail) and one decode step of
    ``tok`` from its cache, through the kernels and the plain versions, in
    the served bf16 and on its weights in f32: f32 kernels against f32
    plain tightly; bf16 kernels against the f32 plain path beside the
    plain bf16 path's own distance from it (the witness)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cf, pf = cfg.with_(dtype="float32"), _f32_copy(params)
    out = {}
    for c, prm in ((cf, pf), (cfg, params)):
        for plain in (False, True):
            with _plain_if(ops, plain):
                lg, cache = transformer.prefill(prm, c, prompt)
                dec, _ = transformer.decode_step(
                    prm, c, tok, None,
                    transformer.prefill_cache_to_decode(c, cache, 512))
            require(bool(torch.isfinite(lg).all() and torch.isfinite(dec)
                         .all()), f"{c.dtype} logits not finite")
            out[c.dtype, plain] = {"prefill logits": lg, "decode logits":
                                   dec, "state": cache.state,
                                   "conv tail": cache.conv}
    del pf
    require(int(out["bfloat16", False]["prefill logits"][0].argmax())
            == int(tok[0]), "engine's first token differs from a fresh "
            "prefill's")
    n = prompt.shape[1]
    for what, ref32 in out["float32", True].items():
        err = _rel(torch, out["float32", False][what], ref32)
        print(f"[ssm_path] float32 {what} {tuple(ref32.shape)} kernels vs "
              f"plain ({n}-token prompt): {err:.3e} of max|plain| (tol "
              f"{SSM_F32_TOL:g})", flush=True)
        require(err <= SSM_F32_TOL, f"float32 {what} disagrees with plain")
        kern = _rel(torch, out["bfloat16", False][what], ref32)
        wit = _rel(torch, out["bfloat16", True][what], ref32)
        both = _rel(torch, out["bfloat16", False][what],
                    out["bfloat16", True][what])
        print(f"[ssm_path] bfloat16 {what}, max|diff| / max|f32 plain|: "
              f"kernels vs f32 {kern:.3e}, plain bf16 vs f32 {wit:.3e} "
              f"(ratio {_ratio(kern, wit):.3f}, tol {SSM_BF16_RATIO:g}); "
              f"kernels vs "
              f"plain bf16 {both:.3e}", flush=True)
        require(kern <= SSM_BF16_RATIO * wit, f"bfloat16 {what}: the "
                f"kernels sit farther from the f32 function than plain bf16")


def _ssm_layers(torch, cfg, params, prompt, tok):
    """The served bf16 model layer by layer: each layer's prefill (output,
    state, conv tail) and decode step (output, state), through the kernels
    and the plain versions on the same input (the plain path's residual
    stream and cache), so that nothing compounds."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, transformer
    from repro_torch.models.layers import apply_norm, embed_tokens
    x = embed_tokens(params, prompt, cfg)
    xd = embed_tokens(params, tok[:, None], cfg)
    worst = {}
    for i, lp in enumerate(transformer._layers(params)):
        h, hd = apply_norm(lp["ln1"], x, cfg), apply_norm(lp["ln1"], xd, cfg)
        res = []
        for plain in (False, True):
            with _plain_if(ops, plain):
                res.append(ssm.apply_mamba2(lp["mixer"], h, cfg))
        # the decode step from the plain prefill's cache on both sides
        cache = res[1][1]
        for plain in (False, True):
            with _plain_if(ops, plain):
                res[plain] += ssm.decode_mamba2(lp["mixer"], hd, cache, cfg)
        (ok, ck, dk, sk), (op, cp, dp, sp) = res
        for what, a, b in (("prefill out", ok, op),
                           ("state", ck.state, cp.state),
                           ("conv tail", ck.conv, cp.conv),
                           ("decode out", dk, dp),
                           ("decode state", sk.state, sp.state)):
            worst[what] = max(worst.get(what, (0.0, 0)),
                              (_rel(torch, a, b), i))
        x, xd = x + op, xd + dp
    for what, (err, i) in worst.items():
        print(f"[ssm_path] bfloat16 per layer (the same input on both "
              f"sides), {what}: worst {err:.3e} of max|plain| at layer {i} "
              f"(tol {SSM_LAYER_TOL:g})", flush=True)
        require(err <= SSM_LAYER_TOL, f"bfloat16 layer {i} {what} disagrees "
                f"with plain")


def _grad_agreement(torch, tag, cfg, params, batch):
    """Step 1's loss and gradients through the kernels and the plain
    versions, in bf16 and on its weights in f32: f32 kernels against f32
    plain tightly; bf16 kernels against the f32 plain gradients beside the
    plain bf16 ones' own distance from them (the witness).  Returns the
    bf16 kernels' loss.  ``tag`` heads the printed lines."""
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts
    cf, pf = cfg.with_(dtype="float32"), _f32_copy(params, trainable=True)
    out = {}
    for c, prm in ((cf, pf), (cfg, params)):
        for plain in (False, True):
            with _plain_if(ops, plain):
                loss, _, grads = ts.loss_and_grads(prm, c, batch)
            out[c.dtype, plain] = (loss.item(), grads)
    del pf
    (lk, gk), (lp, gp) = out["float32", False], out["float32", True]
    (lkb, gkb), (lpb, gpb) = out["bfloat16", False], out["bfloat16", True]
    for dt, a, b in (("float32", lk, lp), ("bfloat16", lkb, lpb)):
        print(f"[{tag}] {dt} step-1 loss kernels {a:.6f} plain {b:.6f} "
              f"rel {abs(a - b) / abs(b):.3e} (tol {LOSS_TOL:g}); f32 plain "
              f"{lp:.6f}", flush=True)
        require(abs(a - b) <= LOSS_TOL * abs(b), f"{dt} loss disagrees with "
                f"plain")
    worst, worst_ratio = 0.0, 0.0
    for name in gk:
        require(bool(torch.isfinite(gk[name]).all()
                     and torch.isfinite(gkb[name]).all()),
                f"{name}: non-finite grad")
        err = _rel(torch, gk[name], gp[name], norm=True)
        kern = _rel(torch, gkb[name], gp[name], norm=True)
        wit = _rel(torch, gpb[name], gp[name], norm=True)
        both = _rel(torch, gkb[name], gpb[name], norm=True)
        worst = max(worst, err)
        worst_ratio = max(worst_ratio, _ratio(kern, wit))
        print(f"[{tag}]   grad {name} {tuple(gk[name].shape)}, rel norm "
              f"err: float32 kernels vs plain {err:.3e}; bfloat16 kernels vs "
              f"f32 plain {kern:.3e}, plain bf16 vs f32 plain {wit:.3e} "
              f"(ratio {_ratio(kern, wit):.3f}), kernels vs plain bf16 "
              f"{both:.3e}",
              flush=True)
        require(err <= GRAD_TOL, f"{name}: f32 gradient disagrees with plain")
        require(kern <= SSM_BF16_RATIO * wit, f"{name}: the bf16 kernels' "
                f"gradient sits farther from the f32 one than plain bf16's")
    print(f"[{tag}] step-1 gradients over {len(gk)} leaves: float32 "
          f"kernels vs plain worst rel norm err {worst:.3e} (tol "
          f"{GRAD_TOL:g}); bfloat16 worst ratio {worst_ratio:.3f} (tol "
          f"{SSM_BF16_RATIO:g})", flush=True)
    return lkb


def _ssm_layer_grads(torch, cfg, params, batch):
    """The bf16 model's VJP layer by layer: each layer (its norm and
    mixer) gets the plain path's input and one seeded cotangent on both
    sides, so that nothing compounds; the gradients of its input and of
    each of its parameters are held to SSM_LAYER_GRAD_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, transformer
    from repro_torch.models.layers import apply_norm, embed_tokens
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        x = embed_tokens(params, batch["tokens"], cfg)
    worst = {}
    for i, lp in enumerate(transformer._layers(params)):
        leaves = {f"{g}.{k}": t.detach().requires_grad_(True)
                  for g, grp in lp.items() for k, t in grp.items()}
        lpl = {g: {k: leaves[f"{g}.{k}"] for k in grp}
               for g, grp in lp.items()}
        ct = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        res = []
        for plain in (False, True):
            xin = x.detach().requires_grad_(True)
            with _plain_if(ops, plain):
                o, _ = ssm.apply_mamba2(
                    lpl["mixer"], apply_norm(lpl["ln1"], xin, cfg), cfg,
                    want_cache=False)
                res.append((o.detach(), torch.autograd.grad(
                    o, [xin, *leaves.values()], ct)))
        for name, a, b in zip(["input", *leaves], res[0][1], res[1][1]):
            worst[name] = max(worst.get(name, (0.0, 0)),
                              (_rel(torch, a, b, norm=True), i))
        x = x + res[1][0]
        del res, leaves, lpl
    for name, (err, i) in worst.items():
        print(f"[ssm_train] bfloat16 per-layer VJP (the same input and "
              f"cotangent on both sides), grad {name}: worst rel norm err "
              f"{err:.3e} at layer {i} (tol {SSM_LAYER_GRAD_TOL:g})",
              flush=True)
        require(err <= SSM_LAYER_GRAD_TOL, f"bfloat16 layer {i} grad {name} "
                f"disagrees with plain")


def phase_ssm_train(torch):
    from repro_torch.configs import mamba2_780m
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.train import train_step as ts

    cfg, params = _model(torch, mamba2_780m, trainable=True)
    require(cfg.remat, "mamba2-780m trains with remat on")
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, SSM_S, SSM_B, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    n_params = sum(p.numel() for p in params.parameters())
    tokens = SSM_B * SSM_S

    # step 1's loss and gradients against the plain path (f32, and bf16
    # beside its witness), then the bf16 VJP layer by layer
    lk = _grad_agreement(torch, "ssm_train", cfg, params, batches[0])
    _ssm_layer_grads(torch, cfg, params, batches[0])
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg)
    before = {k: t.reshape(-1)[:4096].clone()
              for k, t in state.opt.master.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rows = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if i == len(batches) - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            state, metrics = step(state, batch)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        rows.append((ms, loss, gnorm))
        print(f"[ssm_train] step {i + 1}: {ms:.3f} ms, {tokens / ms * 1e3:.1f}"
              f" tok/s, loss {loss:.6f}, grad_norm {gnorm:.6f}", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"step {i + 1}: loss or grad norm not finite")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("[ssm_train] step 3 ran with no host sync (sync debug mode "
          "'error')", flush=True)
    require(abs(rows[0][1] - lk) <= 1e-6 * abs(lk), f"step 1's loss "
            f"{rows[0][1]} != the kernels' loss_and_grads {lk}")
    changed = sum(not torch.equal(before[k], t.reshape(-1)[:4096])
                  for k, t in state.opt.master.items())
    require(changed == len(before), f"only {changed} of {len(before)} f32 "
            f"master leaves changed")
    L, n = cfg.n_layers, TRAIN_STEPS
    # K1 a step: w_in and w_out a layer and the head forward, the 2 L
    # again under remat, and 2 VJP products for each of the 2 L + 1 (the
    # loss asks for no cache: no conv-tail product); K6 a layer in the
    # forward and again in its remat rerun; K7 once a layer
    want = _zero_launches(K1=n * (2 * L + 1 + 2 * L + 2 * (2 * L + 1)),
                          K6=n * 2 * L, K7=n * L)
    print(f"[ssm_train] launches over {n} steps {launches} (derived {want})",
          flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")

    # the step's bound, in three parts: the projections and the head (3x
    # the forward's products) at the bf16 peak; the SSD scans' f32 flops
    # (forward and reverse scan, what this data needs) at the f32 peak;
    # AdamW's 28 B a parameter at 3.35 TB/s
    mm_params = sum(p.numel() for name, p in params.named_parameters()
                    if name.endswith(("w_in", "w_out", "unembed.w")))
    h, hp, sn = ssm.n_ssd_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    fwd, bwd = ssd_work(SSM_B, SSM_S, h, hp, sn, cfg.ssm_chunk)
    mm_ms = 6 * mm_params * tokens / H100_PEAK_FLOPS["bfloat16"] * 1e3
    ssd_ms = L * (fwd + bwd) / H100_PEAK_FLOPS["float32"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[ssm_train] mamba2-780m full width, {n_params / 1e6:.1f} M params, "
          f"B={SSM_B} S={SSM_S}: step ms {[round(r[0], 3) for r in rows]} "
          f"(steps 2-3 mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} "
          f"tok/s); peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[ssm_train] bound: products {6 * mm_params * tokens / 1e12:.3f} "
          f"TFLOP at 989 TFLOP/s = {mm_ms:.3f} ms + SSD scans "
          f"{L * (fwd + bwd) / 1e12:.3f} TFLOP at 67 TFLOP/s = {ssd_ms:.3f} "
          f"ms + AdamW {n_params * 28 / 1e9:.3f} GB at 3.35 TB/s = "
          f"{opt_ms:.3f} ms = {mm_ms + ssd_ms + opt_ms:.3f} ms", flush=True)
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="ssm train")
    return launches


def _hybrid_counts(cfg):
    """``(RG-LRU layers, local layers, K1 launches of one forward)``: 5
    products an RG-LRU layer (w_x, w_gate, wa, wi, w_out) and 4 a local
    layer (q, k, v, o), 2 an MLP, and the head (the forward's last
    position in a prefill or a decode step, every position in the
    loss)."""
    from repro_torch.models import transformer
    g, tail, n_rec, n_att = transformer.hybrid_layout(cfg)
    rec, att = g * n_rec + tail, g * n_att
    return rec, att, 7 * rec + 6 * att + 1


def _zero_launches(**counts):
    want = {f"K{i}": 0 for i in range(1, 10)}
    want.update(counts)
    return want


def _cast_cache(torch, cache, dtype):
    """A hybrid decode cache in ``dtype`` (the RG-LRU states stay f32)."""
    from repro_torch.models.attention import KV
    from repro_torch.models.rglru import RGLRUCache
    out = {}
    for key, c in cache.items():
        if isinstance(c, RGLRUCache):
            out[key] = RGLRUCache(c.h, c.conv.to(dtype))
        else:
            out[key] = KV(c.k.to(dtype), c.v.to(dtype))
    return out


def _hybrid_ctx_cache(torch, cfg, params, ctx):
    """The decode cache after ingesting ``ctx (1, n)`` token by token
    through the plain path (as ``greedy_generate`` ingests a prompt)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, 1, GEN_CACHE,
                                   dtype=getattr(torch, cfg.dtype),
                                   device="cuda")
    with ops.reference_mode():
        for t in range(ctx.shape[1]):
            _, cache = transformer.decode_step(
                params, cfg, ctx[:, t],
                torch.full((1,), t, dtype=torch.int32, device="cuda"), cache)
    return cache


def _hybrid_agreement(torch, cfg, params, tokens, ctx):
    """One prefill of ``tokens`` (logits and the forward cache: the RG-LRU
    states and conv tails, the local layers' K/V) and one decode step of
    ``ctx``'s last token from the cache of the rest, through the kernels
    and the plain versions, in the served bf16 and on its weights in f32
    (at full depth): f32 kernels against f32 plain tightly; bf16 kernels
    against the f32 plain path beside the plain bf16 path's own distance
    from it (the witness)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cf, pf = cfg.with_(dtype="float32"), _f32_copy(params)
    n = ctx.shape[1] - 1
    cache32 = _hybrid_ctx_cache(torch, cf, pf, ctx[:, :n])
    pos = torch.full((1,), n, dtype=torch.int32, device="cuda")
    out = {}
    for c, prm in ((cf, pf), (cfg, params)):
        cache = cache32 if c is cf else _cast_cache(torch, cache32,
                                                    torch.bfloat16)
        for plain in (False, True):
            with _plain_if(ops, plain):
                lg, fc = transformer.prefill(prm, c, tokens)
                dec, dc = transformer.decode_step(prm, c, ctx[:, n], pos,
                                                  cache)
            require(bool(torch.isfinite(lg).all() and torch.isfinite(dec)
                         .all()), f"{c.dtype} logits not finite")
            out[c.dtype, plain] = {
                "prefill logits": lg, "state": fc["rec"].h,
                "tail state": fc["tail"].h, "conv tail": fc["rec"].conv,
                "local K": fc["att"].k, "local V": fc["att"].v,
                "decode logits": dec, "decode state": dc["rec"].h,
                "decode ring K": dc["att"].k}
    del pf, cache32
    for what, ref32 in out["float32", True].items():
        err = _rel(torch, out["float32", False][what], ref32)
        print(f"[hybrid_path] float32 {what} {tuple(ref32.shape)} kernels "
              f"vs plain ({tokens.shape[1]}-token prefill, decode at "
              f"position {n}): {err:.3e} of max|plain| (tol "
              f"{SSM_F32_TOL:g})", flush=True)
        require(err <= SSM_F32_TOL, f"float32 {what} disagrees with plain")
        kern = _rel(torch, out["bfloat16", False][what], ref32)
        wit = _rel(torch, out["bfloat16", True][what], ref32)
        both = _rel(torch, out["bfloat16", False][what],
                    out["bfloat16", True][what])
        print(f"[hybrid_path] bfloat16 {what}, max|diff| / max|f32 plain|: "
              f"kernels vs f32 {kern:.3e}, plain bf16 vs f32 {wit:.3e} "
              f"(ratio {_ratio(kern, wit):.3f}, tol {SSM_BF16_RATIO:g}); "
              f"kernels vs plain bf16 {both:.3e}", flush=True)
        require(kern <= SSM_BF16_RATIO * wit, f"bfloat16 {what}: the "
                f"kernels sit farther from the f32 function than plain bf16")


def _hybrid_sublayers(torch, cfg, kind, lp, x, positions, xd, cd, pos):
    """One hybrid layer's sublayers through the kernels and the plain
    versions, each fed the plain path's input on both sides: the mixer
    (RG-LRU or local attention, prefill and decode step) and the MLP.
    Returns ``{name: (kernels, plain)}`` and the plain path's new
    residuals (prefill, decode)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import rglru
    from repro_torch.models.layers import apply_mlp, apply_norm
    res = {}

    def both(name, fn):
        got = []
        for plain in (False, True):
            with _plain_if(ops, plain):
                got.append(fn())
        for i, part in enumerate(name):
            res[part] = (got[0][i], got[1][i])
        return got[1]

    h, hd = apply_norm(lp["ln1"], x, cfg), apply_norm(lp["ln1"], xd, cfg)
    if kind == "rglru":
        names = ("prefill rglru out", "state", "conv tail")
        fwd = lambda: _flat_out(rglru.apply_rglru(lp["rec"], h, cfg))
        dnames = ("decode rglru out", "decode state")
        dec = lambda: _flat_out(rglru.decode_rglru(lp["rec"], hd, cd,
                                                   cfg))[:2]
    else:
        names = ("prefill local out", "local K", "local V")
        fwd = lambda: _flat_out(attn.attention_fwd(
            lp["attn"], h, cfg, positions=positions,
            window=cfg.local_window))
        dnames = ("decode local out", "decode ring K")
        dec = lambda: _flat_out(attn.attention_decode_ring(
            lp["attn"], hd, cd, pos, cfg))[:2]
    x, xd = x + both(names, fwd)[0], xd + both(dnames, dec)[0]
    m, dm = both(("prefill mlp out", "decode mlp out"), lambda: (
        apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg),
        apply_mlp(lp["mlp"], apply_norm(lp["ln2"], xd, cfg), cfg)))
    return res, x + m, xd + dm


def _flat_out(pair):
    """``(out, cache)`` as ``(out, *cache fields)``."""
    return (pair[0], *pair[1])


def _hybrid_layers(torch, cfg, params, tokens, cache, tok, pos):
    """The served bf16 model layer by layer (each sublayer fed the plain
    path's input on both sides, so that nothing compounds): each RG-LRU
    and local layer's prefill (output, state, conv tail or K/V), decode
    step from ``cache`` (output, state or ring K) and MLP."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_tokens
    x = embed_tokens(params, tokens, cfg)
    xd = embed_tokens(params, tok[:, None], cfg)
    positions = torch.arange(x.shape[1], device="cuda")[None, :]
    rec = transformer._cache_slices(cache["rec"], 2) + \
        transformer._cache_slices(cache["tail"], 1)
    rec, att = iter(rec), iter(transformer._cache_slices(cache["att"], 2))
    worst = {}
    for i, (kind, lp) in enumerate(transformer._hybrid_layers(params, cfg)):
        cd = next(rec if kind == "rglru" else att)
        res, x, xd = _hybrid_sublayers(torch, cfg, kind, lp, x, positions,
                                       xd, cd, pos)
        for what, (a, b) in res.items():
            worst[what] = max(worst.get(what, (0.0, 0)),
                              (_rel(torch, a, b), i))
    for what, (err, i) in worst.items():
        print(f"[hybrid_path] bfloat16 per layer (the same input on both "
              f"sides), {what}: worst {err:.3e} of max|plain| at layer {i} "
              f"(tol {SSM_LAYER_TOL:g})", flush=True)
        require(err <= SSM_LAYER_TOL, f"bfloat16 layer {i} {what} disagrees "
                f"with plain")


def phase_hybrid_path(torch):
    import numpy as np
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, recurrentgemma_9b)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[hybrid_path] recurrentgemma-9b full width and depth "
          f"({cfg.n_layers} layers): {n_params / 1e9:.3f} B params bf16, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, HYB_S))).cuda()
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).cuda()
    n_rec, n_att, k1 = _hybrid_counts(cfg)
    prefill = serve_step.make_prefill(cfg)
    with torch.inference_mode():
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = prefill(params, {"tokens": tokens})
        end.record()
        torch.cuda.synchronize()
        launches_p = dict(ops.LAUNCHES)
        prefill_ms = start.elapsed_time(end)
        require(tuple(logits.shape) == (1, cfg.vocab_size) and
                bool(torch.isfinite(logits).all()), "prefill logits")
        g, tail, _, n_att_g = transformer.hybrid_layout(cfg)
        require(tuple(cache["att"].k.shape) == (g, n_att_g, 1, HYB_S, 1,
                                                cfg.head_dim_) and
                tuple(cache["tail"].h.shape) == (tail, 1, cfg.lru_width),
                "prefill cache shapes")
        del cache
        want = _zero_launches(K1=k1, K2=n_att, K8=n_rec)
        print(f"[hybrid_path] make_prefill B=1 S={HYB_S}: {prefill_ms:.3f} ms"
              f" ({HYB_S / prefill_ms * 1e3:.1f} tok/s); launches "
              f"{launches_p} (derived {want})", flush=True)
        require(launches_p == want, "prefill launches differ from the "
                "derived counts")
        d, hd, g = cfg.d_model, cfg.head_dim_, cfg.n_heads
        head = cfg.vocab_size * d
        layer_mm = sum(p.numel() for name, p in params.named_parameters()
                       if name.endswith(("w_x", "w_gate", "wa", "wi",
                                         "w_out", "wq", "wk", "wv", "wo")))
        flops = 2 * HYB_S * layer_mm + 2 * head \
            + n_att * 4 * _pairs(HYB_S, cfg.local_window) * g * hd
        print(f"[hybrid_path] prefill bound: {flops / 1e12:.3f} TFLOP at 989 "
              f"TFLOP/s = {flops / H100_PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms "
              f"(weights {w_bytes / 1e9:.3f} GB at 3.35 TB/s = "
              f"{bound(0.0, w_bytes, 'bfloat16')[0]:.3f} ms); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = serve_step.greedy_generate(params, cfg, prompts, GEN_NEW,
                                         GEN_CACHE)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_g = dict(ops.LAUNCHES)
        steps = GEN_PROMPT + GEN_NEW
        require(tuple(out.shape) == (GEN_B, steps) and
                torch.equal(out[:, :GEN_PROMPT], prompts) and
                bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                "greedy_generate output")
        want = _zero_launches(K1=steps * k1)
        print(f"[hybrid_path] greedy_generate B={GEN_B}, {GEN_PROMPT} prompt "
              f"tokens (ingested one by one) + {GEN_NEW} new, cache_len "
              f"{GEN_CACHE}: {gen_s:.3f} s, {steps} decode steps, "
              f"{gen_s * 1e3 / steps:.3f} ms a step (host clock), "
              f"{GEN_B * GEN_NEW / gen_s:.2f} new tok/s; launches "
              f"{launches_g} (derived {want}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        require(launches_g == want, "greedy_generate launches differ from "
                "the derived counts")

        # agreement with the plain path: the prefill of the 4096 tokens and
        # a decode step at position HYB_DECODE_CTX
        ctx = prompts[:1, :HYB_DECODE_CTX + 1]
        _hybrid_agreement(torch, cfg, params, tokens, ctx)
        torch.cuda.empty_cache()
        cache = _hybrid_ctx_cache(torch, cfg, params, ctx[:, :-1])
        pos = torch.full((1,), HYB_DECODE_CTX, dtype=torch.int32,
                         device="cuda")
        _hybrid_layers(torch, cfg, params, tokens, cache, ctx[:, -1], pos)

        # one generation decode step (B=2) from the ingested prompts' cache,
        # under the "error" sync debug mode, then timed and profiled
        cache = transformer.init_cache(cfg, GEN_B, GEN_CACHE, device="cuda")
        for t in range(8):
            _, cache = transformer.decode_step(
                params, cfg, prompts[:, t],
                torch.full((GEN_B,), t, dtype=torch.int32, device="cuda"),
                cache)
        pos = torch.full((GEN_B,), 8, dtype=torch.int32, device="cuda")
        decode = serve_step.make_decode(cfg)
        step = lambda: decode(params, prompts[:, 8], pos, cache)
        step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("[hybrid_path] decode step ran with no host sync (sync debug "
              "mode 'error')", flush=True)
        step_ms = time_ms(torch, step, iters=5, warmup=1)
        b_ms, _ = bound(0.0, w_bytes, "bfloat16")
        print(f"[hybrid_path] decode step (B={GEN_B}): {step_ms:.3f} ms (CUDA "
              f"events); weight bytes {w_bytes / 1e9:.3f} GB -> bound "
              f"{b_ms:.3f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        profile_step(torch, step, n=2, what="hybrid decode")
        profile_step(torch, lambda: prefill(params, {"tokens": tokens}), n=1,
                     what="hybrid prefill")
    return {k: launches_p[k] + launches_g[k] for k in launches_p}


def _hybrid_layer_grads(torch, cfg, params, batch):
    """The bf16 model's VJP layer by layer: each layer (both sublayers and
    their norms) gets the plain path's input and one seeded cotangent on
    both sides, so that nothing compounds; the gradients of its input (the
    residual's identity included) and of each of its parameters are held
    to SSM_LAYER_GRAD_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_tokens
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        x = embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device="cuda")[None, :]
    worst = {}
    for i, (kind, lp) in enumerate(transformer._hybrid_layers(params, cfg)):
        leaves = {f"{g}.{k}": t.detach().requires_grad_(True)
                  for g, grp in lp.items() for k, t in grp.items()}
        lpl = {g: {k: leaves[f"{g}.{k}"] for k in grp}
               for g, grp in lp.items()}
        ct = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        res = []
        for plain in (False, True):
            xin = x.detach().requires_grad_(True)
            with _plain_if(ops, plain):
                o, _ = transformer._BLOCKS[kind](lpl, xin, cfg, positions,
                                                 False)
                res.append((o.detach(), torch.autograd.grad(
                    o, [xin, *leaves.values()], ct)))
        for name, a, b in zip(["input", *leaves], res[0][1], res[1][1]):
            key = f"{kind} {name}"
            worst[key] = max(worst.get(key, (0.0, 0)),
                             (_rel(torch, a, b, norm=True), i))
        x = res[1][0]
        del res, leaves, lpl
    for name, (err, i) in worst.items():
        print(f"[hybrid_train] bfloat16 per-layer VJP (the same input and "
              f"cotangent on both sides), grad {name}: worst rel norm err "
              f"{err:.3e} at layer {i} (tol {SSM_LAYER_GRAD_TOL:g})",
              flush=True)
        require(err <= SSM_LAYER_GRAD_TOL, f"bfloat16 layer {i} grad {name} "
                f"disagrees with plain")


def phase_hybrid_train(torch):
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _model(torch, recurrentgemma_9b, HYB_TRAIN_LAYERS,
                         trainable=True)
    require(cfg.remat, "recurrentgemma-9b trains with remat on")
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, HYB_S, HYB_B, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    n_params = sum(p.numel() for p in params.parameters())
    tokens = HYB_B * HYB_S
    print(f"[hybrid_train] recurrentgemma-9b full widths, {cfg.n_layers} "
          f"layers: {n_params / 1e9:.3f} B params bf16", flush=True)

    # step 1's loss and gradients on its first microbatch (B=1) against
    # the plain path (f32, and bf16 beside its witness), then the bf16 VJP
    # layer by layer
    mb = {k: v[:HYB_B // HYB_MB] for k, v in batches[0].items()}
    _grad_agreement(torch, "hybrid_train", cfg, params, mb)
    _hybrid_layer_grads(torch, cfg, params, mb)
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=HYB_MB)
    before = {k: t.reshape(-1)[:4096].clone()
              for k, t in state.opt.master.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rows = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if i == len(batches) - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            state, metrics = step(state, batch)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        rows.append((ms, loss, gnorm))
        print(f"[hybrid_train] step {i + 1}: {ms:.3f} ms, "
              f"{tokens / ms * 1e3:.1f} tok/s, loss {loss:.6f}, grad_norm "
              f"{gnorm:.6f}", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"step {i + 1}: loss or grad norm not finite")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("[hybrid_train] step 3 ran with no host sync (sync debug mode "
          "'error')", flush=True)
    changed = sum(not torch.equal(before[k], t.reshape(-1)[:4096])
                  for k, t in state.opt.master.items())
    require(changed == len(before), f"only {changed} of {len(before)} f32 "
            f"master leaves changed")
    n_rec, n_att, k1 = _hybrid_counts(cfg)
    n, m = TRAIN_STEPS, HYB_MB
    # a microbatch: the forward's K1 products, the layers' again under
    # remat, 2 VJP products for each forward one; K2 a local layer in the
    # forward and the remat rerun, K3/K4 once; K8 an RG-LRU layer in the
    # forward, the remat rerun and the reverse walk
    want = _zero_launches(K1=n * m * (k1 + (k1 - 1) + 2 * k1),
                          K2=n * m * 2 * n_att, K3=n * m * n_att,
                          K4=n * m * n_att, K8=n * m * 3 * n_rec)
    print(f"[hybrid_train] launches over {n} steps {launches} (derived "
          f"{want})", flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")

    # the step's bound: the products (3x the forward's) and attention at
    # the bf16 peak, AdamW's 28 B a parameter at 3.35 TB/s
    mm_params = sum(p.numel() for name, p in params.named_parameters()
                    if name.endswith(("w_x", "w_gate", "wa", "wi", "w_out",
                                      "wq", "wk", "wv", "wo", "table")))
    attn_flops = n_att * 4 * HYB_B * _pairs(HYB_S, cfg.local_window) \
        * cfg.n_heads * cfg.head_dim_
    flops = 3 * (2 * tokens * mm_params + attn_flops)
    mm_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[hybrid_train] recurrentgemma-9b {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params, B={HYB_B} S={HYB_S} in {m} "
          f"microbatches: step ms {[round(r[0], 3) for r in rows]} (steps "
          f"2-3 mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} tok/s); "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[hybrid_train] bound: products {flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s = {mm_ms:.3f} ms + AdamW {n_params * 28 / 1e9:.3f} GB at "
          f"3.35 TB/s = {opt_ms:.3f} ms = {mm_ms + opt_ms:.3f} ms", flush=True)
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="hybrid train")
    return launches


#: moa_path: the demo's GEMM size (examples/moa_gemm_demo.py), the
#: tropical sizes, and examples/kron_compress.py at 64x64 (x) 64x64
MOA_N, MOA_BIG, MOA_RAGGED, KRON = 4096, 8192, (4000, 3000, 5000), 64
#: kron_compress's own tolerance on |Wx - vec(B X A^T)|_inf
KRON_TOL = 1e-3
#: K9's (mul, add) and (add, add) sums and moa_gemm's (K1) f32 products
#: fold in another order than the plain version (K9's tiled (mul, add)
#: also multiplies bf16 hi / lo parts on the tensor cores, within about
#: 2^-16 of each product): max|kernel - plain| <= MOA_SUM_TOL x max|plain|;
#: K1 bf16 x bf16 products are exact in f32, so only the order differs
#: there too.  The tropical cases and the Hadamard, lone reduces and kron
#: (one rounding each, in any order) are held bit for bit.
MOA_SUM_TOL = 1e-4
#: f32 outside the tensor cores: 67 TFLOP/s, an FMA counted as two, so
#: 33.5 T lane-instructions/s
F32_INSTR_PER_S = 33.5e12


def k9_bound(instrs: float, nbytes: float) -> tuple[float, str]:
    """The least time for ``instrs`` f32 lane-instructions and ``nbytes``
    of device memory traffic on an H100 at 700 W (ms, what bounds it)."""
    from repro_torch.hardware import H100
    t_ops = instrs / F32_INSTR_PER_S * 1e3
    t_bytes = nbytes / H100.hbm.bandwidth_Bps * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k9_tc_bound(terms: float, nbytes: float) -> tuple[tuple[float, str],
                                                     dict]:
    """K9's (mul, add) TILE (and CHAIN's stages) on the tensor cores: the
    design's work is three bf16 products a term, bound at the bf16 peak
    or by the bytes (as K1's split and K6 / K7); beside it the f32 FMA
    bound of ``terms`` exact FMAs (one lane-instruction each)."""
    return (bound(3 * 2.0 * terms, nbytes, "bfloat16"),
            {"fma_bound_ms": k9_bound(terms, nbytes)[0]})


def _moa_cases(torch, E, ops):
    """The moa_path cases: ``(label, kernel id, path call, plain call,
    library call or None, exact?, (bound ms, by), extra)`` on seeded card
    inputs (``extra``: further numbers for the row, or {}); each path
    call goes through a user entry (``ops.moa_gemm``,
    ``semiring_matmul``, ``apply``, ``hadamard``, ``ipophp``)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rnd = lambda *s, dt=torch.float32: torch.randn(
        *s, generator=gen, device="cuda").to(dt)
    cases = []

    def add(label, kid, fn, library, exact, bnd, extra=None):
        cases.append((label, kid, fn, library, exact, bnd, extra or {}))

    n = MOA_N
    for dt, dname in ((torch.bfloat16, "bfloat16"), (torch.float32,
                                                     "float32")):
        a, b = rnd(n, n, dt=dt), rnd(n, n, dt=dt) * n ** -0.5
        es = a.element_size()
        # f32 out: the held sums differ only in order (a bf16 out would
        # flip roundings of equal-but-for-the-last-bit sums)
        route = _route(ops, a, b, False, False)
        add(f"K1 {dname} moa_gemm {n}^3 path={route}", "K1",
            lambda a=a, b=b: ops.moa_gemm(a, b, out_dtype=torch.float32),
            lambda a=a, b=b: torch.matmul(a, b), False,
            bound(2.0 * n ** 3, 2 * n * n * es + n * n * 4, dname))
    for plus in ("max", "min"):
        for (m, k, nn), dt in (((MOA_N,) * 3, torch.float32),
                               ((MOA_BIG,) * 3, torch.float32),
                               (MOA_RAGGED, torch.float32),
                               ((MOA_N,) * 3, torch.bfloat16)):
            a, b = rnd(m, k, dt=dt), rnd(k, nn, dt=dt)
            es = a.element_size()
            tag = "x".join(map(str, (m, k, nn)))
            add(f"K9 {str(dt)[6:]} {plus}-plus {tag}", "K9",
                lambda a=a, b=b, plus=plus: ops.semiring_matmul(
                    a, b, plus=plus, times="add"), None, True,
                k9_bound(2.0 * m * k * nn, (m * k + k * nn) * es + m * nn * 4))
    m = MOA_N // 2
    a, b = rnd(m, m), rnd(m, m)
    addadd = E.inner("add", "add", E.arr("A", (m, m)), E.arr("B", (m, m)))
    add(f"K9 float32 (add, add) {m}^3", "K9",
        lambda a=a, b=b: ops.apply(addadd, a, b),
        None, False, k9_bound(2.0 * m ** 3, 3 * m * m * 4))
    e, m = 16, MOA_N // 4
    x, w = rnd(e, m, m), rnd(e, m, m) * m ** -0.5
    batched = E.inner("add", "mul", E.arr("X", (e, m, m)),
                      E.arr("W", (e, m, m)), batch=1)
    add(f"K9 float32 batched (mul, add) e={e} {m}^3", "K9",
        lambda x=x, w=w: ops.apply(batched, x, w),
        lambda x=x, w=w: torch.bmm(x, w), False,
        *k9_tc_bound(1.0 * e * m ** 3, 3 * e * m * m * 4))
    m = MOA_N // 8
    ca, cb, cc = (rnd(m, m) * m ** -0.5 for _ in range(3))
    chain = E.arr("A", (m, m)) @ E.arr("B", (m, m)) @ E.arr("C", (m, m))
    # the function's work: two m^3 contractions (K9's CHAIN, as the
    # reference's einsum), each term three bf16 products on the tensor
    # cores (an FMA a term beside it); the normal form's nest of m^4
    # points would be 3 m^4 instructions (6.154 ms at 512)
    add(f"K9 float32 chain A@B@C {m}^4 terms (pairwise)", "K9",
        lambda: ops.apply(chain, ca, cb, cc),
        lambda: torch.linalg.multi_dot([ca, cb, cc]), False,
        *k9_tc_bound(2.0 * m ** 3, 4 * m * m * 4))
    ta, tb, tc = rnd(m, m), rnd(m, m), rnd(m, m)
    tchain = E.inner("max", "add", E.inner("max", "add", E.arr("A", (m, m)),
                                           E.arr("B", (m, m))),
                     E.arr("C", (m, m)))
    add(f"K9 float32 max-plus chain {m}^4 terms (pairwise)", "K9",
        lambda: ops.apply(tchain, ta, tb, tc), None, True,
        k9_bound(4.0 * m ** 3, 4 * m * m * 4))
    m = MOA_BIG
    ha, hb = rnd(m, m), rnd(m, m)
    add(f"K9 float32 hadamard {m}^2", "K9",
        lambda: ops.hadamard(ha, hb), lambda: ha * hb, True,
        k9_bound(1.0 * m * m, 3 * m * m * 4))
    lone = rnd(m, m)
    for op, axis, lib in (("max", 1, torch.amax), ("min", 0, torch.amin)):
        red = E.reduce(op, E.arr("A", (m, m)), axis)
        add(f"K9 float32 lone {op} axis {axis} {m}^2", "K9",
            lambda red=red: ops.apply(red, lone),
            lambda lib=lib, axis=axis: lib(lone, dim=axis), True,
            k9_bound(1.0 * m * m, (m * m + m) * 4))
    cube = rnd(MOA_N, 64, 64)
    two = E.reduce("max", E.reduce("max", E.arr("A", (MOA_N, 64, 64)), 2), 1)
    add(f"K9 float32 lone max over axes (1, 2) of ({MOA_N}, 64, 64)", "K9",
        lambda: ops.apply(two, cube), lambda: torch.amax(cube, dim=(1, 2)),
        True, k9_bound(1.0 * cube.numel(), (cube.numel() + MOA_N) * 4))
    lsum = E.reduce("add", E.arr("A", (m, m)), 0)
    add(f"K9 float32 lone sum axis 0 {m}^2", "K9",
        lambda: ops.apply(lsum, lone), lambda: torch.sum(lone, dim=0), False,
        k9_bound(1.0 * m * m, (m * m + m) * 4))
    n = MOA_N
    a, bt = rnd(n, n), rnd(n, n)                         # bt: stored (n, k)
    col = E.inner("max", "add", E.arr("A", (n, n)),
                  E.arr("B", (n, n), layout="col"))
    add(f"K9 float32 max-plus col-layout B {n}^3", "K9",
        lambda: ops.apply(col, a, bt), None, True,
        k9_bound(2.0 * n ** 3, 3 * n * n * 4))
    # strided views through a user entry: apply copies a column slice of a
    # wider A and a transposed B to row-major buffers, then runs K9
    m = MOA_N // 2
    wide, bv = rnd(m, m + 64), rnd(m, m)
    add(f"K9 float32 max-plus strided views (A[:, :{m}] of {m}x{m + 64}, "
        f"B transposed) {m}^3", "K9",
        lambda: ops.semiring_matmul(wide[:, :m], bv.t(), plus="max",
                                    times="add"), None, True,
        k9_bound(2.0 * m ** 3, 3 * m * m * 4))
    stack, b = rnd(8, n, n), rnd(n, n)
    psi = E.inner("max", "add", E.psi((3,), E.arr("S", (8, n, n))),
                  E.arr("B", (n, n)))
    add(f"K9 float32 max-plus psi((3,), (8, {n}, {n})) A {n}^3", "K9",
        lambda: ops.apply(psi, stack, b), None, True,
        k9_bound(2.0 * n ** 3, 3 * n * n * 4))
    ka, kb = rnd(KRON, KRON), rnd(KRON, KRON)
    add(f"K9 float32 kron {KRON}x{KRON} (x) {KRON}x{KRON}", "K9",
        lambda: ops.ipophp(ka, kb, "kp"), lambda: torch.kron(ka, kb), True,
        k9_bound(1.0 * KRON ** 4, (2 * KRON ** 2 + KRON ** 4) * 4))
    return cases, (col, a, bt), (ka, kb)


#: profiles one max-plus apply with a col-layout B and one with a psi
#: slab of a stack, in a process of its own, and prints each call's
#: device kernels
NOCOPY_PROBE = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import expr as E
from repro_torch.kernels import ops
n = int(sys.argv[2])
g = torch.Generator(device="cuda").manual_seed(17)
a, bt, b = (torch.randn(n, n, generator=g, device="cuda") for _ in range(3))
stack = torch.randn(8, n, n, generator=g, device="cuda")
cases = {
    "col-layout B": (E.inner("max", "add", E.arr("A", (n, n)),
                             E.arr("B", (n, n), layout="col")), a, bt),
    "psi-view A": (E.inner("max", "add", E.psi((3,), E.arr("S", (8, n, n))),
                           E.arr("B", (n, n))), stack, b)}
for label, (expr, *arrs) in cases.items():
    ops.apply(expr, *arrs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.apply(expr, *arrs)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    print("\t".join([label] + names))
"""


def _nocopy_kernels(n: int) -> dict:
    """``{case: device kernel names}`` of one col-layout and one psi-view
    max-plus apply at n^3.  In a fresh process: after the earlier phases'
    large traces, torch.profiler records no device rows in this one (seen
    on the H100 machine, in every profiler session of this phase)."""
    out = subprocess.run([sys.executable, "-c", NOCOPY_PROBE,
                          os.path.join(ROOT, "src"), str(n)],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"the no-copy profile failed: "
            f"{out.stderr[-2000:]}")
    rows = [line.split("\t") for line in out.stdout.splitlines() if line]
    return {r[0]: r[1:] for r in rows}


def phase_moa_path(torch, rec):
    """The MoA expression pipeline on the card (``ops.apply`` and its
    builders): each case's path call once with the launch counts from 0,
    then each held against its plain version (``ops.reference_mode()``)
    and timed beside its library call and bound."""
    from repro_torch.core import expr as E
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    cases, col, (ka, kb) = _moa_cases(torch, E, ops)
    k1_calls = sum(1 for c in cases if c[1] == "K1")
    k9_calls = len(cases) - k1_calls
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(KRON * KRON, generator=gen, device="cuda")
    torch.cuda.synchronize()

    # the path: every case once, kron_compress's compressed apply (two
    # moa_gemms), and one apply under sync debug mode "error"
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = [c[2]() for c in cases]
    X = x.reshape(KRON, KRON)
    T = ops.apply(E.matmul_expr(KRON, KRON, KRON, transpose_b=True), X, kb)
    Y = ops.moa_gemm(ka, T)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced = ops.apply(*col)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = _zero_launches(K1=k1_calls + 2, K9=k9_calls + 1)
    print(f"[moa_path] {len(cases)} cases + kron_compress's 2 moa_gemms + 1 "
          f"apply under sync debug 'error' in {path_s:.3f} s; launches "
          f"{launches} (derived {want}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    require(launches == want, f"moa_path launches {launches} != {want}")
    i_col = next(i for i, c in enumerate(cases) if "col-layout" in c[0])
    require(torch.equal(synced, outs[i_col]),
            "the apply under sync debug mode differs from the path's")

    # kron_compress: W x against vec(B X A^T)
    W = outs[-1]
    y_dense = W @ x
    err = (y_dense - Y.reshape(-1)).abs().max().item()
    print(f"[moa_path] kron_compress {KRON}x{KRON} (x) {KRON}x{KRON}: "
          f"|Wx - vec(B X A^T)|_inf = {err:.3e} (tol {KRON_TOL:g}); "
          f"max|Wx| = {y_dense.abs().max().item():.3f}", flush=True)
    require(err <= KRON_TOL, "kron_compress disagrees")

    # no operand copy for the col-layout and psi leaves: K9 alone runs.
    for label, names in _nocopy_kernels(MOA_N).items():
        print(f"[moa_path] profiler, max-plus with a {label}: device "
              f"kernels {names}", flush=True)
        require(names and all("k9_" in n for n in names),
                f"{label}: kernels other than K9 ran: {names}")

    for (label, kid, fn, library, exact, (b_ms, b_by), extra), out in zip(
            cases, outs):
        require(bool(torch.isfinite(out.float()).all()), f"{label}: "
                "non-finite")
        plain = lambda fn=fn: _plain(ops, fn)
        want_out = plain()
        torch.cuda.synchronize()
        diff = (out.float() - want_out.float()).abs().max().item()
        scale = want_out.float().abs().max().item()
        ok = torch.equal(out, want_out) if exact else \
            diff <= MOA_SUM_TOL * scale
        del want_out
        big = MOA_BIG in (out.shape[0], out.shape[-1]) and out.dim() == 2 \
            and "hadamard" not in label and "lone" not in label
        ms = time_ms(torch, fn, iters=2 if big else 10,
                     warmup=1 if big else 3)
        plain_ms = time_ms(torch, plain, iters=1, warmup=0)
        lib_ms = time_ms(torch, library) if library is not None else None
        # a sub-millisecond K9 call may be host-bound: its device time too
        g_ms = graph_ms(torch, fn) if kid == "K9" and ms < 1.0 else None
        note = "".join(f" {k}={v:.4f}" for k, v in extra.items())
        print(f"[moa_path] {label}{note}: max_abs_err={diff:.3e} "
              f"({'bit for bit' if exact else f'tol {MOA_SUM_TOL:g} x max|plain|'}"
              f") ms={ms:.4f}"
              f"{'' if g_ms is None else f' graph_ms={g_ms:.4f}'} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"{label}: kernel disagrees with its plain version")
        rec.setdefault(kid, {})[label] = dict(
            max_abs_err=diff, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, **extra)
        if g_ms is not None:
            rec[kid][label]["graph_ms"] = g_ms
    return launches


# ---------------------------------------------------------------------------
# moe_path: deepseek-moe-16b, the MoE family's serving path
# ---------------------------------------------------------------------------

def _moe_counts(cfg):
    """``(K1 launches of one forward, those of K1's expert form)``: 6 a
    dense layer (q, k, v, o and the MLP's two), 9 a MoE layer (q, k, v,
    o, the f32 router, the two expert GEMMs and the shared experts' two)
    and the head (the last position in a prefill, each row in a decode
    step)."""
    nd = cfg.first_dense_layers
    n_moe = cfg.n_layers - nd
    return 6 * nd + 9 * n_moe + 1, 2 * n_moe


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` set to ``value``, restored on exit."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _spy(module, name, record):
    """Wrap ``module.name`` so that each call passes its arguments and
    result to ``record``; restored on exit."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        record(args, out)
        return out
    return _patched(module, name, wrapped)


def _routing_flips(torch, kern, plain) -> tuple[int, int]:
    """``(set, order)``: the (token, layer) routings whose top-k experts
    differ between two lists of per-layer ``idx (t, k)`` as sets (another
    expert chosen), and those with the same set in another order (two
    near-tied gates swapped: the same dispatch, sums and output but for
    the gates' last bits)."""
    sets = order = 0
    for a, b in zip(kern, plain):
        other = (a.sort(-1).values != b.sort(-1).values).any(-1)
        sets += int(other.sum())
        order += int(((a != b).any(-1) & ~other).sum())
    return sets, order


def _moe_layers_check(torch, cfg, params, tokens, rows):
    """Every layer of the served bf16 model, each sublayer fed the plain
    path's input on both sides (so that nothing compounds): attention and
    its K/V at the prefill's tokens; the dense layer's MLP; each MoE FFN
    at the prefill's 2048 tokens (cap 240, K1's tile route) and at the 2
    decode-shaped ``rows`` (cap 8, the gemv route), with the routing held
    to the plain router's (its top-k and gates fed to both sides), so the
    expert GEMMs are compared on one dispatch; the router logits (f32 on
    K1's FMA route) against the plain product; and the routings that the
    two routers order differently, counted."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import apply_mlp, apply_norm, embed_tokens
    x = embed_tokens(params, tokens, cfg)
    xd = embed_tokens(params, rows[:, None], cfg)
    positions = torch.arange(x.shape[1], device="cuda")[None, :]
    worst, flips, routed = {}, (0, 0), 0

    def both(fn):
        got = []
        for plain in (False, True):
            with _plain_if(ops, plain):
                got.append(fn())
        return got

    def note(what, i, a, b, tol):
        err = _rel(torch, a, b)
        worst[what] = max(worst.get(what, (0.0, 0, tol)), (err, i, tol))

    for i, (kind, lp) in enumerate(transformer._moe_layers(params, cfg)):
        h = apply_norm(lp["ln1"], x, cfg)
        (ok, kk), (op, kp) = both(lambda: attn.attention_fwd(
            lp["attn"], h, cfg, positions=positions))
        note("attention out", i, ok, op, SSM_LAYER_TOL)
        note("K", i, kk.k, kp.k, SSM_LAYER_TOL)
        note("V", i, kk.v, kp.v, SSM_LAYER_TOL)
        x = x + op
        outs = []
        for tag, inp in (("prefill", x), ("decode rows", xd)):
            h2 = apply_norm(lp["ln2"], inp, cfg)
            if kind == "dense":
                yk, yp = both(lambda: apply_mlp(lp["mlp"], h2, cfg))
                note(f"{tag} dense mlp out", i, yk, yp, SSM_LAYER_TOL)
            else:
                xt = h2.reshape(-1, cfg.d_model)
                rk, rp = both(lambda: moe.route(lp["moe"], xt, cfg))
                note("router logits", i, rk[0], rp[0], TOL["K1", "float32"])
                flips = tuple(map(sum, zip(flips, _routing_flips(
                    torch, [rk[3]], [rp[3]]))))
                routed += xt.shape[0]
                with _patched(moe, "route", lambda p, t, c, _r=rp: _r):
                    yk, yp = both(lambda: moe.apply_moe(lp["moe"], h2,
                                                        cfg)[0])
                note(f"{tag} moe out (routing held)", i, yk, yp,
                     SSM_LAYER_TOL)
            outs.append(yp)
        x, xd = x + outs[0], xd + outs[1]
    for what, (err, i, tol) in worst.items():
        print(f"[moe_path] bfloat16 per layer (the same input on both "
              f"sides), {what}: worst {err:.3e} of max|plain| at layer {i} "
              f"(tol {tol:g})", flush=True)
        require(err <= tol, f"layer {i} {what} disagrees with plain")
    print(f"[moe_path] per layer, the same input: of {routed} (token, "
          f"layer) routings, {flips[0]} choose other experts and {flips[1]} "
          f"order the same experts otherwise under the kernels' router than "
          f"under the plain one (reported, not held: a last-bit difference "
          f"swaps near-tied experts)", flush=True)


def phase_moe_path(torch, card):
    """deepseek-moe-16b at full width and depth: make_prefill, each layer
    against its plain version, greedy_generate, a decode step."""
    import numpy as np
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params = _model(torch, deepseek_moe_16b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[moe_path] deepseek-moe-16b full width and depth "
          f"({cfg.n_layers} layers, {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared): "
          f"{n_params / 1e9:.3f} B params ({w_bytes / 1e9:.3f} GB, bf16 "
          f"and the f32 router), init {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, MOE_S))).cuda()
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_GEN_B, MOE_PROMPT))).cuda()
    k1, k1e = _moe_counts(cfg)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    expert = [0]
    count_expert = lambda a, o: expert.__setitem__(0, expert[0] + 1)
    prefill = serve_step.make_prefill(cfg)
    with torch.inference_mode():
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with _spy(ops, "_expert_gemm", count_expert):
            start.record()
            logits, cache = prefill(params, {"tokens": tokens})
            end.record()
            torch.cuda.synchronize()
        launches_p = dict(ops.LAUNCHES)
        prefill_ms = start.elapsed_time(end)
        require(tuple(logits.shape) == (1, cfg.vocab_size) and
                bool(torch.isfinite(logits).all()), "prefill logits")
        require(set(cache) == {"dense", "moe"} and
                tuple(cache["moe"].k.shape) == (n_moe, 1, MOE_S,
                                                cfg.n_kv_heads,
                                                cfg.head_dim_),
                "prefill cache shapes")
        want = _zero_launches(K1=k1, K2=cfg.n_layers)
        print(f"[moe_path] make_prefill B=1 S={MOE_S}: {prefill_ms:.3f} ms "
              f"(CUDA events; {MOE_S / prefill_ms * 1e3:.1f} tok/s); "
              f"launches {launches_p} (derived {want}), K1's expert form "
              f"{expert[0]} (derived {k1e}: 2 a MoE layer)", flush=True)
        require(launches_p == want and expert[0] == k1e,
                "prefill launches differ from the derived counts")
        cap = moe.capacity(cfg, MOE_S)
        d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
        dense_mm = sum(p.numel() for name, p in params.named_parameters()
                       if name.endswith(("wq", "wk", "wv", "wo", "wi",
                                         "router", "shared_wi",
                                         "shared_wo"))
                       and ".moe.w" not in name)
        flops = 2 * MOE_S * dense_mm + 2 * d * cfg.vocab_size \
            + n_moe * 2 * e * cap * (d * 2 * f + f * d) \
            + cfg.n_layers * 4 * _pairs(MOE_S) * cfg.n_heads * cfg.head_dim_
        step_bytes = _step_bytes(params, cfg)
        b_ms, b_by = bound(flops, step_bytes, "bfloat16")
        print(f"[moe_path] prefill bound: {flops / 1e12:.3f} TFLOP (the "
              f"experts at capacity {cap} of {MOE_S} x {cfg.top_k} / {e} "
              f"assignments) at 989 TFLOP/s = "
              f"{flops / H100_PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms, weights "
              f"{step_bytes / 1e9:.3f} GB at 3.35 TB/s = "
              f"{bound(0.0, step_bytes, 'bfloat16')[0]:.3f} ms: bound "
              f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / prefill_ms:.1f}% of "
              f"it reached; {card}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        again, cache2 = prefill(params, {"tokens": tokens})
        require(torch.equal(logits, again) and all(
            torch.equal(a, b) for key in cache
            for a, b in zip(cache[key], cache2[key])),
            "a rerun of the prefill differs (dispatch and combine must sum "
            "in a fixed order)")
        print("[moe_path] prefill rerun bit-identical (logits and K/V)",
              flush=True)
        del cache, cache2, again

        # the end-to-end routings: each path routes its own residual
        # stream, so a flip compounds; reported, not held
        routes = {}
        for plain in (False, True):
            seen = routes.setdefault(plain, [])
            with _plain_if(ops, plain), _spy(
                    moe, "route", lambda a, o, s=seen: s.append(o[3])):
                lg, _ = prefill(params, {"tokens": tokens})
            routes[plain, "logits"] = lg
        sets, order = _routing_flips(torch, routes[False], routes[True])
        lk, lp = routes[False, "logits"], routes[True, "logits"]
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"[moe_path] end to end ({cfg.n_layers} bf16 layers, each "
              f"path its own residual): of {MOE_S * n_moe} (token, layer) "
              f"routings, {sets} choose other experts than the plain "
              f"path's and {order} order the same experts otherwise; "
              f"last-position "
              f"logits max|diff| {(lk - lp).abs().max().item():.3e} of "
              f"{lp.abs().max().item():.3g}, argmax "
              f"{'equal' if same else 'differs'}"
              f" (reported, not held: routing is discontinuous)", flush=True)
        del routes, lk, lp
        torch.cuda.empty_cache()
        _moe_layers_check(torch, cfg, params, tokens, prompts[:, 0])
        torch.cuda.empty_cache()

        # greedy_generate: the prompts ingested token by token, as the
        # reference does for moe (no forward->decode re-layout)
        torch.cuda.synchronize()
        ops.reset_launches()
        expert[0] = 0
        t0 = time.perf_counter()
        with _spy(ops, "_expert_gemm", count_expert):
            out = serve_step.greedy_generate(params, cfg, prompts, MOE_NEW,
                                             MOE_CACHE)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_g = dict(ops.LAUNCHES)
        steps = MOE_PROMPT + MOE_NEW
        require(tuple(out.shape) == (MOE_GEN_B, steps) and
                torch.equal(out[:, :MOE_PROMPT], prompts) and
                bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                "greedy_generate output")
        want = _zero_launches(K1=steps * k1)
        print(f"[moe_path] greedy_generate B={MOE_GEN_B}, {MOE_PROMPT} "
              f"prompt tokens (ingested one by one) + {MOE_NEW} new, "
              f"cache_len {MOE_CACHE}: {gen_s:.3f} s, {steps} decode steps, "
              f"{gen_s * 1e3 / steps:.3f} ms a step (host clock), "
              f"{MOE_GEN_B * MOE_NEW / gen_s:.2f} new tok/s; launches "
              f"{launches_g} (derived {want}), K1's expert form {expert[0]} "
              f"(derived {steps * k1e})", flush=True)
        require(launches_g == want and expert[0] == steps * k1e,
                "greedy_generate launches differ from the derived counts")

        # one decode step (B=2) from 8 ingested tokens: under the "error"
        # sync debug mode, against the plain path, timed and profiled
        cache = transformer.init_cache(cfg, MOE_GEN_B, MOE_CACHE,
                                       device="cuda")
        for t in range(8):
            _, cache = transformer.decode_step(
                params, cfg, prompts[:, t],
                torch.full((MOE_GEN_B,), t, dtype=torch.int32,
                           device="cuda"), cache)
        pos = torch.full((MOE_GEN_B,), 8, dtype=torch.int32, device="cuda")
        decode = serve_step.make_decode(cfg)
        step = lambda: decode(params, prompts[:, 8], pos, cache)
        dk, _ = step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("[moe_path] decode step ran with no host sync (sync debug "
              "mode 'error')", flush=True)
        with ops.reference_mode():
            dp, _ = step()
        print(f"[moe_path] decode step logits vs plain: max|diff| "
              f"{(dk - dp).abs().max().item():.3e} of "
              f"{dp.abs().max().item():.3g}, argmax equal in "
              f"{int((dk.argmax(-1) == dp.argmax(-1)).sum())} of "
              f"{MOE_GEN_B} rows (reported; the per-layer checks hold "
              f"the kernels)", flush=True)
        step_ms = time_ms(torch, step, iters=5, warmup=1)
        all_ms = bound(0.0, step_bytes, "bfloat16")[0]
        active = cfg.param_count()[1] * 2
        act_ms = bound(0.0, active, "bfloat16")[0]
        print(f"[moe_path] decode step (B={MOE_GEN_B}): {step_ms:.3f} ms "
              f"(CUDA events); bound, every weight byte read once "
              f"({step_bytes / 1e9:.3f} GB, what the capacity-padded "
              f"experts read): {all_ms:.3f} ms; bound, the active "
              f"parameters only ({active / 1e9:.3f} GB): {act_ms:.3f} ms; "
              f"{card}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        profile_step(torch, step, n=2, what="moe decode")
        profile_step(torch, lambda: prefill(params, {"tokens": tokens}),
                     n=1, what="moe prefill")
    return {k: launches_p[k] + launches_g[k] for k in launches_p}


def profile_step(torch, step, n: int = 3, what: str = "decode") -> None:
    """Device time by kernel over ``n`` steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: an aten op's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kernels = sum(e.count for e in rows) / n
    print(f"[profile] {n} {what} steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {kernels:.0f} "
          f"device kernels and copies a step", flush=True)
    # the 12 largest rows, then every other row of the port's own kernels
    # (their symbols open with an anonymous namespace, PyTorch's name
    # at::), so each kernel's share of the step shows
    ours = ("(anonymous namespace)::", "void (anonymous namespace)::")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 12 or (e.key.startswith(ours) and "at::" not in e.key):
            print(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} "
                  f"ms/step  x{e.count // n:<4d} {e.key[:70]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # full-f32 yardsticks
    torch.backends.cudnn.allow_tf32 = False
    smi_line = phase_device(torch)
    phase_build()
    rec = phase_kernels(torch)
    serve, serve_per_slot = phase_path(torch, smi_line)
    torch.cuda.empty_cache()
    train = phase_train(torch)
    torch.cuda.empty_cache()
    stablelm_serve = phase_stablelm_path(torch, smi_line)
    torch.cuda.empty_cache()
    stablelm_train = phase_stablelm_train(torch, smi_line)
    torch.cuda.empty_cache()
    cmdr_serve = phase_cmdr_path(torch, smi_line)
    torch.cuda.empty_cache()
    ssm_serve = phase_ssm_path(torch)
    torch.cuda.empty_cache()
    ssm_train = phase_ssm_train(torch)
    torch.cuda.empty_cache()
    hybrid_serve = phase_hybrid_path(torch)
    torch.cuda.empty_cache()
    hybrid_train = phase_hybrid_train(torch)
    torch.cuda.empty_cache()
    moa = phase_moa_path(torch, rec)
    torch.cuda.empty_cache()
    moe_serve = phase_moe_path(torch, smi_line)

    src = "src/repro_torch/kernels/csrc/"
    head = {"K1": ("K1_gemm", src + "gemm.cu",
                   "src/repro/kernels/emit.py:148",
                   "K1 bfloat16 m=4 k=2048 n=256000 tb=1"),
            "K2": ("K2_flash_fwd", src + "flash_fwd.cu",
                   "src/repro/kernels/emit.py:269",
                   "K2 bfloat16 B=1 S=512 KV=1 G=8 hd=256 causal"),
            "K3": ("K3_flash_dq", src + "flash_bwd.cu",
                   "src/repro/kernels/emit.py:503",
                   "K3 bfloat16 B=2 S=512 KV=1 G=8 hd=256 causal"),
            "K4": ("K4_flash_dkv", src + "flash_bwd.cu",
                   "src/repro/kernels/emit.py:607",
                   "K4 bfloat16 B=2 S=512 KV=1 G=8 hd=256 causal"),
            "K5": ("K5_paged_decode", src + "paged_decode.cu",
                   "src/repro/kernels/emit.py:826",
                   next(s for s in rec["K5"] if "bfloat16" in s)),
            "K6": ("K6_ssd_scan", src + "ssd.cu",
                   "src/repro/kernels/emit.py:392",
                   f"K6 float32 B={SSM_B} S={SSM_S} q=256 h=48 p=64 n=128 "
                   f"export"),
            "K7": ("K7_ssd_bwd", src + "ssd.cu",
                   "src/repro/kernels/emit.py:717",
                   f"K7 float32 B={SSM_B} S={SSM_S} q=256 h=48 p=64 n=128"),
            "K8": ("K8_gated_scan", src + "gated_scan.cu",
                   "src/repro/kernels/emit.py:461",
                   f"K8 float32 B=1 S={HYB_S} w=4096"),
            "K9": ("K9_semiring", src + "semiring.cu",
                   "src/repro/kernels/emit.py:125",
                   f"K9 float32 max-plus {MOA_BIG}x{MOA_BIG}x{MOA_BIG}")}
    runs = {"path": serve, "path_per_slot": serve_per_slot, "train": train,
            "stablelm_path": stablelm_serve,
            "stablelm_train": stablelm_train, "cmdr_path": cmdr_serve,
            "ssm_path": ssm_serve,
            "ssm_train": ssm_train, "hybrid_path": hybrid_serve,
            "hybrid_train": hybrid_train, "moa_path": moa,
            "moe_path": moe_serve}
    kernels = []
    for kid, (name, source, replaces, shape) in head.items():
        # launches: the path runs', each counted from 0
        by_path = {k: run[kid] for k, run in runs.items()}
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            shape=shape, **rec[kid][shape]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
