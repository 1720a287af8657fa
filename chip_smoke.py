#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

    python3 chip_smoke.py

Five phases; any failure exits non-zero before the result line:

1. device   the card's name, power limit and compute capability (9, 0).
2. build    nvcc builds every kernel under src/repro_torch/kernels/csrc/
            into build/kernels/, all sources in parallel.
3. kernels  each kernel (K1 gemm with its VJP forms, K2 flash_fwd with
            and without its (m, l) export, K3/K4 flash_bwd, K5
            paged_decode) against its plain PyTorch version on the same
            card inputs, at gemma-2b full-width serving and training
            shapes, in bf16 and f32, with the tolerance stated; kernel,
            plain and library times (CUDA events) and the roofline bound
            of each case.
4. path     gemma-2b at full width (18 layers, bf16, random weights from a
            seeded generator) served by ServeEngine(max_slots=4,
            max_len=512) over 6 requests; every kernel of the path must
            have launched, K5 once per layer per decode iteration; one
            prefill and one batched decode step are recomputed through the
            plain versions and must agree.
5. train    gemma-2b at full width (bf16, seeded weights) takes 3 AdamW
            steps of make_train_step on SyntheticLM batches (B=2, S=512,
            seed 0), remat on; step 1's loss and gradients are first held
            against the plain path; every kernel of the path must have
            launched its derived number of times; the third step runs
            under sync debug mode "error"; one step is profiled.

The last two lines before the final one are the kernels' JSON record and
the card's ``nvidia-smi`` name and power limit; the final line is
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
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
TOL = {("K1", "bfloat16"): 1e-4, ("K1", "float32"): 1e-4,
       ("K2", "bfloat16"): 2e-2, ("K2", "float32"): 1e-4,
       ("K3", "bfloat16"): 2e-2, ("K3", "float32"): 1e-4,
       ("K4", "bfloat16"): 2e-2, ("K4", "float32"): 1e-4,
       ("K5", "bfloat16"): 2e-2, ("K5", "float32"): 1e-4}
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
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 512, 3


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
          nbytes, shape):
    """Hold ``kern`` against ``plain`` (each returns a tensor or a tuple
    of tensors, each part held to the tolerance relative to its own
    largest plain entry), time kernel, plain and library calls, and
    record the case under ``rec[name][shape]``."""
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
    b_ms, b_by = bound(flops, nbytes, dtype)
    ok = all(e <= tol * sc for e, sc in zip(errs, scales))
    print(f"[kernels] {shape}: max_abs_err={err:.3e} max_rel_err="
          f"{rel:.3e} (tol {tol:g} x max|plain|) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"{shape}: kernel disagrees with its plain version")
    rec.setdefault(name, {})[shape] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)


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
                      f"K1 {dname} m={m} k={k} n={n} tb={int(tb)}")
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
        page, pool_pages = 16, 4 * 32
        positions = [200, 37, -1, 511]
        perm = torch.randperm(pool_pages, generator=gen, device=dev)
        width = max(p // page + 1 for p in positions)
        tables = torch.zeros((4, width), dtype=torch.int32, device=dev)
        used = 0
        for i, p in enumerate(positions):
            n_pg = p // page + 1 if p >= 0 else 0
            tables[i, :n_pg] = perm[used:used + n_pg].int()
            used += n_pg
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        q = randn(4, 1, 8, 256)
        kp = randn(pool_pages * page, 1, 256)
        vp = randn(pool_pages * page, 1, 256)
        live_keys = sum(p + 1 for p in positions if p >= 0)
        args = dict(page=page, scale=256 ** -0.5)
        out = ops.paged_decode_batched(q, kp, vp, pos, tables, **args)
        require(bool((out[2] == 0).all()), "K5 dead slot row is not zero")
        _case(torch, rec, "K5", dname, ("K5", dname),
              lambda: ops.paged_decode_batched(q, kp, vp, pos, tables, **args),
              lambda: ref.paged_decode_batched(q, kp, vp, pos, tables,
                                               **args),
              None, 4.0 * live_keys * 8 * 256,
              live_keys * 2 * 256 * es + 4 * 8 * 256 * (es + 4) + 4 * 4
              + tables.numel() * 4,
              f"K5 {dname} slots=4 pos={positions} page={page} G=8 hd=256")
    _gemm_training_cases(torch, rec, gen)
    return rec


def _attention_training_cases(torch, rec, gen, dt, dname, es):
    """K2 with its (m, l) export, then K3 and K4, at the training shape:
    q (2, 512, 1, 8, 256), k/v (2, 512, 1, 256), m/l/delta (2, 1, 8,
    512).  The library yardstick of K3 and K4 is one pair: the backward
    alone of SDPA (enable_gqa) through torch.autograd.grad."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, g, hd = TRAIN_B, TRAIN_S, 8, 256
    scale = hd ** -0.5
    randn = lambda *shape: torch.randn(*shape, generator=gen,
                                       device="cuda").to(dt)
    q, k, v, do = (randn(b, s, 1, g, hd), randn(b, s, 1, hd),
                   randn(b, s, 1, hd), randn(b, s, 1, g, hd))
    pairs = b * g * s * (s + 1) // 2
    qkv_bytes = (2 * b * s * g + 2 * b * s) * hd * es
    stat_bytes = b * g * s * 4
    args = dict(scale=scale, causal=True, window=0)
    qs = q.reshape(b, s, g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    _case(torch, rec, "K2", dname, ("K2", dname),
          lambda: ops.attention_stats(q, k, v, **args),
          lambda: ref.attention_stats(q, k, v, **args),
          lambda: F.scaled_dot_product_attention(
              qs, ks, vs, is_causal=True, enable_gqa=True),
          4.0 * pairs * hd, (b * s * g * 2 + 2 * b * s) * hd * es
          + 2 * stat_bytes,
          f"K2 {dname} B={b} S={s} KV=1 G={g} hd={hd} causal export")
    out, m, l = ops.attention_stats(q, k, v, **args)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    bwd = (q, k, v, do, m, l, delta)
    qg = qs.detach().requires_grad_(True)
    kg = ks.detach().requires_grad_(True)
    vg = vs.detach().requires_grad_(True)
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        enable_gqa=True)
    dos = do.reshape(b, s, g, hd).transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), dos,
                                           retain_graph=True)
    _case(torch, rec, "K3", dname, ("K3", dname),
          lambda: ops.flash_dq(*bwd, **args),
          lambda: ref.flash_dq(*bwd, **args), sdpa_bwd,
          2.0 * 3 * pairs * hd, qkv_bytes + 3 * stat_bytes
          + b * s * g * hd * es,
          f"K3 {dname} B={b} S={s} KV=1 G={g} hd={hd} causal")
    _case(torch, rec, "K4", dname, ("K4", dname),
          lambda: ops.flash_dkv(*bwd, **args),
          lambda: ref.flash_dkv(*bwd, **args), sdpa_bwd,
          2.0 * 4 * pairs * hd, qkv_bytes + 3 * stat_bytes
          + 2 * b * s * hd * es,
          f"K4 {dname} B={b} S={s} KV=1 G={g} hd={hd} causal")


def _gemm_training_cases(torch, rec, gen):
    """K1 at the training step's T = 1024 rows: the bf16 forward products
    and the VJP forms, whose cotangent is f32 under bf16 weights and
    activations (mixed operands).  The library yardstick of a mixed
    product is torch.matmul on f32 copies of both operands, made outside
    the timed call."""
    from repro_torch.kernels import ops, ref
    t = TRAIN_B * TRAIN_S
    bf, f32 = torch.bfloat16, torch.float32
    randn = lambda *shape, dt=bf, sc=1.0: (torch.randn(
        *shape, generator=gen, device="cuda") * sc).to(dt)
    # (label, a shape, a dtype, b shape, b dtype, transpose_a, transpose_b)
    forms = []
    for k, n, tb in ((2048, 2048, False), (2048, 32768, False),
                     (16384, 2048, False), (2048, 256000, True)):
        forms.append(("fwd", (t, k), bf, (n, k) if tb else (k, n), bf,
                      False, tb))
    for k, n in ((2048, 2048), (2048, 32768), (16384, 2048)):
        # y = x w: dx = g w^T (transpose_b), dw = x^T g (transpose_a)
        forms.append(("dx", (t, n), f32, (k, n), bf, False, True))
        forms.append(("dw", (t, k), bf, (t, n), f32, True, False))
    # the tied head y = x table^T: dx = g table, dw = g^T x
    forms.append(("dx head", (t, 256000), f32, (256000, 2048), bf, False,
                  False))
    forms.append(("dw head", (t, 256000), f32, (t, 2048), bf, True, False))
    for label, ash, adt, bsh, bdt, ta, tb in forms:
        a = randn(*ash, dt=adt)
        b = randn(*bsh, dt=bdt, sc=ash[0 if ta else 1] ** -0.5)
        m, k = (ash[1], ash[0]) if ta else ash
        n = bsh[0] if tb else bsh[1]
        a32, b32 = a.float(), b.float()
        al = a32.t() if ta else a32
        bl = b32.t() if tb else b32
        mixed = adt != bdt
        # an f32 operand makes exact f32 products: their peak is f32's
        peak = "float32" if f32 in (adt, bdt) else "bfloat16"
        _case(torch, rec, "K1", peak, ("K1", "bfloat16"),
              lambda: ops._gemm(a, b, ta, tb),
              lambda: ref.matmul(a, b, tb, transpose_a=ta),
              (lambda: torch.matmul(al, bl)) if mixed else
              (lambda: torch.matmul(a.t() if ta else a, b.t() if tb else b)),
              2.0 * m * n * k,
              a.numel() * a.element_size() + b.numel() * b.element_size()
              + m * n * 4,
              f"K1 train {label} {str(adt)[6:]}x{str(bdt)[6:]} m={m} k={k} "
              f"n={n} ta={int(ta)} tb={int(tb)}")
        del a, b, a32, b32, al, bl


def phase_path(torch):
    import numpy as np
    from repro_torch.configs import gemma_2b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import PagePool, ServeEngine, pages_needed

    cfg = gemma_2b.full()
    t0 = time.perf_counter()
    params = transformer.init_lm(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[path] gemma-2b full width: {n_params / 1e9:.3f} B params bf16, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(32, 201))
                          ).tolist(), int(rng.integers(16, 33)))
            for _ in range(6)]
    print(f"[path] page={engine.page} (derived on the H100 table) "
          f"pool_pages={engine.pool.pool_pages} prompts="
          f"{[len(p) for p, _ in reqs]} max_new={[n for _, n in reqs]}",
          flush=True)

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0
    rids = [engine.submit(p, n, now=0.0) for p, n in reqs]
    iters, first_seen = 0, {}
    while not engine.idle:
        emitted = engine.step(clock())   # ends in the iteration's host read
        iters += 1
        for rid, _ in emitted:
            first_seen.setdefault(rid, clock())
    torch.cuda.synchronize()
    wall = clock()
    launches = dict(ops.LAUNCHES)
    results = engine.results()
    n_tok = sum(len(results[r]["tokens"]) for r in rids)
    ttft = [first_seen[r] for r in rids]      # all six submitted at t = 0
    decode_steps = engine.kernel_calls
    prefills = len(rids) + sum(results[r]["request"].evictions for r in rids)
    print(f"[path] {n_tok} tokens in {wall:.3f} s over {iters} iterations: "
          f"{n_tok / wall:.1f} tok/s; TTFT p50 {np.percentile(ttft, 50):.4f}"
          f" s max {max(ttft):.4f} s; decode steps {decode_steps}, prefills "
          f"{prefills}; launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    require(all(len(results[r]["tokens"]) == n for r, (_, n)
                in zip(rids, reqs)), "a request did not get max_new tokens")
    require(all(launches[k] > 0 for k in ("K1", "K2", "K5")),
            f"a kernel of the path never launched: {launches}")
    require(launches["K3"] == launches["K4"] == 0,
            f"serving launched a backward kernel: {launches}")
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

        pool = PagePool(cfg, 4 * pages_needed(512, engine.page),
                        engine.page, torch.bfloat16, "cuda")
        live = [0, 1, 3]                 # slot 2 is dead
        tables = torch.zeros((4, pages_needed(201, engine.page)),
                             dtype=torch.int32, device="cuda")
        toks, poss = [0] * 4, [-1] * 4
        for slot, (p, _) in zip(live, reqs):
            slabs = pool.alloc(pages_needed(len(p) + 1, engine.page))
            lgt, cache = transformer.prefill(
                params, cfg, torch.tensor([p], device="cuda"))
            pool.write_prefill(cache, slabs, len(p))
            tables[slot, :len(slabs)] = torch.tensor(slabs)
            toks[slot], poss[slot] = int(lgt[0].argmax()), len(p)
        toks = torch.tensor(toks, dtype=torch.int32, device="cuda")
        poss = torch.tensor(poss, dtype=torch.int32, device="cuda")
        pools_r = {k: t.clone() for k, t in pool.pools.items()}
        dk = transformer.decode_step_paged_batched(
            params, cfg, toks, poss, pool.pools, tables=tables,
            page=engine.page)
        with ops.reference_mode():
            dr = transformer.decode_step_paged_batched(
                params, cfg, toks, poss, pools_r, tables=tables,
                page=engine.page)
        dk, dr = dk[live], dr[live]
        err = (dk - dr).abs().max().item()
        scale = dr.abs().max().item()
        require(bool(torch.isfinite(dk).all()), "decode logits not finite")
        for key in ("k", "v"):
            a, b = pool.pools[key].float(), pools_r[key].float()
            require((a - b).abs().max().item() <= PATH_TOL * b.abs().max()
                    .item(), f"decode {key} pool writes disagree with plain")
        print(f"[path] batched decode logits {tuple(dk.shape)} (3 live "
              f"slots + 1 dead) vs plain: max_abs_err={err:.3e} (tol "
              f"{PATH_TOL:g} x {scale:.3g})", flush=True)
        require(err <= PATH_TOL * scale, "batched decode disagrees with plain")

        # one batched decode step (3 live slots + 1 dead) against its bound:
        # every weight byte read once (the tied table counted once)
        step = lambda: transformer.decode_step_paged_batched(
            params, cfg, toks, poss, pool.pools, tables=tables,
            page=engine.page)
        # the step reads nothing back to the host: any synchronizing call
        # inside it raises under the "error" sync debug mode
        step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("[path] decode step ran with no host sync (sync debug mode "
              "'error')", flush=True)
        step_ms = time_ms(torch, step)
        w_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        b_ms, _ = bound(0.0, w_bytes, "bfloat16")
        print(f"[path] decode step: {step_ms:.3f} ms; weight bytes "
              f"{w_bytes / 1e9:.3f} GB -> bound {b_ms:.3f} ms", flush=True)
        profile_step(torch, step)
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
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts

    cfg = gemma_2b.full()
    require(cfg.remat, "gemma-2b trains with remat on")
    params = transformer.init_lm(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        trainable=True)
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
    want = {"K1": n * (6 * L + 1 + 6 * L + 2 * (6 * L + 1)),
            "K2": n * 2 * L, "K3": n * L, "K4": n * L, "K5": 0}
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
    print(f"[profile] {n} {what} steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} ms/step"
              f"  x{e.count // n:<4d} {e.key[:70]}")


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
    serve = phase_path(torch)
    torch.cuda.empty_cache()
    train = phase_train(torch)

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
                   next(s for s in rec["K5"] if "bfloat16" in s))}
    kernels = []
    for kid, (name, source, replaces, shape) in head.items():
        # launches: the serving path's run plus the training path's
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=serve.get(kid, 0) + train[kid],
                            launches_serve=serve.get(kid, 0),
                            launches_train=train[kid],
                            shape=shape, **rec[kid][shape]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
