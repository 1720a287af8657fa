#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

    python3 chip_smoke.py

Twenty-seven phases; any failure exits non-zero before the result line:

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
            (ops.gemm_route; the FMA kernel's form and split of k), its
            device time in a CUDA graph (graph_ms), the time of the first
            wmma kernel (old_ms, bf16) or of the exact-f32 FMA kernel
            (fma_ms, other dtypes) on the same operands, and a rerun
            that must give the same bits; gemma-2b's six per-layer decode
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
            heads of 128, G = 1, S=2048).  K1's expert VJP forms (dx = g
            wᵀ, dw = xᵀ g, the f32 cotangent split into three bf16 parts)
            at deepseek's training products (cap 240: wi, wo) and on the
            ragged stack, each with torch.bmm on f32 copies and a rerun;
            K2 (export), K3, K4 at its training attention (B=1 S=2048);
            K2 at llama4-scout-17b-a16e's prefill (8 KV heads of 128, G =
            5, S=2048), windowed 8192 and causal.  K1's exact-f32 FMA
            kernel at the MoE routers (deepseek's (t, 2048) x (2048, 64)
            and its dw VJP, llama4's (t, 5120) x (5120, 16); torch.matmul
            in f32 the library row), at a ragged f32 product (1001 x 999
            x 37, its k split), and a mixed product whose f32 operand's
            row (515) TMA cannot read, on the split route through its
            pitched parts.  K1's head form (ops.head_matmul) at
            minicpm3-4b's absorbed decode products (m = 1, 2, 4 rows over
            40 heads on the decode rows, 64 rows on the head tile, strided
            views of one stored wkv_b table; torch.einsum on the same
            views the library row, by events and, at 64 rows, in a CUDA
            graph beside the tile's, with head_matmul's events time and
            its one K1 launch; a rerun), and a head form K1 refuses
            (float16 at 64 rows) on K9; K2 (prefill and export), K3, K4 at
            minicpm3-4b's MLA attention (B=1 S=4096, 40 KV heads of one
            query head) at its own widths, q.k 96 and v 64, and the same
            work zero-padded to 128 beside it (SDPA on the unpadded
            tensors the library row, the unpadded work's bound beside the
            padded one's); (96, 64) also at a ragged length, G = 8, the
            window and prefix-LM forms and in f32 (the FMA form).  K2-K4's
            prefix-LM form at paligemma-3b's prefill (B=1 S=4096, one KV head of 256 under
            8 query heads, prefix 256; K2 alone and with export, K3, K4)
            and training microbatch (B=1, 256 + 768 positions), and in
            f32 at a ragged shape (S=1000, prefix 100), SDPA with the
            boolean mask the library row; their bidirectional form at
            whisper-base's encoder (B=4, 1500 frames, 8 KV heads of 64)
            and cross-attention (448 rows over 1500), SDPA without a
            mask; K1 at paligemma's adapter and 257216-row head (and its
            VJP forms), and at whisper's products and 51865-row head,
            whose VJP forms take the split route through the f32
            cotangent's pitched bf16 parts.
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
5a. remat_dots gemma-2b at train's shape (B=2, S=512, full width and
            depth, its first batch), forward and backward under remat
            "full", off and "dots": K1-K4 launches and peak memory above
            the parameters for each ("dots" also its memo's bytes), then
            the three in turn over 6 rounds (ms, min / median / max) and
            one profiled step each (device busy); "dots" launches K1 as often as
            off and "full" 18 x one layer's forward products more, and
            "dots"' loss and gradients equal "full"'s within LOSS_TOL /
            GRAD_TOL (bit for bit or not, printed); peaks full <= dots <=
            off.
5b. launch_path the launchers at full width: launch.train.main on
            gemma-2b (B=2, S=512, 3 steps) without and with
            --compress-grads (derived launches; step 1's loss equal; each
            step's host seconds, compress_grads' ms and peak a step, and
            at step 2 three leaves, a 2^26 + 768-element slice of wi
            among them, compressed on the card equal to the same function
            on CPU copies bit for bit); whisper-base 4 steps straight
            against 2 steps and a resume to 4 (checkpoints every 2 under
            build/smoke_ckpt, removed after): the step-4 checkpoints
            equal leaf for leaf, save / save_async / restore seconds and
            the GB on disk (save timed alone, save_async's snapshot apart
            from its wait on the earlier write); launch.serve.main on
            gemma-2b, 4 requests of 16 + 32 tokens, then twice 32
            requests of 128 + 32 tokens over 8 slots: tokens/s a call,
            K5 launches (18 x the decode iterations).
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
            user entries: moa_gemm at 4096^3 (bf16, f32 and f16, the f16
            pair on K1's tile route by f16 wgmma; K1), max-plus and
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
            a 6-axis kron (MAP), A[i,a,b,c,d] B[d,c,b,a,j] over 4 contracted
            axes that do not merge (TILE over the flattened K; (mul, add)
            through apply, max-plus through K9's wrapper, as apply's
            schedule derivation refuses that nest), float16 max-plus (K9),
            examples/kron_compress.py at 64x64 (x) 64x64 (kron on K9's
            MAP, as the 6-axis kron, each beside torch.kron in a CUDA
            graph too; the
            compressed apply on two K1 products, |Wx - vec(B X A^T)| <=
            1e-3).  K1 and K9 launch their derived counts; one apply runs
            under sync debug mode "error"; each case prints kernel, plain
            and library ms (CUDA events), the bound and the error.
14. derive_path the derivation on the H100 table: mamba2-780m at full
            width and depth with ssm_chunk = 0 (the SSD chunk derived by
            ops.default_ssd_chunk, 16 expected) serves ssm_path's 6
            prompts and, depth cut to 12 of 48 layers, takes train steps
            at B=2 S=2048 (derived launches;
            prefill, decode, loss and gradients held to the pinned chunk
            256 with ssm_path's and ssm_train's tolerances; step ms and
            peak memory at each chunk; the derived chunk's step profiled
            by kernel; K6 / K7 at both chunks on the same operands, from
            the kernels rows); recurrentgemma-9b's derived gated chunk
            (16 expected; hybrid_path's K8 ran at it) beside chunk 64,
            each K8 row bound by the scan's own bytes, its workspace
            traffic printed beside it; ops.apply(verify=True) and verify="kernel" on every
            expression moa_path applied (0 error findings, the second call
            a verification-cache hit, host us); verify_all's H100 summary;
            K1's int8 tile (apply with acc_dtype int32; an operand
            8-bit wgmma cannot read in place packed K-major first):
            4096^3 with B stored (k, n) and (n, k), bit for bit with its
            plain version, K1's mma.sync int8 form and torch._int_mm on
            the same storage (ms, graph ms, the pack's share, the 1979
            TOPS bound), a ragged 1001x37x999 and e = 16 stacks of 1024^3
            with w stored (e, n, k) and (e, k, n); the int8 head form
            (minicpm3-4b's q_lat at 1 / 2 / 4 rows, out at 4) on K1's
            int8 decode rows beside K9 on the same operands; K9's int8
            Hadamard, lone sum and chain.
15. energy_path the paper's energy model against the card's own energy
            counter (NVML's total energy through ctypes; nvidia-smi's
            power.draw sampled and integrated where NVML refuses): idle
            power over 1 s, then square products at N = 1024 .. 8192 in
            three families, moa_gemm bf16 (K1, B row-major), the same
            product with a col-layout B through apply, and max-plus f32
            on K9, and beside them torch.matmul on the bf16 operands (the
            library row), each over >= 1 s of CUDA-graph replays: ms, J
            (total and above idle), mean W and the bound a product (bf16
            at 989 TFLOP/s, max-plus by k9_bound), the model's ms, J, W
            and bound beside the bf16 rows, the slopes log2(E(2N)/E(N))
            and the power and time ratios; each family's 1024 product
            against its plain version.
16. moe_path deepseek-moe-16b at full width and depth (28 layers: one
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
17. moe_train deepseek-moe-16b at full width, depth cut to 5 of 28 layers
            (the dense one and 4 MoE layers, 2.857 B parameters; the whole
            model's AdamW state, ~260 GB, fits no card): step 1 (its first
            microbatch) against the plain path: the loss with each path's
            own routing (the routings that differ counted), the loss and
            every gradient leaf with the plain routing held on both paths,
            each MoE layer's output and gradients on the plain path's
            input, routing held, and one layer's rerun bit for bit; then 3
            AdamW steps at B=2 S=2048 in 2 microbatches (cap 240), remat
            on: K1 (its expert form and VJP forms), K2-K4 launch their
            derived counts, step 3 under sync debug mode "error", step ms
            against its bound, peak memory under 80 GB, a profiled step.
18. llama4_path llama4-scout-17b-a16e at full width (40 heads over 8 KV
            heads of 128, 16 experts of 8192, top-1, 1 shared, vocab
            202048 untied), depth cut to 8 of 48 layers (two (local,
            local, local, full) groups, 19.69 B parameters, 39.4 GB): its
            make_prefill B=1 S=2048 (K1, the expert tile at cap 160, K2:
            the local layers' window 8192 cuts nothing at S = 2048, so
            every layer's attention is causal) and the rest of moe_path's
            steps (the same code); then one local layer's
            decode from a seeded 8192-slot ring at position 9000 (the ring
            has wrapped) against the plain path.
19. mla_path minicpm3-4b at full width and depth (62 layers of MLA, 40
            heads, q rank 768, kv rank 256; 4.26 B seeded parameters):
            make_prefill B=1 S=4096 (K1 7L+1, K2 L on MLA's attention at
            its widths, q.k 96 and v 64, read from the launches' own
            arguments) against its bound; 6 requests through ServeEngine
            over contiguous per-slot latent caches (tokens/s, TTFT;
            K1 8L+1 a slot-step, 2L of them the head form, counted by a
            spy on ops._head_gemm); greedy_generate B=2, 64 + 16; the
            prefill's logits and MLACache and one decode step against the
            plain path (f32 on the same weights at full depth, bf16 beside
            the plain bf16 witness); a B=2 decode step under sync debug
            mode "error" against every weight byte; a B=32 make_decode
            step from a prefill cache (its absorbed products on K1's head
            tile: 2L head-tile launches, no K9; its logits held as the
            agreement's, f32 and bf16 beside the witness) against every
            weight byte and its cache; profiles.
20. mla_train minicpm3-4b at full width, depth cut to 24 of 62 layers
            (1.88 B parameters): step 1's first microbatch against the
            plain path (loss and every gradient, f32 and bf16), 3 AdamW
            steps at B=2 S=4096 in 2 microbatches, remat on (K1, K2-K4 at
            (96, 64), derived counts), step 3 under sync debug
            "error", peak memory, a profiled step.
21. vlm_path paligemma-3b at full width and depth (18 layers, 2.509 B
            seeded parameters): make_prefill B=1 over 256 patches + 3840
            tokens (K1 6L+2, K2 L, every K2 launch with prefix 256, read
            from the kernel's own arguments) against its bound; patches
            0 and 1 swapped must move position 0's hidden state (the
            prefix is live); the prefill's logits and K/V and a decode
            step against the plain path (f32 at full depth, bf16 beside
            the plain bf16 witness); greedy_generate B=2, 64 + 16 token
            by token (the reference's path); a decode step under sync
            debug "error" against every weight byte; profiles.
22. vlm_train paligemma-3b at full width and depth: step 1's first
            microbatch against the plain path (f32 and bf16), 3 AdamW
            steps at B=2 of 256 patches + 768 tokens in 2 microbatches,
            remat on (K1 24L+5 a microbatch, K2-K4 with prefix 256),
            step 3 under sync debug "error", peak memory, a profile.
23. encdec_path whisper-base at full width and depth (6 + 6 layers, 67.4
            M): make_prefill B=4 over 1500 frames + 64 tokens (K1
            6E+12L+2; K2 bidirectional in the encoder and the
            cross-attention, causal in the decoder), 64 make_decode
            steps from init_cache with the prefill's cross K/V,
            greedy_generate B=4, 8 + 32, the prefill's logits, self and
            cross K/V and a decode step against the plain path (f32 and
            bf16), a decode step under sync debug "error", profiles.
24. encdec_train whisper-base: step 1's first microbatch against the
            plain path (the key biases' vanishing gradients held against
            their value biases'), 3 AdamW steps at B=8 of 1500 frames +
            448 tokens in 4 microbatches (K1 24E+40L+5 a microbatch,
            K2-K4 bidirectional and causal as derived), step 3 under
            sync debug "error", peak memory, a profile.
25. dist_path the distributed layer.  (a) A world of 1 over NCCL in
            this process, mesh (1, 1): gemma-2b at full width and depth,
            prefill B=2 S=512 and 32 greedy tokens under planned_mesh,
            bit for bit and launch for launch against the unplanned
            path; deepseek-moe-16b's MoE layer (64 experts, S=2048)
            through _apply_moe_shardmap against _apply_moe_global (the
            same routings, within PATH_TOL).  (b) 4 spawned ranks sharing
            the card over gloo (not a multi-card measurement), held to
            this process's results: ops.apply(mesh=) at 4096^3 bf16 for
            K1's six plans (row, col, sigma, both, gather, scatter) and
            K9's max-plus with its rows sharded (bit for bit where no
            sigma is sharded and the per-shard route is the single
            product's; each row's per-shard ms and bound, the plain
            version's and torch.matmul's ms at the per-shard shape,
            collective ms and the single-device ms); gemma-2b
            tensor-parallel over model = 4 at full width and depth, the
            same 32 tokens; deepseek-moe-16b (2 of 28 layers, 16
            experts a rank) expert-parallel, prefill B=1 S=2048, 0
            routings differing on the single process's input to the MoE
            layer, at most DIST_ROUTE_E2E_MAX end to end; the sharded
            train step of gemma-2b (4 of 18 layers) on (data 2, model
            2), 2 steps against one process's (the loss; after each
            step AdamW's m, v and update, DIST_CLEAR); whisper-
            base's sharded state saved at (2, 2) and restored at (4, 1)
            and in one process bit for bit.  Each rank's peak memory,
            step and collective ms and K1 / K9 launches.

Each path phase resets the peak memory statistics before it runs.  The
last two lines before the final one are the kernels' JSON record and
the card's ``nvidia-smi`` name and power limit; the final line is
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
import contextlib
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

#: the smoke's start: its whole wall time, the build included, is printed
#: before the result line
START = time.perf_counter()
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
#: K9 bf16 (mul, add): bf16 products are exact in f32 on both sides; the
#: sums differ in order only (moa_path's MOA_SUM_TOL).  K9 float16: a
#: float16 x bf16 product is exact in f32 too (11 + 8 significant bits).
#: K1 float16 (the tile route's f16 wgmma): as bf16, each f16 x f16
#: product is exact in f32 (11-bit significands make 22 bits) on both
#: sides, so the sums differ in order and in the tensor cores' truncated
#: adds, which gemm.cu bounds past 8192 terms by promoting each stage.
TOL = {("K1", "bfloat16"): 1e-4, ("K1", "float32"): 1e-4,
       ("K1", "float16"): 1e-4,
       ("K2", "bfloat16"): 2e-2, ("K2", "float32"): 1e-4,
       ("K3", "bfloat16"): 2e-2, ("K3", "float32"): 1e-4,
       ("K4", "bfloat16"): 2e-2, ("K4", "float32"): 1e-4,
       ("K5", "bfloat16"): 2e-2, ("K5", "float32"): 1e-4,
       ("K6", "float32"): 1e-4, ("K7", "float32"): 1e-4,
       ("K8", "float32"): 1e-6,
       ("K9", "bfloat16"): 1e-4, ("K9", "float16"): 1e-4}
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
#: the MoE serving phases (deepseek-moe-16b, llama4-scout-17b-a16e): the
#: prefill sequence, and greedy_generate's batch, prompt, new tokens and
#: cache length
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
#: K1's expert VJP forms at deepseek-moe-16b's training products (one
#: 2048-token microbatch: cap 240; wi (64, 2048, 2816), wo (64, 1408,
#: 2048)) and at the ragged stack: (name, e, cap, d, f) of the forward
#: x (e, cap, d) @ w (e, d, f) whose dx = g wᵀ and dw = xᵀ g are timed
MOE_VJP_CASES = (("wi", 64, 240, 2048, 2816), ("wo", 64, 240, 1408, 2048),
                 ("ragged", 8, 24, 200, 136))
#: deepseek-moe-16b's training run: depth cut to 5 of 28 layers (the
#: dense one and 4 MoE layers: 2.857 B parameters, ~57 GB of parameters,
#: masters, moments, gradients and f32 accumulators; the full model's
#: AdamW state, ~260 GB, fits no card), B=2 S=2048 in 2 microbatches
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_MB = 5, 2, 2048, 2
#: llama4-scout-17b-a16e at full width, depth cut to 8 of 48 layers (two
#: (local, local, local, full) groups: 19.69 B parameters, 39.4 GB in
#: bf16; the whole model's ~216 GB fits no card), and the position of
#: the wrapped-ring decode check (its ring is the window, 8192 slots)
LLAMA4_LAYERS = 8
LLAMA4_RING_POS = 9000
#: minicpm3-4b (MLA): the prefill and training sequence (the reference's
#: chunked-branch length, attn_chunk_min_seq), the absorbed decode's K1
#: head-form rows (1-4 slots), MLA's attention widths (q.k 96, v 64), a
#: pair K2-K4 are built for, and the training run: depth cut to 24
#: of 62 layers (1.880 B parameters by param_count, ~34 GB of AdamW
#: state; the whole model's ~77 GB leaves no room for activations), B=2
#: in 2 microbatches
MLA_S = 4096
MLA_HEAD_ROWS = (1, 2, 4)
#: the head form's tile rows in [kernels] (MLA's decode at B = 64) and the
#: decode batch of [mla_path]'s second timed step (past K1_DECODE_ROWS:
#: its absorbed products on the head tile)
MLA_TILE_ROWS, MLA_TILE_B = 64, 32
#: the float16 head form on the head tile in [kernels]: (rows, product)
F16_HEAD_CASES = ((MLA_TILE_ROWS, "q_lat"), (MLA_TILE_ROWS, "out"),
                  (4, "q_lat"))
MLA_WIDTHS = (96, 64)
MLA_TRAIN_LAYERS, MLA_TRAIN_B, MLA_TRAIN_MB = 24, 2, 2
#: paligemma-3b (vlm): the prefill is the reference's 4k budget, its 256
#: patches and the text behind them (src/repro/models/registry.py:81,
#: :88-91); the training batch: 2 sequences of 256 patches + 768 text
#: tokens (1024 positions) in 2 microbatches
VLM_S = 4096
VLM_TRAIN_B, VLM_TRAIN_TEXT, VLM_TRAIN_MB = 2, 768, 2
#: whisper-base (enc-dec): make_prefill at B=4 over its 1500 frames with
#: a 64-token decoder prompt; 64 make_decode steps from position 0 over
#: init_cache(4, 448) (448: its decoder context) holding the prefill's
#: cross K/V; greedy_generate at B=4, 8 + 32 tokens; training B=8 of 1500
#: frames and 448 tokens in its 4 microbatches (cfg.train_microbatches)
ENC_B, ENC_PROMPT, ENC_DECODE, ENC_CACHE = 4, 64, 64, 448
ENC_GEN_PROMPT, ENC_GEN_NEW = 8, 32
ENC_TRAIN_B, ENC_TRAIN_S = 8, 448


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


#: a plain version slower than this (ms a call: a Python loop over the
#: steps of a scan) is timed over 2 calls, not 10 after 3 warm-up calls
SLOW_PLAIN_MS = 50.0


def plain_time_ms(torch, fn) -> float:
    """``time_ms`` of a plain version, over fewer calls where one call
    takes ``SLOW_PLAIN_MS`` or more."""
    first = time_ms(torch, fn, iters=1, warmup=0)
    if first < SLOW_PLAIN_MS:
        return time_ms(torch, fn)
    return time_ms(torch, fn, iters=2, warmup=0)


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
    ms, plain_ms = time_ms(torch, kern), plain_time_ms(torch, plain)
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
    decode path's split of k, the FMA kernel's form and split of k, and
    whether a split operand's parts are pitched (its row no multiple of
    8)."""
    route = ops._route(a, b, ta, tb)
    k, m = a.shape if ta else a.shape[::-1]
    n = b.shape[0] if tb else b.shape[1]
    if route == "gemv":
        return f"gemv split-k={ops.gemv_splits(m, n, k)}"
    if route == "fma":
        f32 = a.element_size() == b.element_size() == 4
        return (f"fma form={ops.fma_form(m, n, ta, f32)} split-k="
                f"{ops.fma_splits(m, n, k, ta, tb, f32)}")
    if route == "split":
        f = a if a.element_size() == 4 else b
        return "split pitched" if f.shape[-1] % 8 else "split"
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
    """K1's route; (``old``) the time of the kernels TMA-less operands take
    on the same operands (``repro_gemm``: the first ``gemm_bf16`` for bf16 x
    bf16 without transpose_a, ``old_ms``; else the exact-f32 FMA kernel,
    ``fma_ms``, in its own form and split): the same call's before-and-
    after on this card; and (``call``, the timed entry) its device time in
    a CUDA graph."""
    extra = {"path": _route(ops, a, b, ta, tb)}
    if call is not None:
        extra["graph_ms"] = graph_ms(torch, call)
    if old:
        k, m = a.shape if ta else a.shape[::-1]
        n = b.shape[0] if tb else b.shape[1]
        out = torch.empty((m, n), device=a.device, dtype=torch.float32)
        wmma = a.dtype == b.dtype == torch.bfloat16 and not ta
        form, nsplit, ws = ops._fma_plan(a, b, m, n, k, ta, tb,
                                         "wmma" if wmma else "fma")
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, int(ta),
                int(tb), ops._DTYPE_CODE[a.dtype], ops._DTYPE_CODE[b.dtype],
                int(ops._aligned16(a, m if ta else k)),
                int(ops._aligned16(b, k if tb else n)), form, nsplit)
        extra["old_ms" if wmma else "fma_ms"] = time_ms(
            torch, lambda: ops._launch("repro_gemm", *args))
        del out, ws
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
    _expert_vjp_cases(torch, rec, gen)
    # deepseek-moe-16b's training attention (one microbatch): K2 with its
    # export, K3, K4 at 16 KV heads of 128, G = 1
    _attention_training_cases(torch, rec, gen, torch.bfloat16, "bfloat16",
                              2, b=1, s=MOE_TRAIN_S, g=1, kv=16, hd=128)
    # llama4-scout-17b-a16e's prefill: 8 KV heads of 128, G = 5, the call
    # its local layers make (window 8192 cuts nothing at S = 2048: the
    # causal function, with the window's checks run) and its full layers'
    for window in (8192, 0):
        _prefill_attention_case(torch, rec, gen, torch.bfloat16, MOE_S,
                                kv=8, g=5, hd=128, window=window)
    _router_cases(torch, rec, gen)
    _fma_cases(torch, rec, gen)
    _head_form_cases(torch, rec, gen)
    _mla_width_cases(torch, rec, gen)
    _vlm_encdec_cases(torch, rec, gen)
    _shard_cases(torch, rec, gen)
    return rec


def _mla_width_cases(torch, rec, gen):
    """K2-K4 at MLA's widths, q.k 96 and v 64, as they take them:
    minicpm3-4b's attention at its chunked-branch length (B=1 S=4096, 40
    KV heads of one query head, MLA's scale): the prefill's K2, then K2
    (export), K3, K4 in training; beside them the same work zero-padded to
    128 (the form K2-K4 ran MLA at before they took vd apart from hd).
    Then (96, 64) at a ragged length (B=2 S=300), G > 1 (8 query heads a
    KV head), the window and prefix-LM forms, and the f32 FMA form."""
    bf, f32 = torch.bfloat16, torch.float32
    qk, vd = MLA_WIDTHS
    _prefill_attention_case(torch, rec, gen, bf, MLA_S, kv=40, g=1, hd=qk,
                            vd=vd)
    _attention_training_cases(torch, rec, gen, bf, "bfloat16", 2, b=1,
                              s=MLA_S, g=1, kv=40, hd=qk, vd=vd)
    _prefill_attention_case(torch, rec, gen, bf, MLA_S, kv=40, g=1, hd=128,
                            native=MLA_WIDTHS)
    _attention_training_cases(torch, rec, gen, bf, "bfloat16", 2, b=1,
                              s=MLA_S, g=1, kv=40, hd=128,
                              native=MLA_WIDTHS)
    for dt, kw in ((bf, dict(b=2, s=300, kv=40, g=1)),
                   (bf, dict(b=1, s=2048, kv=4, g=8)),
                   (bf, dict(b=1, s=4096, kv=8, g=2, window=1024)),
                   (bf, dict(b=1, s=1024, kv=2, g=4, prefix=256)),
                   (f32, dict(b=1, s=1000, kv=4, g=2))):
        _attention_training_cases(torch, rec, gen, dt,
                                  str(dt).removeprefix("torch."),
                                  dt.itemsize, hd=qk, vd=vd, **kw)


def _vlm_encdec_cases(torch, rec, gen):
    """K2-K4's prefix-LM form at paligemma-3b's shapes (one KV head of 256
    under 8 query heads, 256 patches): the prefill's K2 at S=4096, K2
    (export), K3, K4 there and at a training microbatch (B=1, 256 + 768
    positions), and an f32 case at a ragged shape (S=1000, prefix 100: no
    multiple of any tile, past the 64-key tile).  The bidirectional form
    at whisper-base's encoder (B=4, 1500 frames, 8 KV heads of 64, G = 1)
    and cross-attention (448 decoder rows over 1500 encoder rows), SDPA
    without a mask the library row.  K1 at paligemma's adapter and tied
    257216-row head (with its training VJP forms), and at whisper's
    products and its tied 51865-row head with the VJP forms: the f32
    cotangent's stored row of 51865 (no multiple of 8) is read through its
    three bf16 parts, written at a pitch of 51872 (the split route)."""
    from repro_torch.configs import paligemma_3b, whisper_base
    bf, f32 = torch.bfloat16, torch.float32
    vcfg, wcfg = paligemma_3b.full(), whisper_base.full()
    p, d, hd = vcfg.num_patches, vcfg.d_model, vcfg.head_dim_
    heads = dict(kv=vcfg.n_kv_heads, g=vcfg.n_heads // vcfg.n_kv_heads,
                 hd=hd)
    _prefill_attention_case(torch, rec, gen, bf, VLM_S, prefix=p, **heads)
    for s in (VLM_S, p + VLM_TRAIN_TEXT):
        _attention_training_cases(torch, rec, gen, bf, "bfloat16", 2, b=1,
                                  s=s, prefix=p, **heads)
    _attention_training_cases(torch, rec, gen, f32, "float32", 4, b=1,
                              s=1000, g=8, kv=1, hd=256, prefix=100)
    enc, wd, mb = wcfg.encoder_seq, wcfg.d_model, wcfg.train_microbatches
    wheads = dict(kv=wcfg.n_kv_heads, g=wcfg.n_heads // wcfg.n_kv_heads,
                  hd=wcfg.head_dim_)
    for sq in (enc, ENC_TRAIN_S):
        _prefill_attention_case(torch, rec, gen, bf, sq, b=ENC_B,
                                causal=False, sk=enc, **wheads)
        _attention_training_cases(torch, rec, gen, bf, "bfloat16", 2,
                                  b=ENC_B, s=sq, causal=False, sk=enc,
                                  **wheads)
    _gemm_forms(torch, rec, gen, "K1 paligemma serve",
                [("fwd adapter", (p, d), bf, (d, d), bf, False, False),
                 ("fwd head", (2, d), bf, (vcfg.vocab_size, d), bf, False,
                  True)])
    _gemm_training_cases(torch, rec, gen, "paligemma ", VLM_TRAIN_TEXT, (),
                         (d, vcfg.vocab_size))
    wf = wcfg.d_ff
    _gemm_forms(torch, rec, gen, "K1 whisper serve",
                [("fwd adapter", (ENC_B * enc, wd), bf, (wd, wd), bf, False,
                  False),
                 ("fwd mlp", (ENC_B * enc, wd), bf, (wd, wf), bf, False,
                  False),
                 ("fwd head", (ENC_B, wd), bf, (wcfg.vocab_size, wd), bf,
                  False, True)])
    _gemm_training_cases(torch, rec, gen, "whisper ",
                         ENC_TRAIN_B // mb * ENC_TRAIN_S,
                         ((wd, wd), (wd, wf), (wf, wd)),
                         (wd, wcfg.vocab_size))


def _router_cases(torch, rec, gen):
    """K1's f32 FMA kernel at the MoE routers (f32 x f32): deepseek-moe-16b's
    (t, 2048) x (2048, 64) and llama4-scout-17b-a16e's (t, 5120) x (5120,
    16), at a 2048-token prefill and at the 2 rows of a decode step, and
    deepseek's dw = x^T g VJP at 2048 tokens; torch.matmul in f32 (TF32
    off) is the library row, timed by events and in a CUDA graph."""
    f32 = torch.float32
    forms = [(f"{name} fwd", (t, d), f32, (d, e), f32, False, False)
             for name, d, e in (("deepseek", 2048, 64), ("llama4", 5120, 16))
             for t in (MOE_S, MOE_GEN_B)]
    forms.append(("deepseek dw", (MOE_S, 2048), f32, (MOE_S, 64), f32, True,
                  False))
    _gemm_forms(torch, rec, gen, "K1 router", forms, lib_graph=True)


def _fma_cases(torch, rec, gen):
    """K1's exact-f32 FMA kernel at a ragged f32 product (m, n and k odd,
    no multiple of any tile or k-step, its k split), and a mixed product
    whose f32 operand's stored row (515) TMA cannot read, on the split
    route through its pitched bf16 parts; torch.matmul on f32 operands the
    library row."""
    f32, bf = torch.float32, torch.bfloat16
    _gemm_forms(torch, rec, gen, "K1 ragged", [
        ("f32", (1001, 999), f32, (999, 37), f32, False, False)],
        lib_graph=True)
    _gemm_forms(torch, rec, gen, "K1 ragged", [
        ("mixed pitched", (333, 515), f32, (515, 136), bf, False, False)])


def _head_form_cases(torch, rec, gen):
    """K1's head form (``ops._head_gemm``, the launch ``ops.head_matmul``
    makes) at minicpm3-4b's absorbed decode products over 40 heads, each
    weight a strided view of one stored (256, 40, 128) ``wkv_b`` table:
    ``q_lat = q_nope w_uk^T`` (q_nope the first 64 of each head's 96
    columns, w_uk the table's first 64: k 64, n 256, ``transpose_b``) and
    ``out = ctx w_uv`` (w_uv its last 64: k 256, n 64).  At
    ``MLA_HEAD_ROWS`` rows on the decode rows, at ``MLA_TILE_ROWS`` on the
    head tile (where ``ops.head_matmul`` makes one K1 launch and no K9,
    timed by events beside the kernel's CUDA-graph time and
    ``torch.einsum``'s).  Each is held to ``ref.head_gemm``, with its
    route, its CUDA-graph time, ``torch.einsum`` on the same views as the
    library row, its bound (bytes) and a rerun that must give the same
    bits.  Then the float16 form (``F16_HEAD_CASES``: q_lat and out at
    ``MLA_TILE_ROWS``, q_lat at 4 rows, on a float16 copy of the table)
    on the head tile at every row count: one K1 launch and no K9 through
    ``ops.head_matmul``, its CUDA-graph time beside ``torch.einsum``'s,
    ``head_matmul``'s time by events.  Last a form K1 refuses (a float16
    activation against the bf16 table at ``MLA_TILE_ROWS``) lands on K9,
    one launch, and matches the plain version."""
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    table = (randn(256, 40, 128) * 256 ** -0.5).to(bf)
    for m in MLA_HEAD_ROWS + (MLA_TILE_ROWS,):
        q, ctx = randn(m, 40, 96).to(bf), randn(m, 40, 256).to(bf)
        for name, x, w, tb in (("q_lat", q[..., :64], table[..., :64], True),
                               ("out", ctx, table[..., 64:], False)):
            k = x.shape[-1]
            n = w.shape[0] if tb else w.shape[2]
            eq = "mhk,nhk->hmn" if tb else "mhk,khn->hmn"
            route = ops.head_route(40, m, k, n, bf, bf, tb,
                                   ops.head_aligned(x, w))
            flops = 2.0 * m * 40 * n * k
            nbytes = (x.numel() + w.numel()) * 2 + 40 * m * n * 4
            shape = (f"K1 bfloat16 head {name} m={m} h=40 k={k} n={n} "
                     f"tb={int(tb)}")
            call = lambda: ops._head_gemm(x, w, tb)
            library = lambda: torch.einsum(eq, x, w)
            if m <= ops.K1_DECODE_ROWS:
                require(route == "gemv", f"{shape}: route {route}, not gemv")
                extra = {"path": f"head gemv split-k="
                                 f"{ops.gemv_splits(m, n, k, 40)}",
                         "graph_ms": graph_ms(torch, call)}
            else:
                require(route == "tile", f"{shape}: route {route}, not tile")
                user = lambda: ops.head_matmul(x[:, None], w,
                                               transpose_b=tb,
                                               out_dtype=torch.float32)
                ops.reset_launches()
                user()
                torch.cuda.synchronize()
                require(ops.LAUNCHES["K1"] == 1 and ops.LAUNCHES["K9"] == 0,
                        f"{shape}: head_matmul launches {ops.LAUNCHES}, not "
                        f"one K1")
                extra = {"path": "head tile",
                         "graph_ms": graph_ms(torch, call),
                         "library_graph_ms": graph_ms(torch, library),
                         "head_matmul_ms": time_ms(torch, user)}
            _case(torch, rec, "K1", "bfloat16", ("K1", "bfloat16"), call,
                  lambda: ref.head_gemm(x, w, tb), library, flops, nbytes,
                  shape, extra)
            _rerun_equal(torch, call, f"K1 head {name} m={m}")
    # float16 x float16 on the head tile (float16 maps, f16 wgmma) at
    # every row count: K1 has no float16 decode-row kernel
    f16 = torch.float16
    table16 = table.to(f16)
    for m, name in F16_HEAD_CASES:
        tb = name == "q_lat"
        x, w = (randn(m, 40, 96).to(f16)[..., :64], table16[..., :64]) \
            if tb else (randn(m, 40, 256).to(f16), table16[..., 64:])
        k, n = x.shape[-1], 256 if tb else 64
        eq = "mhk,nhk->hmn" if tb else "mhk,khn->hmn"
        shape = (f"K1 float16 head {name} m={m} h=40 k={k} n={n} "
                 f"tb={int(tb)}")
        route = ops.head_route(40, m, k, n, f16, f16, tb,
                               ops.head_aligned(x, w))
        require(route == "tile", f"{shape}: route {route}, not tile")
        user = lambda: ops.head_matmul(x[:, None], w, transpose_b=tb,
                                       out_dtype=torch.float32)
        ops.reset_launches()
        user()
        torch.cuda.synchronize()
        require(ops.LAUNCHES["K1"] == 1 and sum(ops.LAUNCHES.values()) == 1,
                f"{shape}: head_matmul launches {ops.LAUNCHES}, not one K1")
        call = lambda: ops._head_gemm(x, w, tb)
        library = lambda: torch.einsum(eq, x, w)
        extra = {"path": "head tile float16",
                 "graph_ms": graph_ms(torch, call),
                 "library_graph_ms": graph_ms(torch, library),
                 "head_matmul_ms": time_ms(torch, user)}
        _case(torch, rec, "K1", "float16", ("K1", "float16"), call,
              lambda: ref.head_gemm(x, w, tb), library,
              2.0 * m * 40 * n * k,
              (x.numel() + w.numel()) * 2 + 40 * m * n * 4, shape, extra)
        _rerun_equal(torch, call, f"K1 float16 head {name} m={m}")
    # a form K1 refuses (a float16 activation against the bf16 table), on
    # K9 through its row-major copies; no one PyTorch call takes the pair
    m = MLA_TILE_ROWS
    x, w = randn(m, 40, 96).to(f16)[..., :64], table[..., :64]
    route = ops.head_route(40, m, 64, 256, f16, bf, True,
                           ops.head_aligned(x, w))
    shape = f"K9 float16 x bfloat16 head q_lat m={m} h=40 k=64 n=256 tb=1"
    require(route == "K9", f"{shape}: route {route}, not K9")
    call = lambda: ops.head_matmul(x[:, None], w, transpose_b=True,
                                   out_dtype=torch.float32)
    ops.reset_launches()
    call()
    torch.cuda.synchronize()
    require(ops.LAUNCHES["K9"] == 1 and sum(ops.LAUNCHES.values()) == 1,
            f"{shape}: launches {ops.LAUNCHES}, not one K9")
    kern = lambda: call()[:, 0].transpose(0, 1)
    _case(torch, rec, "K9", "float16", ("K9", "float16"), kern,
          lambda: ref.head_gemm(x, w, True), None, 2.0 * m * 40 * 256 * 64,
          (x.numel() + w.numel()) * 2 + 40 * m * 256 * 4, shape,
          {"path": "K9"})
    _rerun_equal(torch, kern, shape)


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


def _expert_vjp_cases(torch, rec, gen):
    """K1's expert VJP forms (``ops._expert_gemm`` on the split route: the
    f32 cotangent g as three bf16 parts, split in the timed call as the
    backward does once for both) at ``MOE_VJP_CASES``: dx = g wᵀ (w read
    in its stored (e, d, f) layout) and dw = xᵀ g (x read in its stored
    (e, cap, d) layout), each held to ``ref.expert_gemm`` on the
    transposed views, with its route, its CUDA-graph time, ``torch.bmm``
    on f32 copies (made outside the timed call) as the library row, the
    split design's bound (three bf16 products, or the bytes: the operands,
    the f32 result, and 12 B an f32 element of g for its parts), and a
    rerun that must give the same bits."""
    from repro_torch.kernels import ops, ref
    bf, f32 = torch.bfloat16, torch.float32
    for name, e, cap, d, f in MOE_VJP_CASES:
        x = torch.randn(e, cap, d, generator=gen, device="cuda").to(bf)
        w = (torch.randn(e, d, f, generator=gen, device="cuda")
             * d ** -0.5).to(bf)
        g = torch.randn(e, cap, f, generator=gen, device="cuda")
        x32, w32 = x.float(), w.float()
        g_bytes = 4 * g.numel()
        for form, a, b, ta, tb, lib in (
                ("dx", g, w, False, True,
                 lambda: torch.bmm(g, w32.transpose(1, 2))),
                ("dw", x, g, True, False,
                 lambda: torch.bmm(x32.transpose(1, 2), g))):
            m, k = (a.shape[2], a.shape[1]) if ta else a.shape[1:]
            n = b.shape[1] if tb else b.shape[2]
            call = lambda: ops._expert_gemm(a, b, ta, tb)
            nbytes = x.numel() * 2 * (form == "dw") + \
                w.numel() * 2 * (form == "dx") + g_bytes + e * m * n * 4
            extra = {"path": ops.expert_route(e, m, k, n, a.dtype, b.dtype,
                                              True, ta, tb),
                     "graph_ms": graph_ms(torch, call),
                     "fma_bound_ms": bound(2.0 * e * m * n * k, nbytes,
                                           "float32")[0]}
            require(extra["path"] == "split", f"expert {form} {name}: route "
                    f"{extra['path']}, not split")
            _case(torch, rec, "K1", "bfloat16", ("K1", "bfloat16"), call,
                  lambda: ref.expert_gemm(a.transpose(1, 2) if ta else a,
                                          b.transpose(1, 2) if tb else b),
                  lib, 2.0 * e * m * n * k, nbytes,
                  f"K1 mixed expert {form} {name} E={e} cap={cap} d={d} "
                  f"f={f}", extra,
                  bound(3 * 2.0 * e * m * n * k, nbytes + 3 * g_bytes,
                        "bfloat16"))
            _rerun_equal(torch, call, f"K1 expert {form} {name}")
        del x, w, g, x32, w32


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


def _padded(torch, native, q, k, v, do=None):
    """With ``native`` ``(qk, vd)`` widths (MLA's), zero the columns of q
    and k past ``qk`` and of v (and dO) past ``vd`` in place, as
    ``ops`` pads a pair it is not built for; returns the unpadded (B, heads,
    S, width) copies of q, k, v for the library yardstick (None
    otherwise)."""
    if not native:
        return None
    qk, vd = native
    for t, w in ((q, qk), (k, qk), (v, vd)) + (((do, vd),) if do is not
                                               None else ()):
        t[..., w:] = 0
    b, s, kv = k.shape[:3]
    heads = lambda t: t.reshape(b, s, -1, t.shape[-1]).transpose(1, 2)
    return (heads(q)[..., :qk].contiguous(), heads(k)[..., :qk].contiguous(),
            heads(v)[..., :vd].contiguous())


def _mask_form(ref, s, sk, causal, window, prefix):
    """``(visible pairs of one (batch, query head), SDPA's boolean mask or
    None, its is_causal, the case's tag)`` of a K2-K4 mask: causal (and
    windowed, or with a prefix-LM prefix: counted from the mask itself,
    the pairs this run's kernels must visit) or bidirectional over ``sk``
    keys."""
    if not causal:
        return s * sk, None, False, f"bidirectional Sk={sk}"
    if prefix:
        mask = ref._mask(s, s, True, window, "cuda", prefix)
        tag = (f"window={window} " if window else "") + f"prefix={prefix}"
        return int(mask.sum()), mask, False, tag
    mask = ref._mask(s, s, True, window, "cuda") if 0 < window < s else None
    return (_pairs(s, window), mask, mask is None,
            f"window={window}" if window else "causal")


def _attention_bytes(b, s, sk, kv, g, hd, vd, es):
    """Bytes of q, k, v and out (dO) of one attention call at widths
    ``hd`` (q, k) and ``vd`` (v, out): each read or written once."""
    return dict(q=b * s * kv * g * hd * es, k=b * sk * kv * hd * es,
                v=b * sk * kv * vd * es, o=b * s * kv * g * vd * es)


def _prefill_attention_case(torch, rec, gen, dt, s, kv, g, hd, b=1,
                            window=0, native=None, prefix=0, causal=True,
                            sk=None, vd=None):
    """K2 without its export (the prefill's form), causal (windowed by
    ``window``, or with the prefix-LM's ``prefix``) or bidirectional
    (``causal=False``, over ``sk`` keys: the encoder's and the
    cross-attention's form), at ``kv`` KV heads of ``hd`` under ``g``
    query heads each, against SDPA (a window that cuts or a prefix as a
    boolean mask, else ``is_causal`` or no mask), with its CUDA-graph time
    and a rerun for the same bits.  ``vd``: v's width apart from q's and
    k's ``hd`` (MLA's (96, 64), as K2 takes it).  ``native`` ``(qk,
    vd)``: the inputs zero-padded from those widths, SDPA timed on the
    unpadded tensors, and the bound of the unpadded work printed beside
    the padded one's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dname = str(dt).removeprefix("torch.")
    es = torch.tensor([], dtype=dt).element_size()
    sk = sk or s
    vd = vd or hd
    randn = lambda *shape: torch.randn(*shape, generator=gen,
                                       device="cuda").to(dt)
    q, k, v = randn(b, s, kv, g, hd), randn(b, sk, kv, hd), randn(b, sk, kv,
                                                                  vd)
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    unpadded = _padded(torch, native, q, k, v)
    if unpadded:
        qs, ks, vs = unpadded
    args = dict(scale=(native[0] if native else hd) ** -0.5, window=window)
    if prefix or not causal:
        args.update(prefix_len=prefix, causal=causal)
    visible, mask, is_causal, tag = _mask_form(ref, s, sk, causal,
                                               window, prefix)
    call = lambda: ops.attention(q, k, v, **args)
    shape = (f"K2 {dname} B={b} S={s} KV={kv} G={g} hd={hd}"
             + (f" vd={vd}" if vd != hd else "") + f" {tag}"
             + (f" padded from {native}" if native else ""))
    pairs = b * kv * g * visible
    extra = {"graph_ms": graph_ms(torch, call)}
    if native:
        nat = _attention_bytes(b, s, sk, kv, g, *native, es)
        extra["unpadded_bound_ms"] = bound(2.0 * pairs * sum(native),
                                           sum(nat.values()), dname)[0]
    _case(torch, rec, "K2", dname, ("K2", dname), call,
          lambda: ref.attention(q, k, v, **args),
          lambda: F.scaled_dot_product_attention(
              qs, ks, vs, attn_mask=mask, is_causal=is_causal,
              enable_gqa=True),
          2.0 * pairs * (hd + vd),
          sum(_attention_bytes(b, s, sk, kv, g, hd, vd, es).values()),
          shape, extra)
    _rerun_equal(torch, call, shape)


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
    at q=256 (the config's chunk) and, on the same operands, at the chunk
    the H100 table derives (``ops.default_ssd_chunk``: 16, shorter than a
    64-row tile; its h_in export 16x q=256's), a prefill of 175 tokens (q
    = 175, one ragged chunk) and one of 300 (q = 256, a padded second
    chunk, through the ops-level pad/slice of ``ops.scan_ssd`` on both
    sides); and the training shape again with a state of 64, another
    state width.  No single PyTorch call computes the SSD scan, so neither
    has a library time; reruns of K6 and K7 give the same bits."""
    from repro_torch.kernels import ops, ref
    h, p = 48, 64
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    q_derived = ops.default_ssd_chunk(SSM_S, h, p, 128)
    for b, s, qs, n in ((SSM_B, SSM_S, (256, q_derived), 128),
                        (1, 175, (175,), 128), (1, 300, (256,), 128),
                        (SSM_B, SSM_S, (256,), 64)):
        ins = [randn(b, s, h, p), randn(b, s, n), randn(b, s, n),
               -0.3 * randn(b, s, h).abs(), 0.1 * randn(b, h, p, n)]
        ins += [randn(b, s, h, p), randn(b, h, p, n)] if b == SSM_B else \
            [None, None]
        for q in qs:
            _ssd_rows(torch, rec, ops, ref, ins, b, s, q, n, h, p)
        del ins


def _ssd_rows(torch, rec, ops, ref, ins, b, s, q, n, h, p):
    """``_ssd_cases``' rows of one chunk ``q`` on the operands ``ins`` (x,
    B, C, dA, h0 and, at the training batch, K7's dy and dhf)."""
    x, B, C, dA, h0, dy, dhf = ins
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
        return
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
    if dy is None:
        return
    _rerun_equal(torch, lambda: ops.ssd_scan_chunked(
        x, dA, B, C, h0, q, True), f"K6 n={n} q={q}")
    _, _, h_in = ops.ssd_scan_chunked(x, dA, B, C, h0, q, True)
    args = (C, B, dy, x, dA, h_in, dhf)
    call = lambda: ops.ssd_bwd_chunked(*args)
    nbytes = 4 * (4 * b * s * n + 3 * b * s * h * p + 2 * b * s * h
                  + 2 * b * h * p * n + b * nc * h * p * n)
    bnd, extra = _ssd_bounds(torch, bwd, nbytes, call)
    _case(torch, rec, "K7", "float32", ("K7", "float32"), call,
          lambda: ref.ssd_bwd(*args), None, bwd, nbytes,
          f"K7 float32 B={b} S={s} q={q} h={h} p={p} n={n}", extra, bnd)
    _rerun_equal(torch, call, f"K7 n={n} q={q} (its head sums)")


def _plain(ops, fn, *args, **kw):
    with ops.reference_mode():
        return fn(*args, **kw)


def _pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal (windowed) mask keeps over ``s``
    positions."""
    w = min(window, s) if window else s
    return w * (w + 1) // 2 + (s - w) * w


def _attention_training_cases(torch, rec, gen, dt, dname, es, b=TRAIN_B,
                              s=TRAIN_S, g=8, window=0, kv=1, hd=256,
                              native=None, prefix=0, causal=True, sk=None,
                              vd=None):
    """K2 with its (m, l) export, then K3 and K4, at a training shape (by
    default gemma-2b's: q (2, 512, 1, 8, 256), k/v (2, 512, 1, 256),
    m/l/delta (2, 1, 8, 512)); with a ``window``, K2 without the export
    too (the prefill's form).  ``prefix``: the prefix-LM mask;
    ``causal=False``: bidirectional over ``sk`` keys.  The library
    yardstick of K3 and K4 is one pair: the backward alone of SDPA
    (enable_gqa, a window or a prefix as a boolean mask) through
    torch.autograd.grad.  Each row also prints its CUDA-graph time, and
    each kernel is rerun for the same bits.  ``vd``: v's and dO's width
    apart from q's and k's ``hd`` (MLA's (96, 64), as K2-K4 take it).
    ``native`` ``(qk, vd)``: the inputs zero-padded from those widths
    (MLA's, at its own scale), SDPA timed on the unpadded tensors, and the
    bound of the unpadded work printed beside each padded row's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    scale = (native[0] if native else hd) ** -0.5
    sk = sk or s
    vd_ = vd or hd
    randn = lambda *shape: torch.randn(*shape, generator=gen,
                                       device="cuda").to(dt)
    q, k, v, do = (randn(b, s, kv, g, hd), randn(b, sk, kv, hd),
                   randn(b, sk, kv, vd_), randn(b, s, kv, g, vd_))
    visible, mask, is_causal, tag = _mask_form(ref, s, sk, causal,
                                               window, prefix)
    pairs = b * kv * g * visible
    stat_bytes = b * kv * g * s * 4
    args = dict(scale=scale, causal=causal, window=window)
    if prefix:
        args["prefix_len"] = prefix
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    unpadded = _padded(torch, native, q, k, v, do)
    if unpadded:
        qs, ks, vs = unpadded
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask, is_causal=is_causal, enable_gqa=True)
    shape = (f"B={b} S={s} KV={kv} G={g} hd={hd}"
             + (f" vd={vd_}" if vd_ != hd else "") + f" {tag}"
             + (f" padded from {native}" if native else ""))

    # the work of each kernel at widths (w_qk, w_v): the products' flops
    # and the bytes each operand and output moves once
    def work(w_qk, w_v):
        by = _attention_bytes(b, s, sk, kv, g, w_qk, w_v, es)
        fwd = by["q"] + by["k"] + by["v"] + by["o"]
        bwd = fwd + 3 * stat_bytes           # q, k, v, dO and m, l, delta
        return {"fwd": (2.0 * pairs * (w_qk + w_v), fwd),
                "export": (2.0 * pairs * (w_qk + w_v), fwd + 2 * stat_bytes),
                "dq": (2.0 * pairs * (2 * w_qk + w_v), bwd + by["q"]),
                "dkv": (2.0 * pairs * (2 * w_qk + 2 * w_v),
                        bwd + by["k"] + by["v"])}

    ran = work(hd, vd_)
    nat = work(*native) if native else None

    def graph(call, form):
        extra = {"graph_ms": graph_ms(torch, call)}
        if native:          # the same work at the unpadded widths
            extra["unpadded_bound_ms"] = bound(*nat[form], dname)[0]
        return extra

    if window:
        fwd = lambda: ops.attention(q, k, v, **args)
        _case(torch, rec, "K2", dname, ("K2", dname), fwd,
              lambda: ref.attention(q, k, v, **args),
              lambda: sdpa(qs, ks, vs), *ran["fwd"],
              f"K2 {dname} {shape}", graph(fwd, "fwd"))
        _rerun_equal(torch, fwd, f"K2 {dname} {shape}")
    export = lambda: ops.attention_stats(q, k, v, **args)
    _case(torch, rec, "K2", dname, ("K2", dname), export,
          lambda: ref.attention_stats(q, k, v, **args),
          lambda: sdpa(qs, ks, vs), *ran["export"],
          f"K2 {dname} {shape} export", graph(export, "export"))
    _rerun_equal(torch, export, f"K2 {dname} {shape} export")
    out, m, l = ops.attention_stats(q, k, v, **args)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1).contiguous()
    bwd = (q, k, v, do, m, l, delta)
    qg = qs.detach().requires_grad_(True)
    kg = ks.detach().requires_grad_(True)
    vg = vs.detach().requires_grad_(True)
    og = sdpa(qg, kg, vg)
    dos = do.reshape(b, s, kv * g, vd_).transpose(1, 2)[..., :vs.shape[-1]]
    sdpa_bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), dos,
                                           retain_graph=True)
    dq = lambda: ops.flash_dq(*bwd, **args)
    # s = q k^T, dp = dO v^T, dq = ds k; K4 also dv = p^T dO, dk = ds^T q
    _case(torch, rec, "K3", dname, ("K3", dname), dq,
          lambda: ref.flash_dq(*bwd, **args), sdpa_bwd, *ran["dq"],
          f"K3 {dname} {shape}", graph(dq, "dq"))
    _rerun_equal(torch, dq, f"K3 {dname} {shape}")
    nsplit = ops.dkv_splits(b, s, sk, kv, g, causal, window, prefix)
    k4_tc = dt == torch.bfloat16 and ops.DKV_ROWS % g == 0
    _case(torch, rec, "K4", dname, ("K4", dname),
          lambda: ops.flash_dkv(*bwd, **args),
          lambda: ref.flash_dkv(*bwd, **args), sdpa_bwd, *ran["dkv"],
          f"K4 {dname} {shape}",
          {"path": "tc" if k4_tc else "fma",
           "row_splits": nsplit if k4_tc else 1,
           **graph(lambda: ops.flash_dkv(*bwd, **args), "dkv")})
    _rerun_equal(torch, lambda: ops.flash_dkv(*bwd, **args),
                 f"K4 {dname} {shape}")


def _gated_cases(torch, rec, gen):
    """K8's forward and reverse walks at recurrentgemma-9b's lru width
    (4096): the prefill's and a training microbatch's B=1 S=4096, with and
    without an entering state, and a ragged B=2 S=300.  It reads log_a and
    b and writes h (12 B an element; h0 read and the final state written
    besides), 3 f32 operations an element (exp, multiply, add).  No single
    PyTorch call computes the scan: no library time.  Each row runs at the
    chunk the H100 table derives (``ops.default_gated_chunk``: 16 at this
    width) and prints it with its time in a CUDA graph, and is rerun for
    the same bits; the B=1 S=4096 rows also run at chunk 64 (the chunk
    the earlier occupancy rule on 64-channel strips picked there) on the
    same operands.  The bound is the function's own bytes at every chunk;
    the kernel's workspace traffic, the chunk aggregates (A, H) and group
    folds written and read (8 bytes an aggregate, 4 a fold, a (batch,
    chunk, channel) each), which the chunk sets, is printed beside it as
    ``workspace_mb``."""
    w = 4096
    for b, s in ((1, HYB_S), (2, 300)):
        _gated_rows(torch, rec, gen, b, s, w, with_64=b == 1)


def _gated_rows(torch, rec, gen, b, s, w, with_64=False):
    """``_gated_cases``' rows of one (b, s, w) shape: each walk at the
    derived chunk (with ``with_64`` also at chunk 64, and without an
    entering state as well as with one)."""
    from repro_torch.kernels import ops, ref
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    la, bb = -0.5 * randn(b, s, w).abs(), randn(b, s, w)
    h0 = 0.5 * randn(b, w)
    derived = min(ops.default_gated_chunk(s, w), s)
    for reverse in (False, True):
        for with_h0 in ((False, True) if with_64 else (True,)):
            hh = h0 if with_h0 else None
            for chunk in (derived, 64) if with_64 else (derived,):
                call = lambda c=chunk: ops.gated_recurrence(
                    la, bb, hh, reverse, chunk=c)
                shape = (f"K8 float32 B={b} S={s} w={w}"
                         + " reverse" * reverse + " h0" * with_h0
                         + f" chunk={chunk}")
                work = 2 * b * -(-s // chunk) * w * (8 + 4)
                extra = {"graph_ms": graph_ms(torch, call),
                         "workspace_mb": work / 1e6}
                _case(torch, rec, "K8", "float32", ("K8", "float32"),
                      call, lambda: ref.gated_scan(la, bb, hh, reverse),
                      None, 3.0 * b * s * w,
                      4 * (3 * b * s * w + (1 + with_h0) * b * w),
                      shape, extra)
                _rerun_equal(torch, call, shape)
    del la, bb, h0


def _shard_cases(torch, rec, gen):
    """The kernels at the per-shard shapes ``[dist_path]``'s sharded train
    steps give them on (data 2, model 2), each rank its 2 of the batch's
    4 rows at S = 512: K2 (export), K3, K4 on minicpm3-4b's 20 of 40 MLA
    heads at (96, 64); K6 (with and without its export) and K7 on
    mamba2-780m's 24 of 48 SSD heads of 64 (state 128, q = 256); K8 on
    recurrentgemma-9b's 2048 of 4096 channels."""
    from repro_torch.kernels import ops, ref
    b, s = DIST_SIZES['train_b'] // 2, DIST_SIZES['train_s']
    qk, vd = MLA_WIDTHS
    _attention_training_cases(torch, rec, gen, torch.bfloat16, "bfloat16",
                              2, b=b, s=s, g=1, kv=20, hd=qk, vd=vd)
    h, p, n = 24, 64, 128
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ins = [randn(b, s, h, p), randn(b, s, n), randn(b, s, n),
           -0.3 * randn(b, s, h).abs(), 0.1 * randn(b, h, p, n),
           randn(b, s, h, p), randn(b, h, p, n)]
    _ssd_rows(torch, rec, ops, ref, ins, b, s, 256, n, h, p)
    del ins
    _gated_rows(torch, rec, gen, b, s, 2048)


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


def _gemm_forms(torch, rec, gen, prefix, forms, lib_graph=False):
    """Each K1 form ``(label, a shape, a dtype, b shape, b dtype,
    transpose_a, transpose_b)`` against its plain version, at the bf16
    tolerance, and rerun to the same bits; with ``lib_graph``, the
    library call's CUDA-graph time beside the kernel's (``graph_ms``), as
    a host-bound row compares them."""
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
        if lib_graph:
            extra["library_graph_ms"] = graph_ms(
                torch, lambda: torch.matmul(a.t() if ta else a,
                                            b.t() if tb else b))
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
        elif mixed:
            # a mixed product on the FMA kernel (a bf16 operand TMA cannot
            # read): the f32 FMA bound of its exact product beside the
            # bf16 one
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
        _rerun_equal(torch, lambda: ops._gemm(a, b, ta, tb),
                     f"{prefix} {label} m={m} k={k} n={n}")
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
    TRAIN_STATE.update(cfg=cfg, bytes={
        "params": _tree_bytes(params.parameters()),
        "master": _tree_bytes(state.opt.master.values()),
        "m": _tree_bytes(state.opt.m.values()),
        "v": _tree_bytes(state.opt.v.values())})
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


def _train_steps(torch, tag, step, state, batches, tokens,
                 keys=("loss", "grad_norm")):
    """``step`` over ``batches`` from launch counts 0 and fresh peak
    memory statistics, the last step under sync debug mode "error": each
    step's ms (CUDA events), tokens/s and metrics ``keys`` printed and
    held finite, and every f32 master leaf required to move.  Returns
    ``(state, rows, launches, peak)``, a row ``(ms, {key: value})`` a
    step."""
    from repro_torch.kernels import ops
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
        vals = {k: metrics[k].item() for k in keys}
        rows.append((ms, vals))
        print(f"[{tag}] step {i + 1}: {ms:.3f} ms, {tokens / ms * 1e3:.1f} "
              f"tok/s, " + ", ".join(f"{k} {v:.6f}" for k, v in vals.items()),
              flush=True)
        require(all(math.isfinite(v) for v in vals.values()),
                f"step {i + 1}: a metric is not finite")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] step {len(batches)} ran with no host sync (sync debug "
          f"mode 'error')", flush=True)
    changed = sum(not torch.equal(before[k], t.reshape(-1)[:4096])
                  for k, t in state.opt.master.items())
    require(changed == len(before), f"only {changed} of {len(before)} f32 "
            f"master leaves changed")
    return state, rows, launches, peak


#: the training extras' phases: gemma-2b's [train] shape under each remat
#: policy, then the launchers at full width (whisper-base's checkpoints
#: under build/, removed after)
REMAT_POLICIES = ("full", "off", "dots")
REMAT_ROUNDS = 6
LAUNCH_STEPS = 3
LAUNCH_CKPT_DIR = os.path.join(ROOT, "build", "smoke_ckpt")
WHISPER_LAUNCH = ("--batch", "8", "--seq", "128")
#: the serve launcher's calls: first its default traffic (4 requests of
#: 16 + 32 tokens, 4 slots: too few tokens to keep a rate), then SERVE_RUNS
#: times 32 requests of 128 prompt tokens (within [path]'s 32-200) and 32
#: new ones over 8 slots, whose rates and spread are kept
SERVE_SMALL = ("--requests", "4", "--prompt-len", "16", "--new-tokens", "32")
SERVE_LAUNCH = ("--requests", "32", "--prompt-len", "128", "--new-tokens",
                "32", "--max-slots", "8")
SERVE_RUNS = 2


def phase_remat_dots(torch, card):
    """gemma-2b at full width and depth, B=2 S=512 (``[train]``'s shape,
    its first batch): the forward and backward (``loss_and_grads``)
    under remat "full", off and "dots".  Each policy's first run after a
    warm one counts the launches and reads the peak memory above what is
    held before it ("dots" also the bytes its memo keeps); then
    REMAT_ROUNDS rounds run the three policies in turn, each timed by
    CUDA events, and one profiled step a policy gives its device busy
    time.  "dots" must launch K1 as often as off, "full" one layer's
    forward products (counted in a no-grad forward) 18 times more;
    "dots"' loss and gradients must equal "full"'s within LOSS_TOL /
    GRAD_TOL (printed: bit for bit or not); peaks full <= dots <= off."""
    from repro_torch.configs import gemma_2b
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import train_step as ts

    phase_t0 = time.perf_counter()
    cfg, params = _model(torch, gemma_2b, trainable=True)
    batch = _batches(torch, cfg)[0]
    L = cfg.n_layers
    ops.reset_launches()
    with torch.no_grad():
        registry.loss(params, cfg, batch)
    torch.cuda.synchronize()
    forward_k1 = ops.LAUNCHES["K1"]
    per_layer = (forward_k1 - 1) // L
    print(f"[remat_dots] gemma-2b full width, {L} layers, B={TRAIN_B} "
          f"S={TRAIN_S}: a no-grad forward launches K1 {forward_k1} times "
          f"({per_layer} a layer + the head) ({card})", flush=True)
    runs, steps, total = {}, {}, _zero_launches()
    memo = [0]
    inner_dots = ops._dots_matmul

    def dots_matmul(dots, *args):
        y = inner_dots(dots, *args)
        if dots[1] is None:                      # recorded, not replayed
            memo[0] += y.nbytes
        return y

    for policy in REMAT_POLICIES:
        c = cfg.with_(remat=policy != "off",
                      remat_policy="dots" if policy == "dots" else "full")
        steps[policy] = loss_and_grads = \
            lambda c=c: ts.loss_and_grads(params, c, batch)
        loss_and_grads()                         # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with _patched(ops, "_dots_matmul", dots_matmul):
            (loss, _, grads), ms = _timed(torch, loss_and_grads)
        launches = dict(ops.LAUNCHES)
        for k in total:
            total[k] += launches[k]
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[remat_dots] {policy}: forward+backward {ms:.3f} ms (the "
              f"counted run), loss {loss.item():.6f}, K1 {launches['K1']} "
              f"K2 {launches['K2']} K3 {launches['K3']} K4 "
              f"{launches['K4']}, peak {peak / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held ({card})", flush=True)
        runs[policy] = (loss, launches, peak)
        if policy == "full":
            ref_grads = grads
        else:
            ref_loss = runs["full"][0]
            lk, lp = loss.item(), ref_loss.item()
            rel = abs(lk - lp) / abs(lp)
            worst = max(_rel(torch, grads[k], ref_grads[k], norm=True)
                        for k in grads)
            same = torch.equal(loss, ref_loss) and all(
                torch.equal(grads[k], ref_grads[k]) for k in grads)
            print(f"[remat_dots] {policy} vs full: loss rel {rel:.3e} (tol "
                  f"{LOSS_TOL:g}), worst gradient rel norm err {worst:.3e} "
                  f"(tol {GRAD_TOL:g}) over {len(grads)} leaves; bit for "
                  f"bit: {same}", flush=True)
            require(rel <= LOSS_TOL and worst <= GRAD_TOL,
                    f"[remat_dots] {policy}'s loss or gradients differ "
                    f"from full's")
        del grads
        torch.cuda.empty_cache()
    del ref_grads
    torch.cuda.empty_cache()
    k1 = {p: r[1]["K1"] for p, r in runs.items()}
    k2 = {p: r[1]["K2"] for p, r in runs.items()}
    want_off = 3 * (per_layer * L + 1)
    require(k1["off"] == want_off, f"remat off launched K1 {k1['off']} "
            f"times, derived {want_off}")
    require(k1["dots"] == k1["off"], f"dots launched K1 {k1['dots']} "
            f"times, off {k1['off']}: its backward reran a forward product")
    require(k1["full"] - k1["dots"] == L * per_layer,
            f"full - dots = {k1['full'] - k1['dots']} K1 launches, not "
            f"{L} x {per_layer}")
    require(k2 == {"full": 2 * L, "off": L, "dots": 2 * L},
            f"K2 launches {k2}")
    peaks = {p: r[2] for p, r in runs.items()}
    require(peaks["full"] <= peaks["dots"] <= peaks["off"],
            f"peaks (GiB) {({p: v / 2**30 for p, v in peaks.items()})} "
            f"break full <= dots <= off")
    # the policies in turn, so that a drift of the host's speed reaches
    # each of them alike
    times = {p: [] for p in REMAT_POLICIES}
    for _ in range(REMAT_ROUNDS):
        for policy in REMAT_POLICIES:
            times[policy].append(_timed(torch, steps[policy])[1])
    med = {p: statistics.median(t) for p, t in times.items()}
    for policy, t in times.items():
        print(f"[remat_dots] {policy}: {REMAT_ROUNDS} rounds in turn, ms "
              f"{[round(x, 3) for x in t]}: min {min(t):.3f}, median "
              f"{med[policy]:.3f}, max {max(t):.3f} ({card})", flush=True)
    paired = [f - d for f, d in zip(times["full"], times["dots"])]
    print(f"[remat_dots] full - dots a round, ms "
          f"{[round(x, 3) for x in paired]}: median "
          f"{statistics.median(paired):.3f}", flush=True)
    busy = {p: profile_step(torch, steps[p], n=1, what=f"remat {p} fwd+bwd",
                            detail=False)[1] for p in REMAT_POLICIES}
    print(f"[remat_dots] dots saves {med['full'] - med['dots']:.3f} ms of "
          f"full's median {med['full']:.3f} ms (device busy a step: full "
          f"{busy['full']:.3f}, dots {busy['dots']:.3f}, off "
          f"{busy['off']:.3f} ms; busy saved "
          f"{busy['full'] - busy['dots']:.3f} ms) and holds "
          f"{(peaks['dots'] - peaks['full']) / 2**30:.3f} GiB more at its "
          f"peak, its memo {memo[0] / 2**30:.3f} GiB; off median "
          f"{med['off']:.3f} ms, {(peaks['off'] - peaks['dots']) / 2**30:.3f}"
          f" GiB above dots; phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s ({card})", flush=True)
    return total


class _Tee:
    """Writes to stdout and keeps the text (a launcher's prints)."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _launch(main, argv, tag):
    """``main(argv)`` with its prints shown (prefixed by the caller's
    tag line) and kept; returns ``(result, printed text)``."""
    print(f"[launch_path] {tag}: main({' '.join(argv)})", flush=True)
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        out = main(list(argv))
    return out, tee.text()


#: the compressed run's leaves compared with the same function on CPU
#: copies at its second step (a non-zero error state): a block-aligned
#: slice of wi of 2^26 + 768 elements (two of the CPU's slices), the whole
#: stacked wo and the final norm's scale
COMPRESS_LEAVES = {"layers.mlp.wi": 2 ** 26 + 768, "layers.attn.wo": None,
                   "final_norm.scale": None}


def _compress_spy(torch, compression, record):
    """A ``compress_grads`` that times each call (CUDA events), reads its
    peak memory above what it starts with, and at its second call keeps
    CPU copies of COMPRESS_LEAVES' inputs and outputs."""
    inner = compression.compress_grads
    cut = lambda t, k: t.reshape(-1)[:COMPRESS_LEAVES[k]] \
        if COMPRESS_LEAVES[k] else t
    host = lambda t: t.to("cpu", copy=True)

    def spy(cfg, grads, err):
        if not cfg.enabled:
            return inner(cfg, grads, err)
        n = len(record["events"])
        keep = n == 1
        if keep:
            record["inputs"] = {k: (host(cut(grads[k], k)),
                                    host(cut(err[k], k)))
                                for k in COMPRESS_LEAVES}
        record["peak_before"] = max(record.get("peak_before", 0),
                                    torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(cfg, grads, err)
        end.record()
        record["events"].append((start, end))
        record["peaks"].append(torch.cuda.max_memory_allocated() - base)
        if keep:
            record["outputs"] = {k: (host(cut(out[0][k], k)),
                                     host(cut(out[1][k], k)))
                                 for k in COMPRESS_LEAVES}
        return out
    return spy


def _step_spy(record):
    """A ``StepWatchdog.stop`` that keeps each step's host seconds."""
    from repro_torch.distributed.fault import StepWatchdog
    inner = StepWatchdog.stop

    def stop(self, step):
        dt = inner(self, step)
        record.append(dt)
        return dt
    return stop


def _gemma_launches(cfg, steps):
    """[train]'s derived launches for ``steps`` remat-"full" steps."""
    L = cfg.n_layers
    return _zero_launches(K1=steps * (6 * L + 1 + 6 * L + 2 * (6 * L + 1)),
                          K2=steps * 2 * L, K3=steps * L, K4=steps * L)


def _launch_train_gemma(torch, card, total):
    """(a): gemma-2b at full width and depth through ``launch.train.main``
    without and with ``--compress-grads``."""
    from repro_torch.configs import gemma_2b
    from repro_torch.distributed import compression, fault
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    argv = ["--arch", "gemma-2b", "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--steps", str(LAUNCH_STEPS), "--log-every", "1"]
    losses = {}
    for comp in (False, True):
        tag = "gemma-2b " + ("--compress-grads" if comp else "uncompressed")
        steps, rec = [], {"events": [], "peaks": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with _patched(fault.StepWatchdog, "stop", _step_spy(steps)), \
                _patched(compression, "compress_grads",
                         _compress_spy(torch, compression, rec)):
            out, text = _launch(train.main, argv + (["--compress-grads"]
                                                    if comp else []), tag)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for k in total:
            total[k] += launches[k]
        peak = max(torch.cuda.max_memory_allocated(),
                   rec.get("peak_before", 0))
        losses[comp] = out
        want = _gemma_launches(gemma_2b.full(), LAUNCH_STEPS)
        require(text.startswith("mesh: {'data': 1, 'model': 1} "
                                "device=cuda"), "the launcher's first line")
        require(len(out) == LAUNCH_STEPS and all(map(math.isfinite, out)),
                f"{tag}: losses {out}")
        require(launches == want, f"{tag}: launches {launches}, derived "
                f"{want}")
        line = (f"[launch_path] {tag}: step s (host, to the loss on the "
                f"host) {[round(s, 6) for s in steps]}, losses "
                f"{[round(x, 6) for x in out]}, launches {launches}, peak "
                f"{peak / 2**30:.3f} GiB")
        if comp:
            cms = [a.elapsed_time(b) for a, b in rec["events"]]
            line += (f"; compress_grads ms a step {[round(x, 3) for x in cms]}"
                     f", its peak above its start "
                     f"{max(rec['peaks']) / 2**30:.3f} GiB")
        print(line + f" ({card})", flush=True)
        if comp:
            cfg = compression.CompressionConfig(enabled=True)
            cpu_g = {k: g.clone() for k, (g, _) in rec["inputs"].items()}
            cpu_e = {k: e.clone() for k, (_, e) in rec["inputs"].items()}
            want_g, want_e = compression.compress_grads(cfg, cpu_g, cpu_e)
            for k, (g, e) in rec["outputs"].items():
                same = torch.equal(g, want_g[k]) and torch.equal(e, want_e[k])
                print(f"[launch_path] compress_grads at step 2, {k} "
                      f"{tuple(g.shape)} {g.dtype}: card equals the CPU bit "
                      f"for bit: {same}", flush=True)
                require(same, f"compress_grads on the card differs from the "
                        f"CPU on {k}")
        del out
        torch.cuda.empty_cache()
    l0, l1 = losses[False][0], losses[True][0]
    print(f"[launch_path] step-1 loss uncompressed {l0:.6f}, compressed "
          f"{l1:.6f} (equal: {l0 == l1})", flush=True)
    require(abs(l0 - l1) <= 1e-6 * abs(l0), "step 1's loss moved with "
            "compression, which acts after the gradients")


def _launch_train_whisper(torch, card, total):
    """(b): whisper-base at full width and depth: run A 4 steps straight,
    run B 2 steps then resumed to 4, checkpoints every 2 steps; B's step-4
    arrays equal A's bit for bit."""
    import shutil

    import numpy as np
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    shutil.rmtree(LAUNCH_CKPT_DIR, ignore_errors=True)
    dirs = {r: os.path.join(LAUNCH_CKPT_DIR, r) for r in ("a", "b", "save")}
    argv = ["--arch", "whisper-base", *WHISPER_LAUNCH, "--log-every", "1",
            "--ckpt-every", "2"]
    timing = {"wait": [], "save_async": [], "save": [], "restore": []}
    inner_async, inner_restore = Checkpointer.save_async, Checkpointer.restore

    def save_async(self, step, tree, metadata=None):
        # the wait on the earlier write apart from the snapshot
        t0 = time.perf_counter()
        self.wait()
        timing["wait"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        inner_async(self, step, tree, metadata)
        timing["save_async"].append(time.perf_counter() - t0)
        if not timing["save"]:
            # the same state, blocking, once this write has ended: no
            # other write runs beside it
            self.wait()
            t0 = time.perf_counter()
            Checkpointer(dirs["save"]).save(step, tree, metadata)
            timing["save"].append(time.perf_counter() - t0)

    def restore(self, like, step=None):
        t0 = time.perf_counter()
        out = inner_restore(self, like, step)
        torch.cuda.synchronize()
        timing["restore"].append(time.perf_counter() - t0)
        return out

    ops.reset_launches()
    t0 = time.perf_counter()
    with _patched(Checkpointer, "save_async", save_async), \
            _patched(Checkpointer, "restore", restore):
        a, _ = _launch(train.main, argv + ["--steps", "4", "--ckpt-dir",
                                           dirs["a"]], "whisper-base run A")
        b1, _ = _launch(train.main, argv + ["--steps", "2", "--ckpt-dir",
                                            dirs["b"]], "whisper-base run B")
        b2, text = _launch(train.main, argv + ["--steps", "4", "--ckpt-dir",
                                               dirs["b"]],
                           "whisper-base run B, again")
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k in total:
        total[k] += launches[k]
    require("resumed from step 2" in text, "run B did not resume")
    # step 2's checkpoints come from two runs of the same steps: equal
    # unless training itself does not repeat on the card
    (f2a, _), (f2b, _) = (Checkpointer(dirs[r])._load_step(2)
                          for r in ("a", "b"))
    same2 = all(torch.equal(f2a[k], f2b[k]) for k in f2a)
    print(f"[launch_path] whisper-base step-2 checkpoints of runs A and B "
          f"(no resume yet) equal: {same2}", flush=True)
    require(b1 + b2 == a, f"run B's losses {b1 + b2} != run A's {a}")
    (fa, ma), (fb, mb) = (Checkpointer(dirs[r])._load_step(4)
                          for r in ("a", "b"))
    require(ma["metadata"] == mb["metadata"] == {"data_step": 4},
            "the step-4 manifests' data step")
    differ = [k for k in fa if not torch.equal(fa[k], fb[k])]
    gb = os.path.getsize(os.path.join(dirs["a"], "step_0000000004",
                                      "arrays.npz")) / 1e9
    n_params = sum(int(np.prod(t.shape)) for k, t in fa.items()
                   if k.startswith("params/"))
    print(f"[launch_path] whisper-base ({n_params / 1e6:.2f} M params): B's "
          f"step-4 checkpoint equals A's leaf for leaf: {not differ} "
          f"({len(fa)} leaves; differ {differ[:4]}); losses A "
          f"{[round(x, 6) for x in a]}; launches {launches}; the three "
          f"runs {wall:.1f} s ({card})", flush=True)
    require(not differ and fa.keys() == fb.keys(),
            f"resumed checkpoint differs from the straight one: {differ}")
    print(f"[launch_path] whisper-base checkpoint {gb:.3f} GB on disk a "
          f"step; host-blocking s: save {timing['save']} (alone), "
          f"save_async's snapshot "
          f"{[round(x, 4) for x in timing['save_async']]} (its wait on the "
          f"earlier write apart: {[round(x, 4) for x in timing['wait']]}); "
          f"restore s "
          f"{[round(x, 4) for x in timing['restore']]} (files warm in the "
          f"page cache)", flush=True)
    shutil.rmtree(LAUNCH_CKPT_DIR, ignore_errors=True)


def _launch_serve_gemma(torch, card, total):
    """(c): ``launch.serve.main`` on gemma-2b at full width, once over
    SERVE_SMALL's traffic, then SERVE_RUNS times over SERVE_LAUNCH's:
    each call's tokens/s."""
    from repro_torch.configs import gemma_2b
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    engines = []
    inner = serve.ServeEngine

    class Engine(inner):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    L = gemma_2b.full().n_layers
    ops.reset_launches()
    t0 = time.perf_counter()
    rates = []
    with _patched(serve, "ServeEngine", Engine):
        for run, argv in enumerate([SERVE_SMALL]
                                   + [SERVE_LAUNCH] * SERVE_RUNS):
            results, text = _launch(serve.main, ["--arch", "gemma-2b",
                                                 *argv],
                                    f"gemma-2b serve, call {run + 1}")
            n_req, n_new = int(argv[1]), int(argv[5])
            require(len(results) == n_req and all(
                len(r["tokens"]) == n_new for r in results.values()),
                "the serve launcher's results")
            line = next(x for x in text.splitlines() if "tok/s" in x)
            rates.append(float(line.split("=")[-1].split()[0]))
            del results
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k in total:
        total[k] += launches[k]
    iters = sum(e.kernel_calls for e in engines)
    require(all(e.batched for e in engines) and launches["K5"] == L * iters,
            f"K5 {launches['K5']} != {L} x {iters} decode iterations")
    kept = rates[1:]
    spread = 100 * (max(kept) - min(kept)) / min(kept)
    print(f"[launch_path] gemma-2b serve: tok/s {rates[0]} over "
          f"{' '.join(SERVE_SMALL)} (not kept), then {kept} over "
          f"{' '.join(SERVE_LAUNCH)} (spread {spread:.1f}%); K5 "
          f"{launches['K5']} launches ({iters} decode iterations x {L} "
          f"layers), K1 {launches['K1']}, K2 {launches['K2']}; the "
          f"{len(rates)} calls {wall:.2f} s with the parameters' draws "
          f"({card})", flush=True)


def phase_launch_path(torch, card):
    """The launchers at full width: (a) ``launch.train.main`` on gemma-2b
    (depth 18, B=2 S=512, 3 steps) without and with ``--compress-grads``:
    derived launches, step 1's loss equal, the compression's ms and peak
    memory a step, three leaves' compression equal to the CPU's bit for
    bit; (b) whisper-base's straight and resumed runs, their step-4
    checkpoints equal bit for bit, the save / save_async / restore
    seconds and the GB on disk; (c) ``launch.serve.main`` on gemma-2b,
    4 requests of 16 + 32 tokens, then SERVE_RUNS times 32 requests of
    128 + 32 tokens over 8 slots: tokens/s a call and K5's launches."""
    phase_t0 = time.perf_counter()
    total = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                            "K9")}
    _launch_train_gemma(torch, card, total)
    torch.cuda.empty_cache()
    _launch_train_whisper(torch, card, total)
    torch.cuda.empty_cache()
    _launch_serve_gemma(torch, card, total)
    print(f"[launch_path] launches {total}; phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    return total


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


def _dense_grad_agreement(torch, tag, cfg, params, batch, vanishing=None):
    """Step 1's loss and gradients through the kernels against the plain
    versions, in f32 (the same weights, exact in f32) and in bf16, each
    held as ``[train]`` holds gemma-2b's bf16 step: the loss within
    LOSS_TOL, each gradient leaf within GRAD_TOL in relative norm.
    ``vanishing`` maps a leaf whose gradient is zero in exact arithmetic
    (an attention's key bias: the softmax cancels a shift of a row's
    scores, so both paths' gradients are rounding noise) to a sibling
    leaf, and its error is taken relative to that sibling's gradient
    norm.  Returns the bf16 kernels' loss."""
    vanishing = vanishing or {}
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
            note = ""
            if name in vanishing:
                sib = gp[vanishing[name]].float().norm()
                rel = ((gk[name].float() - gp[name].float()).norm()
                       / sib).item()
                own = gp[name].float().norm().item() / sib.item()
                note = (f" (of ||grad {vanishing[name]}||; its own plain "
                        f"norm {own:.3e} of that)")
            worst = max(worst, rel)
            print(f"[{tag}]   {dtype} grad {name} {tuple(gk[name].shape)}: "
                  f"rel norm err {rel:.3e}{note}", flush=True)
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
    state, rows, launches, peak = _train_steps(
        torch, "stablelm_train", step, state, batches, tokens)
    # the step's loss is the mean of its microbatches' means: the whole
    # batch's mean up to the order of the f32 sums
    require(abs(rows[0][1]["loss"] - lk) <= 1e-5 * abs(lk), f"step 1's "
            f"loss {rows[0][1]['loss']} != the kernels' loss_and_grads {lk}")
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
    reqs = _ssm_reqs(np, cfg)
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


def _ssm_reqs(np, cfg):
    """mamba2-780m's 6 requests from seed 0: one prompt of 300 tokens
    (over one 256-token chunk: its prefill crosses a chunk boundary and
    pads its last chunk) and five of 32-200, 16-32 new tokens each."""
    rng = np.random.default_rng(0)
    lens = [300] + [int(n) for n in rng.integers(32, 201, 5)]
    return [(rng.integers(0, cfg.vocab_size, n).tolist(),
             int(rng.integers(16, 33))) for n in lens]


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


def _f32_witness(torch, tag, out, setting, names=("kernels", "plain")):
    """Hold ``out[(dtype, plain)][what]`` (``dtype`` "float32" or
    "bfloat16", ``plain`` the plain path's) for each ``what``: the f32
    kernels within SSM_F32_TOL x max|plain| of the f32 plain path; the
    bf16 kernels no farther from the f32 plain path than SSM_BF16_RATIO
    x the plain bf16 path's own distance from it (the witness).
    ``setting`` names the input in the printed lines, ``names`` the run
    held and the run it is held to (``derive_path``: the derived chunk's
    kernels and the pinned chunk's)."""
    k, p = names
    for what, ref32 in out["float32", True].items():
        err = _rel(torch, out["float32", False][what], ref32)
        print(f"[{tag}] float32 {what} {tuple(ref32.shape)} {k} vs "
              f"{p} ({setting}): {err:.3e} of max|{p}| (tol "
              f"{SSM_F32_TOL:g})", flush=True)
        require(err <= SSM_F32_TOL, f"float32 {what} disagrees with {p}")
        kern = _rel(torch, out["bfloat16", False][what], ref32)
        wit = _rel(torch, out["bfloat16", True][what], ref32)
        both = _rel(torch, out["bfloat16", False][what],
                    out["bfloat16", True][what])
        print(f"[{tag}] bfloat16 {what}, max|diff| / max|f32 {p}|: "
              f"{k} vs f32 {kern:.3e}, {p} bf16 vs f32 {wit:.3e} "
              f"(ratio {_ratio(kern, wit):.3f}, tol {SSM_BF16_RATIO:g}); "
              f"{k} vs {p} bf16 {both:.3e}", flush=True)
        require(kern <= SSM_BF16_RATIO * wit, f"bfloat16 {what}: the "
                f"{k} sit farther from the f32 function than {p} bf16")


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
    _f32_witness(torch, "ssm_path", out, f"{prompt.shape[1]}-token prompt")


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


def _grad_agreement(torch, tag, cfg, params, batch, against=None):
    """Step 1's loss and gradients through the kernels and the plain
    versions, in bf16 and on its weights in f32: f32 kernels against f32
    plain tightly; bf16 kernels against the f32 plain gradients beside the
    plain bf16 ones' own distance from them (the witness).  Returns the
    bf16 kernels' loss.  ``tag`` heads the printed lines.  With
    ``against`` (a config), the run held to is the kernels' under that
    config, not the plain versions (``derive_path``: the pinned chunk)."""
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts
    pf = _f32_copy(params, trainable=True)
    out = {}
    for dt, prm in (("float32", pf), ("bfloat16", params)):
        for plain in (False, True):
            c = (against if plain and against is not None else cfg).with_(
                dtype=dt)
            with _plain_if(ops, plain and against is None):
                loss, _, grads = ts.loss_and_grads(prm, c, batch)
            out[dt, plain] = (loss.item(), grads)
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
    state, rows, launches, peak = _train_steps(
        torch, "ssm_train", step, state, batches, tokens)
    require(abs(rows[0][1]["loss"] - lk) <= 1e-6 * abs(lk), f"step 1's "
            f"loss {rows[0][1]['loss']} != the kernels' loss_and_grads {lk}")
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
    _f32_witness(torch, "hybrid_path", out, f"{tokens.shape[1]}-token "
                 f"prefill, decode at position {n}")


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
              f"{launches_p} (derived {want}); K8 at the derived chunk "
              f"{ops.default_gated_chunk(HYB_S, cfg.lru_width)}", flush=True)
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
    state, rows, launches, peak = _train_steps(
        torch, "hybrid_train", step, state, batches, tokens)
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
#: K9's wide forms in [moa_path]: the cube edge of the 6-axis Kronecker
#: product (16^6: 16.8 M outputs) and (i, the contracted edges) of the
#: 4-axis contraction (1024 x 1024 outputs, 256 terms each: the H100
#: table's derived schedule refuses a contracted volume of 6^4 and up,
#: its blocks past 227 KB, before K9 is reached)
WIDE_KRON, WIDE_RED = 16, (1024, 4)
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


def _k9_path(launch) -> str:
    """K9's path of a launch as the rows print it (THREAD's and REDUCE's
    warp form marked)."""
    from repro_torch.kernels import emit
    name = {emit.TILE: "TILE", emit.THREAD: "THREAD", emit.REDUCE: "REDUCE",
            emit.MAP: "MAP", emit.CHAIN: "CHAIN",
            emit.FACTOR: "FACTOR"}[launch.mode]
    warp = launch.rows and launch.mode in (emit.THREAD, emit.REDUCE)
    return name + (" warp" if warp else "")


def _moa_cases(torch, E, ops):
    """The moa_path cases: ``(label, kernel id, path call, plain call,
    library call or None, exact?, (bound ms, by), extra)`` on seeded card
    inputs (``extra``: further numbers for the row, or {}); each path
    call goes through a user entry (``ops.moa_gemm``,
    ``semiring_matmul``, ``apply``, ``hadamard``, ``ipophp``), but the
    max-plus contraction over 4 axes, which apply refuses at its
    schedule's derivation, through K9's wrapper
    (``ops.semiring_contract``)."""
    from repro_torch.kernels import emit
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
    # a lone max over two axes: adjacent axes merge into one (REDUCE, a
    # warp an output); axes (0, 2) do not chain and stay on THREAD (its
    # warp form)
    cube = rnd(MOA_N, 64, 64)
    for axes, shape, t in (((1, 2), (MOA_N, 64, 64), cube),
                           ((0, 2), (64, MOA_N, 64),
                            cube.reshape(64, MOA_N, 64))):
        lone2 = E.arr("A", shape)
        for ax in sorted(axes, reverse=True):
            lone2 = E.reduce("max", lone2, ax)
        plan = ops._plan(E.normal_form(lone2), ("float32",), torch.float32,
                         ops.H100, None, "float32", False)[1]
        add(f"K9 float32 lone max over axes {axes} of {shape} "
            f"path={_k9_path(plan)} contracted={plan.red_ext}", "K9",
            lambda lone2=lone2, t=t: ops.apply(lone2, t),
            lambda t=t, axes=axes: torch.amax(t, dim=axes), True,
            k9_bound(1.0 * t.numel(), (t.numel() + MOA_N) * 4))
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
    # past K9's old ranks: a Kronecker product of two cubes (6 out axes,
    # interleaved, none merging) and a contraction over 4 axes in
    # reversed order (no two merge: TILE over the flattened 4 axes)
    c = WIDE_KRON
    k3a, k3b = rnd(c, c, c), rnd(c, c, c)
    kron6 = E.transpose(E.inner("add", "mul", E.arr("A", (c, c, c, 1)),
                                E.arr("B", (1, c, c, c))),
                        (0, 3, 1, 4, 2, 5))
    add(f"K9 float32 kron of ({c},{c},{c}) (x) ({c},{c},{c}): 6 out axes, "
        f"{c ** 6} outputs", "K9",
        lambda: ops.apply(kron6, k3a.reshape(c, c, c, 1),
                          k3b.reshape(1, c, c, c)),
        lambda: torch.kron(k3a, k3b).reshape((c,) * 6), True,
        k9_bound(1.0 * c ** 6, (2 * c ** 3 + c ** 6) * 4))
    i, r = WIDE_RED
    ra, rb = rnd(i, r, r, r, r) * r ** -2, rnd(r, r, r, r, i)
    red4 = E.inner("add", "mul",
                   E.transpose(E.arr("A", (i, r, r, r, r)), (1, 2, 3, 0, 4)),
                   E.transpose(E.arr("B", (r, r, r, r, i)), (3, 2, 1, 0, 4)),
                   batch=3)
    for _ in range(3):
        red4 = E.reduce("add", red4, 0)
    wide_bytes = (2 * i * r ** 4 + i * i) * 4
    plan = ops._plan(E.normal_form(red4), ("float32",) * 2, torch.float32,
                     ops.H100, None, "float32", False)[1]
    add(f"K9 float32 A[i,a,b,c,d] B[d,c,b,a,j] i=j={i} a..d={r}: 4 "
        f"contracted axes path={_k9_path(plan)}", "K9",
        lambda: ops.apply(red4, ra, rb),
        lambda: torch.einsum("iabcd,dcbaj->ij", ra, rb), False,
        *k9_tc_bound(1.0 * i * i * r ** 4, wide_bytes))
    # the same nest in max-plus: its derived schedule (the reference's
    # nest model, the combine materialized) passes the card's shared
    # memory, so apply refuses it before any kernel; K9 reads no schedule
    # blocks, and its descriptor with the semiring's inert element runs it
    # (ops.semiring_contract, the wrapper apply calls)
    mp4 = E.inner("max", "add",
                  E.transpose(E.arr("A", (i, r, r, r, r)), (1, 2, 3, 0, 4)),
                  E.transpose(E.arr("B", (r, r, r, r, i)), (3, 2, 1, 0, 4)),
                  batch=3)
    for _ in range(3):
        mp4 = E.reduce("max", mp4, 0)
    mp4_launch = emit.describe(None, E.normal_form(mp4))
    ma, mb = rnd(i, r, r, r, r), rnd(r, r, r, r, i)
    add(f"K9 float32 max-plus A[i,a,b,c,d] B[d,c,b,a,j] i=j={i} a..d={r}: "
        f"4 contracted axes path={_k9_path(mp4_launch)}", "K9",
        lambda: ops.semiring_contract(mp4_launch, ma, mb), None, True,
        k9_bound(2.0 * i * i * r ** 4, wide_bytes))
    # float16 operands under the f32 accumulator: moa_gemm on K1's tile
    # route (f16 wgmma, one product a term at the f16 peak)
    n = MOA_N
    ha16, hb16 = rnd(n, n, dt=torch.float16), \
        rnd(n, n, dt=torch.float16) * n ** -0.5
    f16_bytes = 2 * n * n * 2 + n * n * 4
    add(f"K1 float16 moa_gemm {n}^3 (f32 accumulator) "
        f"path={_route(ops, ha16, hb16, False, False)}", "K1",
        lambda: ops.moa_gemm(ha16, hb16, out_dtype=torch.float32),
        lambda: torch.matmul(ha16, hb16), False,
        bound(2.0 * n ** 3, f16_bytes, "float16"))
    add(f"K9 float16 max-plus {n}x{n}x{n}", "K9",
        lambda: ops.semiring_matmul(ha16, hb16, plus="max", times="add"),
        None, True, k9_bound(2.0 * n ** 3, 2 * n * n * 2 + n * n * 4))
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
    # moa_gemms), and one apply under sync debug mode "error"; each
    # ops.apply call is recorded (expression, operands, options) for
    # derive_path's verification
    applied = []
    plain_apply = ops.apply

    def recording(expr, *arrays, **kw):
        applied.append((expr, arrays, kw))
        return plain_apply(expr, *arrays, **kw)

    ops.reset_launches()
    t0 = time.perf_counter()
    with _patched(ops, "apply", recording):
        outs = [c[2]() for c in cases]
        X = x.reshape(KRON, KRON)
        T = ops.apply(E.matmul_expr(KRON, KRON, KRON, transpose_b=True), X,
                      kb)
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
        dname = label.split()[1]
        tol = TOL.get((kid, dname), MOA_SUM_TOL)
        ok = torch.equal(out, want_out) if exact else diff <= tol * scale
        del want_out
        big = MOA_BIG in (out.shape[0], out.shape[-1]) and out.dim() == 2 \
            and "hadamard" not in label and "lone" not in label
        ms = time_ms(torch, fn, iters=2 if big else 10,
                     warmup=1 if big else 3)
        plain_ms = time_ms(torch, plain, iters=1, warmup=0)
        lib_ms = time_ms(torch, library) if library is not None else None
        # a sub-millisecond K9 call may be host-bound: its device time too
        # (and K1's f32 moa_gemm's, on the FMA kernel, and f16's, on the
        # tile route, each with a rerun)
        k1_other = kid == "K1" and dname in ("float32", "float16")
        g_ms = graph_ms(torch, fn) if (kid == "K9" and ms < 1.0) or \
            k1_other else None
        if k1_other or "lone max over axes" in label or \
                "contracted axes" in label:
            _rerun_equal(torch, fn, f"[moa_path] {label}")
        # the float16 tile, the wide TILE rows and the kron rows (MAP's
        # span walk): the library call's device time too
        if library is not None and g_ms is not None and (
                "contracted axes" in label or dname == "float16"
                or "kron" in label):
            extra = dict(extra, library_graph_ms=graph_ms(torch, library))
        note = "".join(f" {k}={v:.4f}" for k, v in extra.items())
        print(f"[moa_path] {label}{note}: max_abs_err={diff:.3e} "
              f"({'bit for bit' if exact else f'tol {tol:g} x max|plain|'}"
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
    return launches, applied


# ---------------------------------------------------------------------------
# derive_path: the recurrent derivation, the static verifier, int8 -> int32
# ---------------------------------------------------------------------------

#: derive_path's mamba2-780m train steps: depth cut to 12 of 48 layers
#: (the smoke's time; each layer's SSD call is the same at any depth)
DERIVE_TRAIN_LAYERS = 12
#: the int8 product of derive_path (through ops.apply, acc_dtype int32):
#: 4096^3, and a ragged (m, k, n) that torch._int_mm does not take
INT8_N = 4096
INT8_RAGGED = (1001, 37, 999)


def _chunk_agreement(torch, cfg, pinned, params, prompt, tok, q):
    """The 300-token prompt's prefill (logits, state, conv tail) and one
    decode step from its cache at the derived chunk (``cfg``) against the
    pinned chunk (``pinned``), both through the kernels, in f32 on the same
    weights and in bf16 beside the pinned bf16 run's own distance from
    f32 (``_f32_witness``: ``[ssm_path]``'s tolerances)."""
    from repro_torch.models import transformer
    pf = _f32_copy(params)
    out = {}
    for dt, prm in (("float32", pf), ("bfloat16", params)):
        for ref_run, c in ((False, cfg), (True, pinned)):
            c = c.with_(dtype=dt)
            lg, cache = transformer.prefill(prm, c, prompt)
            dec, _ = transformer.decode_step(
                prm, c, tok, None,
                transformer.prefill_cache_to_decode(c, cache, 512))
            require(bool(torch.isfinite(lg).all() and torch.isfinite(dec)
                         .all()), f"{dt} logits not finite")
            out[dt, ref_run] = {"prefill logits": lg, "decode logits": dec,
                                "state": cache.state, "conv tail": cache.conv}
    del pf
    _f32_witness(torch, "derive_path", out,
                 f"{prompt.shape[1]}-token prompt",
                 (f"chunk {q}", f"chunk {pinned.ssm_chunk}"))


def _int8_tile_row(torch, rec, ops, label, call, a, b, ta, tb, k, terms,
                   nbytes, lib, lib_name):
    """One int8 product on K1's int8 tile through the user entry ``call``:
    once with the launches counted from 0 (the path's: one K1, no K9) and
    the operands packed K-major counted (``ops.PACKED``, the rule's), bit
    for bit its plain version's exact sums, K1's ``mma.sync`` int8 form's
    on the same operands (no route takes it: the comparison) and the
    library call's (where one computes it), a rerun the same bits; timed
    by events and in a CUDA graph beside the plain version, the ``mma.sync``
    form, the pack alone (its share of the graph time) and the library
    call, bound at the card's dense int8 rate (1979 TOPS, the H100 SXM
    data sheet) or its bytes.  ``lib_name`` names the library call, or
    says why there is none.  Returns the path's launches."""
    # the operands the tile packs K-major (its rule, aligned bases), as
    # (operand, MN-major)
    packs = [(t, mn) for t, mn in zip((a, b), (ta, not tb))
             if not ops.int8_reads_in_place(k, mn, True)]
    torch.cuda.synchronize()
    ops.reset_launches()
    out = call()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    packed = ops.PACKED["int8"]
    require(ops.LAUNCHES["K1"] == 1 and sum(ops.LAUNCHES.values()) == 1
            and out.dtype == torch.int32 and packed == len(packs),
            f"{label}: launches {ops.LAUNCHES}, {packed} packs, not one "
            f"K1 into int32 after {len(packs)} packs")
    form = lambda: ops._gemm_int8(a, b, ta, tb)
    plain = _plain(ops, call)
    same = torch.equal(out, plain) and torch.equal(out, form())
    if lib is not None:
        same = same and torch.equal(out, lib())
    del plain
    _rerun_equal(torch, call, label)
    ms, g_ms = time_ms(torch, call), graph_ms(torch, call)
    plain_ms = time_ms(torch, lambda: _plain(ops, call), iters=2, warmup=1)
    form_ms, form_g = time_ms(torch, form), graph_ms(torch, form)
    pack_g = graph_ms(torch, lambda: [ops.pack_kmajor_int8(t, mn)
                                      for t, mn in packs]) if packs else 0.0
    lib_ms = time_ms(torch, lib) if lib is not None else None
    lib_g = graph_ms(torch, lib) if lib is not None else None
    b_ms, b_by = bound(2.0 * terms, nbytes, "int8")
    r4 = lambda x: x if x is None else round(x, 4)
    print(f"[derive_path] {label} path=int8 tile: {len(packs)} operand(s) "
          f"packed K-major; bit for bit with the plain version, the int8 "
          f"form{' and ' + lib_name if lib else ''}: {same}; ms={ms:.4f} "
          f"graph_ms={g_ms:.4f} pack_graph_ms={pack_g:.4f} (its share "
          f"{g_ms and pack_g / g_ms:.1%}) plain_ms={plain_ms:.4f} "
          f"int8_form_ms={form_ms:.4f} int8_form_graph_ms={form_g:.4f} "
          f"library_ms={r4(lib_ms)} library_graph_ms={r4(lib_g)} "
          f"({lib_name}) "
          f"bound_ms={b_ms:.4f} ({b_by}; {g_ms and b_ms / g_ms:.1%} of it "
          f"in the graph)", flush=True)
    require(same, f"{label}: differs from its plain version, the int8 "
            f"form or {lib_name}")
    rec["K1"][label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            graph_ms=g_ms, library_graph_ms=lib_g,
                            path="int8 tile", packed=len(packs),
                            pack_graph_ms=pack_g, int8_form_ms=form_ms,
                            int8_form_graph_ms=form_g)
    del out
    return counts


def _int8_rows(torch, rec, E, ops, ref):
    """Every 2-D int8 product is K1's int8 tile, through ``ops.apply``
    (acc_dtype int32; ``_int8_tile_row``): 4096^3 with B stored (k, n)
    (B packed K-major first; beside ``torch._int_mm(a, b)`` on the same
    storage), the same with B stored (n, k) (both read in place; beside
    ``torch._int_mm(a, b.t())``, cuBLASLt's own layout), and the ragged
    1001x37x999 (both operands packed to k_pad 48; no library call takes
    it).  Returns the launches of the first call of each (the path's)."""
    i8, i32 = torch.int8, torch.int32
    gen = torch.Generator(device="cuda").manual_seed(27)
    counts = _zero_launches()
    for (m, k, n), tb in (((INT8_N,) * 3, False), ((INT8_N,) * 3, True),
                          (INT8_RAGGED, False)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=i8)
        b = torch.randint(-128, 128, (n, k) if tb else (k, n),
                          generator=gen, device="cuda", dtype=i8)
        route = ops.gemm_route(m, n, k, i8, i8, False, tb)
        require(route == "int8_tile", f"int8 {m}x{k}x{n}: route {route}")
        expr = E.matmul_expr(m, k, n, transpose_b=tb)
        call = lambda: ops.apply(expr, a, b, acc_dtype="int32",
                                 out_dtype=i32)
        lib, lib_name = None, "torch._int_mm takes no k or n off a " \
            "multiple of 8"
        if (m, k, n) == (INT8_N,) * 3:
            lib = (lambda: torch._int_mm(a, b.t())) if tb else (
                lambda: torch._int_mm(a, b))
            lib_name = f"torch._int_mm(a, {'b.t()' if tb else 'b'})"
        label = f"K1 int8 apply {m}x{k}x{n}{' tb=1' if tb else ''} acc int32"
        run = _int8_tile_row(torch, rec, ops, label, call, a, b, False, tb,
                             k, m * n * k, m * k + k * n + 4 * m * n, lib,
                             lib_name)
        for kid, v in run.items():
            counts[kid] += v
        del a, b
    return counts


#: K9's integer accumulator in [derive_path]: the Hadamard, the lone sum
#: and the chain in int8 -> int32; one IMAD a term on the CUDA cores (64
#: INT32 lanes an SM where f32 has 128: half the 33.5 T FMA
#: lane-instructions a second) beside the int8 bound.  The int8 stacks
#: (e = 16 of 1024^3, B stored (e, n, k) or (e, k, n)) are K1's int8 tile
#: (``_int8_stack_row``), and minicpm3-4b's absorbed head products (40
#: heads, 1-4 rows) K1's int8 decode rows (``_int8_head_rows``).
INT32_E, INT32_N, INT32_BIG, INT32_CHAIN = 16, 1024, 8192, 512
IMAD_PER_S = 16.75e12


def _int8_stack_row(torch, rec, E, ops):
    """The int8 stacks (e = 16 of 1024^3, x (e, m, k)) through
    ``ops.apply`` (acc_dtype int32) on K1's int8 tile
    (``_int8_tile_row``): w stored (e, n, k) (both read in place) and w
    stored (e, k, n) (w packed K-major first).  No PyTorch call computes
    it (``torch.bmm`` takes no int8 on the card; ``torch._int_mm`` is
    2-D).  The first also times the tile's wrapper alone by events
    (``ops._gemm_int8_tile``: apply's host path apart).  Returns the
    path's launches."""
    i8 = torch.int8
    gen = torch.Generator(device="cuda").manual_seed(29)
    e, n = INT32_E, INT32_N
    counts = _zero_launches()
    for tb in (True, False):
        x, w = (torch.randint(-128, 128, (e, n, n), generator=gen,
                              device="cuda", dtype=i8) for _ in range(2))
        we = E.arr("W", (e, n, n))
        expr = E.inner("add", "mul", E.arr("X", (e, n, n)),
                       E.transpose(we, (0, 2, 1)) if tb else we, batch=1)
        call = lambda: ops.apply(expr, x, w, acc_dtype="int32",
                                 out_dtype=torch.int32)
        label = (f"K1 int8 batched (B transposed) e={e} {n}^3 acc int32"
                 if tb else f"K1 int8 batched (B stored (e, k, n)) e={e} "
                 f"{n}^3 acc int32")
        route = ops.expert_route(e, n, n, n, i8, i8, True, False, tb)
        require(route == "int8_tile", f"{label}: route {route}")
        run = _int8_tile_row(torch, rec, ops, label, call, x, w, False, tb,
                             n, e * n ** 3, 2 * e * n * n + 4 * e * n * n,
                             None, "torch.bmm takes no int8 on the card; "
                             "torch._int_mm is 2-D")
        for kid, v in run.items():
            counts[kid] += v
        if tb:
            # the tile's wrapper alone by events: apart from the graph
            # time, what apply's host path adds to the call
            rec["K1"][label]["tile_ms"] = time_ms(
                torch, lambda: ops._gemm_int8_tile(x, w, False, True))
            print(f"[derive_path] {label}: the tile's wrapper alone "
                  f"{rec['K1'][label]['tile_ms']:.4f} ms by events",
                  flush=True)
        del x, w
    return counts


def _int8_head_rows(torch, rec, E, ops, ref):
    """minicpm3-4b's absorbed head products in int8 (40 heads, views of a
    stored (256, 40, 128) table read in place): q_lat at 1, 2 and 4 rows
    (k 64, n 256, w stored (n, h, k)) and out at 4 rows (k 256, n 64, w
    stored (k, h, n), its k split), through ``ops.apply`` (acc_dtype
    int32) on K1's int8 decode rows: once with the launches counted from 0
    (the path's: one K1, no K9), bit for bit ``ref.head_gemm_int8``, a
    rerun the same bits; timed by events and in a CUDA graph beside the
    plain version and K9's integer TILE on the same operands (the plan of
    unaligned views, on the row-major copies ``apply`` makes for it, the
    route before this one), bound by bytes.  No PyTorch call computes it
    (``torch.einsum`` takes no int8 on the card).  Returns the path's
    launches."""
    i8 = torch.int8
    gen = torch.Generator(device="cuda").manual_seed(31)
    ints = lambda *s: torch.randint(-128, 128, s, generator=gen,
                                    device="cuda", dtype=i8)
    table = ints(256, 40, 128)
    counts = _zero_launches()
    cases = [(rows, True, 64, 256) for rows in MLA_HEAD_ROWS] + [
        (4, False, 256, 64)]
    for rows, tb, k, n in cases:
        x = ints(rows, 40, k)
        w = table[..., :64] if tb else ints(256, 40, 128)[..., 64:]
        name = "q_lat" if tb else "out"
        label = (f"K1 int8 head {name} m={rows} h=40 k={k} n={n} "
                 f"tb={int(tb)} acc int32")
        route = ops.head_route(40, rows, k, n, i8, i8, tb,
                               ops.head_aligned(x, w))
        require(route == "gemv", f"{label}: route {route}, not gemv")
        expr = E.head_gemm_expr(40, rows, k, n, transpose_b=tb)
        call = lambda: ops.apply(expr, x, w, acc_dtype="int32",
                                 out_dtype=torch.int32)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = call()
        torch.cuda.synchronize()
        for kid, v in ops.LAUNCHES.items():
            counts[kid] += v
        require(ops.LAUNCHES["K1"] == 1 and sum(ops.LAUNCHES.values()) == 1
                and out.dtype == torch.int32,
                f"{label}: launches {ops.LAUNCHES}, not one K1 into int32")
        plan = ops._plan(E.normal_form(expr), ("int8", "int8"), torch.int32,
                         ops.H100, None, "int32", False)
        require(plan[0] == "K9", f"{label}: the unaligned plan {plan[0]}")
        k9 = lambda: ops.semiring_contract(
            plan[1], x.contiguous(), w.contiguous(), out_dtype=torch.int32)
        same = torch.equal(out, ref.head_gemm_int8(x, w, tb)) and \
            torch.equal(out, k9())
        _rerun_equal(torch, call, label)
        ms, g_ms = time_ms(torch, call), graph_ms(torch, call)
        plain_ms = time_ms(torch, lambda: _plain(ops, call), iters=2,
                           warmup=1)
        k9_ms, k9_g = time_ms(torch, k9), graph_ms(torch, k9)
        nsplit = ops.gemv_splits(rows, n, k, 40, *ops.K1_GEMV8[tb])
        terms = 40 * rows * n * k
        b_ms, b_by = bound(2.0 * terms, x.numel() + 40 * n * k
                           + 4 * 40 * rows * n, "int8")
        print(f"[derive_path] {label} path=int8 decode rows split-k="
              f"{nsplit}: bit for bit with the plain version and K9: "
              f"{same}; ms={ms:.4f} graph_ms={g_ms:.4f} plain_ms="
              f"{plain_ms:.4f} k9_ms={k9_ms:.4f} k9_graph_ms={k9_g:.4f} "
              f"library_ms=None (torch.einsum takes no int8 on the card) "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        require(same, f"{label}: differs from its plain version or K9")
        rec["K1"][label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                library_ms=None, bound_ms=b_ms,
                                bound_by=b_by, graph_ms=g_ms,
                                path=f"int8 decode rows split-k={nsplit}",
                                k9_ms=k9_ms, k9_graph_ms=k9_g)
        del out, x, w
    return counts


def _int32_k9_cases(torch, E, ops):
    """``(label, call, library call or None, why none, terms, bytes)`` of
    K9's int8 -> int32 forms on seeded card operands."""
    i8 = torch.int8
    gen = torch.Generator(device="cuda").manual_seed(29)
    ints = lambda *s: torch.randint(-128, 128, s, generator=gen,
                                    device="cuda", dtype=i8)
    apply = lambda expr, *a: (lambda: ops.apply(
        expr, *a, acc_dtype="int32", out_dtype=torch.int32))
    cases = []
    m = INT32_BIG
    ha, hb = ints(m, m), ints(m, m)
    cases.append((f"K9 int8 hadamard {m}^2 acc int32",
                  apply(E.hadamard_expr(m, m), ha, hb), None,
                  "no one PyTorch call multiplies int8 into int32",
                  m * m, 2 * m * m + 4 * m * m))
    lone = ints(m, m)
    cases.append((f"K9 int8 lone sum axis 0 {m}^2 acc int32",
                  apply(E.reduce("add", E.arr("A", (m, m)), 0), lone),
                  lambda: torch.sum(lone, dim=0, dtype=torch.int32), None,
                  m * m, m * m + 4 * m))
    c = INT32_CHAIN
    ca, cb, cc = ints(c, c), ints(c, c), ints(c, c)
    chain = E.arr("A", (c, c)) @ E.arr("B", (c, c)) @ E.arr("C", (c, c))
    cases.append((f"K9 int8 chain A@B@C {c}^4 terms (pairwise) acc int32",
                  apply(chain, ca, cb, cc), None,
                  "two torch._int_mm calls (no single call)",
                  2 * c ** 3, 3 * c * c + 4 * c * c))
    return cases


def _int32_k9_rows(torch, rec, E, ops):
    """Each K9 int8 -> int32 case once with the launches counted from 0
    (the path's), bit for bit its plain version's exact sums (and the
    library call's, where one computes the same function), a rerun the
    same bits; timed by events and in a CUDA graph beside its plain
    version, library call and bound.  Returns the path's launches."""
    counts = _zero_launches()
    for label, call, lib, why, terms, nbytes in _int32_k9_cases(torch, E,
                                                                ops):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = call()
        torch.cuda.synchronize()
        for kid, v in ops.LAUNCHES.items():
            counts[kid] += v
        require(ops.LAUNCHES["K9"] == 1 and ops.LAUNCHES["K1"] == 0
                and out.dtype == torch.int32,
                f"{label}: launches {ops.LAUNCHES}, not one K9 into int32")
        plain = _plain(ops, call)
        same = torch.equal(out, plain)
        if lib is not None:
            same = same and torch.equal(out, lib())
        del plain
        _rerun_equal(torch, call, label)
        ms = time_ms(torch, call)
        g_ms = graph_ms(torch, call)
        plain_ms = time_ms(torch, lambda: _plain(ops, call), iters=2,
                           warmup=1)
        lib_ms = time_ms(torch, lib) if lib is not None else None
        b_ms, b_by = bound(2.0 * terms, nbytes, "int8")
        imad_ms = terms / IMAD_PER_S * 1e3
        print(f"[derive_path] {label}: bit for bit with the plain version"
              f"{' and the library call' if lib else ''}: {same}; "
              f"ms={ms:.4f} graph_ms={g_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}"
              f"{'' if lib else f' ({why})'} bound_ms={b_ms:.4f} ({b_by}) "
              f"imad_bound_ms={imad_ms:.4f}", flush=True)
        require(same, f"{label}: differs from its plain version")
        rec["K9"][label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by, graph_ms=g_ms,
                                imad_bound_ms=imad_ms)
        del out
    return counts


def phase_derive_path(torch, rec, applied):
    """The derivation on the H100 table end to end: mamba2-780m at full
    width and depth with ``ssm_chunk = 0`` (the SSD chunk derived:
    ``ops.default_ssd_chunk``) served over ``[ssm_path]``'s prompts and
    trained at B=2 S=2048 with its depth cut to ``DERIVE_TRAIN_LAYERS``,
    held to the config's pinned chunk 256;
    recurrentgemma-9b's derived gated chunk (``[hybrid_path]`` ran K8 at
    it); ``apply(verify=True)`` and ``verify="kernel"`` on every
    expression ``[moa_path]`` ran (zero error findings, the second call a
    cache hit, host µs); the ``verify_all`` sweep's H100 summary; K1's
    int8 products and stacks on K1's int8 tile (``_int8_rows``,
    ``_int8_stack_row``), the int8 head form on its int8 decode rows
    (``_int8_head_rows``) and K9's int8 -> int32 forms
    (``_int32_k9_rows``).  Returns the
    launches of its driven paths."""
    import numpy as np
    from repro_torch import analysis
    from repro_torch.analysis import verify_all
    from repro_torch.configs import mamba2_780m, recurrentgemma_9b
    from repro_torch.core import expr as E
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import TPU_V5E
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm
    from repro_torch.serving import ServeEngine
    from repro_torch.train import train_step as ts

    phase_t0 = time.perf_counter()
    launches = _zero_launches()

    def count(run):
        for kid, v in run.items():
            launches[kid] += v

    # 1. mamba2-780m with ssm_chunk = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pinned, params = _model(torch, mamba2_780m)
    cfg = pinned.with_(ssm_chunk=0)
    h, hp, n = ssm.n_ssd_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    reqs = _ssm_reqs(np, cfg)
    q = ops.default_ssd_chunk(SSM_S, h, hp, n)
    served_q = sorted({min(ops.default_ssd_chunk(len(pr), h, hp, n), len(pr))
                       for pr, _ in reqs})
    print(f"[derive_path] mamba2-780m ssm_chunk=0: derived SSD chunk {q} "
          f"at S={SSM_S} (h={h} p={hp} n={n}, the H100 table; carried state "
          f"{2 * h * hp * n * 4 / 1e6:.2f} MB against a quarter of 227 KB; "
          f"the v5e copy derives "
          f"{ops.default_ssd_chunk(SSM_S, h, hp, n, hardware=TPU_V5E)}; "
          f"the config pins {pinned.ssm_chunk}); the served prompts' "
          f"derived chunks {served_q}", flush=True)
    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    run = _run_engine(torch, engine, reqs)
    rids, results, served = run[:3]
    _serve_line(torch, np, "derive_path", reqs, *run, engine)
    L = cfg.n_layers
    want = _zero_launches(K1=len(rids) * (3 * L + 1)
                          + engine.kernel_calls * (2 * L + 1),
                          K6=L * len(rids))
    print(f"[derive_path] serving launches {served} (derived {want})",
          flush=True)
    require(served == want, "derive_path serving launches differ from the "
            "derived counts")
    count(served)
    del engine
    with torch.inference_mode():
        prompt = torch.tensor([reqs[0][0]], device="cuda")
        tok = torch.tensor([results[rids[0]]["tokens"][0]], device="cuda")
        _chunk_agreement(torch, cfg, pinned, params, prompt, tok,
                         min(q, prompt.shape[1]))
    del params
    torch.cuda.empty_cache()

    # train steps at B=2 S=2048 at the derived chunk and at 256 (the same
    # batches, one optimizer state stepped through both), depth cut
    cfg = cfg.with_(n_layers=DERIVE_TRAIN_LAYERS)
    pinned = pinned.with_(n_layers=DERIVE_TRAIN_LAYERS)
    L = cfg.n_layers
    _, params = _model(torch, mamba2_780m, DERIVE_TRAIN_LAYERS,
                       trainable=True)
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, SSM_S, SSM_B, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(2)]
    print(f"[derive_path] step-1 loss and gradients at chunk {q} "
          f"('kernels') against chunk {pinned.ssm_chunk} ('plain'), both "
          f"through the kernels:", flush=True)
    _grad_agreement(torch, "derive_path", cfg, params, batches[0],
                    against=pinned)
    torch.cuda.empty_cache()
    state = ts.init_state(cfg, params, "cuda")
    steps = {}
    for c in (cfg, pinned):
        step = ts.make_train_step(c)
        state, rows, run, peak = _train_steps(
            torch, "derive_path", step, state, batches, SSM_B * SSM_S)
        steps[c.ssm_chunk] = (rows[-1][0], peak)
        if c is cfg:
            n2 = len(batches)
            want = _zero_launches(K1=n2 * (2 * L + 1 + 2 * L
                                           + 2 * (2 * L + 1)),
                                  K6=n2 * 2 * L, K7=n2 * L)
            require(run == want, f"derive_path train launches {run} != "
                    f"{want}")
            count(run)
            # K6 / K7's share of the step by kernel at the derived chunk
            # ([ssm_train]'s profile has them at 256)
            profile_step(torch, lambda: step(state, batches[0]), n=1,
                         what=f"derive_path train (chunk {q})")
    (ms_q, peak_q), (ms_p, peak_p) = steps[0], steps[pinned.ssm_chunk]
    print(f"[derive_path] mamba2-780m ({L} of 48 layers) train step "
          f"B={SSM_B} S={SSM_S}: chunk "
          f"{q} {ms_q:.3f} ms, peak {peak_q / 2**30:.2f} GiB; chunk "
          f"{pinned.ssm_chunk} {ms_p:.3f} ms, peak {peak_p / 2**30:.2f} GiB",
          flush=True)
    for kid, what in (("K6", " export"), ("K6", ""), ("K7", "")):
        rows = {qq: rec[kid][f"{kid} float32 B={SSM_B} S={SSM_S} q={qq} "
                             f"h={h} p={hp} n={n}{what}"]
                for qq in (q, 256)}
        print(f"[derive_path] {kid}{what} on the same operands: q={q} "
              f"{rows[q]['ms']:.4f} ms (graph {rows[q]['graph_ms']:.4f}) "
              f"against q=256 {rows[256]['ms']:.4f} ms (graph "
              f"{rows[256]['graph_ms']:.4f})", flush=True)
    del state, params, batches
    torch.cuda.empty_cache()

    # 2. recurrentgemma-9b: the gated chunk its prefill derived
    rcfg = recurrentgemma_9b.full()
    qg = ops.default_gated_chunk(HYB_S, rcfg.lru_width)
    print(f"[derive_path] recurrentgemma-9b: derived gated chunk {qg} at "
          f"S={HYB_S} w={rcfg.lru_width} (the H100 table; the v5e copy "
          f"derives {ops.default_gated_chunk(HYB_S, rcfg.lru_width, hardware=TPU_V5E)}); "
          f"[hybrid_path]'s make_prefill ran K8 at it", flush=True)
    for tail in ("", " reverse h0"):
        rows = {c: rec["K8"][f"K8 float32 B=1 S={HYB_S} w=4096{tail} "
                             f"chunk={c}"] for c in (qg, 64)}
        print(f"[derive_path] K8{tail or ' forward'} on the same operands: "
              f"chunk={qg} {rows[qg]['ms']:.4f} ms (graph "
              f"{rows[qg]['graph_ms']:.4f}, bound {rows[qg]['bound_ms']:.4f})"
              f" against chunk=64 {rows[64]['ms']:.4f} ms (graph "
              f"{rows[64]['graph_ms']:.4f})", flush=True)

    # 3. the static verifier on every expression moa_path ran
    analysis.reset_verification_cache()
    first, cached, plain_us = [], [], []
    for expr, arrays, kw in applied:
        for mode in (True, "kernel"):
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                before = analysis.verification_cache_stats()
                t0 = time.perf_counter()
                try:
                    ops.apply(expr, *arrays, verify=mode, **kw)
                except analysis.VerificationError as exc:
                    fail(f"[derive_path] verify={mode!r}: {exc}")
                times.append((time.perf_counter() - t0) * 1e6)
                after = analysis.verification_cache_stats()
            require(after["hits"] == before["hits"] + 1, "the second "
                    "verified call did not hit the verification cache")
            first.append(times[0])
            cached.append(times[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.apply(expr, *arrays, **kw)
        plain_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    print(f"[derive_path] verify=True and verify='kernel' on the "
          f"{len(applied)} expressions [moa_path] applied: 0 error findings; "
          f"every second call a verification-cache hit; host us a call "
          f"(median / max): first {med(first):.1f} / {max(first):.1f}, "
          f"cached {med(cached):.1f} / {max(cached):.1f}, unverified "
          f"{med(plain_us):.1f} / {max(plain_us):.1f}; cache "
          f"{analysis.verification_cache_stats()}", flush=True)

    # 4. the sweep on the H100 table
    t0 = time.perf_counter()
    report = verify_all.run_sweep()
    h_cases = {c: v for c, v in report["cases"].items()
               if c.startswith("h100/")}
    h_err = [f for f in report["findings"] if f["case"].startswith("h100/")]
    print(f"[derive_path] verify_all on the H100 table: {report['forms']} "
          f"forms x {len(report['dtypes'])} dtypes {report['dtypes']}: "
          f"{sum(v == 'checked' for v in h_cases.values())} checked, "
          f"{sum(v == 'refused' for v in h_cases.values())} refused, "
          f"{len(h_err)} error findings ({time.perf_counter() - t0:.2f} s "
          f"for both tables)", flush=True)
    require(report["failed"] == 0, f"verify_all failures "
            f"{report['failures']}")

    # 5. K1's int8 tile and int8 decode rows, then K9's integer
    # accumulator
    count(_int8_rows(torch, rec, E, ops, ref))
    count(_int8_stack_row(torch, rec, E, ops))
    count(_int8_head_rows(torch, rec, E, ops, ref))
    count(_int32_k9_rows(torch, rec, E, ops))
    print(f"[derive_path] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# moe_path: deepseek-moe-16b, the MoE family's serving path
# ---------------------------------------------------------------------------

#: [energy_path]: the square GEMM sizes; the least device time of one
#: CUDA-graph replay (r products captured, so a small N is not bound by the
#: host's launches); the least window of replays between two reads of the
#: energy counter; the idle window; nvidia-smi's sampling period where NVML
#: refuses the counter
ENERGY_NS = (1024, 2048, 4096, 8192)
ENERGY_REPLAY_MS = 20.0
ENERGY_WINDOW_S = 1.0
ENERGY_IDLE_S = 1.0
ENERGY_SMI_MS = 100


class _NvmlEnergy:
    """The card's own energy counter: NVML's
    ``nvmlDeviceGetTotalEnergyConsumption`` (mJ since the driver loaded),
    bound by ctypes to ``libnvidia-ml.so.1``, on the device at torch's
    device 0's PCI bus id (its UUID where the bus id is not known)."""

    def __init__(self, torch):
        import ctypes
        self.ct = ctypes
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._ok("nvmlInit_v2", self.lib.nvmlInit_v2())
        self.handle = ctypes.c_void_p()
        props = torch.cuda.get_device_properties(0)
        if hasattr(props, "pci_bus_id"):
            self.bus = (f"{getattr(props, 'pci_domain_id', 0):08x}:"
                        f"{props.pci_bus_id:02x}:"
                        f"{props.pci_device_id:02x}.0")
            self._ok("nvmlDeviceGetHandleByPciBusId_v2",
                     self.lib.nvmlDeviceGetHandleByPciBusId_v2(
                         self.bus.encode(), ctypes.byref(self.handle)))
        else:
            self.bus = None
            self._ok("nvmlDeviceGetHandleByUUID",
                     self.lib.nvmlDeviceGetHandleByUUID(
                         f"GPU-{props.uuid}".encode(),
                         ctypes.byref(self.handle)))
        self.source = (f"NVML nvmlDeviceGetTotalEnergyConsumption (mJ), "
                       f"device {self.bus or props.uuid}")
        self.read()

    def _ok(self, what, code):
        if code != 0:
            raise RuntimeError(f"{what} returned NVML error {code}")

    def read(self) -> float:
        """Joules since the driver loaded."""
        mj = self.ct.c_ulonglong()
        self._ok("nvmlDeviceGetTotalEnergyConsumption",
                 self.lib.nvmlDeviceGetTotalEnergyConsumption(
                     self.handle, self.ct.byref(mj)))
        return mj.value / 1e3

    def close(self) -> None:
        self.lib.nvmlShutdown()


class _SmiEnergy:
    """Where NVML refuses: ``nvidia-smi --query-gpu=power.draw`` sampled
    every ENERGY_SMI_MS by one ``nvidia-smi -lms`` process, integrated on
    the host's clock (trapezoids between arrivals); ``read`` is the
    integral so far, so a window's ends are as coarse as the period."""

    def __init__(self, bus):
        import threading
        self.joules, self.last, self.lock = 0.0, None, threading.Lock()
        target = [f"--id={bus}"] if bus else []
        self.proc = subprocess.Popen(
            ["nvidia-smi", *target, "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", str(ENERGY_SMI_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.source = (f"nvidia-smi power.draw sampled every "
                       f"{ENERGY_SMI_MS} ms, integrated on the host clock")
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()
        t0 = time.perf_counter()
        while self.last is None and time.perf_counter() - t0 < 10:
            time.sleep(0.01)
        require(self.last is not None, "nvidia-smi gave no power sample")

    def _pump(self):
        for line in self.proc.stdout:
            try:
                watts = float(line.strip())
            except ValueError:
                continue
            now = time.perf_counter()
            with self.lock:
                if self.last is not None:
                    t, w = self.last
                    self.joules += 0.5 * (w + watts) * (now - t)
                self.last = (now, watts)

    def read(self) -> float:
        with self.lock:
            return self.joules

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.thread.join(timeout=10)


def _energy_meter(torch):
    """NVML's counter, or nvidia-smi's sampled power where NVML refuses;
    the phase prints which."""
    try:
        return _NvmlEnergy(torch)
    except (OSError, AttributeError, RuntimeError) as err:
        print(f"[energy_path] NVML refused ({err}); falling back to "
              f"nvidia-smi power.draw", flush=True)
    props = torch.cuda.get_device_properties(0)
    bus = (f"{getattr(props, 'pci_domain_id', 0):08x}:"
           f"{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
           if hasattr(props, "pci_bus_id") else None)
    return _SmiEnergy(bus)


def _edge(meter, since=None) -> tuple[float, float]:
    """``(joules, host time)`` at the counter's next update after ``since``
    (a value read before; now by default), polled every 0.5 ms: the
    counter moves in steps (about every 100 ms on an H100), so a window
    read between two steps' edges counts whole steps, where a read at a
    random instant would miss up to a step at either end.  Gives up
    after 1 s and returns the value it holds then."""
    v0 = meter.read() if since is None else since
    t_start = time.perf_counter()
    while True:
        v, t = meter.read(), time.perf_counter()
        if v != v0 or t - t_start > 1.0:
            return v, t
        time.sleep(0.0005)


def _idle_power(torch, meter) -> tuple[float, int]:
    """Mean watts over at least ENERGY_IDLE_S with nothing launched, from
    one counter edge to another, and how many times the counter changed
    in that window (its update rate)."""
    torch.cuda.synchronize()
    time.sleep(0.2)
    e0, t0 = _edge(meter)
    last, changes = e0, 0
    while time.perf_counter() - t0 < ENERGY_IDLE_S:
        time.sleep(0.001)
        now = meter.read()
        changes += now != last
        last = now
    e1, t1 = _edge(meter, last)
    return (e1 - e0) / (t1 - t0), changes + 1


def _energy_row(torch, meter, fn, idle_w) -> dict:
    """``fn``'s time, energy and power over a window of at least
    ENERGY_WINDOW_S: r calls captured in one CUDA graph (a replay at least
    ENERGY_REPLAY_MS of device time), the graph replayed R times from one
    counter edge (``_edge``) until the synchronize after the last, the
    next edge read after that and the idle power of the tail between
    the two taken off; the same replays timed by CUDA events."""
    one = time_ms(torch, fn, iters=3, warmup=2)
    r = max(1, math.ceil(ENERGY_REPLAY_MS / one))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph):
            for _ in range(r):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    replay_ms = time_ms(torch, graph.replay, iters=2, warmup=1)
    reps = max(1, math.ceil(ENERGY_WINDOW_S * 1e3 / replay_ms))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0, t0 = _edge(meter)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    e1, t1 = _edge(meter)
    del graph
    n = reps * r
    wall = t_end - t0
    joules = e1 - e0 - idle_w * (t1 - t_end)
    return dict(ms=start.elapsed_time(end) / n, J=joules / n,
                J_above_idle=(joules - idle_w * wall) / n, W=joules / wall,
                products=n, per_replay=r, window_s=wall, rose=e1 > e0)


def _slopes(values) -> list:
    """log2(v(2N) / v(N)) between neighbouring sizes."""
    return [round(math.log2(b / a), 3) if a > 0 and b > 0 else None
            for a, b in zip(values, values[1:])]


def phase_energy_path(torch, card) -> dict:
    """The paper's energy model held against the card's own energy
    counter: idle power, then for N in ENERGY_NS three families of
    square products, each timed and metered over a window of CUDA-graph
    replays: (a) ``ops.moa_gemm`` in bf16 (K1, B row-major: MoA's
    contiguous normal form), (b) the same product with B stored
    column-major through ``ops.apply`` (the classical column walk of B,
    its route printed), (c) max-plus in f32 on K9 (CUDA cores, as the
    paper's V100), and the library row, ``torch.matmul`` on (a)'s
    operands.  Every row prints its bound (the bytes or the operations:
    bf16 at 989 TFLOP/s, max-plus by ``k9_bound``); the bf16 rows print
    the model's ms, J, W and bound (``energy.gemm_energy`` on the H100
    table's solved blocks) beside the derived block and K1's tile, and
    the classical HBM bytes the model charges; a line a size gathers the
    kernel table's row (with the plain versions' ms of (a) and (c)); then
    the slopes log2(E(2N)/E(N)) and the paper's
    §3.6.3 ratios.  Each kernel family's 1024 product is held to its
    plain version.  Returns the launches of its driven calls."""
    from repro_torch.core import energy
    from repro_torch.core import expr as E
    from repro_torch.core.blocking import solve_blocks
    from repro_torch.hardware import H100
    from repro_torch.kernels import ops

    phase_t0 = time.perf_counter()
    limit_w = float(card.rsplit(",", 1)[1].strip().split()[0])
    meter = _energy_meter(torch)
    try:
        idle_w, changes = _idle_power(torch, meter)
        print(f"[energy_path] source: {meter.source}; idle {idle_w:.2f} W "
              f"over {ENERGY_IDLE_S:.1f} s, the counter changed {changes} "
              f"times in it ({card})", flush=True)
        require(0 < idle_w <= 1.05 * limit_w, f"idle power {idle_w} W "
                f"outside (0, 1.05 x {limit_w} W]")
        gen = torch.Generator(device="cuda").manual_seed(28)
        rows = {"a": [], "b": [], "c": [], "lib": [], "model": []}
        ops.reset_launches()
        for n in ENERGY_NS:
            a = torch.randn(n, n, generator=gen, device="cuda").bfloat16()
            b = (torch.randn(n, n, generator=gen, device="cuda")
                 * n ** -0.5).bfloat16()
            bt = b.t().contiguous()              # B stored column-major
            col = E.inner("add", "mul", E.arr("A", (n, n)),
                          E.arr("B", (n, n), layout="col"))
            a32, b32 = a.float(), b.float()
            fams = {
                "a": (f"moa_gemm bf16 (K1 {_route(ops, a, b, False, False)}"
                      f", B row-major)",
                      lambda: ops.moa_gemm(a, b, out_dtype=torch.float32)),
                "b": (None, lambda: ops.apply(col, a, bt,
                                              out_dtype=torch.float32)),
                "c": ("max-plus f32 (K9, B row-major)",
                      lambda: ops.semiring_matmul(a32, b32, plus="max",
                                                  times="add")),
                # the library call on the same bf16 operands, timed and
                # metered as the others; used nowhere in the port.  It
                # writes bf16 where (a) and (b) write f32: n * n * 2
                # fewer bytes, 0.6 us at N = 1024 at 3.35 TB/s
                "lib": ("library torch.matmul bf16, bf16 out (B row-major)",
                        lambda: torch.matmul(a, b))}
            before = dict(ops.LAUNCHES)
            fams["b"][1]()
            torch.cuda.synchronize()
            kid = next(k for k in ops.LAUNCHES
                       if ops.LAUNCHES[k] > before[k])
            fams["b"] = (f"apply bf16, B col-layout ({kid}"
                         + (f" {_route(ops, a, bt, False, True)} tb=1"
                            if kid == "K1" else "") + ")", fams["b"][1])
            if n == ENERGY_NS[0]:
                for key, (label, fn) in fams.items():
                    if key == "lib":
                        continue
                    got = fn()
                    with ops.reference_mode():
                        want = fn()
                    torch.cuda.synchronize()
                    if key == "c":
                        ok = torch.equal(got, want)
                    else:
                        err = (got - want).abs().max().item()
                        ok = err <= TOL[("K1", "bfloat16")] * \
                            want.abs().max().item()
                    print(f"[energy_path] {label} N={n}: equals its plain "
                          f"version: {ok}", flush=True)
                    require(ok, f"[energy_path] {label}: differs from its "
                            f"plain version")
                    del got, want
            bc = solve_blocks(n, n, n, "bfloat16", H100)
            model = energy.gemm_energy(n, n, n, bc, hardware=H100)
            bn = 256 if -(-n // 128) * -(-n // 256) >= ops.SM_COUNT else 128
            rows["model"].append(model)
            for key, (label, fn) in fams.items():
                row = _energy_row(torch, meter, fn, idle_w)
                if key in ("a", "c"):        # the plain versions' time
                    row["plain_ms"] = plain_time_ms(
                        torch, lambda: _plain(ops, fn))
                rows[key].append(row)
                require(row["rose"] and row["J"] > 0, f"[energy_path] "
                        f"{label} N={n}: the energy counter did not rise")
                require(0 < row["W"] <= 1.05 * limit_w, f"[energy_path] "
                        f"{label} N={n}: mean power {row['W']:.1f} W "
                        f"outside (0, 1.05 x {limit_w} W]")
                line = (f"[energy_path] {label} N={n}: {row['ms']:.4f} ms, "
                        f"{row['J']:.6f} J a product ({row['J_above_idle']:.6f}"
                        f" J above idle), mean {row['W']:.1f} W over "
                        f"{row['window_s']:.3f} s ({row['products']} "
                        f"products, {row['per_replay']} a replay)")
                if key in ("a", "b", "lib"):
                    # each operand read once (bf16), C written once (f32;
                    # bf16 for the library call)
                    row["bound_ms"], row["bound_by"] = bound(
                        2.0 * n ** 3, n * n * (2 + 2 + (2 if key == "lib"
                                                       else 4)), "bfloat16")
                else:
                    # an add and a max a term, f32 lane instructions
                    row["bound_ms"], row["bound_by"] = k9_bound(
                        2.0 * n ** 3, 3 * n * n * 4)
                line += (f"; bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']})")
                if key in ("a", "b"):
                    line += (f"; model {model.time_s * 1e3:.4f} ms, "
                             f"{model.energy_J:.6f} J, {model.power_W:.1f} "
                             f"W, {model.bound}-bound, derived block "
                             f"{bc.as_tuple()} vs K1 tile (128, {bn}, 64); "
                             f"classical HBM bytes "
                             f"{energy.gemm_unblocked_traffic(n, n, n):.4e}")
                print(line, flush=True)
            del a, b, bt, a32, b32
            torch.cuda.empty_cache()
        launches = dict(ops.LAUNCHES)
        for i, n in enumerate(ENERGY_NS):
            print(f"[energy_path] N={n} table row: moa_gemm bf16 "
                  f"{rows['a'][i]['ms']:.4f} ms / library torch.matmul "
                  f"{rows['lib'][i]['ms']:.4f} ms / bound "
                  f"{rows['a'][i]['bound_ms']:.4f} ms / plain "
                  f"{rows['a'][i]['plain_ms']:.4f} ms; max-plus "
                  f"{rows['c'][i]['ms']:.4f} ms / bound "
                  f"{rows['c'][i]['bound_ms']:.4f} ms / plain "
                  f"{rows['c'][i]['plain_ms']:.4f} ms "
                  f"({rows['c'][i]['bound_by']}); J a product moa_gemm "
                  f"{rows['a'][i]['J']:.6f}, library "
                  f"{rows['lib'][i]['J']:.6f}, max-plus "
                  f"{rows['c'][i]['J']:.6f} ({card})", flush=True)
        for key, label in (("a", "moa_gemm bf16"),
                           ("b", "apply bf16 col-layout B"),
                           ("c", "max-plus f32"),
                           ("lib", "library torch.matmul bf16")):
            rs = rows[key]
            p = [r["W"] for r in rs]
            t = [r["ms"] for r in rs]
            print(f"[energy_path] {label}: slopes log2(E(2N)/E(N)) total "
                  f"{_slopes([r['J'] for r in rs])}, above idle "
                  f"{_slopes([r['J_above_idle'] for r in rs])}, time "
                  f"{_slopes(t)}; power max/min {max(p) / min(p):.3f} "
                  f"against time max/min {max(t) / min(t):.1f}", flush=True)
        ms_ = rows["model"]
        print(f"[energy_path] model (H100 table, bf16): slopes energy "
              f"{_slopes([m.energy_J for m in ms_])}, time "
              f"{_slopes([m.time_s for m in ms_])}; power max/min "
              f"{max(m.power_W for m in ms_) / min(m.power_W for m in ms_):.3f}"
              f" against time max/min "
              f"{ms_[-1].time_s / ms_[0].time_s:.1f}", flush=True)
    finally:
        meter.close()
    print(f"[energy_path] launches {launches}; phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launches


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


def _moe_layers_check(torch, cfg, params, tokens, rows, phase):
    """Every layer of the served bf16 model, each sublayer fed the plain
    path's input on both sides (so that nothing compounds): attention (a
    local layer's windowed) and its K/V at the prefill's tokens; the dense
    layer's MLP; each MoE FFN at the prefill's tokens (K1's tile route)
    and at the 2 decode-shaped ``rows`` (cap 8, the gemv route), with the
    routing held to the plain router's (its top-k and gates fed to both
    sides), so the expert GEMMs are compared on one dispatch; the router
    logits (f32 on K1's FMA route) against the plain product; and the
    routings that the two routers order differently, counted."""
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
        window = cfg.local_window if kind == "moe_local" else 0
        (ok, kk), (op, kp) = both(lambda: attn.attention_fwd(
            lp["attn"], h, cfg, positions=positions, window=window))
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
        print(f"[{phase}] bfloat16 per layer (the same input on both "
              f"sides), {what}: worst {err:.3e} of max|plain| at layer {i} "
              f"(tol {tol:g})", flush=True)
        require(err <= tol, f"layer {i} {what} disagrees with plain")
    print(f"[{phase}] per layer, the same input: of {routed} (token, "
          f"layer) routings, {flips[0]} choose other experts and {flips[1]} "
          f"order the same experts otherwise under the kernels' router than "
          f"under the plain one (reported, not held: a last-bit difference "
          f"swaps near-tied experts)", flush=True)


def _kv_leaves(cache):
    """The K and V tensors of a cache: a KV pair or a dict of them."""
    pairs = cache.values() if isinstance(cache, dict) else (cache,)
    return [t for kv in pairs for t in kv]


def _moe_serve_phase(torch, card, module, phase, n_layers=None):
    """A MoE config at full width (``n_layers`` cuts its depth):
    make_prefill B=1 S=MOE_S (derived launches, the bound, a bit-identical
    rerun, the end-to-end routings), each layer against its plain version,
    greedy_generate, a decode step under sync debug "error" against its
    bounds, and profiles.  Returns ``(cfg, params, launches)``."""
    import numpy as np
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params = _model(torch, module, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    full_l = module.full().n_layers
    depth = ("full depth" if L == full_l else
             f"depth cut to {L} of {full_l} layers")
    layout = f"{L} layers"
    if cfg.layer_pattern:
        layout += (f", {transformer.moe_groups(cfg)[0]} groups of "
                   f"{cfg.layer_pattern}, window {cfg.local_window}")
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[{phase}] {cfg.name} full width, {depth} ({layout}; "
          f"{cfg.n_experts} "
          f"experts of {cfg.moe_ff} top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared): {n_params / 1e9:.3f} B params "
          f"({w_bytes / 1e9:.3f} GB, bf16 and the f32 router), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, MOE_S))).cuda()
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_GEN_B, MOE_PROMPT))).cuda()
    k1, k1e = _moe_counts(cfg)
    n_moe = L - cfg.first_dense_layers
    windows = [cfg.local_window if kind == "moe_local" else 0
               for kind, _ in transformer._moe_layers(params, cfg)]
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
        kv = _kv_leaves(cache)
        require(all(tuple(t.shape[-4:]) == (1, MOE_S, cfg.n_kv_heads,
                                            cfg.head_dim_) for t in kv) and
                sum(math.prod(t.shape[:-4]) for t in kv) == 2 * L,
                "prefill cache shapes: K and V of every layer, (1, S, KV, "
                "hd) each")
        want = _zero_launches(K1=k1, K2=L)
        cap = moe.capacity(cfg, MOE_S)
        print(f"[{phase}] make_prefill B=1 S={MOE_S}: {prefill_ms:.3f} ms "
              f"(CUDA events; {MOE_S / prefill_ms * 1e3:.1f} tok/s); "
              f"launches {launches_p} (derived {want}), K1's expert form "
              f"{expert[0]} (derived {k1e}: 2 a MoE layer, cap {cap})",
              flush=True)
        require(launches_p == want and expert[0] == k1e,
                "prefill launches differ from the derived counts")
        d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
        dense_mm = sum(p.numel() for name, p in params.named_parameters()
                       if name.endswith(("wq", "wk", "wv", "wo", "wi",
                                         "router", "shared_wi",
                                         "shared_wo"))
                       and ".moe.w" not in name)
        flops = 2 * MOE_S * dense_mm + 2 * d * cfg.vocab_size \
            + n_moe * 2 * e * cap * (d * 2 * f + f * d) \
            + sum(4 * _pairs(MOE_S, w) for w in windows) * cfg.n_heads \
            * cfg.head_dim_
        step_bytes = _step_bytes(params, cfg)
        b_ms, b_by = bound(flops, step_bytes, "bfloat16")
        print(f"[{phase}] prefill bound: {flops / 1e12:.3f} TFLOP (the "
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
            torch.equal(a, b) for a, b in zip(kv, _kv_leaves(cache2))),
            "a rerun of the prefill differs (dispatch and combine must sum "
            "in a fixed order)")
        print(f"[{phase}] prefill rerun bit-identical (logits and K/V)",
              flush=True)
        del cache, cache2, again, kv

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
        print(f"[{phase}] end to end ({L} bf16 layers, each path its own "
              f"residual): of {MOE_S * n_moe} (token, layer) routings, "
              f"{sets} choose other experts than the plain path's and "
              f"{order} order the same experts otherwise; last-position "
              f"logits max|diff| {(lk - lp).abs().max().item():.3e} of "
              f"{lp.abs().max().item():.3g}, argmax "
              f"{'equal' if same else 'differs'}"
              f" (reported, not held: routing is discontinuous)", flush=True)
        require(cfg.top_k > 1 or order == 0,
                "top-1 routings cannot differ in order alone")
        del routes, lk, lp
        torch.cuda.empty_cache()
        _moe_layers_check(torch, cfg, params, tokens, prompts[:, 0], phase)
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
        print(f"[{phase}] greedy_generate B={MOE_GEN_B}, {MOE_PROMPT} "
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
        print(f"[{phase}] decode step ran with no host sync (sync debug "
              f"mode 'error')", flush=True)
        with ops.reference_mode():
            dp, _ = step()
        print(f"[{phase}] decode step logits vs plain: max|diff| "
              f"{(dk - dp).abs().max().item():.3e} of "
              f"{dp.abs().max().item():.3g}, argmax equal in "
              f"{int((dk.argmax(-1) == dp.argmax(-1)).sum())} of "
              f"{MOE_GEN_B} rows (reported; the per-layer checks hold "
              f"the kernels)", flush=True)
        step_ms = time_ms(torch, step, iters=5, warmup=1)
        all_ms = bound(0.0, step_bytes, "bfloat16")[0]
        active = cfg.param_count()[1] * 2
        act_ms = bound(0.0, active, "bfloat16")[0]
        print(f"[{phase}] decode step (B={MOE_GEN_B}): {step_ms:.3f} ms "
              f"(CUDA events); bound, every weight byte read once "
              f"({step_bytes / 1e9:.3f} GB, what the capacity-padded "
              f"experts read): {all_ms:.3f} ms; bound, the active "
              f"parameters only ({active / 1e9:.3f} GB): {act_ms:.3f} ms; "
              f"{card}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        profile_step(torch, step, n=2, what=f"{phase} decode")
        profile_step(torch, lambda: prefill(params, {"tokens": tokens}),
                     n=1, what=f"{phase} prefill")
    return cfg, params, {k: launches_p[k] + launches_g[k] for k in launches_p}


def phase_moe_path(torch, card):
    """deepseek-moe-16b at full width and depth (``_moe_serve_phase``)."""
    from repro_torch.configs import deepseek_moe_16b
    return _moe_serve_phase(torch, card, deepseek_moe_16b, "moe_path")[2]



def _held_route(record):
    """A ``moe.route`` that routes each layer as ``record`` (the router
    slice's data pointer -> its top-k ``idx``) says: the router's logits
    and probabilities on its own input, the recorded experts, their
    probabilities renormalised as ``route`` does.  Both paths then compute
    one function, differentiable in the router as ``route`` is."""
    from repro_torch.models import moe
    orig = moe.route

    def held(p, xt, cfg):
        logits, probs, _, _ = orig(p, xt, cfg)
        idx = record[p["router"].data_ptr()]
        gates = probs.gather(1, idx)
        return (logits, probs,
                gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx)
    return held


def _moe_train_agreement(torch, cfg, params, batch):
    """Step 1 (the first microbatch: the step's shapes) against the plain
    path.  (1) Each path routes its own residual: the loss is held within
    LOSS_TOL and the routings that differ are counted (a flip compounds;
    reported).  (2) The plain path's routing held on both paths (the same
    function): the loss within LOSS_TOL and every gradient leaf within
    GRAD_TOL in relative norm.  (3) Each MoE layer on the plain path's
    input, routing held: its output within SSM_LAYER_TOL and the
    gradients of its input and leaves within SSM_LAYER_GRAD_TOL, the
    routings its two routers order otherwise counted; the first layer's
    loss and gradients rerun bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import train_step as ts
    record, inputs, own, losses = {}, [], {}, {}

    for plain in (False, True):
        seen = own.setdefault(plain, [])

        def routed(a, o, seen=seen, plain=plain):
            seen.append(o[3])
            if plain:
                record[a[0]["router"].data_ptr()] = o[3]
        with contextlib.ExitStack() as stack, torch.no_grad():
            stack.enter_context(_plain_if(ops, plain))
            stack.enter_context(_spy(moe, "route", routed))
            if plain:
                stack.enter_context(_spy(moe, "apply_moe",
                                         lambda a, o: inputs.append(a[1])))
            losses[plain] = transformer.lm_loss(
                params, cfg, batch["tokens"], batch["targets"])[0].item()
    lk, lp = losses[False], losses[True]
    sets, order = _routing_flips(torch, own[False], own[True])
    n_moe = len(inputs)
    print(f"[moe_train] step-1 loss, each path its own routing: kernels "
          f"{lk:.6f} plain {lp:.6f} rel {abs(lk - lp) / abs(lp):.3e} (tol "
          f"{LOSS_TOL:g}); of {own[True][0].shape[0] * n_moe} (token, "
          f"layer) routings {sets} choose other experts and {order} order "
          f"the same ones otherwise (reported)", flush=True)
    require(abs(lk - lp) <= LOSS_TOL * abs(lp), "loss disagrees with plain")
    del own

    held = _held_route(record)
    res = {}
    for plain in (False, True):
        with _plain_if(ops, plain), _patched(moe, "route", held):
            res[plain] = ts.loss_and_grads(params, cfg, batch)
    (loss_k, _, gk), (loss_p, _, gp) = res[False], res[True]
    lk, lp = loss_k.item(), loss_p.item()
    print(f"[moe_train] step-1 loss, the plain routing held on both paths: "
          f"kernels {lk:.6f} plain {lp:.6f} rel {abs(lk - lp) / abs(lp):.3e} "
          f"(tol {LOSS_TOL:g})", flush=True)
    require(abs(lk - lp) <= LOSS_TOL * abs(lp), "held-routing loss "
            "disagrees with plain")
    worst = (0.0, "")
    for name in gk:
        require(bool(torch.isfinite(gk[name]).all()), f"{name}: non-finite "
                f"grad")
        rel = _rel(torch, gk[name], gp[name], norm=True)
        worst = max(worst, (rel, name))
        require(rel <= GRAD_TOL, f"{name}: gradient disagrees with plain "
                f"({rel:.3e})")
    print(f"[moe_train] step-1 gradients, routing held: worst rel norm err "
          f"{worst[0]:.3e} ({worst[1]}; tol {GRAD_TOL:g}) over {len(gk)} "
          f"leaves", flush=True)
    del res, gk, gp

    layers = [lp for kind, lp in transformer._moe_layers(params, cfg)
              if kind == "moe"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, flips, routed = {}, (0, 0), 0
    for i, (lp, x) in enumerate(zip(layers, inputs)):
        c = torch.randn(x.shape, generator=gen, device="cuda")
        leaves = list(lp["moe"].values())

        def vjp(plain):
            with _plain_if(ops, plain), _patched(moe, "route", held):
                xg = x.detach().requires_grad_()
                y, st = moe.apply_moe(lp["moe"], xg, cfg)
                loss = (y.float() * c).sum() + 0.01 * st.aux_loss \
                    + 1e-3 * st.z_loss
                return (loss.detach(), y.detach()) + torch.autograd.grad(
                    loss, [xg] + leaves)
        got, want = vjp(False), vjp(True)
        with torch.no_grad():
            xt = x.reshape(-1, cfg.d_model)
            flips = tuple(map(sum, zip(flips, _routing_flips(
                torch, [moe.route(lp["moe"], xt, cfg)[3]],
                [record[lp["moe"]["router"].data_ptr()]]))))
        routed += xt.shape[0]
        for what, a, b, tol, norm in (
                [("moe out", got[1], want[1], SSM_LAYER_TOL, False),
                 ("input grad", got[2], want[2], SSM_LAYER_GRAD_TOL, True)]
                + [(f"{name} grad", a, b, SSM_LAYER_GRAD_TOL, True)
                   for name, a, b in zip(lp["moe"], got[3:], want[3:])]):
            err = _rel(torch, a, b, norm=norm)
            worst[what] = max(worst.get(what, (0.0, 0, tol)), (err, i, tol))
        if i == 0:
            again = vjp(False)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    "a MoE layer's loss and gradients differ on a rerun")
            print("[moe_train] MoE layer 1's loss and gradients (input, "
                  "router, experts, shared) rerun bit-identical", flush=True)
        del got, want
    for what, (err, i, tol) in worst.items():
        print(f"[moe_train] bfloat16 MoE layer on the plain path's input, "
              f"routing held, {what}: worst {err:.3e} at MoE layer {i + 1} "
              f"(tol {tol:g}, {'relative norm' if 'grad' in what else 'of max|plain|'})",
              flush=True)
        require(err <= tol, f"MoE layer {i + 1} {what} disagrees with plain")
    print(f"[moe_train] per MoE layer, the same input: of {routed} (token, "
          f"layer) routings, {flips[0]} choose other experts and {flips[1]} "
          f"order the same ones otherwise under the kernels' router "
          f"(reported)", flush=True)


def phase_moe_train(torch, card):
    """deepseek-moe-16b at full width, MOE_TRAIN_LAYERS deep: step 1
    against the plain path, then 3 AdamW steps at B=2 S=2048 in 2
    microbatches, remat on."""
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.train import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _model(torch, deepseek_moe_16b, n_layers=MOE_TRAIN_LAYERS,
                         trainable=True)
    torch.cuda.synchronize()
    mb, L = MOE_TRAIN_MB, cfg.n_layers
    nd = cfg.first_dense_layers
    n_moe = L - nd
    require(cfg.remat, "deepseek-moe-16b trains with remat on")
    n_params = sum(p.numel() for p in params.parameters())
    tokens = MOE_TRAIN_B * MOE_TRAIN_S
    s_mb = MOE_TRAIN_S                     # a microbatch: one sequence
    cap = moe.capacity(cfg, s_mb)
    print(f"[moe_train] deepseek-moe-16b full width, depth cut to {L} of 28 "
          f"layers ({nd} dense, {n_moe} MoE): {n_params / 1e9:.3f} B params; "
          f"B={MOE_TRAIN_B} S={MOE_TRAIN_S} in {mb} microbatches (cap "
          f"{cap}); init {time.perf_counter() - t0:.1f} s", flush=True)
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, MOE_TRAIN_S,
                                      MOE_TRAIN_B, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    first = {k: v[:MOE_TRAIN_B // mb] for k, v in batches[0].items()}
    _moe_train_agreement(torch, cfg, params, first)
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=mb)
    expert = [0]
    with _spy(ops, "_expert_gemm",
              lambda a, o: expert.__setitem__(0, expert[0] + 1)):
        state, rows, launches, peak = _train_steps(
            torch, "moe_train", step, state, batches, tokens,
            ("loss", "grad_norm", "nll", "moe_aux", "moe_z", "dropped"))
    # per microbatch: K1 6 products a dense layer and 9 a MoE layer (q,
    # k, v, o, the f32 router, the two expert GEMMs, the shared pair),
    # the head; the layers again under remat; 2 VJP products for each; K2
    # a layer forward and in its remat rerun, K3 and K4 a layer; the
    # expert form 2 a MoE layer forward, 2 in the rerun, 4 VJP forms
    prods = 6 * nd + 9 * n_moe
    n = TRAIN_STEPS * mb
    want = _zero_launches(K1=n * (prods + 1 + prods + 2 * (prods + 1)),
                          K2=n * 2 * L, K3=n * L, K4=n * L)
    print(f"[moe_train] launches over {TRAIN_STEPS} steps of {mb} "
          f"microbatches {launches} (derived {want}); K1's expert form "
          f"{expert[0]} (derived {n * 8 * n_moe}: 2 a MoE layer forward, 2 "
          f"in the remat rerun, 4 VJP forms)", flush=True)
    require(launches == want and expert[0] == n * 8 * n_moe,
            "kernel launches differ from the derived counts")
    # the bound: products at the bf16 peak (the forward, its remat rerun,
    # the VJP products at three bf16 products each: the f32 cotangent is
    # split), attention's (K3 1.5x, K4 2x the forward's), and AdamW's 28 B
    # a parameter at 3.35 TB/s
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    layer_mm = sum(p.numel() for name, p in params.named_parameters()
                   if name.endswith(("wq", "wk", "wv", "wo", "wi",
                                     "router", "shared_wi", "shared_wo"))
                   and ".moe.w" not in name)
    f_layers = 2 * s_mb * layer_mm
    f_head = 2 * s_mb * d * cfg.vocab_size
    f_exp = n_moe * 2 * e * cap * (d * 2 * f + f * d)
    f_attn = L * 4 * _pairs(s_mb) * cfg.n_heads * cfg.head_dim_
    flops = mb * (2 * (f_layers + f_exp + f_attn) + f_head
                  + 3 * 2 * (f_layers + f_exp + f_head) + 3.5 * f_attn)
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[moe_train] step ms {[round(r[0], 3) for r in rows]} (steps 2-3 "
          f"mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} tok/s); peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[moe_train] bound: products {flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s = {ops_ms:.3f} ms + AdamW {n_params * 28 / 1e9:.3f} GB "
          f"at 3.35 TB/s = {opt_ms:.3f} ms = {ops_ms + opt_ms:.3f} ms "
          f"({100 * (ops_ms + opt_ms) / mean_ms:.1f}% of it reached; "
          f"{card})", flush=True)
    require(peak < 80e9, f"peak memory {peak / 1e9:.1f} GB over the card's "
            f"80 GB")
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="moe train")
    return launches


def phase_llama4_path(torch, card):
    """llama4-scout-17b-a16e at full width, LLAMA4_LAYERS deep
    (``_moe_serve_phase``), then a local layer's decode from a wrapped
    ring against its plain version."""
    from repro_torch.configs import llama4_scout_17b_a16e
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm

    cfg, params, launches = _moe_serve_phase(
        torch, card, llama4_scout_17b_a16e, "llama4_path", LLAMA4_LAYERS)
    # a local layer's decode from a wrapped ring: its 8192 slots hold
    # positions pos - 8191 .. pos (seeded K/V), the new token's K/V lands
    # in slot pos % 8192
    kind, lp = transformer._moe_layers(params, cfg)[0]
    require(kind == "moe_local", "llama4's first layer is local")
    gen = torch.Generator(device="cuda").manual_seed(7)
    b = MOE_GEN_B
    shape = (b, cfg.local_window, cfg.n_kv_heads, cfg.head_dim_)
    with torch.inference_mode():
        ring = attn.KV(*(torch.randn(shape, generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(2)))
        x = torch.randn(b, 1, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
        pos = torch.tensor([LLAMA4_RING_POS, LLAMA4_RING_POS + 77],
                           dtype=torch.int32, device="cuda")
        h = apply_norm(lp["ln1"], x, cfg)
        got = []
        for plain in (False, True):
            with _plain_if(ops, plain):
                got.append(attn.attention_decode_ring(lp["attn"], h, ring,
                                                      pos, cfg))
        (ok, ck), (op, cp) = got
        written = (ck.k != ring.k).flatten(2).any(-1)
        slots = (pos.long() % cfg.local_window).tolist()
        require(all(written[i].nonzero().flatten().tolist() == [slots[i]]
                    for i in range(b)),
                "the ring write missed slot pos % window")
        errs = [_rel(torch, ok, op), _rel(torch, ck.k, cp.k),
                _rel(torch, ck.v, cp.v)]
    print(f"[llama4_path] local layer decode from a wrapped "
          f"{cfg.local_window}-slot ring at pos {pos.tolist()} (written to "
          f"slots {slots}): out, K, V vs plain {errs[0]:.3e}, "
          f"{errs[1]:.3e}, {errs[2]:.3e} of max|plain| (tol "
          f"{SSM_LAYER_TOL:g})", flush=True)
    require(max(errs) <= SSM_LAYER_TOL, "ring decode disagrees with plain")
    return launches


def _mla_counts(cfg):
    """``(K1 launches of one forward, of one decode step)``: a forward
    makes 7 products a layer (wq_a, wq_b, wkv_a, wkv_b, wo and the MLP's
    two) and the head; a decode step 8 (wq_a, wq_b, wkv_a, the two
    absorbed head-form products on wkv_b's views, wo and the MLP's two)
    and the head."""
    L = cfg.n_layers
    return 7 * L + 1, 8 * L + 1


def _mla_mm_params(params) -> int:
    """The parameters a token's forward multiplies: every product's weight
    (the untied embedding table is gathered, the norms scale)."""
    return sum(p.numel() for name, p in params.named_parameters()
               if name.endswith(("wq_a", "wq_b", "wkv_a", "wkv_b", "wo",
                                 "wi", "unembed.w")))


def _mla_agreement(torch, cfg, params, tokens, cache_len):
    """One prefill of ``tokens`` (logits, the stacked ``MLACache``) and
    one decode step from its re-laid cache (its logits and latents),
    through the kernels and the plain versions, in the served bf16 and on
    its weights in f32 at full depth: f32 kernels against f32 plain
    within SSM_F32_TOL (in f32 the head-form products take K9: f32 is no
    K1 head form); bf16 kernels against the f32 plain path beside the
    plain bf16 path's own distance from it (the witness), as the hybrid's
    ``_hybrid_agreement``."""
    from repro_torch.models import transformer
    n = tokens.shape[1]
    pos = torch.full((1,), n, dtype=torch.int32, device="cuda")

    def run(c, prm):
        lg, fc = transformer.prefill(prm, c, tokens)
        dec, dc = transformer.decode_step(
            prm, c, tokens[:, -1], pos,
            transformer.prefill_cache_to_decode(c, fc, cache_len))
        return {"prefill logits": lg, "c_kv": fc.c_kv, "k_pe": fc.k_pe,
                "decode logits": dec,
                "decode c_kv": dc["layers"].c_kv[:, :, n]}
    _witness(torch, "mla_path", cfg, params, run, f"{n}-token prefill, "
             f"decode at position {n}")


def _mla_tile_step(torch, cfg, params, prefill, decode, card, k1_step):
    """One make_decode step at B = MLA_TILE_B (past K1_DECODE_ROWS) from
    the prefill cache of MLA_TILE_B seeded prompts: its launches (K1
    8L+1, the 2L absorbed products on the head tile, no K9), its logits
    against the plain path (``_witness``: f32 kernels within SSM_F32_TOL,
    bf16 beside the plain bf16 witness), its ms by CUDA events and its
    bound (every weight byte and the latent cache at 3.35 TB/s)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    b, L = MLA_TILE_B, cfg.n_layers
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (b, MOE_PROMPT))).cuda()
    pos = torch.full((b,), MOE_PROMPT, dtype=torch.int32, device="cuda")
    _, fwd = prefill(params, {"tokens": prompts})
    cache = transformer.prefill_cache_to_decode(cfg, fwd, MOE_CACHE)
    del fwd
    tok = prompts[:, -1]
    step = lambda: decode(params, tok, pos, cache)
    step()
    torch.cuda.synchronize()
    routes = []

    def record(args, out):
        x, w = args[0], args[1]
        tb = args[2] if len(args) > 2 else False
        m, h, k = x.shape
        n = w.shape[0] if tb else w.shape[2]
        routes.append(ops.head_route(h, m, k, n, x.dtype, w.dtype, tb,
                                     ops.head_aligned(x, w)))
    ops.reset_launches()
    with _spy(ops, "_head_gemm", record):
        logits, _ = step()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = _zero_launches(K1=k1_step, K2=0)
    print(f"[mla_path] decode step B={b} (latent cache of {MOE_CACHE}): "
          f"launches {launches} (derived {want}); K1's head form "
          f"{len(routes)} launches, routes {sorted(set(routes))}",
          flush=True)
    require(launches == want and routes == ["tile"] * (2 * L),
            f"the B={b} decode step must run its {2 * L} absorbed products "
            f"on K1's head tile and no K9")
    require(tuple(logits.shape) == (b, cfg.vocab_size) and
            bool(torch.isfinite(logits).all()), "B=32 decode logits")

    def run(c, prm):
        _, fc = transformer.prefill(prm, c, prompts)
        dec, _ = transformer.decode_step(
            prm, c, tok, pos,
            transformer.prefill_cache_to_decode(c, fc, MOE_CACHE))
        return {"decode logits": dec}
    _witness(torch, "mla_path", cfg, params, run, f"B={b} decode at "
             f"position {MOE_PROMPT}")
    step_ms = time_ms(torch, step, iters=5, warmup=1)
    s_bytes = _step_bytes(params, cfg)
    c_bytes = sum(t.numel() * t.element_size() for t in cache["layers"])
    b_ms, _ = bound(0.0, s_bytes + c_bytes, "bfloat16")
    print(f"[mla_path] decode step (B={b}, latent cache of {MOE_CACHE}, "
          f"the absorbed products on the head tile): {step_ms:.3f} ms (CUDA "
          f"events); bound {b_ms:.3f} ms: weights {s_bytes / 1e9:.3f} GB + "
          f"latent cache {c_bytes / 1e9:.4f} GB at 3.35 TB/s ({card})",
          flush=True)
    del cache, logits
    torch.cuda.empty_cache()


def phase_mla_path(torch, card):
    """minicpm3-4b at full width and depth: make_prefill B=1 S=MLA_S (K2 on
    MLA's attention at its widths, q.k 96 and v 64, read from the launches'
    own arguments), ServeEngine over contiguous per-slot latent
    caches, greedy_generate (K1's head form in each decode step), the
    agreement with the plain path, a decode step under sync debug
    "error", profiles."""
    import numpy as np
    from repro_torch.configs import minicpm3_4b
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = phase_t0 = time.perf_counter()
    cfg, params = _model(torch, minicpm3_4b)
    torch.cuda.synchronize()
    L, V, d, h = cfg.n_layers, cfg.vocab_size, cfg.d_model, cfg.n_heads
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[mla_path] minicpm3-4b full width and depth ({L} layers, MLA "
          f"q rank 768, kv rank 256, {h} heads of 64 + 32 rope, v 64): "
          f"{n_params / 1e9:.3f} B params bf16 ({w_bytes / 1e9:.3f} GB; "
          f"param_count {cfg.param_count()[0]:,}), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, V, (1, MLA_S))).cuda()
    prompts = torch.from_numpy(rng.integers(
        0, V, (MOE_GEN_B, MOE_PROMPT))).cuda()
    k1_fwd, k1_step = _mla_counts(cfg)
    heads = [0]
    count_head = lambda a, o: heads.__setitem__(0, heads[0] + 1)
    prefill = serve_step.make_prefill(cfg)
    with torch.inference_mode():
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        widths = {}
        with _width_spy(widths):
            start.record()
            logits, cache = prefill(params, {"tokens": tokens})
            end.record()
            torch.cuda.synchronize()
        launches_p = dict(ops.LAUNCHES)
        prefill_ms = start.elapsed_time(end)
        require(tuple(logits.shape) == (1, V) and
                bool(torch.isfinite(logits).all()), "prefill logits")
        require(tuple(cache.c_kv.shape) == (L, 1, MLA_S, 256) and
                tuple(cache.k_pe.shape) == (L, 1, MLA_S, 32),
                "prefill MLACache shapes")
        del cache
        want = _zero_launches(K1=k1_fwd, K2=L)
        print(f"[mla_path] make_prefill B=1 S={MLA_S}: {prefill_ms:.3f} ms "
              f"({MLA_S / prefill_ms * 1e3:.1f} tok/s); launches "
              f"{launches_p} (derived {want})", flush=True)
        require(launches_p == want, "prefill launches differ from the "
                "derived counts")
        qk, vd = MLA_WIDTHS
        print(f"[mla_path] K2 launched at (kernel, hd, vd): {widths}",
              flush=True)
        require(widths == {("K2", qk, vd): L}, "MLA's K2 must run at its "
                f"own widths {MLA_WIDTHS}, no zero column")
        pairs = MLA_S * (MLA_S + 1) // 2
        mm = _mla_mm_params(params) - V * d        # the head: one row
        att = L * h * pairs * 2 * (qk + vd)
        flops = 2 * MLA_S * mm + 2 * V * d + att
        print(f"[mla_path] prefill bound: {flops / 1e12:.3f} TFLOP at 989 "
              f"TFLOP/s = {flops / H100_PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms "
              f"(attention {att / 1e12:.3f} TFLOP at ({qk}, {vd})); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({card})", flush=True)
        torch.cuda.empty_cache()

    engine = ServeEngine(cfg, params, max_slots=4, max_len=512)
    require(engine.pool is None and not engine.paged, "MLA must serve "
            "through contiguous per-slot caches")
    reqs = _dense_reqs(cfg, 6)
    print(f"[mla_path] contiguous per-slot latent caches of 512; prompts "
          f"{[len(p) for p, _ in reqs]} max_new {[n for _, n in reqs]}",
          flush=True)
    with _spy(ops, "_head_gemm", count_head):
        run = _run_engine(torch, engine, reqs)
    rids, results, launches_e = run[:3]
    _serve_line(torch, np, "mla_path", reqs, *run, engine)
    prefills = len(rids)
    want = _zero_launches(K1=prefills * k1_fwd + engine.kernel_calls *
                          k1_step, K2=L * prefills)
    print(f"[mla_path] engine launches {launches_e} (derived {want}); K1's "
          f"head form {heads[0]} (derived {2 * L} a slot-step x "
          f"{engine.kernel_calls})", flush=True)
    require(launches_e == want and heads[0] == 2 * L * engine.kernel_calls,
            "engine launches differ from the derived counts")

    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launches()
        heads[0] = 0
        t0 = time.perf_counter()
        with _spy(ops, "_head_gemm", count_head):
            out = serve_step.greedy_generate(params, cfg, prompts, MOE_NEW,
                                             MOE_CACHE)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_g = dict(ops.LAUNCHES)
        require(tuple(out.shape) == (MOE_GEN_B, MOE_PROMPT + MOE_NEW) and
                torch.equal(out[:, :MOE_PROMPT], prompts) and
                bool(((out >= 0) & (out < V)).all()),
                "greedy_generate output")
        want = _zero_launches(K1=k1_fwd + MOE_NEW * k1_step, K2=L)
        print(f"[mla_path] greedy_generate B={MOE_GEN_B}, {MOE_PROMPT} prompt "
              f"tokens (one prefill, its cache re-laid) + {MOE_NEW} new, "
              f"cache_len {MOE_CACHE}: {gen_s:.3f} s, "
              f"{MOE_GEN_B * MOE_NEW / gen_s:.2f} new tok/s; launches "
              f"{launches_g} (derived {want}); K1's head form {heads[0]} "
              f"({2 * L} a decode step); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        require(launches_g == want and heads[0] == MOE_NEW * 2 * L,
                "greedy_generate launches differ from the derived counts")

        _mla_agreement(torch, cfg, params, tokens, MLA_S + 64)
        torch.cuda.empty_cache()

        # one decode step (B=2) from the prompts' prefill cache, under the
        # "error" sync debug mode, then timed and profiled
        _, fwd = prefill(params, {"tokens": prompts})
        cache = transformer.prefill_cache_to_decode(cfg, fwd, MOE_CACHE)
        pos = torch.full((MOE_GEN_B,), MOE_PROMPT, dtype=torch.int32,
                         device="cuda")
        decode = serve_step.make_decode(cfg)
        tok = prompts[:, -1]
        step = lambda: decode(params, tok, pos, cache)
        step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("[mla_path] decode step ran with no host sync (sync debug "
              "mode 'error')", flush=True)
        step_ms = time_ms(torch, step, iters=5, warmup=1)
        s_bytes = _step_bytes(params, cfg)
        c_bytes = sum(t.numel() * t.element_size() for t in cache["layers"])
        b_ms, _ = bound(0.0, s_bytes + c_bytes, "bfloat16")
        print(f"[mla_path] decode step (B={MOE_GEN_B}, latent cache of "
              f"{MOE_CACHE}): {step_ms:.3f} ms (CUDA events); bound "
              f"{b_ms:.3f} ms: weights {s_bytes / 1e9:.3f} GB (every "
              f"parameter but the untied embedding table's other rows) + "
              f"latent cache {c_bytes / 1e9:.4f} GB at 3.35 TB/s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({card})", flush=True)
        profile_step(torch, step, n=2, what="mla decode")
        del cache, fwd
        torch.cuda.empty_cache()
        _mla_tile_step(torch, cfg, params, prefill, decode, card, k1_step)
        profile_step(torch, lambda: prefill(params, {"tokens": tokens}), n=1,
                     what="mla prefill")
    print(f"[mla_path] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return {k: launches_p[k] + launches_e[k] + launches_g[k]
            for k in launches_p}


def phase_mla_train(torch, card):
    """minicpm3-4b at full width, depth cut to MLA_TRAIN_LAYERS: step 1's
    first microbatch against the plain path (f32 and bf16), then 3 AdamW
    steps at B=MLA_TRAIN_B S=MLA_S in MLA_TRAIN_MB microbatches, remat
    on."""
    from repro_torch.configs import minicpm3_4b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    cfg, params = _model(torch, minicpm3_4b, MLA_TRAIN_LAYERS,
                         trainable=True)
    mb, L = MLA_TRAIN_MB, cfg.n_layers
    require(cfg.remat, "minicpm3-4b trains with remat on")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[mla_train] minicpm3-4b full width, depth cut to {L} of "
          f"{minicpm3_4b.full().n_layers} layers: {n_params / 1e9:.3f} B "
          f"params (param_count {cfg.param_count()[0]:,}), B={MLA_TRAIN_B} "
          f"S={MLA_S} in {mb} microbatches", flush=True)
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, MLA_S, MLA_TRAIN_B,
                                      seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    tokens = MLA_TRAIN_B * MLA_S
    first = {k: v[:MLA_TRAIN_B // mb] for k, v in batches[0].items()}
    _dense_grad_agreement(torch, "mla_train", cfg, params, first)
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=mb)
    widths = {}
    with _width_spy(widths):
        state, rows, launches, peak = _train_steps(
            torch, "mla_train", step, state, batches, tokens)
    n = TRAIN_STEPS * mb
    qk, vd = MLA_WIDTHS
    print(f"[mla_train] K2-K4 launched at (kernel, hd, vd): {widths}",
          flush=True)
    require(set(widths) == {(x, qk, vd) for x in ("K2", "K3", "K4")},
            f"MLA's K2-K4 must run at its own widths {MLA_WIDTHS}")
    k1 = _mla_counts(cfg)[0]
    # per microbatch: the forward's products, the layers' again under
    # remat, two VJP products each; K2 a layer forward and in its remat
    # rerun; K3, K4 a layer; no K5-K9 (the head form serves decode only)
    want = _zero_launches(K1=n * (k1 + (k1 - 1) + 2 * k1), K2=n * 2 * L,
                          K3=n * L, K4=n * L)
    print(f"[mla_train] launches over {TRAIN_STEPS} steps of {mb} "
          f"microbatches {launches} (derived {want})", flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")
    pairs = MLA_TRAIN_B * MLA_S * (MLA_S + 1) // 2
    att = L * cfg.n_heads * pairs * 2 * (qk + vd)
    flops = 3 * (2 * tokens * _mla_mm_params(params) + att)
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[mla_train] step ms {[round(r[0], 3) for r in rows]} (steps 2-3 "
          f"mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} tok/s); peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[mla_train] bound: products and attention at ({qk}, {vd}) "
          f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s = {ops_ms:.3f} ms + "
          f"AdamW {n_params * 28 / 1e9:.3f} GB at 3.35 TB/s = {opt_ms:.3f} "
          f"ms = {ops_ms + opt_ms:.3f} ms ({card})", flush=True)
    require(peak < 80e9, "peak memory over the card's 80 GB")
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="mla train")
    print(f"[mla_train] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return launches



def _mask_spy(record):
    """``ops._launch`` wrapped to record ``(entry, causal, window,
    prefix)`` of every K2-K4 launch: the mask arguments the kernels
    receive."""
    from repro_torch.kernels import ops
    orig = ops._launch

    def wrapped(name, *args):
        if name.startswith("repro_flash"):
            i = ops._SIGNATURES[name][1].index(ops._F)
            record.append((name, *args[i + 1:i + 4]))
        return orig(name, *args)
    return _patched(ops, "_launch", wrapped)


def _width_spy(record):
    """``ops._launch`` wrapped to count ``{(kernel, hd, vd): launches}`` of
    every K2-K4 launch: the widths the kernels receive (the two ints
    before the scale)."""
    from repro_torch.kernels import ops
    orig = ops._launch
    names = {"repro_flash_fwd": "K2", "repro_flash_dq": "K3",
             "repro_flash_dkv": "K4"}

    def wrapped(name, *args):
        if name in names:
            i = ops._SIGNATURES[name][1].index(ops._F)
            key = (names[name], *args[i - 2:i])
            record[key] = record.get(key, 0) + 1
        return orig(name, *args)
    return _patched(ops, "_launch", wrapped)


def _mask_counts(record) -> dict:
    """``{(kernel, "causal" / "bidirectional", window, prefix): launches}``
    of a ``_mask_spy`` record."""
    names = {"repro_flash_fwd": "K2", "repro_flash_dq": "K3",
             "repro_flash_dkv": "K4"}
    out = {}
    for name, causal, window, prefix in record:
        key = (names[name], "causal" if causal else "bidirectional",
               window, prefix)
        out[key] = out.get(key, 0) + 1
    return out


def _witness(torch, tag, cfg, params, run, setting):
    """``run(cfg, params)`` (a dict of output tensors) through the kernels
    and the plain versions, in the served bf16 and on its weights in f32:
    held by ``_f32_witness``."""
    from repro_torch.kernels import ops
    cf, pf = cfg.with_(dtype="float32"), _f32_copy(params)
    out = {}
    for c, prm in ((cf, pf), (cfg, params)):
        for plain in (False, True):
            with _plain_if(ops, plain):
                got = run(c, prm)
            require(all(bool(torch.isfinite(t).all()) for t in got.values()),
                    f"{tag}: {c.dtype} outputs not finite")
            out[c.dtype, plain] = got
    del pf
    _f32_witness(torch, tag, out, setting)


def _sync_free(torch, tag, step) -> None:
    """One call of ``step`` under sync debug mode "error"."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[{tag}] decode step ran with no host sync (sync debug mode "
          f"'error')", flush=True)


def _timed(torch, fn):
    """``(fn's result, its ms by CUDA events)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _vlm_counts(cfg):
    """``(K1 launches of one prefill, of one decode step, of one training
    microbatch)``: 6 products a layer (q, k, v, o, the MLP's two), the
    adapter's one (prefill) and the head.  A microbatch: the forward's
    6L + 2, the layers' 6L again under remat, two VJP products each but
    the adapter's one (the patches take no gradient): 24L + 5."""
    L = cfg.n_layers
    return 6 * L + 2, 6 * L + 1, 24 * L + 5


def _vlm_batch(torch, cfg, b, text, seed):
    """A seeded batch of ``b`` rows: ``text`` tokens behind the f32 stub
    patches ``(b, P, d)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, text),
                                    generator=gen, device="cuda"),
            "patches": torch.randn(b, cfg.num_patches, cfg.d_model,
                                   generator=gen, device="cuda")}


def _mm_params(params, names) -> int:
    """The parameters a row multiplies: the leaves ending in ``names``."""
    return sum(p.numel() for n, p in params.named_parameters()
               if n.endswith(names))


def phase_vlm_path(torch, card):
    """paligemma-3b at full width and depth: make_prefill B=1 over its 256
    patches and 3840 text tokens (K2 with the prefix-LM's prefix 256 in
    every layer), the patch swap, greedy_generate on the reference's
    token-by-token path, the agreement with the plain path, a decode step
    under sync debug "error", profiles."""
    import numpy as np
    from repro_torch.configs import paligemma_3b
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import registry, transformer
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = phase_t0 = time.perf_counter()
    cfg, params = _model(torch, paligemma_3b)
    torch.cuda.synchronize()
    L, V, d, P = cfg.n_layers, cfg.vocab_size, cfg.d_model, cfg.num_patches
    text = VLM_S - P
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[vlm_path] paligemma-3b full width and depth ({L} layers, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV head of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} GeGLU, tied vocab {V}, "
          f"{P} stub patches): {n_params / 1e9:.3f} B params bf16 "
          f"({w_bytes / 1e9:.3f} GB; param_count {cfg.param_count()[0]:,}), "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    batch = _vlm_batch(torch, cfg, 1, text, 0)
    k1_fwd, k1_step, _ = _vlm_counts(cfg)
    prefill = serve_step.make_prefill(cfg)
    masks = []
    with torch.inference_mode():
        prefill(params, batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        with _mask_spy(masks):
            (logits, cache), prefill_ms = _timed(
                torch, lambda: prefill(params, batch))
        launches_p = dict(ops.LAUNCHES)
        require(tuple(logits.shape) == (1, V) and
                bool(torch.isfinite(logits).all()), "prefill logits")
        require(tuple(cache.k.shape) == (L, 1, VLM_S, 1, cfg.head_dim),
                "prefill K/V shapes")
        del cache
        want = _zero_launches(K1=k1_fwd, K2=L)
        print(f"[vlm_path] make_prefill B=1, {P} patches + {text} tokens "
              f"= {VLM_S} positions: {prefill_ms:.3f} ms "
              f"({VLM_S / prefill_ms * 1e3:.1f} positions/s); launches "
              f"{launches_p} (derived {want}); K2 masks "
              f"{_mask_counts(masks)}", flush=True)
        require(launches_p == want, "prefill launches differ from the "
                "derived counts")
        require(_mask_counts(masks) == {("K2", "causal", 0, P): L},
                f"every layer's K2 must take the prefix {P}")
        pairs = VLM_S * (VLM_S + 1) // 2 + P * (P - 1) // 2
        mm = _mm_params(params, ("wq", "wk", "wv", "wo", "wi"))
        att = 4.0 * L * cfg.n_heads * pairs * cfg.head_dim
        flops = 2.0 * VLM_S * mm + 2.0 * P * d * d + 2.0 * V * d + att
        print(f"[vlm_path] prefill bound: {flops / 1e12:.3f} TFLOP at 989 "
              f"TFLOP/s = {flops / H100_PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms "
              f"(products {(flops - att) / 1e12:.3f} TFLOP; prefix-LM "
              f"attention {att / 1e12:.3f} TFLOP over {pairs:,} visible "
              f"pairs a head, {P * (P - 1) // 2:,} of them the prefix's "
              f"above the diagonal); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({card})", flush=True)

        # the prefix is live on the kernel path: position 0 sees patch 1
        order = [1, 0] + list(range(2, P))
        h = [transformer.forward(params, cfg, batch["tokens"],
                                 want_cache=False, patches=pt)[0][:, 0]
             for pt in (batch["patches"], batch["patches"][:, order])]
        diff = (h[0].float() - h[1].float()).abs().max().item()
        scale = h[0].float().abs().max().item()
        print(f"[vlm_path] patches 0 and 1 swapped: position 0's hidden "
              f"state moves by {diff:.4e} (max|h| {scale:.4e}; a causal "
              f"mask would leave it unchanged)", flush=True)
        require(diff > 1e-3 * scale, "swapping patches 0 and 1 must move "
                "position 0 (the prefix attends both ways)")
        del h
        torch.cuda.empty_cache()

        pos0 = torch.zeros(1, dtype=torch.int32, device="cuda")

        def run(c, prm):
            lg, fc = registry.prefill(prm, c, batch)
            dt = getattr(torch, str(c.dtype))
            dec, _ = registry.decode_step(
                prm, c, batch["tokens"][:, 0], pos0,
                registry.init_cache(c, 1, 16, dtype=dt, device="cuda"))
            return {"prefill logits": lg, "K": fc.k, "V": fc.v,
                    "decode logits": dec}
        _witness(torch, "vlm_path", cfg, params, run,
                 f"{P} patches + {text} tokens; a decode step at position 0")
        torch.cuda.empty_cache()

        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, V, (MOE_GEN_B, MOE_PROMPT))).cuda()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = serve_step.greedy_generate(params, cfg, prompts, MOE_NEW,
                                         MOE_CACHE)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_g = dict(ops.LAUNCHES)
        require(tuple(out.shape) == (MOE_GEN_B, MOE_PROMPT + MOE_NEW) and
                torch.equal(out[:, :MOE_PROMPT], prompts) and
                bool(((out >= 0) & (out < V)).all()),
                "greedy_generate output")
        want = _zero_launches(K1=(MOE_PROMPT + MOE_NEW) * k1_step)
        print(f"[vlm_path] greedy_generate B={MOE_GEN_B}, {MOE_PROMPT} "
              f"prompt tokens ingested one by one (the reference's path: "
              f"no patches, no relayout) + {MOE_NEW} new, cache_len "
              f"{MOE_CACHE}: {gen_s:.3f} s, {MOE_GEN_B * MOE_NEW / gen_s:.2f} "
              f"new tok/s, {MOE_GEN_B * (MOE_PROMPT + MOE_NEW) / gen_s:.2f} "
              f"tok/s in all; launches {launches_g} (derived {want})",
              flush=True)
        require(launches_g == want, "greedy_generate launches differ from "
                "the derived counts")

        cache = registry.init_cache(cfg, MOE_GEN_B, MOE_CACHE,
                                     device="cuda")
        pos = torch.full((MOE_GEN_B,), MOE_PROMPT, dtype=torch.int32,
                         device="cuda")
        decode = serve_step.make_decode(cfg)
        step = lambda: decode(params, prompts[:, -1], pos, cache)
        step()
        _sync_free(torch, "vlm_path", step)
        step_ms = time_ms(torch, step, iters=5, warmup=1)
        s_bytes = _step_bytes(params, cfg)
        c_bytes = sum(t.numel() * t.element_size() for t in cache["layers"])
        b_ms, _ = bound(0.0, s_bytes + c_bytes, "bfloat16")
        print(f"[vlm_path] decode step (B={MOE_GEN_B}, cache of "
              f"{MOE_CACHE}): {step_ms:.3f} ms (CUDA events), "
              f"{MOE_GEN_B / step_ms * 1e3:.1f} tok/s; bound {b_ms:.3f} ms: "
              f"weights {s_bytes / 1e9:.3f} GB + cache {c_bytes / 1e9:.4f} GB "
              f"at 3.35 TB/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
              flush=True)
        profile_step(torch, step, n=2, what="vlm decode")
        profile_step(torch, lambda: prefill(params, batch), n=1,
                     what="vlm prefill")
    print(f"[vlm_path] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return {k: launches_p[k] + launches_g[k] for k in launches_p}


def phase_vlm_train(torch, card):
    """paligemma-3b at full width and depth: step 1's first microbatch
    against the plain path (f32 and bf16), then 3 AdamW steps at B=2 of
    256 patches + 768 text in 2 microbatches, remat on; K2 (export), K3,
    K4 with the prefix in every layer."""
    from repro_torch.configs import paligemma_3b
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    cfg, params = _model(torch, paligemma_3b, trainable=True)
    mb, L, P = VLM_TRAIN_MB, cfg.n_layers, cfg.num_patches
    s = P + VLM_TRAIN_TEXT
    require(cfg.remat, "paligemma-3b trains with remat on")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[vlm_train] paligemma-3b full width and depth: "
          f"{n_params / 1e9:.3f} B params, B={VLM_TRAIN_B} of {P} patches "
          f"+ {VLM_TRAIN_TEXT} tokens in {mb} microbatches", flush=True)
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, VLM_TRAIN_TEXT,
                                      VLM_TRAIN_B, seed=0), cfg)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    first = {k: v[:VLM_TRAIN_B // mb] for k, v in batches[0].items()}
    _dense_grad_agreement(torch, "vlm_train", cfg, params, first)
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=mb)
    masks = []
    with _mask_spy(masks):
        state, rows, launches, peak = _train_steps(
            torch, "vlm_train", step, state, batches, VLM_TRAIN_B * s)
    n = TRAIN_STEPS * mb
    want = _zero_launches(K1=n * _vlm_counts(cfg)[2], K2=n * 2 * L,
                          K3=n * L, K4=n * L)
    want_masks = {(k, "causal", 0, P): c * n * L
                  for k, c in (("K2", 2), ("K3", 1), ("K4", 1))}
    print(f"[vlm_train] launches over {TRAIN_STEPS} steps of {mb} "
          f"microbatches {launches} (derived {want}); masks "
          f"{_mask_counts(masks)}", flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")
    require(_mask_counts(masks) == want_masks, "K2-K4 must take the prefix "
            f"{P} in every layer")
    tokens = VLM_TRAIN_B * s
    pairs = VLM_TRAIN_B * (s * (s + 1) // 2 + P * (P - 1) // 2)
    att = 4.0 * L * cfg.n_heads * pairs * cfg.head_dim
    mm = _mm_params(params, ("wq", "wk", "wv", "wo", "wi"))
    fwd = (2.0 * tokens * mm + 2.0 * VLM_TRAIN_B * P * cfg.d_model ** 2
           + 2.0 * VLM_TRAIN_B * VLM_TRAIN_TEXT * cfg.vocab_size
           * cfg.d_model + att)
    flops = 3 * fwd
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[vlm_train] step ms {[round(r[0], 3) for r in rows]} (steps 2-3 "
          f"mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} positions/s, "
          f"{VLM_TRAIN_B * VLM_TRAIN_TEXT / mean_ms * 1e3:.1f} text tok/s); "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[vlm_train] bound: products and prefix-LM attention "
          f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s = {ops_ms:.3f} ms + "
          f"AdamW {n_params * 28 / 1e9:.3f} GB at 3.35 TB/s = {opt_ms:.3f} "
          f"ms = {ops_ms + opt_ms:.3f} ms ({card})", flush=True)
    require(peak < 80e9, "peak memory over the card's 80 GB")
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="vlm train")
    print(f"[vlm_train] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return launches


def _encdec_counts(cfg):
    """``(K1 launches of one prefill, of one decode step, of one training
    microbatch; K2 launches of one forward)``.  The encoder: 6 products a
    layer (q, k, v, o, the MLP's two) behind the adapter's one; the
    decoder: 10 (self q, k, v, o; the cross K/V of the encoder states,
    projected in every layer, and cross q, o; the MLP's two); the prefill
    projects the cross K/V once more for its cache (2 a layer) and takes
    the head; a decode step 8 a layer (self q, k, v, o, cross q, o, the
    MLP's two) and the head.  A microbatch: the forward, the layers again
    under remat, two VJP products each but the adapter's one (the frames
    take no gradient): 24E + 40L + 5.  K2: the encoder's E and the
    cross-attention's L bidirectional, the decoder's L causal."""
    E, L = cfg.encoder_layers, cfg.n_layers
    return (6 * E + 12 * L + 2, 8 * L + 1, 24 * E + 40 * L + 5,
            E + 2 * L)


def _encdec_model(torch, trainable=False):
    from repro_torch.configs import whisper_base
    from repro_torch.models import registry
    cfg = whisper_base.full()
    params = registry.init(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda", trainable=trainable)
    return cfg, params


def _encdec_flops(cfg, b, sd, prefill):
    """The products' and the attention's flops of one forward over ``b``
    rows of ``cfg.encoder_seq`` frames and ``sd`` decoder tokens (the
    prefill: its cross K/V projected once more, the head on the last
    position; else the head on every position)."""
    E, L, d, V = cfg.encoder_layers, cfg.n_layers, cfg.d_model, \
        cfg.vocab_size
    se, h, hd, f = cfg.encoder_seq, cfg.n_heads, cfg.head_dim_, cfg.d_ff
    enc_rows, dec_rows = b * se, b * sd
    prods = (enc_rows * (d * d + E * (4 * d * d + 2 * d * f))
             + dec_rows * L * (6 * d * d + 2 * d * f)
             + enc_rows * L * 2 * d * d * (2 if prefill else 1)
             + (b if prefill else dec_rows) * d * V)
    att = 4.0 * b * h * hd * (E * se * se + L * sd * (sd + 1) // 2
                              + L * sd * se)
    return 2.0 * prods, att


def phase_encdec_path(torch, card):
    """whisper-base at full width and depth: make_prefill B=4 over 1500
    frames and a 64-token prompt (K2 bidirectional in the encoder and the
    cross-attention, causal in the decoder), 64 make_decode steps over
    init_cache with the prefill's cross K/V, greedy_generate, the
    agreement with the plain path, a decode step under sync debug
    "error", profiles."""
    import numpy as np
    from repro_torch.hardware import H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import serve_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = phase_t0 = time.perf_counter()
    cfg, params = _encdec_model(torch)
    torch.cuda.synchronize()
    E, L, V, d = cfg.encoder_layers, cfg.n_layers, cfg.vocab_size, \
        cfg.d_model
    se = cfg.encoder_seq
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[encdec_path] whisper-base full width and depth ({E} encoder "
          f"+ {L} decoder layers, d {d}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} GELU, LayerNorm and biases, "
          f"tied vocab {V}, {se} stub frames): {n_params / 1e6:.3f} M "
          f"params bf16 (param_count {cfg.param_count()[0]:,}), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, V, (ENC_B, ENC_PROMPT),
                                     generator=gen, device="cuda"),
             "frames": torch.randn(ENC_B, se, d, generator=gen,
                                   device="cuda")}
    k1_fwd, k1_step, _, k2_fwd = _encdec_counts(cfg)
    prefill = serve_step.make_prefill(cfg)
    decode = serve_step.make_decode(cfg)
    masks = []
    with torch.inference_mode():
        prefill(params, batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        with _mask_spy(masks):
            (logits, pcache), prefill_ms = _timed(
                torch, lambda: prefill(params, batch))
        launches_p = dict(ops.LAUNCHES)
        require(tuple(logits.shape) == (ENC_B, V) and
                bool(torch.isfinite(logits).all()), "prefill logits")
        heads = (cfg.n_kv_heads, cfg.head_dim_)
        require(tuple(pcache.self_kv.k.shape) == (L, ENC_B, ENC_PROMPT,
                                                  *heads) and
                tuple(pcache.cross_kv.k.shape) == (L, ENC_B, se, *heads),
                "prefill EncDecCache shapes")
        want = _zero_launches(K1=k1_fwd, K2=k2_fwd)
        want_masks = {("K2", "bidirectional", 0, 0): E + L,
                      ("K2", "causal", 0, 0): L}
        prods, att = _encdec_flops(cfg, ENC_B, ENC_PROMPT, True)
        print(f"[encdec_path] make_prefill B={ENC_B}, {se} frames + "
              f"{ENC_PROMPT} tokens: {prefill_ms:.3f} ms; launches "
              f"{launches_p} (derived {want}); K2 masks "
              f"{_mask_counts(masks)}; bound {(prods + att) / 1e12:.4f} "
              f"TFLOP at 989 TFLOP/s = "
              f"{(prods + att) / H100_PEAK_FLOPS['bfloat16'] * 1e3:.4f} ms "
              f"(attention {att / 1e12:.4f} TFLOP)", flush=True)
        require(launches_p == want, "prefill launches differ from the "
                "derived counts")
        require(_mask_counts(masks) == want_masks, "K2's masks differ: the "
                "encoder and cross-attention bidirectional, the decoder "
                "causal")

        # 64 decode steps from position 0 over init_cache, its cross K/V
        # the prefill's (the reference's test_decode_matches_forward)
        cache = registry.init_cache(cfg, ENC_B, ENC_CACHE, device="cuda")
        cache = cache._replace(cross_kv=pcache.cross_kv)
        ops.reset_launches()

        def steps(cache):
            lg = None
            for t in range(ENC_DECODE):
                pos = torch.full((ENC_B,), t, dtype=torch.int32,
                                 device="cuda")
                tok = batch["tokens"][:, t % ENC_PROMPT]
                lg, cache = decode(params, tok, pos, cache)
            return lg, cache
        (lg, cache), dec_ms = _timed(torch, lambda: steps(cache))
        launches_d = dict(ops.LAUNCHES)
        want = _zero_launches(K1=ENC_DECODE * k1_step)
        require(bool(torch.isfinite(lg).all()), "decode logits")
        print(f"[encdec_path] {ENC_DECODE} make_decode steps B={ENC_B} over "
              f"init_cache({ENC_B}, {ENC_CACHE}) with the prefill's cross "
              f"K/V: {dec_ms:.3f} ms ({dec_ms / ENC_DECODE:.4f} ms a step, "
              f"{ENC_B * ENC_DECODE / dec_ms * 1e3:.1f} tok/s); launches "
              f"{launches_d} (derived {want})", flush=True)
        require(launches_d == want, "decode launches differ from the "
                "derived counts")

        pos0 = torch.zeros(ENC_B, dtype=torch.int32, device="cuda")

        def run(c, prm):
            lg, pc = registry.prefill(prm, c, batch)
            dt = getattr(torch, str(c.dtype))
            ic = registry.init_cache(c, ENC_B, ENC_PROMPT, dtype=dt,
                                     device="cuda")
            dec, _ = registry.decode_step(
                prm, c, batch["tokens"][:, 0], pos0,
                ic._replace(cross_kv=pc.cross_kv))
            return {"prefill logits": lg, "self K": pc.self_kv.k,
                    "self V": pc.self_kv.v, "cross K": pc.cross_kv.k,
                    "cross V": pc.cross_kv.v, "decode logits": dec}
        _witness(torch, "encdec_path", cfg, params, run,
                 f"{se} frames + {ENC_PROMPT} tokens; a decode step at "
                 f"position 0 over the prefill's cross K/V")

        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, V, (ENC_B, ENC_GEN_PROMPT))).cuda()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = serve_step.greedy_generate(params, cfg, prompts, ENC_GEN_NEW,
                                         ENC_CACHE)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches_g = dict(ops.LAUNCHES)
        require(tuple(out.shape) == (ENC_B, ENC_GEN_PROMPT + ENC_GEN_NEW)
                and torch.equal(out[:, :ENC_GEN_PROMPT], prompts) and
                bool(((out >= 0) & (out < V)).all()),
                "greedy_generate output")
        want = _zero_launches(K1=(ENC_GEN_PROMPT + ENC_GEN_NEW) * k1_step)
        print(f"[encdec_path] greedy_generate B={ENC_B}, {ENC_GEN_PROMPT} "
              f"prompt tokens one by one from init_cache's zero cross K/V "
              f"(the reference's path) + {ENC_GEN_NEW} new, cache_len "
              f"{ENC_CACHE}: {gen_s:.3f} s, "
              f"{ENC_B * ENC_GEN_NEW / gen_s:.2f} new tok/s; launches "
              f"{launches_g} (derived {want})", flush=True)
        require(launches_g == want, "greedy_generate launches differ from "
                "the derived counts")

        pos = torch.full((ENC_B,), ENC_DECODE, dtype=torch.int32,
                         device="cuda")
        step = lambda: decode(params, batch["tokens"][:, 0], pos, cache)
        step()
        _sync_free(torch, "encdec_path", step)
        step_ms = time_ms(torch, step, iters=10, warmup=2)
        s_bytes = _step_bytes(params, cfg)
        c_bytes = sum(t.numel() * t.element_size()
                      for kv in cache for t in kv)
        b_ms, _ = bound(0.0, s_bytes + c_bytes, "bfloat16")
        print(f"[encdec_path] decode step (B={ENC_B}, self cache of "
              f"{ENC_CACHE}, cross K/V of {se}): {step_ms:.4f} ms (CUDA "
              f"events); bound {b_ms:.4f} ms: weights {s_bytes / 1e6:.1f} MB "
              f"+ caches {c_bytes / 1e6:.1f} MB at 3.35 TB/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
              flush=True)
        profile_step(torch, step, n=3, what="encdec decode")
        profile_step(torch, lambda: prefill(params, batch), n=2,
                     what="encdec prefill")
    print(f"[encdec_path] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return {k: launches_p[k] + launches_d[k] + launches_g[k]
            for k in launches_p}


def phase_encdec_train(torch, card):
    """whisper-base at full width and depth: step 1's first microbatch
    against the plain path (f32 and bf16; the key biases' vanishing
    gradients held against their value biases'), then 3 AdamW steps at
    B=8 of 1500 frames and 448 tokens in its 4 microbatches, remat on."""
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.hardware import H100, H100_PEAK_FLOPS
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    cfg, params = _encdec_model(torch, trainable=True)
    mb, E, L = cfg.train_microbatches, cfg.encoder_layers, cfg.n_layers
    require(cfg.remat, "whisper-base trains with remat on")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[encdec_train] whisper-base full width and depth: "
          f"{n_params / 1e6:.3f} M params, B={ENC_TRAIN_B} of "
          f"{cfg.encoder_seq} frames + {ENC_TRAIN_S} tokens in {mb} "
          f"microbatches", flush=True)
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, ENC_TRAIN_S,
                                      ENC_TRAIN_B, seed=0), cfg)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.global_batch(i).items()} for i in range(TRAIN_STEPS)]
    first = {k: v[:ENC_TRAIN_B // mb] for k, v in batches[0].items()}
    vanishing = {f"{stack}.{a}.bk": f"{stack}.{a}.bv"
                 for stack, a in (("encoder", "attn"),
                                  ("decoder", "self_attn"),
                                  ("decoder", "cross_attn"))}
    _dense_grad_agreement(torch, "encdec_train", cfg, params, first,
                          vanishing)
    torch.cuda.empty_cache()

    state = ts.init_state(cfg, params, "cuda")
    step = ts.make_train_step(cfg, microbatches=mb)
    masks, routes = [], {}

    def count_route(args, out):
        r = _route(ops, *args[:4])
        routes[r] = routes.get(r, 0) + 1
    tokens = ENC_TRAIN_B * ENC_TRAIN_S
    with _mask_spy(masks), _spy(ops, "_gemm", count_route):
        state, rows, launches, peak = _train_steps(
            torch, "encdec_train", step, state, batches, tokens)
    n = TRAIN_STEPS * mb
    k1 = _encdec_counts(cfg)[2]
    want = _zero_launches(K1=n * k1, K2=n * 2 * (E + 2 * L),
                          K3=n * (E + 2 * L), K4=n * (E + 2 * L))
    want_masks = {}
    for k, c in (("K2", 2), ("K3", 1), ("K4", 1)):
        want_masks[k, "bidirectional", 0, 0] = c * n * (E + L)
        want_masks[k, "causal", 0, 0] = c * n * L
    print(f"[encdec_train] launches over {TRAIN_STEPS} steps of {mb} "
          f"microbatches {launches} (derived {want}); masks "
          f"{_mask_counts(masks)}; K1 by route {routes} (the tied head's "
          f"dx and dw on the split route through pitched parts: derived "
          f"{2 * n})", flush=True)
    require(launches == want, "kernel launches differ from the derived "
            "counts")
    require(routes.get("split pitched") == 2 * n and not any(
        r.startswith("fma") for r in routes), "the head's VJPs (a stored "
        f"row of {cfg.vocab_size}) must take the split route through "
        "pitched parts, and no product the FMA kernel")
    require(_mask_counts(masks) == want_masks, "K2-K4's masks differ from "
            "the derived ones")
    prods, att = _encdec_flops(cfg, ENC_TRAIN_B, ENC_TRAIN_S, False)
    flops = 3 * (prods + att)
    ops_ms = flops / H100_PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = n_params * 28 / H100.hbm.bandwidth_Bps * 1e3
    mean_ms = sum(r[0] for r in rows[1:]) / (len(rows) - 1)
    print(f"[encdec_train] step ms {[round(r[0], 3) for r in rows]} (steps "
          f"2-3 mean {mean_ms:.3f} ms, {tokens / mean_ms * 1e3:.1f} decoder "
          f"tok/s, {ENC_TRAIN_B * cfg.encoder_seq / mean_ms * 1e3:.1f} "
          f"frames/s); peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[encdec_train] bound: products and attention "
          f"{flops / 1e12:.4f} TFLOP at 989 TFLOP/s = {ops_ms:.3f} ms + "
          f"AdamW {n_params * 28 / 1e9:.4f} GB at 3.35 TB/s = {opt_ms:.4f} "
          f"ms = {ops_ms + opt_ms:.3f} ms ({card})", flush=True)
    require(peak < 80e9, "peak memory over the card's 80 GB")
    profile_step(torch, lambda: step(state, batches[0]), n=1,
                 what="encdec train")
    print(f"[encdec_train] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# dist_path: the distributed layer (plans and their collectives, the
# tensor- and expert-parallel layers, the sharded train step, the
# re-meshed checkpoint)
# ---------------------------------------------------------------------------

DIST_DIR = os.path.join(ROOT, "build", "dist_smoke")
#: ranks of the spawned world; they share the one card over gloo (NCCL
#: refuses two ranks on one card)
DIST_RANKS = 4
#: the phase's sizes (passed to the spawned ranks): products at n^3, the
#: gemma-2b prompt and greedy tokens, deepseek's MoE layers and prefill,
#: the sharded train step's depth (gemma-2b's at 2 of 18 layers, cut from
#: 4 to keep the smoke's time when DIST_STEPS' steps joined the phase),
#: batch, sequence and steps
DIST_SIZES = dict(n=4096, prompt=(2, 512), tokens=32, moe_layers=2,
                  moe_s=2048, train_layers=2, train_b=4, train_s=512,
                  train_steps=2)
#: the K1 plans at n^3 bf16: (label, mesh axes, shard, keywords)
DIST_PLANS = (("row", (("x", 4),), {"i": "x"}, {}),
              ("col", (("x", 4),), {"j": "x"}, {}),
              ("sigma", (("x", 4),), {"k": "x"}, {}),
              ("both", (("dx", 2), ("dy", 2)), {"i": "dx", "j": "dy"}, {}),
              ("gather", (("x", 4),), {"i": "x"}, {"replicate_out": True}),
              ("scatter", (("x", 4),), {"k": "x"}, {"scatter_axis": "i"}))
#: a plan whose route or k split differs from the single product's (a
#: sharded sigma: the k split's f32 partials summed by the psum) holds
#: to it within K1's TOL, relative to the largest magnitude
DIST_PLAN_TOL = TOL[("K1", "bfloat16")]
#: the tensor-parallel layers sum their partials in f32 before the cast
#: to bf16 (one product casts one f32 sum): logits and MoE outputs within
#: PATH_TOL of the single process's, relative to their largest magnitude
DIST_PATH_TOL = PATH_TOL
#: the sharded train step against the single process's, after each step,
#: on a grid sample of at most DIST_SAMPLE elements of each held leaf
#: (``_grid_strides``): the loss within LOSS_TOL; AdamW's first and second
#: moments m and v within GRAD_TOL in relative norm, as the other train
#: phases hold bf16 gradients (the TP partials and the data reduction sum
#: in another order).  A first step moves each element by about lr *
#: sign(g) whatever the gradient's size, so where the rounding flips the
#: sign of a gradient near zero the element moves the other way: the
#: step's update (the f32 master's change) holds within GRAD_TOL in
#: relative norm on the elements whose |m| clears DIST_CLEAR times the
#: m's noise (the root mean square of the two runs' m difference over
#: the elements either run's m touched: the rows of an untied table that
#: no token looked up hold exact zeros in both runs and no noise), and
#: its sign agrees on at least DIST_SIGN_AGREE of all elements; the
#: flipped elements' |m| over that noise is printed
DIST_SAMPLE = 1 << 20
DIST_CLEAR = 4.0
DIST_SIGN_AGREE = 0.99
DIST_LEAVES = ("embed.table", "layers.mlp.wi", "layers.mlp.wo",
               "layers.attn.wq", "final_norm.scale")
#: the sharded train steps beside gemma-2b's, each on (data 2, model 2)
#: at train_b x train_s from one seed, held to the single process's as
#: gemma-2b's is: (name, config module, layers, the leaves whose master,
#: m and v are held, the kernels the step must launch).  minicpm3-4b's
#: MLA runs 20 of its 40 heads a rank (K2-K4 at (96, 64)),
#: recurrentgemma-9b's (rglru, rglru, local) group 2048 of its 4096
#: channels a rank (K8), mamba2-780m 24 of its 48 SSD heads a rank (K6 /
#: K7)
DIST_STEPS = (
    ("minicpm3-4b", "minicpm3_4b", 2,
     ("layers.attn.wq_b", "layers.attn.wkv_a", "layers.attn.wo",
      "layers.mlp.wi", "embed.table"), ("K1", "K2", "K3", "K4")),
    ("recurrentgemma-9b", "recurrentgemma_9b", 3,
     ("groups.rec.w_x", "groups.rec.wa", "groups.rec.w_out",
      "groups.att.wq", "embed.table"), ("K1", "K2", "K3", "K4", "K8")),
    ("mamba2-780m", "mamba2_780m", 2,
     ("layers.mixer.w_in", "layers.mixer.conv_w", "layers.mixer.norm_scale",
      "layers.mixer.w_out", "embed.table"), ("K1", "K6", "K7")))
#: the dry-run's collective model of a sharded step's cell against the
#: bytes its collectives sent (``comm.SENT``), per op: within 1% (the
#: model leaves out the f32 scalars), as the CPU test holds it
DIST_SENT_TOL = 0.01
#: deepseek's EP prefill routes its own residual, which the dense
#: layer's TP rounding moves: the (token, layer) routings that differ end
#: to end from the single process's are at most 3x the 24 of 2048
#: measured on an H100 80GB HBM3 at 700 W (an EP fault scrambles far
#: more)
DIST_ROUTE_E2E_MAX = 72


def _dist_cfg(module, full, n_layers=None):
    cfg = full(module)
    return cfg.with_(n_layers=n_layers) if n_layers else cfg


def _dist_params(torch, cfg, device, seed=0, trainable=False):
    from repro_torch.models import registry
    return registry.init(cfg, torch.Generator(device=device).manual_seed(seed),
                         device, trainable=trainable)


def _dist_operands(torch, device, S):
    """The plans' operands, seeded alike on every rank: bf16 for K1's
    six plans, f32 for K9's max-plus."""
    g = torch.Generator(device=device).manual_seed(30)
    n = S['n']
    mk = lambda dt: torch.randn(n, n, generator=g, device=device).to(dt)
    return mk(torch.bfloat16), mk(torch.bfloat16), mk(torch.float32), \
        mk(torch.float32)


def _dist_prompt(torch, cfg, device, shape, seed=31):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g,
                         device=device)


def _dist_batches(torch, cfg, device, S):
    from repro_torch.data import PipelineConfig, SyntheticLM
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, S['train_s'],
                                      S['train_b'], seed=0), cfg)
    return [{k: torch.from_numpy(v).to(device) for k, v in
             data.global_batch(i).items()} for i in range(S['train_steps'])]


def _routes(moe, record):
    """A spy on ``moe.route`` keeping each call's top-k."""
    return _spy(moe, "route", lambda args, out: record.append(
        out[3].detach().clone()))


def _hash_leaves(state) -> dict:
    """sha256 of each whole leaf's bytes (DTensor leaves gathered)."""
    import hashlib

    from repro_torch.checkpoint.checkpointer import _flatten
    return {k: hashlib.sha256(arr.tobytes()).hexdigest()
            for k, (arr, _) in _flatten(state).items()}


def _dist_whisper_step(torch, cfg, state, step_fn, mesh, device):
    """One sharded step of whisper-base on this rank's rows of a global
    batch of 4."""
    from repro_torch.data import PipelineConfig, SyntheticLM
    data = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 4, seed=0), cfg)
    row, dp = mesh.get_coordinate()[0], mesh.size(0)
    rows = slice(row * 4 // dp, (row + 1) * 4 // dp)
    batch = {k: torch.from_numpy(v[rows]).to(device)
             for k, v in data.global_batch(0).items()}
    return step_fn(state, batch)[0]


def _grid_strides(shape, world=DIST_RANKS, budget=DIST_SAMPLE) -> tuple:
    """Per-dim strides of a grid sample of at most ``budget`` elements of a
    tensor of ``shape`` (or as few as the strides allow).  Each stride
    divides its dim's extent over any chunking a world of ``world`` ranks
    gives it, so a rank's chunk's grid is its chunk of the whole grid."""
    room = []
    for e in shape:
        c = world
        while c > 1 and e % c:
            c //= 2
        room.append(e // c)
    strides = [1] * len(shape)
    while math.prod(e // st for e, st in zip(shape, strides)) > budget:
        free = [i for i, st in enumerate(strides) if room[i] % (2 * st) == 0]
        if not free:
            break
        i = max(free, key=lambda j: shape[j] // strides[j])
        strides[i] *= 2
    return tuple(strides)


def _grid(t, strides):
    """``t``'s grid sample at ``strides``, in f32."""
    return t[tuple(slice(None, None, st) for st in strides)].float().clone()


def _dist_time(torch, device, fn, **kw) -> float:
    """``time_ms`` on the card; 0 on the CPU rehearsal (no events)."""
    return time_ms(torch, fn, **kw) if device == "cuda" else 0.0


def _dist_single(torch, device, full, card, S):
    """The single-process results the spawned world is held to: the
    plans' products (and their times), gemma-2b's tokens and last
    logits, deepseek's routings and logits, gemma-2b's train steps.
    Returns them as a dict (saved for the ranks)."""
    from repro_torch.configs import deepseek_moe_16b, gemma_2b
    from repro_torch.core import expr as E
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.train import serve_step
    from repro_torch.train import train_step as ts
    ref = {}
    a, b, fa, fb = _dist_operands(torch, device, S)
    n = S['n']
    mm = E.matmul_expr(n, n, n)
    mp = E.inner("max", "add", E.arr("A", (n, n)), E.arr("B", (n, n)))
    ref["K1"] = ops.apply(mm, a, b, out_dtype=torch.float32)
    ref["K1_ms"] = _dist_time(torch, device, lambda: ops.apply(
        mm, a, b, out_dtype=torch.float32))
    ref["K1_route"] = _route(ops, a, b, False, False)
    ref["K9"] = ops.apply(mp, fa, fb)
    ref["K9_ms"] = _dist_time(torch, device, lambda: ops.apply(mp, fa, fb),
                              iters=3, warmup=1)
    del a, b, fa, fb

    cfg = _dist_cfg(gemma_2b, full)
    params = _dist_params(torch, cfg, device)
    prompt = _dist_prompt(torch, cfg, device, S['prompt'])
    with torch.no_grad():
        logits, _ = serve_step.make_prefill(cfg)(params, {"tokens": prompt})
        ref["gemma_last"] = logits[:, -1].float().clone()
        del logits
        ref["gemma_tokens"] = serve_step.greedy_generate(
            params, cfg, prompt, S['tokens'], S['prompt'][1] + S['tokens'])
    del params

    cfg = _dist_cfg(deepseek_moe_16b, full, S['moe_layers'])
    params = _dist_params(torch, cfg, device)
    tokens = _dist_prompt(torch, cfg, device, (1, S['moe_s']), seed=32)
    routes, layer = [], []
    with torch.no_grad(), _routes(moe, routes), _spy(
            moe, "apply_moe", lambda args, out: layer.append(
                (args[1].clone(), out[0].clone()))):
        logits, _ = serve_step.make_prefill(cfg)(params, {"tokens": tokens})
    ref["moe_last"] = logits[:, -1].float().clone()
    ref["moe_routes"] = routes
    # the first MoE layer's input and output: the ranks route the same
    # input (the prefill's own input to it differs by TP's rounding)
    ref["moe_in"], ref["moe_out"] = layer[0]
    del params, logits

    cfg = _dist_cfg(gemma_2b, full, S['train_layers'])
    ref["train"] = _dist_single_steps(torch, device, cfg, DIST_LEAVES, S)
    tr = ref["train"]
    print(f"[dist_path] single process: K1 {n}^3 bf16 {ref['K1_ms']:.4f} ms "
          f"({ref['K1_route']}), K9 max-plus {n}^3 f32 {ref['K9_ms']:.4f} "
          f"ms; gemma-2b {S['train_layers']} layers {tr['params'] / 1e9:.3f} "
          f"B params: step ms {[round(x, 1) for x in tr['ms']]}, losses "
          f"{tr['losses']}, peak {tr['peak'] / 2**30:.2f} GiB ({card})",
          flush=True)
    for name, module, layers, leaves, _ in DIST_STEPS:
        cfg = _dist_cfg(importlib.import_module(
            f"repro_torch.configs.{module}"), full, layers)
        tr = ref[name] = _dist_single_steps(torch, device, cfg, leaves, S)
        print(f"[dist_path] single process: {name} {layers} layers "
              f"{tr['params'] / 1e9:.3f} B params: step ms "
              f"{[round(x, 1) for x in tr['ms']]}, losses {tr['losses']}, "
              f"peak {tr['peak'] / 2**30:.2f} GiB ({card})", flush=True)
    return ref


def _dist_single_steps(torch, device, cfg, leaves, S) -> dict:
    """``S['train_steps']`` AdamW steps of ``cfg`` in one process on
    ``_dist_batches``: the losses, step ms, peak, parameter count, and
    each held leaf's grid strides, starting values and (master, m, v)
    after each step."""
    from repro_torch.train import train_step as ts
    params = _dist_params(torch, cfg, device, trainable=True)
    strides = {k: _grid_strides(params.get_parameter(k).shape)
               for k in leaves}
    start = {k: _grid(params.get_parameter(k).detach(), strides[k])
             for k in leaves}
    state = ts.init_state(cfg, params, device)
    step = ts.make_train_step(cfg)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ms, moments = [], [], []
    for batch in _dist_batches(torch, cfg, device, S):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))          # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        moments.append({k: tuple(_grid(tree[k], strides[k]) for tree in (
            state.opt.master, state.opt.m, state.opt.v)) for k in leaves})
    out = {"losses": losses, "ms": ms, "start": start, "strides": strides,
           "moments": moments,
           "peak": torch.cuda.max_memory_allocated() if cuda else 0,
           "params": sum(p.numel() for p in params.parameters())}
    del state, params
    if cuda:
        torch.cuda.empty_cache()
    return out


def _dist_barrier(torch):
    """Every rank here: an all-reduce of a host tensor (gloo's own
    barrier is not relied on after collectives of CUDA tensors)."""
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1))


class _CollectiveClock:
    """Host seconds inside the port's collectives (each blocks the host
    until its transfer is done on a gloo world)."""

    def __init__(self, comm):
        self.comm, self.s, self.calls = comm, 0.0, 0

    def __enter__(self):
        self.saved = {}
        for name in ("all_reduce", "reduce_scatter", "all_gather"):
            orig = getattr(self.comm, name)
            self.saved[name] = orig

            def timed(*a, _orig=orig, **k):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    self.s += time.perf_counter() - t0
                    self.calls += 1
            setattr(self.comm, name, timed)
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.comm, name, orig)


def _hold_moments(torch, moments: list, ref: dict) -> dict:
    """Each step's sharded m, v and master update against the single
    process's (``ref``, from ``_dist_single_steps``), on each held leaf's
    grid (the rules at DIST_CLEAR): ``{leaf: [per step {m_err, v_err,
    upd_err, upd_err_all, clear, sign_agree, flipped, flip_m_med,
    flip_m_max}]}``."""
    held = {}
    for k in ref["start"]:
        prev_k = prev_p = ref["start"][k]
        rows = []
        for got, want in zip(moments, ref["moments"]):
            (mk, m1k, v1k), (mp, m1p, v1p) = got[k], want[k]
            # in f64: the f32 sum of squares of v (g^2 summed) overflows
            # on recurrentgemma's tied table
            rel = lambda a, b: ((a - b).double().norm()
                                / b.double().norm()).item()
            duk, dup = mk - prev_k, mp - prev_p
            touched = (m1k != 0) | (m1p != 0)
            noise = (m1k - m1p)[touched].square().mean().sqrt() \
                if touched.any() else torch.zeros(())
            clear = m1p.abs() > DIST_CLEAR * noise
            # printed beside: the noise over every element, never-read
            # rows' zeros included
            clear_all = m1p.abs() > DIST_CLEAR * (
                m1k - m1p).square().mean().sqrt()
            flip = torch.sign(duk) != torch.sign(dup)
            ratio = m1p.abs()[flip] / noise
            rows.append(dict(
                touched=touched.float().mean().item(),
                m_err=rel(m1k, m1p), v_err=rel(v1k, v1p),
                upd_err=rel(duk[clear], dup[clear]) if clear.any() else 0.0,
                upd_err_all=rel(duk[clear_all], dup[clear_all])
                if clear_all.any() else 0.0,
                clear=clear.float().mean().item(),
                sign_agree=1.0 - flip.float().mean().item(),
                flipped=int(flip.sum()),
                flip_m_med=ratio.median().item() if flip.any() else 0.0,
                flip_m_max=ratio.max().item() if flip.any() else 0.0))
            prev_k, prev_p = mk, mp
        held[k] = rows
    return held


def _dist_sharded_steps(torch, cfg, mesh, device, S, ref, rank) -> dict:
    """``S['train_steps']`` sharded AdamW steps of ``cfg`` on ``mesh``
    (data 2, model 2) from the single process's seed, this rank's rows of
    each ``_dist_batches`` batch: the losses, step and collective ms, the
    ``fsdp.GATHERED`` high-water, the bytes the first step's collectives
    sent by op (``comm.SENT``) and, on rank 0, the held leaves' moments
    against ``ref`` (``_hold_moments``)."""
    from repro_torch.distributed import comm, fsdp
    from repro_torch.train import train_step as ts
    params = _dist_params(torch, cfg, device, trainable=True)
    state = ts.init_sharded_state(cfg, params, mesh)
    del params
    step = ts.make_sharded_train_step(cfg, mesh)
    fsdp.GATHERED.reset()
    row = mesh.get_coordinate()[0]
    losses, step_ms, coll_ms, moments, sent = [], [], [], [], None
    for batch in _dist_batches(torch, cfg, device, S):
        rows_b = {k: v.chunk(2)[row] for k, v in batch.items()}
        comm.SENT.clear()
        with _CollectiveClock(comm) as clock:
            t = time.perf_counter()
            state, mt = step(state, rows_b)
            if device == "cuda":
                torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        coll_ms.append(clock.s * 1e3)
        sent = dict(comm.SENT) if sent is None else sent
        losses.append(float(mt["loss"]))
        # each held leaf's master, m and v: every rank's chunk's grid,
        # gathered into the whole leaf's grid
        moments.append({k: tuple(comm.gather_full(
            _grid(tree[k].to_local(), ref["strides"][k]), mesh,
            tree[k].placements).cpu() for tree in (
                state.opt.master, state.opt.m, state.opt.v))
            for k in ref["start"]})
    del state
    return {"losses": losses, "ms": step_ms, "coll_ms": coll_ms,
            "gathered_high": fsdp.GATHERED.high, "sent": sent,
            "held": _hold_moments(torch, moments, ref) if rank == 0
            else None}


def _dist_rank(rank: int, world: int, directory: str, device: str,
               full_name: str, S: dict) -> None:
    """One rank of the spawned world: the plans, gemma-2b TP over model
    = 4, deepseek's MoE layers EP over model = 4, the sharded train
    step of gemma-2b on (data 2, model 2), whisper-base's checkpoint
    saved at (2, 2) and restored at (4, 1).  Writes its results to
    ``<directory>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import warnings
    warnings.simplefilter("ignore")     # all_gather_into_tensor's notice
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import deepseek_moe_16b, gemma_2b, whisper_base
    from repro_torch.core import expr as E
    from repro_torch.distributed import comm, fsdp
    from repro_torch.distributed import plan as dplan
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import moe
    from repro_torch.train import serve_step
    from repro_torch.train import train_step as ts
    full = _DIST_FULL[full_name]
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=world)
    out = {"launches": {}, "peak": {}, "ms": {}, "coll_ms": {}}
    ref = torch.load(os.path.join(directory, "ref.pt"), map_location=device)
    # the sharded steps' references are held on the host, so that a rank's
    # peak in a step is the step's own
    names = ("train", *(name for name, *_ in DIST_STEPS))
    steps = torch.load(os.path.join(directory, "ref.pt"), map_location="cpu")
    steps = {k: steps[k] for k in names}
    for k in names:
        del ref[k]
    meshes = {}

    def mesh(axes):
        if axes not in meshes:
            shape = tuple(s for _, s in axes)
            meshes[axes] = DeviceMesh(device, torch.arange(world).reshape(
                shape), mesh_dim_names=tuple(a for a, _ in axes))
        return meshes[axes]

    def phase(name):
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        return time.perf_counter()

    def done(name, t0):
        if device == "cuda":
            torch.cuda.synchronize()
            out["peak"][name] = torch.cuda.max_memory_allocated()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        out["launches"][name] = dict(ops.LAUNCHES)

    # 1. the plans at S['n']^3: K1's six, K9's max-plus (rows sharded)
    t0 = phase("plans")
    a, b, fa, fb = _dist_operands(torch, device, S)
    n = S['n']
    mm = E.matmul_expr(n, n, n)
    mp = E.inner("max", "add", E.arr("A", (n, n)), E.arr("B", (n, n)))
    rows = []
    plan_launches = {k: 0 for k in ops.LAUNCHES}
    cases = [(lab, axes, sh, kw, mm, (a, b), torch.float32, "K1")
             for lab, axes, sh, kw in DIST_PLANS]
    cases.append(("max-plus rows", (("x", 4),), {"i": "x"}, {}, mp, (fa, fb),
                  None, "K9"))
    for label, axes, shard, kw, form, ins, odt, kid in cases:
        m = mesh(axes)
        plan = dplan.derive_plan(form, m, shard=shard,
                                 dtype=str(ins[0].dtype)[6:], **kw)
        before = dict(ops.LAUNCHES)
        y = ops.apply(form, *ins, mesh=m, shard=shard, out_dtype=odt,
                      verify=True, **kw)
        for k in plan_launches:
            plan_launches[k] += ops.LAUNCHES[k] - before[k]
        whole = comm.gather_full(y.to_local(), m, y.placements)
        shards = [comm.local_chunk(x, m, pl).contiguous()
                  for x, pl in zip(ins, plan.in_placements(m))]
        local = lambda: ops.apply_normal_form(plan.local_nf, *shards,
                                              out_dtype=torch.float32)
        part = local()
        # the per-shard product alone: rank 0 times it while the others wait
        _dist_barrier(torch)
        shard_ms = _dist_time(torch, device, local, iters=5, warmup=2) \
            if rank == 0 else 0.0
        # the plain version and one library call (K1's; K9 has none) at
        # the per-shard shape
        plain = (lambda: kref.matmul(*shards)) if kid == "K1" else \
            (lambda: kref.eval_nf(plan.local_nf, *shards))
        plain_ms = _dist_time(torch, device, plain, iters=3, warmup=1) \
            if rank == 0 else 0.0
        lib_ms = _dist_time(torch, device, lambda: torch.matmul(*shards),
                            iters=5, warmup=2) \
            if rank == 0 and kid == "K1" else None
        _dist_barrier(torch)
        coll = [0.0]

        def collectives():
            t = time.perf_counter()
            yy = part
            for st in plan.collectives:
                g = m.get_group(st.mesh_axis)
                yy = (comm.all_reduce(yy, g) if st.kind == "psum" else
                      comm.reduce_scatter(yy, g, st.out_dim)
                      if st.kind == "reduce_scatter" else
                      comm.all_gather(yy, g, st.out_dim))
            if device == "cuda":
                torch.cuda.synchronize()
            coll[0] = (time.perf_counter() - t) * 1e3
        for _ in range(3):
            collectives()
        t = time.perf_counter()
        y = ops.apply(form, *ins, mesh=m, shard=shard, out_dtype=odt, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t) * 1e3
        if rank == 0:
            want = ref[kid]
            err = (whole.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            lm, ln = plan.local_extent("i"), plan.local_extent("j")
            lk = plan.local_extent("k")
            route = _route(ops, *shards, False, False) if kid == "K1" \
                else "K9"
            rows.append(dict(label=label, kid=kid, local=(lm, lk, ln),
                             route=route, collective=plan.collective,
                             max_abs_err=err, scale=scale, shard_ms=shard_ms,
                             plain_ms=plain_ms, lib_ms=lib_ms,
                             coll_ms=coll[0], total_ms=total_ms,
                             bits=bool(torch.equal(whole.float(),
                                                   want.float()))))
    done("plans", t0)
    out["launches"]["plans"] = plan_launches      # the sharded applies'
    out["plans"] = rows
    del a, b, fa, fb, y, whole, shards, part

    # 2. gemma-2b tensor-parallel over model = 4, full width and depth
    t0 = phase("gemma_tp")
    m14 = mesh((("data", 1), ("model", world)))
    cfg = _dist_cfg(gemma_2b, full)
    params = _dist_params(torch, cfg, device)
    prompt = _dist_prompt(torch, cfg, device, S['prompt'])
    with torch.no_grad(), dplan.planned_mesh(m14), \
            _CollectiveClock(comm) as clock:
        t = time.perf_counter()
        logits, _ = serve_step.make_prefill(cfg)(params, {"tokens": prompt})
        if device == "cuda":
            torch.cuda.synchronize()
        out["gemma_prefill_ms"] = (time.perf_counter() - t) * 1e3
        last = logits[:, -1].float()
        del logits
        t = time.perf_counter()
        toks = serve_step.greedy_generate(params, cfg, prompt, S['tokens'],
                                          S['prompt'][1] + S['tokens'])
        if device == "cuda":
            torch.cuda.synchronize()
        out["gemma_generate_ms"] = (time.perf_counter() - t) * 1e3
    out["coll_ms"]["gemma_tp"] = clock.s * 1e3
    out["gemma_tokens_equal"] = bool(torch.equal(toks, ref["gemma_tokens"]))
    out["gemma_token_diffs"] = int((toks != ref["gemma_tokens"]).sum())
    out["gemma_last_err"] = ((last - ref["gemma_last"]).abs().max() /
                             ref["gemma_last"].abs().max()).item()
    done("gemma_tp", t0)
    del params

    # 3. deepseek-moe-16b's MoE layers expert-parallel over model = 4
    t0 = phase("moe_ep")
    cfg = _dist_cfg(deepseek_moe_16b, full, S['moe_layers'])
    params = _dist_params(torch, cfg, device)
    tokens = _dist_prompt(torch, cfg, device, (1, S['moe_s']), seed=32)
    routes = []
    held = []
    with torch.no_grad(), dplan.planned_mesh(m14), \
            _CollectiveClock(comm) as clock:
        with _routes(moe, routes):
            logits, _ = serve_step.make_prefill(cfg)(params,
                                                     {"tokens": tokens})
        # the first MoE layer on the single process's input to it
        with _routes(moe, held):
            y, _ = moe.apply_moe({k: v[0] for k, v in
                                  params["layers"]["moe"].items()},
                                 ref["moe_in"], cfg)
    out["coll_ms"]["moe_ep"] = clock.s * 1e3
    last = logits[:, -1].float()
    flips = lambda got: sum(
        int((r.sort(-1).values != w.sort(-1).values).any(-1).sum())
        for r, w in zip(got, ref["moe_routes"]))
    out["moe_last_err"] = ((last - ref["moe_last"]).abs().max() /
                           ref["moe_last"].abs().max()).item()
    out["moe_route_diffs_e2e"] = flips(routes)
    out["moe_route_diffs"] = flips(held)
    out["moe_layer_err"] = ((y.float() - ref["moe_out"].float()).abs().max()
                            / ref["moe_out"].float().abs().max()).item()
    out["moe_routes_n"] = (len(routes), len(ref["moe_routes"]))
    out["moe_experts_a_rank"] = cfg.n_experts // world
    done("moe_ep", t0)
    del params, logits

    # 4. the sharded train step of gemma-2b on (data 2, model 2): every
    # leaf at its stored chunk, each layer's weights gathered in the layer
    t0 = phase("train")
    m22 = mesh((("data", 2), ("model", world // 2)))
    cfg = _dist_cfg(gemma_2b, full, S['train_layers'])
    out["train"] = _dist_sharded_steps(torch, cfg, m22, device, S,
                                       steps["train"], rank)
    done("train", t0)
    # 4b. minicpm3-4b's MLA heads, recurrentgemma-9b's RG-LRU channels and
    # mamba2-780m's SSD heads at their "model" chunks, the same way
    for name, module, layers, _, _ in DIST_STEPS:
        t0 = phase(name)
        cfg = _dist_cfg(importlib.import_module(
            f"repro_torch.configs.{module}"), full, layers)
        out[name] = _dist_sharded_steps(torch, cfg, m22, device, S,
                                        steps[name], rank)
        done(name, t0)

    # 5. whisper-base's state saved at (2, 2), restored at (4, 1)
    t0 = phase("checkpoint")
    cfg = _dist_cfg(whisper_base, full)
    comp = CompressionConfig(enabled=True)
    state = ts.init_sharded_state(cfg, _dist_params(
        torch, cfg, device, trainable=True), m22, comp)
    state = _dist_whisper_step(torch, cfg, state,
                               ts.make_sharded_train_step(cfg, m22,
                                                          comp=comp),
                               m22, device)
    ck = Checkpointer(os.path.join(directory, "ckpt"))
    t = time.perf_counter()
    ck.save(1, state)
    out["save_ms"] = (time.perf_counter() - t) * 1e3
    saved = _hash_leaves(state)
    del state
    m41 = mesh((("data", world), ("model", 1)))
    fresh = ts.init_sharded_state(cfg, _dist_params(
        torch, cfg, device, seed=9, trainable=True), m41, comp)
    t = time.perf_counter()
    fresh, _ = ck.restore(fresh)
    out["restore_ms"] = (time.perf_counter() - t) * 1e3
    restored = _hash_leaves(fresh)
    out["ckpt_equal"] = saved == restored
    out["ckpt_hashes"] = saved
    done("checkpoint", t0)
    del fresh
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _dist_report_steps(outs, key, name, cfg, ref, S, card) -> None:
    """Print and hold one sharded step's results (``_dist_sharded_steps``
    under ``key`` in each rank's ``outs``) against the single process's
    ``ref``: the losses within LOSS_TOL, the held leaves' m, v and
    updates at DIST_CLEAR; each rank's peak beside the dry-run's per-rank
    model of the cell (state + activations), its ``fsdp.GATHERED``
    high-water beside the model's largest layer and table (held at most
    their sum), and the bytes its collectives sent by op beside the
    dry-run's ``collective_bytes`` of the cell (held within
    DIST_SENT_TOL, the same ops)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.common import ShapeConfig
    o = outs[0][key]
    print(f"[dist_path] {name} sharded train step on (data 2, model 2), "
          f"{cfg.n_layers} layers, B={S['train_b']} S={S['train_s']}: "
          f"losses {o['losses']} (single {ref['losses']}); step ms "
          f"{[round(x, 1) for x in o['ms']]} (single "
          f"{[round(x, 1) for x in ref['ms']]}), collectives ms "
          f"{[round(x, 1) for x in o['coll_ms']]}", flush=True)
    for a, b in zip(o["losses"], ref["losses"]):
        require(abs(a - b) <= LOSS_TOL * abs(b), f"{name}'s sharded loss off")
    for k, steps in o["held"].items():
        for i, h in enumerate(steps):
            print(f"[dist_path] {name} step {i + 1} {k}: m rel err "
                  f"{h['m_err']:.3e}, v rel err {h['v_err']:.3e} (tol "
                  f"{GRAD_TOL:g}); update rel err {h['upd_err']:.3e} on "
                  f"the {h['clear']:.4f} of elements whose |m| > "
                  f"{DIST_CLEAR:g} x the m noise on the {h['touched']:.4f} "
                  f"touched (tol {GRAD_TOL:g}; {h['upd_err_all']:.3e} "
                  f"at the noise over every element); update "
                  f"sign agrees on {h['sign_agree']:.6f} (tol "
                  f"{DIST_SIGN_AGREE:g}); {h['flipped']} flipped, their |m| "
                  f"/ noise median {h['flip_m_med']:.3f} max "
                  f"{h['flip_m_max']:.3f}", flush=True)
            require(h["m_err"] <= GRAD_TOL and h["v_err"] <= GRAD_TOL,
                    f"{name}'s sharded moments of {k} off (step {i + 1})")
            require(h["upd_err"] <= GRAD_TOL and
                    h["sign_agree"] >= DIST_SIGN_AGREE,
                    f"{name}'s sharded update of {k} off (step {i + 1})")
    sized = dryrun.SizedMesh({"data": 2, "model": DIST_RANKS // 2})
    shp = ShapeConfig("dist_train", S['train_s'], S['train_b'], "train")
    state_b = sum(dryrun.state_bytes(cfg, sized).values())
    act_b = dryrun._activation_bytes(cfg, shp, sized, 1)
    layer_b, table_b = dryrun.gathered_bytes(cfg, sized)
    model = dryrun.collective_bytes(cfg, shp, sized, 1)
    for r, x in enumerate(outs):
        peak, got = x["peak"].get(key, 0), x[key]
        sent = got["sent"]
        print(f"[dist_path] {name} rank {r}: peak {peak / 2**30:.3f} GiB, "
              f"dry-run model {(state_b + act_b) / 2**30:.3f} GiB (state "
              f"{state_b / 2**30:.3f} + activations {act_b / 2**30:.3f}), "
              f"peak / model {peak / (state_b + act_b):.3f}; GATHERED "
              f"high-water {got['gathered_high'] / 2**30:.3f} GiB (largest "
              f"layer {layer_b / 2**30:.3f} + table {table_b / 2**30:.3f} "
              f"GiB); step 1 collectives sent MiB "
              f"{ {k: round(v / 2**20, 3) for k, v in sorted(sent.items())} }"
              f", dry-run "
              f"{ {k: round(v / 2**20, 3) for k, v in sorted(model.items())} }"
              f" ({card})", flush=True)
        require(got["gathered_high"] <= layer_b + table_b,
                f"{name} rank {r} held more gathered weights than a layer "
                f"and the table")
        require(sorted(sent) == sorted(model) and all(
            abs(sent[k] - v) <= DIST_SENT_TOL * v for k, v in model.items()),
            f"{name} rank {r}'s collectives differ from the dry-run's model")


#: a config module's config at full width (the smoke's), or its reduced
#: one (a rehearsal on the CPU)
_DIST_FULL = {"full": lambda module: module.full(),
              "reduced": lambda module: module.reduced()}


def phase_dist_path(torch, card, device="cuda", full_name="full",
                    S=DIST_SIZES):
    """(a) a world of 1 over NCCL in this process, mesh (1, 1): gemma-2b
    prefill and greedy tokens under planned_mesh bit for bit against the
    unplanned path, deepseek's MoE layers through _apply_moe_shardmap
    against _apply_moe_global; (b) DIST_RANKS spawned ranks sharing the
    card over gloo (``_dist_rank``), held to this process's results."""
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import deepseek_moe_16b, gemma_2b, whisper_base
    from repro_torch.distributed import plan as dplan
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import embed_tokens
    from repro_torch.train import serve_step
    from repro_torch.train import train_step as ts
    full = _DIST_FULL[full_name]
    phase_t0 = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    launches = {k: 0 for k in ops.LAUNCHES}

    # (a) one rank over NCCL (gloo on the CPU rehearsal)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{DIST_DIR}/store1",
                            rank=0, world_size=1)
    try:
        m11 = make_host_mesh(1, 1, device)
        cfg = _dist_cfg(gemma_2b, full)
        params = _dist_params(torch, cfg, device)
        prompt = _dist_prompt(torch, cfg, device, S['prompt'])
        got = {}
        for planned in (False, True):
            ops.reset_launches()
            ctx = dplan.planned_mesh(m11) if planned else \
                contextlib.nullcontext()
            with torch.no_grad(), ctx:
                logits, _ = serve_step.make_prefill(cfg)(
                    params, {"tokens": prompt})
                toks = serve_step.greedy_generate(
                    params, cfg, prompt, S['tokens'],
                    S['prompt'][1] + S['tokens'])
            got[planned] = (logits, toks, dict(ops.LAUNCHES))
            del logits
        same = torch.equal(got[True][0], got[False][0]) and \
            torch.equal(got[True][1], got[False][1])
        for k, v in got[True][2].items():
            launches[k] += v
        print(f"[dist_path] (a) NCCL world of 1, mesh (1, 1): gemma-2b "
              f"full width and depth, prefill B={S['prompt'][0]} "
              f"S={S['prompt'][1]} + {S['tokens']} greedy tokens under "
              f"planned_mesh bit for bit = {same}; K1 launches planned "
              f"{got[True][2]['K1']} / unplanned {got[False][2]['K1']}",
              flush=True)
        require(same, "planned_mesh on (1, 1) differs from the unplanned "
                "path")
        require(got[True][2] == got[False][2], "planned_mesh on (1, 1) "
                "launched other kernels than the unplanned path")
        del got, params
        cfg = _dist_cfg(deepseek_moe_16b, full, S['moe_layers'])
        params = _dist_params(torch, cfg, device)
        x = _dist_prompt(torch, cfg, device, (1, S['moe_s']), seed=32)
        with torch.no_grad():
            h = embed_tokens(params, x, cfg)
        # the first MoE layer's FFN, fed the embedded tokens
        lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
        r_g, r_s = [], []
        with torch.no_grad():
            with _routes(moe, r_g):
                yg, sg = moe._apply_moe_global(lp, h, cfg)
            ops.reset_launches()
            with _routes(moe, r_s):
                ys, ss = moe._apply_moe_shardmap(lp, h, cfg, m11)
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        err = ((ys.float() - yg.float()).abs().max() /
               yg.float().abs().max()).item()
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(r_s, r_g))
        print(f"[dist_path] (a) deepseek-moe-16b MoE layer (full width, "
              f"{cfg.n_experts} experts, S={S['moe_s']}) _apply_moe_shardmap "
              f"on (1, 1) against _apply_moe_global: routings differing "
              f"{flips}, max |diff| / max |global| {err:.3e} (tolerance "
              f"{DIST_PATH_TOL}), bit for bit {torch.equal(ys, yg)}, "
              f"dropped {float(ss.dropped_frac):.4f} / "
              f"{float(sg.dropped_frac):.4f}", flush=True)
        require(flips == 0 and err <= DIST_PATH_TOL, "the shard-local MoE "
                "on (1, 1) differs from the global dispatch")
        del params, h, lp, yg, ys
    finally:
        dist.destroy_process_group()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) the spawned world, held to this process's results
    t0 = time.perf_counter()
    ref = _dist_single(torch, device, full, card, S)
    torch.save(ref, os.path.join(DIST_DIR, "ref.pt"))
    single_peak = ref["train"]["peak"]
    del ref
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[dist_path] single-process references "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mp.spawn(_dist_rank, args=(DIST_RANKS, DIST_DIR, device, full_name, S),
             nprocs=DIST_RANKS, join=True)
    print(f"[dist_path] (b) {DIST_RANKS} spawned ranks sharing the card over "
          f"gloo: {time.perf_counter() - t0:.1f} s (not a multi-card "
          f"measurement; {card})", flush=True)
    outs = [torch.load(os.path.join(DIST_DIR, f"rank{r}.pt"))
            for r in range(DIST_RANKS)]
    ref = torch.load(os.path.join(DIST_DIR, "ref.pt"), map_location="cpu")
    o = outs[0]
    rows = []
    for r in o["plans"]:
        lm, lk, ln = r["local"]
        if r["kid"] == "K1":
            b_ms, by = bound(2.0 * lm * ln * lk, 2 * (lm * lk + lk * ln)
                             + 4 * lm * ln, "bfloat16")
            single = ref["K1_ms"]
        else:
            b_ms, by = k9_bound(2.0 * lm * ln * lk, 4 * (lm * lk + lk * ln
                                                         + lm * ln))
            single = ref["K9_ms"]
        same_route = r["route"] == ref["K1_route"] if r["kid"] == "K1" \
            else True
        exact = r["kid"] == "K9" or (r["collective"] in ("none",
                                                         "all_gather")
                                     and same_route)
        print(f"[dist_path] {r['kid']} {r['label']:<13} local "
              f"{lm}x{lk}x{ln} route {r['route']} (single "
              f"{ref['K1_route'] if r['kid'] == 'K1' else 'K9'}) "
              f"collective {r['collective']}: per-shard "
              f"{r['shard_ms']:.4f} ms (bound {b_ms:.4f} ms, {by}; plain "
              f"{r['plain_ms']:.4f} ms; torch.matmul at that shape "
              f"{'none' if r['lib_ms'] is None else round(r['lib_ms'], 4)}"
              f"{'' if r['lib_ms'] is None else ' ms'}), "
              f"collective {r['coll_ms']:.3f} ms (host clock, gloo), apply "
              f"{r['total_ms']:.3f} ms, single device {single:.4f} ms; "
              f"max|err| {r['max_abs_err']:.3e} of {r['scale']:.3e}, "
              f"bit for bit {r['bits']} (required {exact})", flush=True)
        require(r["bits"] if exact else
                r["max_abs_err"] <= DIST_PLAN_TOL * r["scale"],
                f"plan {r['label']} differs from the single-device product")
        rows.append(dict(r, bound_ms=b_ms, bound_by=by, single_ms=single))
    print(f"[dist_path] gemma-2b TP over model={DIST_RANKS}: prefill "
          f"{o['gemma_prefill_ms']:.1f} ms, greedy {S['tokens']} tokens "
          f"{o['gemma_generate_ms']:.1f} ms (host clock, collectives "
          f"{o['coll_ms']['gemma_tp']:.1f} ms); tokens equal the single "
          f"process's {o['gemma_tokens_equal']} ({o['gemma_token_diffs']} "
          f"differ); last logits max|diff| / max {o['gemma_last_err']:.3e}",
          flush=True)
    require(o["gemma_tokens_equal"], "TP tokens differ from the single "
            "process's")
    require(o["gemma_last_err"] <= DIST_PATH_TOL, "TP logits off")
    print(f"[dist_path] deepseek-moe-16b {S['moe_layers']} layers EP over "
          f"model={DIST_RANKS} ({o['moe_experts_a_rank']} experts a rank), "
          f"prefill B=1 S={S['moe_s']}: last logits max|diff| / max "
          f"{o['moe_last_err']:.3e} (routings differing end to end "
          f"{o['moe_route_diffs_e2e']} of {S['moe_s']} over "
          f"{o['moe_routes_n']} routers, at most {DIST_ROUTE_E2E_MAX}: the "
          f"dense layer's TP rounding moves near-ties); the MoE layer on the "
          f"single process's input: routings differing "
          f"{o['moe_route_diffs']}, output max|diff| / max "
          f"{o['moe_layer_err']:.3e} (collectives "
          f"{o['coll_ms']['moe_ep']:.1f} ms)", flush=True)
    require(o["moe_route_diffs"] == 0 and o["moe_routes_n"][0] ==
            o["moe_routes_n"][1] and o["moe_last_err"] <= DIST_PATH_TOL
            and o["moe_route_diffs_e2e"] <= DIST_ROUTE_E2E_MAX
            and o["moe_layer_err"] <= DIST_PATH_TOL,
            "EP MoE differs from the single process")
    cfg = _dist_cfg(gemma_2b, full, S['train_layers'])
    _dist_report_steps(outs, "train", "gemma-2b", cfg, ref["train"], S, card)
    for name, module, layers, _, _ in DIST_STEPS:
        cfg = _dist_cfg(importlib.import_module(
            f"repro_torch.configs.{module}"), full, layers)
        _dist_report_steps(outs, name, name, cfg, ref[name], S, card)
    require(all(x["ckpt_equal"] for x in outs), "re-meshed checkpoint "
            "differs")

    # the same checkpoint in one process
    cfg = _dist_cfg(whisper_base, full)
    comp = CompressionConfig(enabled=True)
    one = ts.init_state(cfg, _dist_params(torch, cfg, device, seed=9,
                                          trainable=True), device, comp)
    one, _ = Checkpointer(os.path.join(DIST_DIR, "ckpt")).restore(one)
    one_equal = _hash_leaves(one) == o["ckpt_hashes"]
    print(f"[dist_path] whisper-base state saved at (2, 2) "
          f"({o['save_ms']:.1f} ms), restored at (4, 1) "
          f"({o['restore_ms']:.1f} ms) and in one process: bit for bit "
          f"{o['ckpt_equal']} / {one_equal}", flush=True)
    require(one_equal, "the checkpoint restored in one process differs")
    del one
    for r, x in enumerate(outs):
        peaks = {k: round(v / 2**30, 2) for k, v in x["peak"].items()}
        launched = {k: {kid: v for kid, v in d.items() if v}
                    for k, d in x["launches"].items()}
        print(f"[dist_path] rank {r}: peak GiB {peaks} (single process's "
              f"train step {single_peak / 2**30:.2f}); launches {launched}; "
              f"wall ms {({k: round(v) for k, v in x['ms'].items()})}",
              flush=True)
        for d in x["launches"].values():
            for kid, v in d.items():
                launches[kid] += v
        if device == "cuda":           # every path launched its kernels
            for path, want in (("plans", ("K1", "K9")),
                               ("gemma_tp", ("K1", "K2")),
                               ("moe_ep", ("K1", "K2")),
                               ("train", ("K1", "K2", "K3", "K4")),
                               *((name, kids) for name, _, _, _, kids
                                 in DIST_STEPS)):
                require(all(x["launches"][path][k] > 0 for k in want),
                        f"rank {r}'s {path} launched none of {want}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    print(f"[dist_path] phase wall {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# dryrun_path: the dry-run's counterpart and the launch-plan sweep, in this
# process (no JAX on the card's machine)
# ---------------------------------------------------------------------------

#: what [train] built on the card: the per-leaf bytes of its TrainState's
#: parameters, f32 masters, m and v, and the config it trained
TRAIN_STATE: dict = {}
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_smoke")


def _tree_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_dryrun_path(torch):
    """``python -m repro_torch.launch.dryrun --all --mesh both`` and
    ``python -m repro_torch.analysis.conformance_all --hardware h100``,
    each through its ``main`` in this process: 80 records (66 OK, 14
    SKIP, none FAIL) and no failure, with no JAX module imported; then
    the dry-run's per-rank state bytes for gemma-2b on a (1, 1) mesh held
    equal to the bytes of the TrainState ``[train]`` built on the card.
    Launches nothing on the card."""
    import shutil

    from repro_torch.analysis import conformance_all
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    rc = dryrun.main(["--all", "--mesh", "both", "--out", DRYRUN_DIR])
    recs = [json.load(open(os.path.join(DRYRUN_DIR, f)))
            for f in sorted(os.listdir(DRYRUN_DIR))]
    status = [r["status"] for r in recs]
    dry_s = time.perf_counter() - t0
    print(f"[dryrun_path] dryrun --all --mesh both: rc {rc}, {len(recs)} "
          f"records, {status.count('OK')} OK, {status.count('SKIP')} SKIP, "
          f"{status.count('FAIL')} FAIL in {dry_s:.2f} s", flush=True)
    require(rc == 0 and len(recs) == 80 and status.count("OK") == 66
            and status.count("SKIP") == 14, "the dry-run's records")
    t1 = time.perf_counter()
    report = conformance_all.run_sweep(hardware="h100")
    print(f"[dryrun_path] conformance_all --hardware h100: "
          f"{report['checked']} checked, {report['refused']} refused, "
          f"{report['not_planned']} not planned, {report['failed']} failed "
          f"in {time.perf_counter() - t1:.2f} s", flush=True)
    require(report["failed"] == 0, f"conformance failures "
            f"{report['failures']}")
    jax_mods = sorted(m for m in sys.modules if m == "jax"
                      or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro."))
    require(not jax_mods, f"JAX or the JAX package imported: {jax_mods}")
    cfg, built = TRAIN_STATE["cfg"], TRAIN_STATE["bytes"]
    model = dryrun.state_bytes(cfg, dryrun.SizedMesh({"data": 1,
                                                      "model": 1}))
    print(f"[dryrun_path] gemma-2b ({cfg.n_layers} layers) state bytes on a "
          f"(1, 1) mesh: dry-run {model}, [train]'s TrainState on the card "
          f"{built}", flush=True)
    require(model == built, "the dry-run's state bytes differ from the "
            "TrainState's")
    for r in recs:
        if r["arch"] == "gemma-2b" and r["status"] == "OK":
            pr = r["per_rank_bytes"]
            print(f"[dryrun_path] {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r['n_chips']} chips, per rank params "
                  f"{pr['params'] / 2**20:.1f} MiB, state "
                  f"{sum(pr.get(k, 0) for k in ('master', 'm', 'v')) / 2**20:.1f}"
                  f" MiB, activations {pr['activations'] / 2**30:.2f} GiB, "
                  f"cache {pr['cache'] / 2**30:.2f} GiB, collectives "
                  f"{ {k: round(v / 2**30, 2) for k, v in r['collectives_bytes'].items()} }"
                  f" GiB, dominant {r['roofline']['dominant']}", flush=True)
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    print(f"[dryrun_path] phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return _zero_launches()


def profile_step(torch, step, n: int = 3, what: str = "decode",
                 detail: bool = True) -> tuple[float, float]:
    """Device time by kernel over ``n`` steps (torch.profiler); the
    kernels' rows only with ``detail``.  Returns ``(wall ms, device busy
    ms)`` over the ``n`` steps."""
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
    if not detail:
        return wall_ms, busy_ms
    # the 12 largest rows, then every other row of the port's own kernels
    # (their symbols open with an anonymous namespace, PyTorch's name
    # at::), so each kernel's share of the step shows
    ours = ("(anonymous namespace)::", "void (anonymous namespace)::")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 12 or (e.key.startswith(ours) and "at::" not in e.key):
            print(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} "
                  f"ms/step  x{e.count // n:<4d} {e.key[:70]}")
    return wall_ms, busy_ms


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
    remat = phase_remat_dots(torch, smi_line)
    torch.cuda.empty_cache()
    launch = phase_launch_path(torch, smi_line)
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
    t0 = time.perf_counter()
    moa, applied = phase_moa_path(torch, rec)
    print(f"[moa_path] phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    derive = phase_derive_path(torch, rec, applied)
    del applied
    torch.cuda.empty_cache()
    energy = phase_energy_path(torch, smi_line)
    torch.cuda.empty_cache()
    moe_serve = phase_moe_path(torch, smi_line)
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(torch, smi_line)
    torch.cuda.empty_cache()
    llama4_serve = phase_llama4_path(torch, smi_line)
    torch.cuda.empty_cache()
    mla_serve = phase_mla_path(torch, smi_line)
    torch.cuda.empty_cache()
    mla_train = phase_mla_train(torch, smi_line)
    torch.cuda.empty_cache()
    vlm_serve = phase_vlm_path(torch, smi_line)
    torch.cuda.empty_cache()
    vlm_train = phase_vlm_train(torch, smi_line)
    torch.cuda.empty_cache()
    encdec_serve = phase_encdec_path(torch, smi_line)
    torch.cuda.empty_cache()
    encdec_train = phase_encdec_train(torch, smi_line)
    torch.cuda.empty_cache()
    dist_launches, _ = phase_dist_path(torch, smi_line)
    dryrun_launches = phase_dryrun_path(torch)

    from repro_torch.kernels import ops
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
                   f"K8 float32 B=1 S={HYB_S} w=4096 chunk="
                   f"{ops.default_gated_chunk(HYB_S, 4096)}"),
            "K9": ("K9_semiring", src + "semiring.cu",
                   "src/repro/kernels/emit.py:125",
                   f"K9 float32 max-plus {MOA_BIG}x{MOA_BIG}x{MOA_BIG}")}
    runs = {"path": serve, "path_per_slot": serve_per_slot, "train": train,
            "remat_dots": remat, "launch_path": launch,
            "stablelm_path": stablelm_serve,
            "stablelm_train": stablelm_train, "cmdr_path": cmdr_serve,
            "ssm_path": ssm_serve,
            "ssm_train": ssm_train, "hybrid_path": hybrid_serve,
            "hybrid_train": hybrid_train, "moa_path": moa,
            "derive_path": derive, "energy_path": energy,
            "moe_path": moe_serve, "moe_train": moe_train,
            "llama4_path": llama4_serve, "mla_path": mla_serve,
            "mla_train": mla_train, "vlm_path": vlm_serve,
            "vlm_train": vlm_train, "encdec_path": encdec_serve,
            "encdec_train": encdec_train, "dist_path": dist_launches,
            "dryrun_path": dryrun_launches}
    kernels = []
    for kid, (name, source, replaces, shape) in head.items():
        # launches: the path runs', each counted from 0
        by_path = {k: run[kid] for k, run in runs.items()}
        # the kernel's routes over its [kernels] rows (K1's decode rows,
        # head tile, ...), their split counts and forms left out
        routes = sorted({re.sub(r" (split-k|form)=\S+", "", str(r["path"]))
                         for r in rec[kid].values() if "path" in r})
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, routes=routes,
                            shape=shape, **rec[kid][shape]))
    for route in ("head tile", "head tile float16", "int8 tile",
                  "int8 decode rows"):
        require(route in kernels[0]["routes"],
                f"K1's routes {kernels[0]['routes']} lack the {route}")
    print(f"[smoke] wall {time.perf_counter() - START:.1f} s, the build "
          f"included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
