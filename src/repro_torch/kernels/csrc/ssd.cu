// K6, the Mamba-2 SSD chunked scan with the optional export of the state
// entering each chunk, and K7, its reverse scan (the backward of K6).  The
// two share one source so that K7 replays each chunk's decays with the
// very code (and so the same bits) that K6 ran.
//
// K6:  C, B (b, S, n), X (b, S, h, 64), dA (b, S, h), H0 (b, h, 64, n)
//      ->  y (b, S, h, 64), h_final (b, h, 64, n), h_in (b, S / q, h, 64, n)
// K7:  C, B, dY (b, S, h, 64), X, dA, Hin (b, S / q, h, 64, n) (K6's export),
//      dHf (b, h, 64, n)
//      ->  dX (b, S, h, 64), dh0 (b, h, 64, n), dB, dC (b, S, n),
//          ddA (b, S, h)
// All f32.  S is a multiple of the chunk q; 1 <= q <= 256, 1 <= n <= 128.
//
// Per chunk of q tokens and per head, with csh the in-chunk cumulative sum
// of dA, ind = exp(csh) and dec = exp(total - csh):
//   L[i, j] = exp(csh[i] - csh[j]) for j <= i, else 0,   P = (C B') . L
//   y[i]    = sum_j P[i, j] X[j] + ind[i] (C[i] . h)
//   h'      = exp(total) h + sum_j B[j] dec[j] X[j]
// and K7, per chunk, from its entering state Hc and the cotangent dh of its
// exit state, every cotangent in the reference's terms:
//   dtotal = exp(total) sum(dh . Hc) + sum_j ddec[j] dec[j]
//   dXd = B dh',  dX = dXd dec + P' dY,  ddec[j] = dXd[j] . X[j]
//   dB = (dec X) dh' + dG' C,   dC = (ind dY) Hc + dG B,
//   dG = sum over heads of dP . L,   dP = dY X',   dseg = tril(dP . G . L),
//   dcsh = -ddec dec + (dY . (C Hc')) ind + rowsum(dseg) - colsum(dseg)
//          (+ dtotal at q - 1),   ddA = reverse cumsum of dcsh,
//   dh (entering) = exp(total) dh + C' (ind dY)
//
// Replaces: src/repro/kernels/emit.py, _ssd_kind (the `ssd` recurrence kind
// that ops.scan_ssd reaches through _ssd_executor, and with n_so == 2 the
// ssd_chk_form of _ssd_chk_executor: the h_in export, emit.py:429-430) and
// _ssd_backward_kind (the `ssd_backward` kind of ops._ssd_bwd_executor).
// On the TPU one grid cell holds the whole (h, p, n) state in VMEM and walks
// the chunks in order; here the chunked-SSD decomposition that _ssd_kind's
// docstring spells out (emit.py:392-400) runs as a chunk-parallel grid.
//
// What bounds them on an H100: the products, f32 by the reference's
// contract.  Per chunk and head K6 does 2 q^2 p (P.X, half of it causal) +
// 4 q p n (readout, state update) flops, plus 2 q^2 n (scores) per chunk
// for all heads; K7 about twice that.  On the FMA units (67 TFLOP/s) that
// is far above the f32 ridge.  Here every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) at f32 accuracy: each f32
// operand is split as hi = bf16(x), lo = bf16(x - hi) (|x - hi - lo| <=
// 2^-16 |x|) and a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi, three products
// (ops.py's SSD_SPLIT_PARTS; one part fewer misses the 1e-4 tolerance,
// tests/test_torch_ssd_design.py).  mma.sync rather than wgmma: the P, P'
// and dP tiles are made in registers (scores times decays) and feed the
// next product straight from the accumulator layout, which is mma.sync's
// A-fragment layout, and the elementwise work between products (L, ind,
// dec, dseg) stays in f32 registers.  Operands are staged as they lie in
// device memory by cp.async (16-byte copies when n is a multiple of 4 and
// every base 16-byte aligned, a shape rule checked before launch; 4-byte
// copies otherwise), the next stage in flight while the tensor cores run;
// a tile that several warps read is split once a block into bf16 hi / lo
// planes that ldmatrix reads.
//
// Design: a call is a few kernels over a grid of chunks, heads and 64-row
// tiles of the chunk; only the hand-over of the state between chunks runs
// in order.  Independent chains run on a second stream, forked from and
// joined back into the caller's stream by events.
//   ssd_decay        csh per (b, chunk, head), with ind = exp(csh) and dec =
//                    exp(total - csh) beside it (K6 and K7 read their
//                    decays from it, so both see the same bits)
//   ssd_scores       C B' (K6) or B C' (K7) once per chunk and 64 x 64 tile
//                    pair, into a (b, nc, qp, qp) buffer every head reads
//   ssd_gemm         the chunk GEMM: the (q, p, n) products with the heads
//                    side by side, 128 x 128 tiles of 8 warps
// K6:  decay, then
//   caller's stream  ssd_scores; ssd_fwd_out per (chunk, head, row tile):
//                    y = sum over column tiles of (G . L) X
//   side stream      ssd_gemm: each chunk's state contribution B' (dec X)
//                    into h_in's slots; ssd_fwd_pass per (b, head),
//                    elementwise over (p, n), chunks in order: h_in[c] <-
//                    h, h <- exp(total) h + contribution, and h_final
//   joined           ssd_gemm: the readout, y += ind (C h_in')
// K7:  decay, then
//   caller's stream  ssd_gemm: each chunk's share C' (ind dY) of the
//                    entering state's cotangent; ssd_bwd_pass per (b,
//                    head), chunks last to first: the cotangent of each
//                    chunk's exit state, dh0 and sum(dh . Hc); ssd_gemm:
//                    dXd = B dh' (dX's first term dXd dec, and ddec dec
//                    from its rows dotted with X); ssd_bwd_col per (chunk,
//                    head, tile): dX += P' dY and dseg's row / column sums
//   side stream      ssd_scores (G'); ssd_bwd_dg per (chunk, tile pair,
//                    head group): dG' summed over the group's heads in
//                    registers, in head order; once the exit cotangents
//                    are in, ssd_bwd_bc per (chunk, tile, head group, side,
//                    64 state columns): dB's and dC's terms summed over the
//                    group's heads in registers, in order, plus the group's
//                    dG' C and dG B, and din; ssd_bwd_sum: the groups'
//                    partials summed in order
//   joined           ssd_bwd_ddA per (b, chunk, head): dcsh and its reverse
//                    cumsum
// Every sum runs in a fixed order and no kernel uses atomics, so a rerun
// gives the same bits; y and h_final are the same bits with the export on
// or off (the entering states are always computed, the export only hands
// them back).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr int P = 64;          // head_dim
constexpr int NMAX = 128;      // widest state
constexpr int QMAX = 256;      // longest chunk
constexpr int T = 64;          // rows of a tile
// the row stride (floats) of an f32 tile that warps read as row pairs
// (float2 at row g, column 2t: conflict-free when the stride is 8 mod 32)
constexpr int S64RM = 72;

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [0, R) x columns [0, width) of a row-major f32 matrix
// (row r at src + r * ld) into dst (row stride ds floats), NT threads; rows
// >= rows and columns >= cols are zero-filled.  `safe` is a valid address
// of the same operand for the zero-filled copies.  vec: 16-byte copies
// (src, ld and cols multiples of 4 floats), else 4-byte ones.
template <int R, int NT>
__device__ __forceinline__ void stage_rows(float* dst, int ds,
                                           const float* src, size_t ld,
                                           int rows, int cols, int width,
                                           bool vec, const float* safe) {
  if (vec) {
    const int w4 = width >> 2;
    for (int e = threadIdx.x; e < R * w4; e += NT) {
      const int r = e / w4, c = (e - r * w4) << 2;
      const bool ok = r < rows && c < cols;
      cp16(dst + r * ds + c, ok ? src + (size_t)r * ld + c : safe, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * width; e += NT) {
      const int r = e / width, c = e - r * width;
      const bool ok = r < rows && c < cols;
      cp4(dst + r * ds + c, ok ? src + (size_t)r * ld + c : safe, ok);
    }
  }
}

__device__ __forceinline__ void stage(float* dst, int ds, const float* src,
                                      size_t ld, int rows, int cols,
                                      int width, bool vec,
                                      const float* safe) {
  stage_rows<T, THREADS>(dst, ds, src, ld, rows, cols, width, vec, safe);
}

// ---- decays (the code both scans run) -----------------------------------

__device__ __forceinline__ float decay_in(float c) { return expf(c); }
__device__ __forceinline__ float decay_out(float total, float c) {
  return expf(total - c);
}
// L[i, j] = exp(csh[i] - csh[j]) on the special-function unit (ex2.approx,
// relative error below 2^-22): exactly 0 off the causal triangle and past
// the chunk's q real rows, as the reference's exp(MASK_NEG_INF) is
__device__ __forceinline__ float seg_decay(int i, int j, int q, float ci,
                                           float cj) {
  if (!(j <= i && i < q)) return 0.f;
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(r)
      : "f"(__fmul_rn(__fsub_rn(ci, cj), 1.4426950408889634f)));
  return r;
}

// ---- split-bf16 tensor-core products ---------------------------------------

struct FragA {   // a 16 x 16 A operand, hi and lo parts
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// The eight f32 values of a thread's share of a 16 x 16 A tile, at
// (row, col) = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8),
// (g, 2t+9), (g+8, 2t+8), (g+8, 2t+9): the order of mma.sync's A registers,
// and of two neighbouring 16 x 8 accumulators' four values each.
__device__ __forceinline__ FragA frag_a(const float (&v)[8]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split2(v[2 * i], v[2 * i + 1], f.hi[i], f.lo[i]);
  return f;
}

// element (r, c) at a[r * s + c]
__device__ __forceinline__ void ld_a_rm(float (&v)[8], const float* a,
                                        int s) {
  const float* r0 = a + lane_g() * s + 2 * lane_t();
  const float* r8 = r0 + 8 * s;
  float2 x = *reinterpret_cast<const float2*>(r0);
  v[0] = x.x; v[1] = x.y;
  x = *reinterpret_cast<const float2*>(r8);
  v[2] = x.x; v[3] = x.y;
  x = *reinterpret_cast<const float2*>(r0 + 8);
  v[4] = x.x; v[5] = x.y;
  x = *reinterpret_cast<const float2*>(r8 + 8);
  v[6] = x.x; v[7] = x.y;
}

// (not volatile: a pure register operation, so the compiler may interleave
// products into different accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 planes: an f32 tile split once a block, read with ldmatrix ----
//
// A tile shared by the block's warps (a B operand, or an A operand read
// whole) is split once into hi and lo bf16 planes, the lo plane right after
// the hi one; rows are 16-byte aligned and 8 mod 64 elements apart (40 for
// the chunk GEMM's 32-wide planes: 80 bytes, which eight rows also spread
// over distinct banks), so ldmatrix reads them without bank conflicts.
constexpr int PL64 = 72, PLN = 136;   // plane row strides (bf16 elements)
constexpr int PLANE64 = 2 * T * PL64 * 2, PLANEN = 2 * T * PLN * 2;   // bytes

// rows [0, R) x columns [0, width) of the f32 tile src (row stride ss
// floats, width a multiple of 4) into the planes at pl (row stride ps, the
// lo plane R rows after the hi one), NT threads; each value scaled first
// (the reference's rounded product) by wt[r] (wmode 1) or wt[2 r + c / 64]
// (wmode 2)
template <int R, int NT>
__device__ __forceinline__ void to_planes_rows(uint16_t* pl, int ps,
                                               const float* src, int ss,
                                               int width, const float* wt,
                                               int wmode) {
  const int w4 = width >> 2;
  for (int e = threadIdx.x; e < R * w4; e += NT) {
    const int r = e / w4, c = (e - r * w4) << 2;
    float4 v = *reinterpret_cast<const float4*>(src + r * ss + c);
    if (wmode != 0) {
      const float k = wmode == 1 ? wt[r] : wt[2 * r + (c >> 6)];
      v.x = __fmul_rn(v.x, k);
      v.y = __fmul_rn(v.y, k);
      v.z = __fmul_rn(v.z, k);
      v.w = __fmul_rn(v.w, k);
    }
    uint32_t h0, l0, h1, l1;
    split2(v.x, v.y, h0, l0);
    split2(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(pl + r * ps + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(pl + (R + r) * ps + c) = make_uint2(l0, l1);
  }
}

__device__ __forceinline__ void to_planes(uint16_t* pl, int ps,
                                          const float* src, int ss,
                                          int width, const float* wt) {
  to_planes_rows<T, THREADS>(pl, ps, src, ss, width, wt, wt ? 1 : 0);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A (16 x 16) with A(r, c) = M[r0 + r][c0 + c] of the planes at pl (the lo
// plane `rows` rows after the hi one)
__device__ __forceinline__ FragA lda_pl(const uint16_t* pl, int ps, int r0,
                                        int c0, int rows = T) {
  const int l = threadIdx.x & 31;
  const int off = (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ps + c0 + (l >> 4) * 8;
  FragA f;
  ldsm4(f.hi, pl + off);
  ldsm4(f.lo, pl + rows * ps + off);
  return f;
}

// A (16 x 16) with A(r, c) = M[r0 + c][c0 + r]
__device__ __forceinline__ FragA ldat_pl(const uint16_t* pl, int ps, int r0,
                                         int c0, int rows = T) {
  const int l = threadIdx.x & 31;
  const int off = (r0 + (l & 7) + (l >> 4) * 8) * ps + c0 + ((l >> 3) & 1) * 8;
  FragA f;
  ldsm4t(f.hi, pl + off);
  ldsm4t(f.lo, pl + rows * ps + off);
  return f;
}

struct FragB2 {   // two neighbouring 16 x 8 B operands, n-tiles n0, n0 + 8
  uint32_t hi[4], lo[4];
};

// B(k, n) = M[n0 + n][k0 + k]
__device__ __forceinline__ FragB2 ldb_nm_pl(const uint16_t* pl, int ps,
                                            int k0, int n0, int rows = T) {
  const int l = threadIdx.x & 31;
  const int off = (n0 + (l & 7) + (l >> 4) * 8) * ps + k0 + ((l >> 3) & 1) * 8;
  FragB2 f;
  ldsm4(f.hi, pl + off);
  ldsm4(f.lo, pl + rows * ps + off);
  return f;
}

// B(k, n) = M[k0 + k][n0 + n]
__device__ __forceinline__ FragB2 ldb_km_pl(const uint16_t* pl, int ps,
                                            int k0, int n0, int rows = T) {
  const int l = threadIdx.x & 31;
  const int off = (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ps + n0 + (l >> 4) * 8;
  FragB2 f;
  ldsm4t(f.hi, pl + off);
  ldsm4t(f.lo, pl + rows * ps + off);
  return f;
}

// d[nt] += a b[nt] at f32 accuracy over the first npairs pairs of 8
// n-tiles (b[np] holds n-tiles 2 np, 2 np + 1): the three products of the
// split parts, lo.hi, hi.lo, hi.hi, taken pass by pass so that neighbouring
// mma.sync write different accumulators
__device__ __forceinline__ void mma3_row(float (&d)[8][4], const FragA& a,
                                         const FragB2 (&b)[4],
                                         int npairs = 4) {
#pragma unroll
  for (int np = 0; np < 4; ++np)
    if (np < npairs) {
      mma_bf16(d[2 * np], a.lo, b[np].hi[0], b[np].hi[1]);
      mma_bf16(d[2 * np + 1], a.lo, b[np].hi[2], b[np].hi[3]);
    }
#pragma unroll
  for (int np = 0; np < 4; ++np)
    if (np < npairs) {
      mma_bf16(d[2 * np], a.hi, b[np].lo[0], b[np].lo[1]);
      mma_bf16(d[2 * np + 1], a.hi, b[np].lo[2], b[np].lo[3]);
    }
#pragma unroll
  for (int np = 0; np < 4; ++np)
    if (np < npairs) {
      mma_bf16(d[2 * np], a.hi, b[np].hi[0], b[np].hi[1]);
      mma_bf16(d[2 * np + 1], a.hi, b[np].hi[2], b[np].hi[3]);
    }
}

// acc += t, each sum rounded to nearest.  The tensor cores' own f32 sums
// round toward zero, which over a long contraction biases a result toward
// zero (measured on K6's y, PERF.md); so each stage's products land in a
// fresh tile t that is added here.
__device__ __forceinline__ void add_tile(float (&acc)[8][4],
                                         const float (&t)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], t[nt][e]);
}

// The A operand of a 16 x 16 block made of accumulators nt, nt + 1 (a tile
// computed by this warp), weighted and split in registers
__device__ __forceinline__ void acc_pair(float (&v)[8], const float (&c0)[4],
                                         const float (&c1)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = c0[e];
    v[4 + e] = c1[e];
  }
}

// accumulator element e of n-tile nt: row g + 8 (e >> 1), col 8 nt + 2t +
// (e & 1)
__device__ __forceinline__ int acc_row(int e) { return lane_g() + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int nt, int e) {
  return 8 * nt + 2 * lane_t() + (e & 1);
}

// the sum over the 4 lanes that share a row of the accumulator layout
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum over the 8 lane groups (rows g) that share a column
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ void tile_pair(int idx, int& hi, int& lo) {
  // 0 -> (0, 0), 1 -> (1, 0), 2 -> (1, 1), 3 -> (2, 0), ...
  hi = 0;
  while (idx > hi) {
    idx -= hi + 1;
    ++hi;
  }
  lo = idx;
}

// head group gi of ng over H heads: [first, last) (ops.ssd_head_groups)
__device__ __forceinline__ int group_first(int gi, int H, int ng) {
  return static_cast<int>((static_cast<long long>(gi) * H) / ng);
}

__device__ __forceinline__ int ntiles(int q) { return (q + T - 1) / T; }
__device__ __forceinline__ int kpad(int n) { return (n + 15) & ~15; }

// ---------------------------------------------------------------------------
// shared
// ---------------------------------------------------------------------------

// csh (b, S, H): the in-chunk cumulative sum of dA, and beside it ind =
// exp(csh) and dec = exp(total - csh).  A block takes one chunk and 32
// heads; thread (segment g, head) sums rows [32 g, 32 g + 32) in order,
// then adds the totals of the segments before it, in order (one
// association on every call, so K6 and K7 read the same bits).
constexpr int DECAY_SEG = 32, DECAY_THREADS = 32 * (QMAX / DECAY_SEG);

__global__ void __launch_bounds__(DECAY_THREADS)
ssd_decay(const float* __restrict__ dA, float* __restrict__ csh,
          float* __restrict__ ind, float* __restrict__ dec, int H, int q) {
  __shared__ float tot[QMAX / DECAY_SEG][32];
  __shared__ float last[32];
  const int hl = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int hh = blockIdx.y * 32 + hl;
  const size_t row0 = (size_t)blockIdx.x * q;
  const int i0 = seg * DECAY_SEG;
  float v[DECAY_SEG];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < DECAY_SEG; ++k) {
    v[k] = (hh < H && i0 + k < q) ? dA[(row0 + i0 + k) * H + hh] : 0.f;
    run += v[k];
  }
  tot[seg][hl] = run;
  __syncthreads();
  run = 0.f;
  for (int g = 0; g < seg; ++g) run += tot[g][hl];
#pragma unroll
  for (int k = 0; k < DECAY_SEG; ++k) {
    run += v[k];
    v[k] = run;
    if (i0 + k == q - 1) last[hl] = run;
  }
  __syncthreads();
  if (hh >= H) return;
  const float total = last[hl];
#pragma unroll
  for (int k = 0; k < DECAY_SEG; ++k) {
    if (i0 + k >= q) break;
    const size_t o = (row0 + i0 + k) * H + hh;
    csh[o] = v[k];
    ind[o] = decay_in(v[k]);
    dec[o] = decay_out(total, v[k]);
  }
}

// out[bc][r][c] = sum_k A[r][k] Bm[c][k] over a chunk's 64 x 64 tile pairs:
// row tile >= column tile when `lower` (K6: G = C B'), <= otherwise (K7:
// G' = B C').  out is (b * nc, qp, qp); other tiles are left unwritten.
constexpr int SCORES_SMEM = 2 * T * NMAX * 4 + 2 * PLANEN;

__global__ void __launch_bounds__(THREADS)
ssd_scores(const float* __restrict__ A, const float* __restrict__ Bm,
           float* __restrict__ out, int n, int q, int lower, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;                                   // A, Bm: (T, NMAX) f32
  uint16_t* ap = reinterpret_cast<uint16_t*>(sm + 2 * T * NMAX);
  uint16_t* bp = ap + PLANEN / 2;
  const size_t bc = blockIdx.x;
  int hi, lo;
  tile_pair(blockIdx.y, hi, lo);
  const int rt = lower ? hi : lo, ct = lower ? lo : hi;
  const int qp = ntiles(q) * T, kp = kpad(n), w = threadIdx.x >> 5;
  stage(raw, NMAX, A + (bc * q + rt * T) * n, n, q - rt * T, n, kp, vec, A);
  stage(raw + T * NMAX, NMAX, Bm + (bc * q + ct * T) * n, n, q - ct * T, n,
        kp, vec, Bm);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  to_planes(ap, PLN, raw, NMAX, kp, nullptr);
  to_planes(bp, PLN, raw + T * NMAX, NMAX, kp, nullptr);
  __syncthreads();

  float acc[8][4] = {};
  for (int h0 = 0; h0 < kp; h0 += 64) {   // 64 state columns a stage
    float t[8][4] = {};
    for (int k0 = h0; k0 < kp && k0 < h0 + 64; k0 += 16) {
      const FragA a = lda_pl(ap, PLN, 16 * w, k0);
      FragB2 b[4];
#pragma unroll
      for (int np = 0; np < 4; ++np) b[np] = ldb_nm_pl(bp, PLN, k0, 16 * np);
      mma3_row(t, a, b);
    }
    add_tile(acc, t);
  }
  float* o = out + (bc * qp + rt * T + 16 * w) * qp + ct * T;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = acc_col(nt, 0);
    *reinterpret_cast<float2*>(o + (size_t)lane_g() * qp + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o + (size_t)(lane_g() + 8) * qp + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// The chunk GEMM: every (q, p, n) product of both scans
// ---------------------------------------------------------------------------
//
// D (M x N) = sum_k A (m, k) B (k, n) for each chunk z (blockIdx.z), over
// 128 x 128 tiles, 8 warps of 32 x 64 each.  The per-head (q, p, n)
// products are taken whole per chunk with the heads side by side in one
// dimension (X's and dY's (h, p) columns, the states' (h, p) rows), so a
// head-independent operand (C or B rows) is staged once for two heads.
// The contraction is staged 32 deep by cp.async, the next stage in flight
// while the tensor cores run on the last, each stage split into bf16
// planes once.
constexpr int GM = 128, GN = 128, GK = 32, GTHREADS = 256;

struct GemmOp {
  // A (m, k) at a + z a_z + (column-major ? k lda + m : m lda + k)
  const float* a;
  long long a_z;
  int lda;
  // B (k, n) at b + z b_z + (n-major ? n ldb + k : k ldb + n)
  const float* b;
  long long b_z;
  int ldb;
  // extents: rows m < M and columns n < N are staged and stored, k < K
  // summed (a chunk-row extent is the chunk's q rows)
  int M, N, K, q, H;
  // column-major A scaled before the product (the reference's rounded
  // product) by wa (b, S, H) at row k, head m / 64, when given
  const float* wa;
  // D (m, n) into out + z out_z + m ldo + n, scaled first by wo (b, S, H)
  // at row m, head n / 64, when given; added to what is there when
  // accumulate
  float* out;
  long long out_z;
  int ldo, accumulate;
  const float* wo;
  // per row m and head n / 64: the sum over the head's 64 columns of D . R
  // (R (m, n) at rd + z rd_z + m ldr + n), times wo, into rv (b, S, H)
  const float* rd;
  long long rd_z;
  int ldr;
  float* rv;
};

constexpr int GEMM_STAGE = 2 * GM * GK + GM;         // A, B, the A weights

template <int ACM, int BNM>
constexpr int gemm_smem() {
  return 2 * GEMM_STAGE * 4 +
         2 * 2 * ((ACM ? GK * (GM + 8) : GM * (GK + 8)) +
                  (BNM ? GN * (GK + 8) : GK * (GN + 8)));
}

template <int ACM, int BNM>
__global__ void __launch_bounds__(GTHREADS, 2)
ssd_gemm(const GemmOp op, int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int APS = ACM ? GM + 8 : GK + 8, AROWS = ACM ? GK : GM;
  constexpr int BPS = BNM ? GK + 8 : GN + 8, BROWS = BNM ? GN : GK;
  uint16_t* ap = reinterpret_cast<uint16_t*>(sm + 2 * GEMM_STAGE);
  uint16_t* bp = ap + 2 * AROWS * APS;
  const size_t z = blockIdx.z;
  const int bm0 = blockIdx.x * GM, bn0 = blockIdx.y * GN;
  const float* A = op.a + z * op.a_z;
  const float* Bo = op.b + z * op.b_z;
  const int w = threadIdx.x >> 5, wm = w & 3, wn = w >> 2;
  const int ke = op.K, nsteps = (ke + GK - 1) / GK;
  auto issue = [&](int s) {
    float* st = sm + (s & 1) * GEMM_STAGE;
    const int k0 = s * GK;
    const int kr = ke - k0;
    if (ACM)
      stage_rows<GK, GTHREADS>(st, GM, A + (size_t)k0 * op.lda + bm0, op.lda,
                               kr, op.M - bm0, GM, vec, op.a);
    else
      stage_rows<GM, GTHREADS>(st, GK, A + (size_t)bm0 * op.lda + k0, op.lda,
                               op.M - bm0, kr, GK, vec, op.a);
    float* bs = st + GM * GK;
    if (BNM)
      stage_rows<GN, GTHREADS>(bs, GK, Bo + (size_t)bn0 * op.ldb + k0,
                               op.ldb, op.N - bn0, kr, GK, vec, op.b);
    else
      stage_rows<GK, GTHREADS>(bs, GN, Bo + (size_t)k0 * op.ldb + bn0,
                               op.ldb, kr, op.N - bn0, GN, vec, op.b);
    float* ws = bs + GK * GN;
    if (ACM && op.wa != nullptr && threadIdx.x < 2 * GK) {
      const int row = k0 + (threadIdx.x >> 1);
      const int head = bm0 / P + (threadIdx.x & 1);
      const bool ok = row < ke && row < op.q && head < op.H;
      cp4(ws + threadIdx.x,
          ok ? op.wa + (z * op.q + row) * op.H + head : op.wa, ok);
    }
    cp_commit();
  };
  float acc[2][8][4] = {};
  const bool busy = bm0 + wm * 32 < op.M && bn0 + wn * 64 < op.N;
  if (nsteps > 0) issue(0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* st = sm + (s & 1) * GEMM_STAGE;
    to_planes_rows<AROWS, GTHREADS>(ap, APS, st, ACM ? GM : GK,
                                    ACM ? GM : GK, st + 2 * GM * GK,
                                    ACM && op.wa != nullptr ? 2 : 0);
    to_planes_rows<BROWS, GTHREADS>(bp, BPS, st + GM * GK, BNM ? GK : GN,
                                    BNM ? GK : GN, nullptr, 0);
    __syncthreads();
    if (busy) {
      const int k0 = s * GK;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float t[8][4] = {};
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk) {
          if (k0 + kk * 16 >= ke) break;
          const FragA a =
              ACM ? ldat_pl(ap, APS, kk * 16, wm * 32 + mt * 16, AROWS)
                  : lda_pl(ap, APS, wm * 32 + mt * 16, kk * 16, AROWS);
          FragB2 b[4];
#pragma unroll
          for (int np = 0; np < 4; ++np)
            b[np] = BNM ? ldb_nm_pl(bp, BPS, kk * 16, wn * 64 + np * 16, BROWS)
                        : ldb_km_pl(bp, BPS, kk * 16, wn * 64 + np * 16, BROWS);
          mma3_row(t, a, b);
        }
        add_tile(acc[mt], t);
      }
    }
    __syncthreads();
  }
  if (!busy) return;
  const int head = (bn0 + wn * 64) / P;
  float* O = op.out != nullptr ? op.out + z * op.out_z : nullptr;
  const float* R = op.rd != nullptr ? op.rd + z * op.rd_z : nullptr;
  // column pairs (2t, 2t + 1) go out as one 8-byte store where the rows
  // keep them 8-byte aligned: a row's four lanes fill a 32-byte sector
  const bool pairs = (op.ldo & 1) == 0 && (op.N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = bm0 + wm * 32 + mt * 16 + lane_g() + 8 * hf;
      const bool rowok = m < op.M;
      const float wgt = op.wo != nullptr && rowok
                            ? op.wo[(z * op.q + m) * op.H + head] : 1.f;
      float dot = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = bn0 + acc_col(wn * 8 + nt, 0);
        if (!rowok || n >= op.N) continue;
        float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        if (R != nullptr) {
          const float2 r =
              *reinterpret_cast<const float2*>(R + (size_t)m * op.ldr + n);
          dot = fmaf(v0, r.x, dot);
          dot = fmaf(v1, r.y, dot);
        }
        if (O == nullptr) continue;
        if (op.wo != nullptr) {
          v0 = __fmul_rn(v0, wgt);
          v1 = __fmul_rn(v1, wgt);
        }
        float* o = O + (size_t)m * op.ldo + n;
        if (pairs) {
          float2* o2 = reinterpret_cast<float2*>(o);
          if (op.accumulate) {
            const float2 was = *o2;
            v0 = __fadd_rn(was.x, v0);
            v1 = __fadd_rn(was.y, v1);
          }
          *o2 = make_float2(v0, v1);
        } else {
          o[0] = op.accumulate ? __fadd_rn(o[0], v0) : v0;
          if (n + 1 < op.N) o[1] = op.accumulate ? __fadd_rn(o[1], v1) : v1;
        }
      }
      if (R != nullptr) {
        dot = quad_sum(dot);
        if (lane_t() == 0 && rowok)
          op.rv[(z * op.q + m) * op.H + head] =
              op.wo != nullptr ? __fmul_rn(dot, wgt) : dot;
      }
    }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// per (b, head), elementwise over the (p, n) state, chunks in order: buf[c]
// holds chunk c's contribution on entry and the state entering chunk c on
// exit; hf the state after the last chunk.  Eight chunks' loads in flight.
__global__ void __launch_bounds__(256)
ssd_fwd_pass(const float* __restrict__ csh, const float* __restrict__ H0,
             float* __restrict__ buf, float* __restrict__ hf, int nc, int H,
             int n, int q) {
  const int pn = P * n;
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= pn) return;
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  float h = H0[(size_t)bh * pn + e];
  float* slot = buf + ((size_t)b * nc * H + hh) * pn + e;
  const size_t step = (size_t)H * pn;
  const float* tot = csh + ((size_t)b * nc * q + q - 1) * H + hh;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float u[8], et[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      u[k] = c0 + k < nc ? slot[(c0 + k) * step] : 0.f;
      et[k] = c0 + k < nc ? tot[(size_t)(c0 + k) * q * H] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < nc) {
        slot[(c0 + k) * step] = h;
        h = __fadd_rn(__fmul_rn(expf(et[k]), h), u[k]);
      }
    }
  }
  hf[(size_t)bh * pn + e] = h;
}

// per (chunk, head, row tile it): y = sum_{jt <= it} (G . L) X_jt over the
// tile's 64 rows (the readout ind (C h_in') is added after)
constexpr int OUT_SLOT = T * P + T * S64RM;          // X raw, G
constexpr int OUT_SMEM = (QMAX + 2 * OUT_SLOT) * 4 + PLANE64;

__global__ void __launch_bounds__(THREADS)
ssd_fwd_out(const float* __restrict__ X, const float* __restrict__ G,
            const float* __restrict__ csh, float* __restrict__ y, int H,
            int q, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;
  float* raw = sm + QMAX;
  uint16_t* pl = reinterpret_cast<uint16_t*>(raw + 2 * OUT_SLOT);
  const size_t bc = blockIdx.x;
  const int hh = blockIdx.y, it = blockIdx.z;
  const int qp = ntiles(q) * T, w = threadIdx.x >> 5, t = lane_t();
  const size_t row0 = bc * q, ldx = (size_t)H * P;
  auto issue = [&](int jt) {
    float* s = raw + (jt & 1) * OUT_SLOT;
    stage(s, P, X + (row0 + jt * T) * ldx + hh * P, ldx, q - jt * T, P, P,
          vec, X);
    stage(s + T * P, S64RM, G + (bc * qp + it * T) * qp + jt * T, qp, T, T,
          T, vec, G);
    cp_commit();
  };
  issue(0);
  for (int i = threadIdx.x; i < qp; i += THREADS)
    cs[i] = i < q ? csh[(row0 + i) * H + hh] : 0.f;
  const int ia = it * T + 16 * w + lane_g(), ib = ia + 8;
  float acc[8][4] = {};
  // P X over the column tiles jt <= it: X and G double-buffered raw, X's
  // planes made from the stage that arrived
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      issue(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xs = raw + (jt & 1) * OUT_SLOT;
    const float* gs = xs + T * P;
    to_planes(pl, PL64, xs, P, P, nullptr);
    __syncthreads();
    float tile[8][4] = {};
    for (int kk = 0; kk < 4; ++kk) {
      const int jb = jt * T + kk * 16;
      if (jb >= q || (jt == it && kk > w)) break;
      float v[8];
      ld_a_rm(v, gs + 16 * w * S64RM + kk * 16, S64RM);
      // P = G . L, rounded as the reference's G * L
      const int j0 = jb + 2 * t;
      v[0] = __fmul_rn(v[0], seg_decay(ia, j0, q, cs[ia], cs[j0]));
      v[1] = __fmul_rn(v[1], seg_decay(ia, j0 + 1, q, cs[ia], cs[j0 + 1]));
      v[2] = __fmul_rn(v[2], seg_decay(ib, j0, q, cs[ib], cs[j0]));
      v[3] = __fmul_rn(v[3], seg_decay(ib, j0 + 1, q, cs[ib], cs[j0 + 1]));
      v[4] = __fmul_rn(v[4], seg_decay(ia, j0 + 8, q, cs[ia], cs[j0 + 8]));
      v[5] = __fmul_rn(v[5], seg_decay(ia, j0 + 9, q, cs[ia], cs[j0 + 9]));
      v[6] = __fmul_rn(v[6], seg_decay(ib, j0 + 8, q, cs[ib], cs[j0 + 8]));
      v[7] = __fmul_rn(v[7], seg_decay(ib, j0 + 9, q, cs[ib], cs[j0 + 9]));
      const FragA a = frag_a(v);
      FragB2 b[4];
#pragma unroll
      for (int np = 0; np < 4; ++np) b[np] = ldb_km_pl(pl, PL64, kk * 16, 16 * np);
      mma3_row(tile, a, b);
    }
    add_tile(acc, tile);
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= q) continue;
    float* yr = y + (row0 + i) * ldx + hh * P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(yr + acc_col(nt, 0)) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// per (b, head), chunks last to first: buf[c] holds chunk c's C' (ind dY) on
// entry and the cotangent of chunk c's exit state on exit; sdh[b, c, h] =
// sum(dh_exit . Hin[c]); dh0 the entering state's cotangent.  A chunk's
// loads are all issued before its stores.
constexpr int PASS_THREADS = 256;
constexpr int PASS_PER = P * NMAX / PASS_THREADS;   // elements a thread

__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass(const float* __restrict__ csh, const float* __restrict__ dHf,
             const float* __restrict__ Hin, float* __restrict__ buf,
             float* __restrict__ dh0, float* __restrict__ sdh, int nc, int H,
             int n, int q) {
  __shared__ float red[PASS_THREADS / 32];
  const int pn = P * n, tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  float dh[PASS_PER];
#pragma unroll
  for (int m = 0; m < PASS_PER; ++m) {
    const int e = tid + m * PASS_THREADS;
    dh[m] = e < pn ? dHf[(size_t)bh * pn + e] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const size_t base = (((size_t)b * nc + c) * H + hh) * pn;
    const float etot =
        expf(csh[(((size_t)b * nc + c) * q + q - 1) * H + hh]);
    float u[PASS_PER], hv[PASS_PER];
#pragma unroll
    for (int m = 0; m < PASS_PER; ++m) {
      const int e = tid + m * PASS_THREADS;
      u[m] = e < pn ? buf[base + e] : 0.f;
      hv[m] = e < pn ? Hin[base + e] : 0.f;
    }
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < PASS_PER; ++m) {
      const int e = tid + m * PASS_THREADS;
      if (e < pn) buf[base + e] = dh[m];
      part = fmaf(dh[m], hv[m], part);
      dh[m] = __fadd_rn(__fmul_rn(etot, dh[m]), u[m]);
    }
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < PASS_THREADS / 32; ++i) s += red[i];
      sdh[((size_t)b * nc + c) * H + hh] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < PASS_PER; ++m) {
    const int e = tid + m * PASS_THREADS;
    if (e < pn) dh0[(size_t)bh * pn + e] = dh[m];
  }
}

// per (chunk, tile pair jt <= it, head group): dGt[bc][gi] tile (jt, it) =
// sum over the group's heads, in order, of (X_j dY_i') . L'
constexpr int DG_RAW = 2 * T * P + 2 * T;            // X, dY, csh j / i rows
constexpr int DG_SMEM = (DG_RAW + 2 * T) * 4 + 2 * PLANE64;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_dg(const float* __restrict__ X, const float* __restrict__ dY,
           const float* __restrict__ csh, float* __restrict__ dGt, int H,
           int q, int ng, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;
  float* cs = sm + DG_RAW;                           // csh of the j, i rows
  uint16_t* xp = reinterpret_cast<uint16_t*>(cs + 2 * T);
  uint16_t* yp = xp + PLANE64 / 2;
  const size_t bc = blockIdx.x;
  int it, jt;
  tile_pair(blockIdx.y, it, jt);
  const int gi = blockIdx.z;
  const int h0 = group_first(gi, H, ng), h1 = group_first(gi + 1, H, ng);
  const int qp = ntiles(q) * T, w = threadIdx.x >> 5;
  const size_t row0 = bc * q, ldx = (size_t)H * P;
  auto issue = [&](int k) {
    const int hh = h0 + k;
    float* r0 = raw;
    stage(r0, P, X + (row0 + jt * T) * ldx + hh * P, ldx, q - jt * T, P, P,
          vec, X);
    stage(r0 + T * P, P, dY + (row0 + it * T) * ldx + hh * P, ldx,
          q - it * T, P, P, vec, dY);
    const int r = threadIdx.x & (T - 1), tile = threadIdx.x >> 6;
    const int row = (tile ? it : jt) * T + r;
    cp4(r0 + 2 * T * P + threadIdx.x,
        row < q ? csh + (row0 + row) * H + hh : csh, row < q);
    cp_commit();
  };
  issue(0);
  const int nh = h1 - h0;
  float dg[8][4] = {};
  for (int k = 0; k < nh; ++k) {
    cp_wait<0>();
    __syncthreads();
    to_planes(xp, PL64, raw, P, P, nullptr);
    to_planes(yp, PL64, raw + T * P, P, P, nullptr);
    cs[threadIdx.x] = raw[2 * T * P + threadIdx.x];
    __syncthreads();
    if (k + 1 < nh) issue(k + 1);   // in flight while the products run
    const float* csj = cs;
    const float* csi = cs + T;
    float dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const FragA a = lda_pl(xp, PL64, 16 * w, kk * 16);
      FragB2 b[4];
#pragma unroll
      for (int np = 0; np < 4; ++np) b[np] = ldb_nm_pl(yp, PL64, kk * 16, 16 * np);
      mma3_row(dp, a, b);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 16 * w + acc_row(e), il = acc_col(nt, e);
        const float L =
            seg_decay(it * T + il, jt * T + jl, q, csi[il], csj[jl]);
        if (L != 0.f) dg[nt][e] = __fadd_rn(dg[nt][e], __fmul_rn(dp[nt][e], L));
      }
    __syncthreads();
  }
  float* o = dGt + ((bc * ng + gi) * qp + jt * T + 16 * w) * qp + it * T;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = acc_col(nt, 0);
    *reinterpret_cast<float2*>(o + (size_t)lane_g() * qp + c) =
        make_float2(dg[nt][0], dg[nt][1]);
    *reinterpret_cast<float2*>(o + (size_t)(lane_g() + 8) * qp + c) =
        make_float2(dg[nt][2], dg[nt][3]);
  }
}

// per (chunk, head, tile jt), over the tile's rows as j: dX += sum_{it >=
// jt} P' dY_it (dX holds (B dh') dec already), colsum(dseg) (into csum);
// and rowsum(dseg) over this tile's columns, per row tile it (into
// rowpart[bc][h][jt])
constexpr int COL_SLOT = T * P + T * S64RM;          // dY raw, G'
constexpr int COL_SMEM =
    (QMAX + T * S64RM + 2 * COL_SLOT + 4 * T) * 4 + PLANE64;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_col(const float* __restrict__ dY, const float* __restrict__ X,
            const float* __restrict__ csh, const float* __restrict__ Gt,
            float* __restrict__ dX, float* __restrict__ csum,
            float* __restrict__ rowpart, int H, int q, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;
  float* xs = sm + QMAX;                 // (T, S64RM): X
  float* slot0 = xs + T * S64RM;
  float* slot1 = slot0 + COL_SLOT;
  float* red = slot1 + COL_SLOT;         // (4, T)
  uint16_t* pl = reinterpret_cast<uint16_t*>(red + 4 * T);
  const size_t bc = blockIdx.x;
  const int hh = blockIdx.y, jt = blockIdx.z;
  const int nt_ = ntiles(q), qp = nt_ * T;
  const int w = threadIdx.x >> 5, t = lane_t();
  const size_t row0 = bc * q, ldx = (size_t)H * P;
  const int ja = jt * T + 16 * w + lane_g(), jb = ja + 8;   // this thread's rows
  stage(xs, S64RM, X + (row0 + jt * T) * ldx + hh * P, ldx, q - jt * T, P,
        P, vec, X);
  auto issue = [&](int it) {
    float* s = (it - jt) & 1 ? slot1 : slot0;
    stage(s, P, dY + (row0 + it * T) * ldx + hh * P, ldx, q - it * T, P, P,
          vec, dY);
    stage(s + T * P, S64RM, Gt + (bc * qp + jt * T) * qp + it * T, qp, T, T,
          T, vec, Gt);
    cp_commit();
  };
  issue(jt);
  for (int i = threadIdx.x; i < qp; i += THREADS)
    cs[i] = i < q ? csh[(row0 + i) * H + hh] : 0.f;
  float dx[8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? jb : ja;
    const float* o = dX + (row0 + (j < q ? j : 0)) * ldx + hh * P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 v = j < q ? *reinterpret_cast<const float2*>(
                                   o + acc_col(nt, 0))
                             : make_float2(0.f, 0.f);
      dx[nt][2 * half] = v.x;
      dx[nt][2 * half + 1] = v.y;
    }
  }

  // the row tiles it >= jt: dP' = X_j dY_i', P' = G' . L', dseg; dX +=
  // P' dY_i, with dY_i's planes serving both products
  float csa = 0.f, csb = 0.f;   // colsum(dseg) of rows ja, jb
  for (int it = jt; it < nt_; ++it) {
    if (it + 1 < nt_) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ys = (it - jt) & 1 ? slot1 : slot0;
    const float* gs = ys + T * P;
    to_planes(pl, PL64, ys, P, P, nullptr);
    __syncthreads();
    float dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[8];
      ld_a_rm(v, xs + 16 * w * S64RM + kk * 16, S64RM);
      const FragA a = frag_a(v);
      FragB2 b[4];
#pragma unroll
      for (int np = 0; np < 4; ++np) b[np] = ldb_nm_pl(pl, PL64, kk * 16, 16 * np);
      mma3_row(dp, a, b);
    }
    // dp becomes P' = G' . L' once its dseg is taken
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float cv[2] = {0.f, 0.f};   // this thread's column sums of dseg'
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 16 * w + acc_row(e), il = acc_col(nt, e);
        const int j = jt * T + jl, i = it * T + il;
        const float gv = gs[jl * S64RM + il];
        const float L = seg_decay(i, j, q, cs[i], cs[j]);
        const float ds =
            L != 0.f ? __fmul_rn(__fmul_rn(dp[nt][e], gv), L) : 0.f;
        dp[nt][e] = __fmul_rn(gv, L);
        if (e < 2) csa += ds;
        else csb += ds;
        cv[e & 1] += ds;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = col_sum(cv[c]);
        if (lane_g() == 0) red[w * T + 8 * nt + 2 * t + c] = s;
      }
    }
    float tile[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (it == jt && 16 * kk + 15 < 16 * w) continue;
      float v[8];
      acc_pair(v, dp[2 * kk], dp[2 * kk + 1]);
      const FragA a = frag_a(v);
      FragB2 b[4];
#pragma unroll
      for (int np = 0; np < 4; ++np) b[np] = ldb_km_pl(pl, PL64, kk * 16, 16 * np);
      mma3_row(tile, a, b);
    }
    add_tile(dx, tile);
    __syncthreads();
    if (threadIdx.x < T)
      rowpart[((bc * H + hh) * nt_ + jt) * qp + it * T + threadIdx.x] =
          red[threadIdx.x] + red[T + threadIdx.x] + red[2 * T + threadIdx.x] +
          red[3 * T + threadIdx.x];
  }
  csa = quad_sum(csa);
  csb = quad_sum(csb);
  if (t == 0) {
    if (ja < q) csum[(row0 + ja) * H + hh] = csa;
    if (jb < q) csum[(row0 + jb) * H + hh] = csb;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? jb : ja;
    if (j >= q) continue;
    float* o = dX + (row0 + j) * ldx + hh * P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(o + acc_col(nt, 0)) =
          make_float2(dx[nt][2 * half], dx[nt][2 * half + 1]);
  }
}

// per (chunk, tile rt, head group, side, 64 state columns c0..): side 0,
// dB's partial of the group over the tile's rows: sum over its heads, in
// order, of (dec X) dh', then the group's dG' C; side 1, dC's: ind (dY Hc)
// summed the same way, then dG B, and per head this column block's share
// of din ind = ind sum_n C (dY Hc) (the readout's term of dcsh, into
// dinv[half]).  Into part[side][gi] (b, S, n).
constexpr int BC_RAW = 2 * T * P + 2 * T;            // A rows, B operand, csh
constexpr int BC_SMEM = (BC_RAW + T) * 4 + 2 * PLANE64;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_bc(const float* __restrict__ C, const float* __restrict__ B,
           const float* __restrict__ dY, const float* __restrict__ X,
           const float* __restrict__ csh, const float* __restrict__ Hin,
           const float* __restrict__ dhx, const float* __restrict__ dGt,
           float* __restrict__ part, float* __restrict__ dinv, int H, int n,
           int q, int ng, int halves, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;
  float* wv = sm + BC_RAW;                           // (T) row decays
  uint16_t* ap = reinterpret_cast<uint16_t*>(wv + T);
  uint16_t* bp = ap + PLANE64 / 2;
  const int half = blockIdx.x % halves;
  const int side = (blockIdx.x / halves) & 1;
  const size_t bc = blockIdx.x / halves >> 1;
  const int rt = blockIdx.y, gi = blockIdx.z;
  const size_t rows_all = (size_t)(gridDim.x / halves >> 1) * q;   // b * S
  const int h0 = group_first(gi, H, ng), h1 = group_first(gi + 1, H, ng);
  const int nt_ = ntiles(q), qp = nt_ * T, kp = kpad(n);
  const int c0 = 64 * half, cols = n - c0 < 64 ? n - c0 : 64;
  const int cw = kp - c0 < 64 ? kp - c0 : 64, n8 = cw / 8;
  const int w = threadIdx.x >> 5;
  const size_t row0 = bc * q, ldx = (size_t)H * P;
  const int nh = h1 - h0;
  // the score tiles: side 0, dG' rows rt with C rows it >= rt; side 1, dG'
  // columns rt with B rows jt <= rt
  const int first = side ? 0 : rt, nsc = side ? rt + 1 : nt_ - rt;
  float* bs = raw + T * P;
  auto issue = [&](int k) {
    if (k < nh) {
      const int hh = h0 + k;
      const size_t soff = (bc * H + hh) * P * n;
      stage(raw, P, (side ? dY : X) + (row0 + rt * T) * ldx + hh * P, ldx,
            q - rt * T, P, P, vec, side ? dY : X);
      stage(bs, P, (side ? Hin : dhx) + soff + c0, n, P, cols, cw, vec,
            side ? Hin : dhx);
      float* wc = bs + T * P;       // csh of the tile's rows, then total
      if (threadIdx.x <= T) {
        const int row = threadIdx.x < T ? rt * T + threadIdx.x : q - 1;
        const bool ok = row < q;
        cp4(wc + threadIdx.x, ok ? csh + (row0 + row) * H + hh : csh, ok);
      }
    } else {
      const int ot = first + (k - nh);   // the other tile
      const float* gsrc =
          side ? dGt + ((bc * ng + gi) * qp + ot * T) * qp + rt * T
               : dGt + ((bc * ng + gi) * qp + rt * T) * qp + ot * T;
      stage(raw, P, gsrc, qp, T, T, T, vec, dGt);
      stage(bs, P, (side ? B : C) + (row0 + ot * T) * n + c0, n, q - ot * T,
            cols, cw, vec, side ? B : C);
    }
    cp_commit();
  };
  const int items = nh + nsc;
  issue(0);
  const int ra = rt * T + 16 * w + lane_g(), rb = ra + 8;
  // side 1: C at this thread's accumulator positions, for din
  float cv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb, k = acc_col(nt, e);
      cv[nt][e] = side && r < q && k < cols ? C[(row0 + r) * n + c0 + k]
                                             : 0.f;
    }
  float acc[8][4] = {};
  for (int k = 0; k < items; ++k) {
    cp_wait<0>();
    __syncthreads();
    const bool head = k < nh;
    if (head && threadIdx.x < T) {
      const float* wc = bs + T * P;
      const int r = threadIdx.x, row = rt * T + r;
      wv[r] = row < q ? (side ? decay_in(wc[r]) : decay_out(wc[T], wc[r]))
                      : 0.f;
    }
    __syncthreads();
    // side 0: A (j, p) = dec[j] X[j][p], the reference's rounded product
    to_planes(ap, PL64, raw, P, P, head && !side ? wv : nullptr);
    to_planes(bp, PL64, bs, P, cw, nullptr);
    __syncthreads();
    if (k + 1 < items) issue(k + 1);   // in flight while the products run
    const int ot = first + (k - nh);
    auto product = [&](float (&d)[8][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (!head && ot * T + kk * 16 >= q) break;
        // head: A (r, p); side 0 scores: A (j, i) = dG'[j][i]; side 1
        // scores: A (i, j) = dG'[j][i]
        const FragA a = (!head && side) ? ldat_pl(ap, PL64, kk * 16, 16 * w)
                                        : lda_pl(ap, PL64, 16 * w, kk * 16);
        FragB2 b[4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (2 * np < n8) b[np] = ldb_km_pl(bp, PL64, kk * 16, 16 * np);
        mma3_row(d, a, b, n8 / 2);
      }
    };
    float m[8][4] = {};
    product(m);
    if (!(head && side)) add_tile(acc, m);
    if (head && side) {
      // M = dY Hc: din's share sum_n C M, then dC += ind M
      const float wa = wv[16 * w + lane_g()], wb = wv[16 * w + lane_g() + 8];
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < 2) {
            pa = fmaf(cv[nt][e], m[nt][e], pa);
            acc[nt][e] = __fadd_rn(acc[nt][e], __fmul_rn(m[nt][e], wa));
          } else {
            pb = fmaf(cv[nt][e], m[nt][e], pb);
            acc[nt][e] = __fadd_rn(acc[nt][e], __fmul_rn(m[nt][e], wb));
          }
        }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (lane_t() == 0) {
        const int hh = h0 + k;
        float* dv = dinv + (half * rows_all + row0) * H + hh;
        if (ra < q) dv[(size_t)ra * H] = __fmul_rn(pa, wa);
        if (rb < q) dv[(size_t)rb * H] = __fmul_rn(pb, wb);
      }
    }
    __syncthreads();
  }
  float* o = part + ((size_t)(side * ng + gi) * rows_all + row0) * n + c0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = hf ? rb : ra, k = acc_col(nt, 0);
      if (r >= q || k >= cols) continue;
      float* d = o + (size_t)r * n + k;
      if ((n & 1) == 0) {   // 8-byte aligned pairs (k even, n even)
        *reinterpret_cast<float2*>(d) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      } else {
        d[0] = acc[nt][2 * hf];
        if (k + 1 < cols) d[1] = acc[nt][2 * hf + 1];
      }
    }
  }
}

// dB = sum of the groups' partials, in order; dC the same
__global__ void __launch_bounds__(256)
ssd_bwd_sum(const float* __restrict__ part, float* __restrict__ dB,
            float* __restrict__ dC, long long total, int ng) {
  for (long long e = (long long)blockIdx.x * 256 + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < ng; ++g) {
      sb += part[(size_t)g * total + e];
      sc += part[(size_t)(ng + g) * total + e];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

// per (b, chunk, head), one warp: dcsh and its reverse cumulative sum, lane
// l over 8 rows of the chunk [8 l, 8 l + 8): each lane's rows from its end,
// plus the lanes after it (a fixed-order scan)
constexpr int DDA_PER = QMAX / 32;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_ddA(const float* __restrict__ csh, const float* __restrict__ sdh,
            const float* __restrict__ ddd, const float* __restrict__ csum,
            const float* __restrict__ dinv,
            const float* __restrict__ rowpart, float* __restrict__ ddA,
            long long bch, int H, int q, int halves) {
  const long long e = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (e >= bch) return;
  const int lane = threadIdx.x & 31;
  const int hh = static_cast<int>(e % H);
  const size_t bc = (size_t)(e / H), row0 = bc * q;
  const int nt_ = ntiles(q), qp = nt_ * T;
  const float* rp = rowpart + (bc * H + hh) * nt_ * qp;
  float d[DDA_PER];
  float dsum = 0.f, own = 0.f;
#pragma unroll
  for (int m = 0; m < DDA_PER; ++m) {
    const int k = DDA_PER * lane + m;
    d[m] = 0.f;
    if (k < q) {
      const size_t o = (row0 + k) * H + hh;
      const float dd = ddd[o];
      float rs = 0.f;
      for (int jt = 0; jt <= k / T; ++jt) rs += rp[(size_t)jt * qp + k];
      float din = 0.f;
      for (int hf = 0; hf < halves; ++hf) din += dinv[hf * bch * q + o];
      float v = __fadd_rn(-dd, din);
      v = __fadd_rn(v, rs);
      d[m] = __fadd_rn(v, -csum[o]);
      dsum += dd;
    }
  }
  // dtotal = exp(total) sum(dh . Hc) + sum_j ddec dec, at row q - 1
  for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
  const float total = csh[(row0 + q - 1) * H + hh];
  const float dtotal = __fadd_rn(__fmul_rn(sdh[e], expf(total)), dsum);
#pragma unroll
  for (int m = 0; m < DDA_PER; ++m) {
    if (DDA_PER * lane + m == q - 1) d[m] = __fadd_rn(d[m], dtotal);
    own += d[m];
  }
  // the sum over the lanes after this one
  float after = own;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, after, o);
    if (lane + o < 32) after += v;
  }
  float run = after - own;
#pragma unroll
  for (int m = DDA_PER - 1; m >= 0; --m) {
    const int k = DDA_PER * lane + m;
    run += d[m];
    if (k < q) ddA[(row0 + k) * H + hh] = run;
  }
}

// ---- host side --------------------------------------------------------------

// The workspace of one call: offsets in floats, each rounded up to 16 bytes
// (repro_ssd_workspace tells the caller the total)
struct Layout {
  size_t csh, ind, dec, g, dhx, sdh, dgt, ddd, csum, dinv, rowpart, part,
      total;
};

Layout layout(int kind, int batch, int S, int H, int n, int q, int ng) {
  size_t used = 0;
  auto take = [&](size_t floats) {
    const size_t at = used;
    used += (floats + 3) & ~size_t(3);
    return at;
  };
  const size_t nc = S / q, qt = (q + T - 1) / T, qp = qt * T;
  const size_t bsh = (size_t)batch * S * H, bnc = (size_t)batch * nc;
  Layout w{};
  w.csh = take(bsh);
  w.ind = take(bsh);
  w.dec = take(bsh);
  w.g = take(bnc * qp * qp);            // G (K6) or G' (K7)
  if (kind == 1) {
    w.dhx = take(bnc * H * P * n);      // C' (ind dY), then dh at each exit
    w.sdh = take(bnc * H);              // sum(dh . Hc)
    w.dgt = take(bnc * ng * qp * qp);   // each group's dG'
    w.ddd = take(bsh);                  // ddec dec
    w.csum = take(bsh);                 // colsum(dseg)
    w.dinv = take(bsh * ((n + 63) / 64));   // din ind, by 64 state columns
    w.rowpart = take(bnc * H * qt * qp);   // rowsum(dseg) per column tile
    w.part = take(2 * (size_t)ng * batch * S * n);   // dB, dC of each group
  }
  w.total = used;
  return w;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

unsigned cdiv(long long a, long long b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

// one chunk GEMM over (M / 128, N / 128, chunks) blocks
template <int ACM, int BNM>
cudaError_t gemm(const GemmOp& op, unsigned chunks, int vec,
                 cudaStream_t st) {
  static bool smem_set = false;
  constexpr int smem = gemm_smem<ACM, BNM>();
  cudaError_t err = allow_smem(ssd_gemm<ACM, BNM>, smem, smem_set);
  if (err != cudaSuccess) return err;
  ssd_gemm<ACM, BNM><<<dim3(cdiv(op.M, GM), cdiv(op.N, GN), chunks),
                       GTHREADS, smem, st>>>(op, vec);
  return cudaGetLastError();
}

// A second stream for the independent chains of one call, forked from and
// joined back into the caller's stream by events (so a CUDA graph capture
// takes it too): made once, on the first call
struct Side {
  cudaStream_t s = nullptr;
  cudaEvent_t ev[4] = {};
};

cudaError_t side_stream(Side& sd) {
  if (sd.s != nullptr) return cudaSuccess;
  cudaError_t err = cudaStreamCreateWithFlags(&sd.s, cudaStreamNonBlocking);
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaEventCreateWithFlags(&sd.ev[i], cudaEventDisableTiming);
  return err;
}

// `after` waits for the work queued on `before` so far
cudaError_t order(cudaStream_t before, cudaStream_t after, cudaEvent_t ev) {
  cudaError_t err = cudaEventRecord(ev, before);
  return err != cudaSuccess ? err : cudaStreamWaitEvent(after, ev, 0);
}

Side g_side;

#define SSD_TRY(expr)                                   \
  do {                                                  \
    cudaError_t e_ = (expr);                            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)
#define SSD_LAUNCHED() SSD_TRY(cudaGetLastError())

bool ssd_shape_ok(int p, int n, int q, int S) {
  return p == P && n >= 1 && n <= NMAX && q >= 1 && q <= QMAX && S % q == 0;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of workspace one K6 (backward 0) or K7 (1) call takes, with ng
// head groups
extern "C" long long repro_ssd_workspace(int backward, int batch, int S,
                                         int H, int n, int q, int ng) {
  return static_cast<long long>(
      layout(backward, batch, S, H, n, q, ng).total);
}

// K6.  h_in (b, S / q, h, 64, n) is always written (the entering states the
// readout needs); ws holds ws_floats floats.  head_dim 64, 1 <= n <= 128,
// 1 <= q <= 256 and S a multiple of q.
extern "C" int repro_ssd_scan(const void* C, const void* B, const void* X,
                              const void* dA, const void* H0, void* y,
                              void* h_final, void* h_in, void* ws,
                              long long ws_floats, int batch, int S, int H,
                              int p, int n, int q, void* stream) {
  if (!ssd_shape_ok(p, n, q, S) || h_in == nullptr || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(0, batch, S, H, n, q, 1);
  if (lay.total > static_cast<size_t>(ws_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool s_scores, s_out;
  SSD_TRY(allow_smem(ssd_scores, SCORES_SMEM, s_scores));
  SSD_TRY(allow_smem(ssd_fwd_out, OUT_SMEM, s_out));
  float* base = static_cast<float*>(ws);
  float* csh = base + lay.csh;
  float* ind = base + lay.ind;
  float* dec = base + lay.dec;
  float* G = base + lay.g;
  const int nc = S / q, qt = (q + T - 1) / T;
  const int vec = n % 4 == 0 && aligned16(C) && aligned16(B) &&
                  aligned16(X) && aligned16(h_in) && aligned16(ws);
  const auto* Cf = static_cast<const float*>(C);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Xf = static_cast<const float*>(X);
  float* hin = static_cast<float*>(h_in);
  float* yf = static_cast<float*>(y);
  const unsigned bnc = static_cast<unsigned>(batch * nc);
  const int hp = H * P;
  const long long qhp = (long long)q * hp, hpn = (long long)hp * n;

  SSD_TRY(side_stream(g_side));
  cudaStream_t sd = g_side.s;

  ssd_decay<<<dim3(bnc, (H + 31) / 32), DECAY_THREADS, 0, st>>>(
      static_cast<const float*>(dA), csh, ind, dec, H, q);
  SSD_LAUNCHED();
  SSD_TRY(order(st, sd, g_side.ev[0]));
  // the caller's stream: the scores and y = sum (G . L) X, which need no
  // state; the side stream: the states
  ssd_scores<<<dim3(bnc, qt * (qt + 1) / 2), THREADS, SCORES_SMEM, st>>>(
      Cf, Bf, G, n, q, 1, vec);
  SSD_LAUNCHED();
  ssd_fwd_out<<<dim3(bnc, H, qt), THREADS, OUT_SMEM, st>>>(Xf, G, csh, yf, H,
                                                          q, vec);
  SSD_LAUNCHED();
  // each chunk's state contribution: (h p, j) (dec X)' times (j, n) B
  GemmOp sc{};
  sc.a = Xf; sc.a_z = qhp; sc.lda = hp;
  sc.b = Bf; sc.b_z = (long long)q * n; sc.ldb = n;
  sc.M = hp; sc.N = n; sc.K = q; sc.q = q; sc.H = H;
  sc.wa = dec;
  sc.out = hin; sc.out_z = hpn; sc.ldo = n;
  SSD_TRY((gemm<1, 0>(sc, bnc, vec, sd)));
  ssd_fwd_pass<<<dim3(batch * H, (P * n + 255) / 256), 256, 0, sd>>>(
      csh, static_cast<const float*>(H0), hin, static_cast<float*>(h_final),
      nc, H, n, q);
  SSD_LAUNCHED();
  SSD_TRY(order(sd, st, g_side.ev[1]));
  // the readout: (i, n) C times (n, h p) h_in', times ind, added to y
  GemmOp ro{};
  ro.a = Cf; ro.a_z = (long long)q * n; ro.lda = n;
  ro.b = hin; ro.b_z = hpn; ro.ldb = n;
  ro.M = q; ro.N = hp; ro.K = n; ro.q = q; ro.H = H;
  ro.out = yf; ro.out_z = qhp; ro.ldo = hp; ro.wo = ind; ro.accumulate = 1;
  SSD_TRY((gemm<0, 1>(ro, bnc, vec, st)));
  return 0;
}

// K7.  ng head groups (ops.ssd_head_groups); ws holds ws_floats floats.
// head_dim 64, 1 <= n <= 128, 1 <= q <= 256 and S a multiple of q.
extern "C" int repro_ssd_bwd(const void* C, const void* B, const void* dY,
                             const void* X, const void* dA, const void* Hin,
                             const void* dHf, void* dX, void* dh0, void* dB,
                             void* dC, void* ddA, void* ws,
                             long long ws_floats, int batch, int S, int H,
                             int p, int n, int q, int ng, void* stream) {
  if (!ssd_shape_ok(p, n, q, S) || ng < 1 || ng > H || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(1, batch, S, H, n, q, ng);
  if (lay.total > static_cast<size_t>(ws_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool s_scores, s_dg, s_col, s_bc;
  SSD_TRY(allow_smem(ssd_scores, SCORES_SMEM, s_scores));
  SSD_TRY(allow_smem(ssd_bwd_dg, DG_SMEM, s_dg));
  SSD_TRY(allow_smem(ssd_bwd_col, COL_SMEM, s_col));
  SSD_TRY(allow_smem(ssd_bwd_bc, BC_SMEM, s_bc));
  const int nc = S / q, qt = (q + T - 1) / T, qp = qt * T;
  const size_t bnc = (size_t)batch * nc;
  float* base = static_cast<float*>(ws);
  float* csh = base + lay.csh;
  float* ind = base + lay.ind;
  float* dec = base + lay.dec;
  float* Gt = base + lay.g;
  float* dhx = base + lay.dhx;
  float* sdh = base + lay.sdh;
  float* dGt = base + lay.dgt;
  float* ddd = base + lay.ddd;
  float* csum = base + lay.csum;
  float* dinv = base + lay.dinv;
  float* rowpart = base + lay.rowpart;
  float* part = base + lay.part;
  const int vec = n % 4 == 0 && aligned16(C) && aligned16(B) &&
                  aligned16(dY) && aligned16(X) && aligned16(Hin) &&
                  aligned16(ws);
  const auto* Cf = static_cast<const float*>(C);
  const auto* Bf = static_cast<const float*>(B);
  const auto* dYf = static_cast<const float*>(dY);
  const auto* Xf = static_cast<const float*>(X);
  const auto* Hf = static_cast<const float*>(Hin);
  float* dXf = static_cast<float*>(dX);
  const long long bch = (long long)bnc * H;
  const unsigned ubnc = static_cast<unsigned>(bnc);
  const int hp = H * P;
  const long long qhp = (long long)q * hp, hpn = (long long)hp * n;
  const long long qn = (long long)q * n, qp2 = (long long)qp * qp;
  const long long rows_n = (long long)batch * S * n;

  SSD_TRY(side_stream(g_side));
  cudaStream_t sd = g_side.s;

  ssd_decay<<<dim3(ubnc, (H + 31) / 32), DECAY_THREADS, 0, st>>>(
      static_cast<const float*>(dA), csh, ind, dec, H, q);
  SSD_LAUNCHED();
  SSD_TRY(order(st, sd, g_side.ev[0]));
  // the side stream: the scores, then dG (X, dY and the decays only)
  ssd_scores<<<dim3(ubnc, qt * (qt + 1) / 2), THREADS, SCORES_SMEM, sd>>>(
      Bf, Cf, Gt, n, q, 0, vec);
  SSD_LAUNCHED();
  SSD_TRY(cudaEventRecord(g_side.ev[1], sd));
  ssd_bwd_dg<<<dim3(ubnc, qt * (qt + 1) / 2, ng), THREADS, DG_SMEM, sd>>>(
      Xf, dYf, csh, dGt, H, q, ng, vec);
  SSD_LAUNCHED();
  // the caller's stream: each chunk's share of the entering cotangent,
  // (h p, i) (ind dY)' C, then the reverse pass
  GemmOp sc{};
  sc.a = dYf; sc.a_z = qhp; sc.lda = hp;
  sc.b = Cf; sc.b_z = qn; sc.ldb = n;
  sc.M = hp; sc.N = n; sc.K = q; sc.q = q; sc.H = H;
  sc.wa = ind;
  sc.out = dhx; sc.out_z = hpn; sc.ldo = n;
  SSD_TRY((gemm<1, 0>(sc, ubnc, vec, st)));
  ssd_bwd_pass<<<batch * H, PASS_THREADS, 0, st>>>(
      csh, static_cast<const float*>(dHf), Hf, dhx, static_cast<float*>(dh0),
      sdh, nc, H, n, q);
  SSD_LAUNCHED();
  // the side stream, once the exit cotangents are in: dB's and dC's group
  // partials, and their sums over the groups
  SSD_TRY(order(st, sd, g_side.ev[2]));
  const int halves = (n + 63) / 64;   // 64 state columns a block
  ssd_bwd_bc<<<dim3(2 * ubnc * halves, qt, ng), THREADS, BC_SMEM, sd>>>(
      Cf, Bf, dYf, Xf, csh, Hf, dhx, dGt, part, dinv, H, n, q, ng, halves,
      vec);
  SSD_LAUNCHED();
  // the caller's stream: dXd = B dh' (j, h p): dX's first term dXd dec,
  // and ddec dec = dec sum_p dXd X; then P' dY and dseg's sums
  GemmOp dx{};
  dx.a = Bf; dx.a_z = qn; dx.lda = n;
  dx.b = dhx; dx.b_z = hpn; dx.ldb = n;
  dx.M = q; dx.N = hp; dx.K = n; dx.q = q; dx.H = H;
  dx.out = dXf; dx.out_z = qhp; dx.ldo = hp; dx.wo = dec;
  dx.rd = Xf; dx.rd_z = qhp; dx.ldr = hp; dx.rv = ddd;
  SSD_TRY((gemm<0, 1>(dx, ubnc, vec, st)));
  SSD_TRY(cudaStreamWaitEvent(st, g_side.ev[1], 0));   // the scores
  ssd_bwd_col<<<dim3(ubnc, H, qt), THREADS, COL_SMEM, st>>>(
      dYf, Xf, csh, Gt, dXf, csum, rowpart, H, q, vec);
  SSD_LAUNCHED();
  const unsigned sblocks = static_cast<unsigned>(
      rows_n / 256 + 1 < 4096 ? rows_n / 256 + 1 : 4096);
  ssd_bwd_sum<<<sblocks, 256, 0, sd>>>(part, static_cast<float*>(dB),
                                       static_cast<float*>(dC), rows_n, ng);
  SSD_LAUNCHED();
  SSD_TRY(order(sd, st, g_side.ev[3]));
  ssd_bwd_ddA<<<cdiv(bch * 32, THREADS), THREADS, 0, st>>>(
      csh, sdh, ddd, csum, dinv, rowpart, static_cast<float*>(ddA), bch, H,
      q, halves);
  SSD_LAUNCHED();
  return 0;
}
