// K1: the (mul, add) GEMM  C[m, n] = sum_k A[m, k] * B[k, n]   (f32 out)
//
// Replaces: src/repro/kernels/emit.py, emit_pallas, (mul, add) branch (the
// blocked einsum into an f32 accumulator that ops.matmul reaches through
// _pallas_matmul_f32, including its transpose_b form for the tied logits
// head), and the two VJP forms of src/repro/kernels/ops.py: _gemm_tb
// (a @ b.T) and _gemm_ta (a.T @ b, the transposed-first-operand schedule
// of both weight gradients).  Its expert form replaces emit_pallas on
// expert_gemm_expr (src/repro/kernels/ops.py, expert_gemm and the
// _pallas_expert_f32 forward of expert_matmul): the capacity-padded MoE
// GEMM x (E, cap, d) @ w (E, d, f) -> (E, cap, f), the expert axis one
// more lift of the same blocked product.
//
// Layouts: A is row-major (m, k), or with transpose_a row-major (k, m)
// read as its transpose in place.  B is row-major (k, n), or with
// transpose_b row-major (n, k), read in its stored layout: neither the
// (256000, 2048) tied embedding table nor the vocab-sized logits gradient
// is ever copied transposed.  C is row-major (m, n) float32; the caller
// casts to its out dtype.
//
// Operand types: A and B are each float32 or bfloat16.  In a training
// step the cotangent reaching the VJP products is f32 (the primal returns
// f32; the cast to bf16 sits outside) while weights and activations are
// bf16.
//
// Precision contract.  bf16 x bf16: every product is exact in f32 and the
// sums are f32.  f32 x f32: exact f32 FMA (no TF32).  Mixed (f32 x bf16):
// the f32 operand is split, once per backward for both of its products
// (ops.split_bf16, the `split_bf16` pass below), into three bf16 parts
// hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid), which hold g
// within 2^-24 |g| (two parts would hold 2^-16, and miss the card tests'
// atol = 1e-4 on unit-variance operands from k ~ 256 on); the product is
// the three bf16 x bf16 products summed into one f32 accumulator.  The
// tensor cores' own f32 sums do not round to nearest, so over a long k
// they drift (past the 1e-4 tolerance over the 256000-term vocab
// product); the split products therefore add each 64-k stage into the
// accumulator with f32 adds.
//
// Routes, chosen on the host before launch by ops.gemm_route (a stated
// shape rule, never by catching a failure):
//   tile  bf16 x bf16, m > 16 or transpose_a: a persistent block a SM,
//         one producer warp keeping a 4-5 stage ring of 128x64 A and
//         BNx64 B tiles full by TMA (128-byte swizzle), two consumer
//         warpgroups each running wgmma 64xBN over its half of the
//         128-row tile; BN = 256 when those tiles fill the SMs, else 128.
//         A and B are K-major or MN-major through wgmma's transpose bits,
//         so transpose_a / transpose_b read the stored layout in place.
//   split one f32 operand: the tile path with that operand's three parts
//         (three wgmmas a k-step, the bf16 operand's tile read once),
//         BN = 128, 3 stages, and the per-stage f32 promotion above.
//   gemv  bf16 x bf16 with m <= 16 rows, no transpose_a, k % 32 == 0: the
//         decode rows.  The weight is streamed once with 16-byte
//         non-allocating loads straight into mma.sync m16n8k16 fragments
//         (rows padded to 16; the k order inside each 32-wide unit is
//         permuted alike in x and w so every load is a whole vector),
//         64 columns and a k range a block; where the columns alone do
//         not fill the card (2048-column products), k is split and a
//         second pass adds the partials in split order (no atomics:
//         reruns are the same bits).
//   the expert form (repro_expert_gemm, bf16 x bf16, w stored (E, d, f)):
//         the tile path with the experts' tiles one after another in the
//         persistent walk, A, B and C read and written through rank-3
//         tensor maps (expert outermost), so each expert's ragged k, row
//         and column edges are zero-filled or clipped inside that expert
//         (a 2-D map over the stacked (E d, f) weight would read the next
//         expert's rows at a ragged d); at cap <= 16 rows (decode) the
//         decode-row kernel with the expert as grid axis z, its k split
//         sized by the E x n/64 blocks.
//   the first kernels where TMA cannot read an operand (a stored row
//         length not a multiple of 8 elements, a base not 16-byte
//         aligned, k = 0): bf16 x bf16 without transpose_a on
//         nvcuda::wmma 64x64 tiles (gemm_bf16), every other form on f32
//         FMA 128x128 tiles (gemm_fma); f32 x f32 always takes gemm_fma.
//
// What bounds it on an H100: at prefill and training row counts the tile
// and split paths are compute-bound (989 TFLOP/s bf16; the split path
// does three products, plus 12 bytes an f32 element for its parts); at
// decode (m = 1-4 slots) every product is a GEMV that must stream the
// weight once (gemma-2b: ~5.0 GB of bf16 weights per decode step, 1.5 ms
// at 3.35 TB/s), so device-memory bandwidth bounds it.  The tile path
// does not overlap a tile's f32 store with the next tile's products (the
// consumers store from registers), which costs most at short k.  The
// expert form reads every expert's weight (the reference's capacity-padded
// dispatch computes all E experts): at decode (cap 8) that stream is the
// whole cost, bytes-bound (deepseek-moe-16b: 0.74 GB for wi, 0.22 ms);
// at prefill (cap 240) the products are at the bytes / operations
// crossover, and the padding of cap to 256 rows wastes 6%.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, PAD = 8;
constexpr int THREADS = 128;

// Stage a (rows x cols) tile of a row-major (R x C) bf16 matrix into
// shared memory with row pitch `pitch`, zero-filling outside the matrix.
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, int pitch, const __nv_bfloat16* __restrict__ src,
    int R, int C, int r0, int c0, int rows, int cols, int vec) {
  const int vecs_per_row = cols / 8;
  for (int v = threadIdx.x; v < rows * vecs_per_row; v += THREADS) {
    const int r = v / vecs_per_row, c = (v % vecs_per_row) * 8;
    const int gr = r0 + r, gc = c0 + c;
    __nv_bfloat16* d = dst + r * pitch + c;
    if (vec && gr < R && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
          src + (size_t)gr * C + gc);
    } else {
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < R && gc + e < C) ? src[(size_t)gr * C + gc + e]
                                       : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool TB>
__global__ void __launch_bounds__(THREADS)
gemm_bf16(const __nv_bfloat16* __restrict__ A,
          const __nv_bfloat16* __restrict__ B, float* __restrict__ C,
          int M, int N, int K, int vec_a, int vec_b) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * (BK + PAD)];
  // (BK, BN + PAD) for plain B; (BN, BK + PAD) for transpose_b
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * (BK + PAD)];
  __shared__ __align__(32) float Cs[BM * (BN + 4)];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  using BLayout = typename std::conditional<TB, wmma::col_major,
                                            wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile_bf16(As, BK + PAD, A, M, K, m0, k0, BM, BK, vec_a);
    if (TB) {
      load_tile_bf16(Bs, BK + PAD, B, N, K, n0, k0, BN, BK, vec_b);
    } else {
      load_tile_bf16(Bs, BN + PAD, B, K, N, k0, n0, BK, BN, vec_b);
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * (BK + PAD) + kk,
                               BK + PAD);
      for (int j = 0; j < 2; ++j) {
        if (TB) {   // element (k, n) of B^T sits at Bs[n * pitch + k]
          wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * (BK + PAD) + kk,
                                 BK + PAD);
        } else {
          wmma::load_matrix_sync(b[j], Bs + kk * (BN + PAD) + wn + j * 16,
                                 BN + PAD);
        }
      }
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * (BN + 4) + wn + j * 16,
                              acc[i][j], BN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    if (m0 + r < M && n0 + c < N)
      C[(size_t)(m0 + r) * N + n0 + c] = Cs[r * (BN + 4) + c];
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int FBM = 128, FBN = 128, FBK = 8, FTHREADS = 256;

// C = op(A) op(B) with op(A) (M, K), op(B) (K, N); A stored (M, K), or
// (K, M) when TA; B stored (K, N), or (N, K) when TB.
template <typename AT, typename BT, bool TA, bool TB>
__global__ void __launch_bounds__(FTHREADS)
gemm_fma(const AT* __restrict__ A, const BT* __restrict__ B,
         float* __restrict__ C, int M, int N, int K) {
  // both tiles k-major (f32) so the inner loop reads rows of shared memory
  __shared__ __align__(16) float As[FBK][FBM + 4];
  __shared__ __align__(16) float Bs[FBK][FBN + 4];
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = threadIdx.x; e < FBM * FBK; e += FTHREADS) {
      // consecutive threads walk the stored row: coalesced either way
      const int r = TA ? e % FBM : e / FBK, c = TA ? e / FBM : e % FBK;
      const int gm = m0 + r, gk = k0 + c;
      float val = 0.f;
      if (gm < M && gk < K)
        val = to_f(TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk]);
      As[c][r] = val;
    }
    for (int e = threadIdx.x; e < FBN * FBK; e += FTHREADS) {
      const int n = TB ? e / FBK : e % FBN, c = TB ? e % FBK : e / FBN;
      const int gn = n0 + n, gk = k0 + c;
      float val = 0.f;
      if (gn < N && gk < K)
        val = to_f(TB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn]);
      Bs[c][n] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

template <typename AT, typename BT>
void launch_fma(const void* a, const void* b, float* c, int m, int n, int k,
                int ta, int tb, cudaStream_t s) {
  const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
  auto A = static_cast<const AT*>(a);
  auto B = static_cast<const BT*>(b);
  if (ta && tb)
    gemm_fma<AT, BT, true, true><<<grid, FTHREADS, 0, s>>>(A, B, c, m, n, k);
  else if (ta)
    gemm_fma<AT, BT, true, false><<<grid, FTHREADS, 0, s>>>(A, B, c, m, n, k);
  else if (tb)
    gemm_fma<AT, BT, false, true><<<grid, FTHREADS, 0, s>>>(A, B, c, m, n, k);
  else
    gemm_fma<AT, BT, false, false><<<grid, FTHREADS, 0, s>>>(A, B, c, m, n,
                                                              k);
}

// ---------------------------------------------------------------------------
// The tensor-core forms: the tile path (bf16 x bf16, and bf16 x the three
// bf16 parts of a split f32 operand) and the decode rows' weight stream
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TBM = 128, TBK = 64;

// Shared memory of the tile path: a ring of stages, each the PA parts of
// the A tile (128 rows x 64 k) and the PB parts of the B tile (BN x 64 k),
// at most 5 stages; then each consumer warpgroup's staging buffer for C
// (64 rows x 64 f32 columns, two 128-byte-swizzled boxes of 32 columns)
constexpr int CCOLS = 64;
template <int BN, int PA, int PB>
struct TileSmem {
  static constexpr uint32_t A = TBM * TBK * 2;
  static constexpr uint32_t B = BN * TBK * 2;
  static constexpr uint32_t STAGE = A * PA + B * PB;
  static constexpr uint32_t CST = 64 * CCOLS * 4;
  static constexpr int FIT = (225 * 1024 - 2 * CST) / STAGE;
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  static constexpr size_t BYTES =
      1024 + STAGES * STAGE + 2 * CST + 2 * STAGES * 8;
};

// The tensor maps of the operands' parts (hi, mid, lo of a split one) and
// of C (f32, boxes of 64 rows x 32 columns; used when n % 4 == 0)
struct TileMaps {
  CUtensorMap a[3];
  CUtensorMap b[3];
  CUtensorMap c;
};

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// The expert form's rank-3 maps: one box at (c0, c1, expert)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, "
      "%3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the shared-memory sources of this thread's bulk stores have been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma's transpose bits mark an MN-major operand: A stored (K, M) (TA),
// B stored (K, N) (not TB)
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (BN == 256)
    wgmma_ss_t256<TA, 1 - TB>(d, a, b, scale_d);
  else
    wgmma_ss_t128<TA, 1 - TB>(d, a, b, scale_d);
}

// C = op(A) op(B), 128 x BN tiles over all of K, a persistent block
// walking its tiles.  A stored (M, K) (TA = 0,
// K-major) or (K, M) (TA = 1, MN-major); B stored (N, K) (TB = 1,
// K-major) or (K, N) (TB = 0, MN-major).  A split f32 operand comes as its
// three bf16 parts (PA or PB = 3): three wgmmas a k-step into the same
// accumulator, the other operand's tile read once.
// EX: the expert form, E products A[e] (M, K) B[e] (K, N) -> C[e] (M, N)
// (TA = TB = 0, bf16): the tiles of expert e follow those of e - 1, and
// A, B and C are rank-3 tensor maps with the expert outermost, so each
// expert's ragged k, row and column edges read as zeros (and stores
// clip) inside that expert.
template <int BN, int TA, int TB, int PA, int PB, bool EX = false>
__global__ void __launch_bounds__(384, 1)
gemm_tc(const __grid_constant__ TileMaps maps, float* __restrict__ C, int M,
        int N, int K, int tma_c, int n_fast, int E) {
  static_assert(!EX || (TA == 0 && TB == 0 && PA == 1 && PB == 1),
                "the expert form is bf16 x bf16, A (M, K), B (K, N)");
  using L = TileSmem<BN, PA, PB>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* cstage = ring + S * L::STAGE;          // 2 x CST
  uint64_t* full = reinterpret_cast<uint64_t*>(cstage + 2 * L::CST);
  uint64_t* empty = full + S;
  // part h of the A / B tile of stage s (each 1024-byte aligned)
  auto a_tile = [&](int s, int h) { return ring + s * L::STAGE + h * L::A; };
  auto b_tile = [&](int s, int h) {
    return ring + s * L::STAGE + PA * L::A + h * L::B;
  };

  const int KT = (K + TBK - 1) / TBK;
  const int mt = (M + TBM - 1) / TBM, nt = (N + BN - 1) / BN;
  const int tiles = EX ? E * mt * nt : mt * nt;
  // tile -> (e, m0, n0): the experts in order; within one, the larger
  // operand's tile is the one the blocks in flight share in L2 (the N
  // tiles of one M tile together when A is larger, else the M tiles of
  // one N tile)
  auto origin = [&](int tile, int& e, int& m0, int& n0) {
    e = EX ? tile / (mt * nt) : 0;
    if (EX) tile -= e * mt * nt;
    m0 = (n_fast ? tile / nt : tile % mt) * TBM;
    n0 = (n_fast ? tile % nt : tile / mt) * BN;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Persistent: block b takes output tiles b, b + gridDim.x, ...; the
  // ring's k-steps count on across tiles, so the producer loads the next
  // tile while the consumers store this one.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full by TMA ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int e, m0, n0;
        origin(tile, e, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S, k0 = kt * TBK;
          mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full + s, L::STAGE);
#pragma unroll
          for (int h = 0; h < PA; ++h) {
            if constexpr (TA) {
              tma_load_2d(a_tile(s, h), &maps.a[h], full + s, m0, k0);
              tma_load_2d(a_tile(s, h) + 8192, &maps.a[h], full + s,
                          m0 + 64, k0);
            } else if constexpr (EX) {
              tma_load_3d(a_tile(s, h), &maps.a[h], full + s, k0, m0, e);
            } else {
              tma_load_2d(a_tile(s, h), &maps.a[h], full + s, k0, m0);
            }
          }
#pragma unroll
          for (int h = 0; h < PB; ++h) {
            if constexpr (TB) {
              tma_load_2d(b_tile(s, h), &maps.b[h], full + s, k0, n0);
            } else {
#pragma unroll
              for (int c = 0; c < BN / 64; ++c) {
                if constexpr (EX)
                  tma_load_3d(b_tile(s, h) + c * 8192, &maps.b[h], full + s,
                              n0 + 64 * c, k0, e);
                else
                  tma_load_2d(b_tile(s, h) + c * 8192, &maps.b[h], full + s,
                              n0 + 64 * c, k0);
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each ----
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // K-major: 8-row groups 1024 bytes apart, a k16 step 32 bytes on;
    // MN-major: 64-column chunks 8192 bytes apart, a k16 step 16 rows on
    constexpr uint32_t A_LBO = TA ? 8192 : 16, B_LBO = TB ? 16 : 8192;
    constexpr uint32_t A_STEP = TA ? 2048 : 32, B_STEP = TB ? 32 : 2048;
    // The tensor cores' f32 sums lose low bits over a long k (they do not
    // round to nearest); a split operand's products run over the longest
    // k (the vocab), so there each stage's products go to a fresh tile of
    // registers, added into `acc` in f32 while the next stage runs.
    constexpr bool PROMOTE = PA * PB > 1;
    float acc[BN / 2];
    int it0 = 0;                  // the ring's k-steps before this tile
    // stage it0 + kt's products into d
    auto issue = [&](int kt, float (&d)[BN / 2]) {
      const int it = it0 + kt, s = it % S;
      mbar_wait(full + s, (it / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
#pragma unroll
        for (int ha = 0; ha < PA; ++ha)
#pragma unroll
          for (int hb = 0; hb < PB; ++hb)
            wgmma_tile<BN, TA, TB>(
                d,
                make_desc(a_tile(s, ha) + wg * 8192, A_LBO, 1024) +
                    ((kk * A_STEP) >> 4),
                make_desc(b_tile(s, hb), B_LBO, 1024) + ((kk * B_STEP) >> 4),
                !PROMOTE || kk + ha + hb > 0);
      }
      wgmma_commit();
    };
    auto release = [&](int kt) { mbar_arrive(empty + (it0 + kt) % S); };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int e, m0, n0;
      origin(tile, e, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if constexpr (!PROMOTE) {
        for (int kt = 0; kt < KT; ++kt) {
          issue(kt, acc);
          wgmma_wait<1>();
          if (kt > 0) release(kt - 1);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(KT - 1);
      } else {
        float t0[BN / 2], t1[BN / 2];
        // stage kt's products are in `t`: add them, release the stage
        auto fold = [&](int kt, float (&t)[BN / 2]) {
          fence_regs(t);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += t[i];
          release(kt);
        };
        int kt = 0;
        for (; kt + 1 < KT; kt += 2) {
          issue(kt, t0);
          wgmma_wait<1>();
          if (kt > 0) fold(kt - 1, t1);
          issue(kt + 1, t1);
          wgmma_wait<1>();
          fold(kt, t0);
        }
        if (kt < KT) {
          issue(kt, t0);
          wgmma_wait<1>();
          if (kt > 0) fold(kt - 1, t1);
          wgmma_wait<0>();
          fold(kt, t0);
        } else {
          wgmma_wait<0>();
          fold(kt - 1, t1);
        }
      }
      it0 += KT;

      // f32 C: thread (warp, lane) holds rows 16 warp + lane / 4 (+ 8),
      // columns 8 j + 2 (lane % 4) (+ 1).  With tma_c, 64 columns at a
      // time go through the warpgroup's staging buffer and out by TMA
      // (which clips the ragged edge), so the stores drain while the next
      // tile's products run; else they are stored from registers, masked.
      if (tma_c) {
        uint8_t* cw = cstage + wg * L::CST;
#pragma unroll
        for (int r = 0; r < BN / CCOLS; ++r) {
          if (tid == 0) bulk_wait_read();        // the buffer's last stores
          named_bar_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < CCOLS / 8; ++jj) {
            const int j = r * (CCOLS / 8) + jj;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = warp * 16 + lane / 4 + 8 * h;
              const int cl = 8 * jj + 2 * (lane % 4);      // < CCOLS
              const int cb = cl % 32;
              float* dst = reinterpret_cast<float*>(
                  cw + (cl / 32) * 8192 + rr * 128 +
                  (((cb / 4) ^ (rr % 8)) << 4) + (cb % 4) * 4);
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
          fence_proxy_async();
          named_bar_sync(1 + wg, 128);
          if (tid == 0) {
#pragma unroll
            for (int b = 0; b < CCOLS / 32; ++b) {
              if constexpr (EX)
                tma_store_3d(&maps.c, cw + b * 8192,
                             n0 + r * CCOLS + 32 * b, m0 + wg * 64, e);
              else
                tma_store_2d(&maps.c, cw + b * 8192,
                             n0 + r * CCOLS + 32 * b, m0 + wg * 64);
            }
            bulk_commit();
          }
        }
      } else {
        const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
        const bool pairs = (N % 2) == 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= M) continue;
          float* row = C + ((size_t)e * M + r) * N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = n0 + 8 * j + 2 * (lane % 4);
            const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
            if (pairs && c + 1 < N) {
              *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
            } else {
              if (c < N) row[c] = x0;
              if (c + 1 < N) row[c + 1] = x1;
            }
          }
        }
      }
    }
    if (tma_c && tid == 0) bulk_wait_all();
  }
}

template <int BN, int TA, int TB, int PA, int PB, bool EX = false>
int launch_tile_t(const TileMaps& maps, float* c, int m, int n, int k,
                  int tma_c, int n_fast, cudaStream_t s, int e = 1) {
  constexpr size_t smem = TileSmem<BN, PA, PB>::BYTES;
  auto kern = gemm_tc<BN, TA, TB, PA, PB, EX>;
  static bool sized = false;               // once a kernel (host time)
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long tiles =
      (long long)e * ((m + TBM - 1) / TBM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kern<<<grid, 384, smem, s>>>(maps, c, m, n, k, tma_c, n_fast, e);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int PA, int PB>
int launch_tile_parts(int ta, int tb, const TileMaps& maps, float* c, int m,
                      int n, int k, int tma_c, int n_fast, cudaStream_t s) {
  if (ta && tb)
    return launch_tile_t<BN, 1, 1, PA, PB>(maps, c, m, n, k, tma_c, n_fast,
                                           s);
  if (ta)
    return launch_tile_t<BN, 1, 0, PA, PB>(maps, c, m, n, k, tma_c, n_fast,
                                           s);
  if (tb)
    return launch_tile_t<BN, 0, 1, PA, PB>(maps, c, m, n, k, tma_c, n_fast,
                                           s);
  return launch_tile_t<BN, 0, 0, PA, PB>(maps, c, m, n, k, tma_c, n_fast, s);
}

// The map of the f32 (m, n) output, boxes of 64 rows x 32 columns,
// 128-byte swizzled (as the staging buffer is written)
static inline int encode_out_map(CUtensorMap* map, void* base, int m,
                                 int n) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tile path; `a[1..2]` / `b[1..2]` the mid and lo parts of a split
// operand (null when it is bf16).  BN = 256 where its tiles fill the SMs
// (and nothing is split), else 128.  C leaves by TMA when its rows are a
// multiple of 16 bytes.
int launch_tile(const void* const a[3], const void* const b[3], float* c,
                int m, int n, int k, int ta, int tb, cudaStream_t s) {
  const int pa = a[1] ? 3 : 1, pb = b[1] ? 3 : 1;
  const long long tiles256 =
      (long long)((m + TBM - 1) / TBM) * ((n + 255) / 256);
  const int bn = pa == 1 && pb == 1 && tiles256 >= sm_count() ? 256 : 128;
  TileMaps maps;
  int err = 0;
  for (int h = 0; h < pa && err == 0; ++h)
    err = ta ? encode_matrix_map(&maps.a[h], a[h], k, m, 64)
             : encode_matrix_map(&maps.a[h], a[h], m, k, TBM);
  for (int h = 0; h < pb && err == 0; ++h)
    err = tb ? encode_matrix_map(&maps.b[h], b[h], n, k, bn)
             : encode_matrix_map(&maps.b[h], b[h], k, n, 64);
  const int tma_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (err == 0 && tma_c) err = encode_out_map(&maps.c, c, m, n);
  if (err != 0) return err;
  const int n_fast = (long long)m * pa > (long long)n * pb;   // A larger
  if (pa == 3)
    return launch_tile_parts<128, 3, 1>(ta, tb, maps, c, m, n, k, tma_c,
                                        n_fast, s);
  if (pb == 3)
    return launch_tile_parts<128, 1, 3>(ta, tb, maps, c, m, n, k, tma_c,
                                        n_fast, s);
  if (bn == 256)
    return launch_tile_parts<256, 1, 1>(ta, tb, maps, c, m, n, k, tma_c,
                                        n_fast, s);
  return launch_tile_parts<128, 1, 1>(ta, tb, maps, c, m, n, k, tma_c,
                                      n_fast, s);
}

// The rank-3 map of E row-major (rows, cols) matrices, one after another
// (bf16 operands in boxes of box_rows x 64 columns, 128-byte swizzled;
// the f32 output in boxes of 64 rows x 32 columns, swizzled as the
// staging buffer is written): box (c, r, e) is rows r .. of columns c ..
// of matrix e, and what lies past that matrix's rows or columns reads as
// zeros (or is not stored), whatever the next matrix holds.  Needs a
// 16-byte aligned base and rows a multiple of 16 bytes.
static inline int encode_expert_map(CUtensorMap* map, const void* base,
                                    int E, int rows, int cols, int box_rows,
                                    bool out) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = out ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * es,
                                 (cuuint64_t)rows * cols * es};
  const cuuint32_t box[3] = {out ? 32u : 64u, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(
      map, out ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      !out && (cols * 2) % 128 == 0 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                                    : CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The expert form on the tile path: x (E, m, k) and w (E, k, n) bf16
// into c (E, m, n) f32; BN = 256 where its tiles fill the SMs.
int launch_tile_expert(const void* x, const void* w, float* c, int e, int m,
                       int n, int k, cudaStream_t s) {
  const long long tiles256 =
      (long long)e * ((m + TBM - 1) / TBM) * ((n + 255) / 256);
  const int bn = tiles256 >= sm_count() ? 256 : 128;
  TileMaps maps;
  int err = encode_expert_map(&maps.a[0], x, e, m, k, TBM, false);
  if (err == 0) err = encode_expert_map(&maps.b[0], w, e, k, n, 64, false);
  const int tma_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (err == 0 && tma_c)
    err = encode_expert_map(&maps.c, c, e, m, n, 64, true);
  if (err != 0) return err;
  const int n_fast = m > n;
  if (bn == 256)
    return launch_tile_t<256, 0, 0, 1, 1, true>(maps, c, m, n, k, tma_c,
                                                n_fast, s, e);
  return launch_tile_t<128, 0, 0, 1, 1, true>(maps, c, m, n, k, tma_c,
                                              n_fast, s, e);
}

// g = hi + mid + lo + r: hi = bf16(g), mid = bf16(g - hi), lo = bf16(g -
// hi - mid), each difference exact in f32, |r| <= 2^-24 |g| (a normal g;
// four elements a thread)
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16(r1);
  lo = __float2bfloat16(r1 - __bfloat162float(mid));
}

__global__ void split_bf16(const float* __restrict__ g, bf16* __restrict__ hi,
                           bf16* __restrict__ mid, bf16* __restrict__ lo,
                           long long n) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(g + i);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[2], m[2], w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bf16 h0, m0, w0, h1, m1, w1;
      split3(x[2 * e], h0, m0, w0);
      split3(x[2 * e + 1], h1, m1, w1);
      h[e] = __bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
      m[e] = __bfloat16_as_ushort(m0) | ((uint32_t)__bfloat16_as_ushort(m1) << 16);
      w[e] = __bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
    }
    *reinterpret_cast<uint2*>(hi + i) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(mid + i) = make_uint2(m[0], m[1]);
    *reinterpret_cast<uint2*>(lo + i) = make_uint2(w[0], w[1]);
  } else {
    for (long long j = i; j < n; ++j) split3(g[j], hi[j], mid[j], lo[j]);
  }
}

// ---- the decode rows: m <= 16 rows against a streamed weight ----

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr int GEMV_WARPS = 4, GEMV_COLS = 64, GEMV_UNIT = 32;

// out (M <= 16 rows, N) = x (M, K) op(w) over this block's units of 32 k
// (split `blockIdx.y` of `nsplit`) for 64 columns (`blockIdx.x`).  Each
// warp streams every fourth unit of the weight with 16-byte loads, the
// rows padded to 16 for mma.sync m16n8k16; the k order inside a unit is
// permuted alike in x and w so each thread's loads are whole vectors.
// TB (w stored (N, K)): thread (g, t) holds rows n = nb + 8 j + g, k 8 t
// .. 8 t + 7 of the unit.  Otherwise (w stored (K, N)): thread (g, t)
// holds columns nb + 8 g .. + 7 of k rows 4 t .. 4 t + 3 of each half,
// paired along k with byte permutes; tile j is the columns nb + 8 g + j.
// The four warps' sums are added in warp order; with nsplit > 1 the block
// writes its split's partial (ws), summed by gemv_reduce.  The expert
// form stacks E such products (x (E, M, K), w (E, K, N), out (E, M, N)):
// blockIdx.z is the expert.
template <bool TB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
         float* __restrict__ out, float* __restrict__ ws, int M, int N,
         int K, int nsplit) {
  __shared__ float red[GEMV_WARPS - 1][32][33];
  const size_t ex = blockIdx.z;
  x += ex * M * K;
  w += ex * K * N;
  out += ex * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * GEMV_COLS;
  const int units = K / GEMV_UNIT;
  const int per = (units + nsplit - 1) / nsplit;
  const int u0 = blockIdx.y * per, u1 = min(units, u0 + per);
  const bool row0 = g < M, row1 = g + 8 < M;
  const bf16* x0 = x + (size_t)g * K;
  const bf16* x1 = x + (size_t)(g + 8) * K;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint4 zero = make_uint4(0, 0, 0, 0);

#pragma unroll 2
  for (int u = u0 + warp; u < u1; u += GEMV_WARPS) {
    const int k0 = u * GEMV_UNIT;
    if constexpr (TB) {
      uint4 wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb + 8 * j + g;
        wv[j] = n < N ? ld_stream(w + (size_t)n * K + k0 + 8 * t) : zero;
      }
      const uint4 xa = row0 ? *reinterpret_cast<const uint4*>(x0 + k0 + 8 * t) : zero;
      const uint4 xb = row1 ? *reinterpret_cast<const uint4*>(x1 + k0 + 8 * t) : zero;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_16816(acc[j], xa.x, xb.x, xa.y, xb.y, wv[j].x, wv[j].y);
        mma_16816(acc[j], xa.z, xb.z, xa.w, xb.w, wv[j].z, wv[j].w);
      }
    } else {
      const bool col_ok = nb + 8 * g < N;
      uint4 wr[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wr[h][r] = col_ok ? ld_stream(w + (size_t)(k0 + 16 * h + 4 * t + r) * N +
                                        nb + 8 * g)
                            : zero;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = k0 + 16 * h + 4 * t;
        const uint2 xa = row0 ? *reinterpret_cast<const uint2*>(x0 + kb)
                              : make_uint2(0, 0);
        const uint2 xb = row1 ? *reinterpret_cast<const uint2*>(x1 + kb)
                              : make_uint2(0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
          const uint32_t b0 = __byte_perm(word(wr[h][0], j / 2),
                                          word(wr[h][1], j / 2), sel);
          const uint32_t b1 = __byte_perm(word(wr[h][2], j / 2),
                                          word(wr[h][3], j / 2), sel);
          mma_16816(acc[j], xa.x, xb.x, xa.y, xb.y, b0, b1);
        }
      }
    }
  }

  // the warps' sums in warp order
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp - 1][4 * j + e][lane] = acc[j][e];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int q = 0; q < GEMV_WARPS - 1; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += red[q][4 * j + e][lane];
  float* dst = nsplit == 1
                   ? out
                   : ws + ((size_t)blockIdx.y * gridDim.z + ex) * M * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);
      const int n = TB ? nb + 8 * j + 2 * t + (e % 2)
                       : nb + 8 * (2 * t + (e % 2)) + j;
      if (r < M && n < N) dst[(size_t)r * N + n] = acc[j][e];
    }
}

// out = the sum of the nsplit partials, in split order (no atomics:
// reruns are the same bits)
__global__ void gemv_reduce(const float* __restrict__ ws,
                            float* __restrict__ out, long long total,
                            int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = ws[i];
  for (int s = 1; s < nsplit; ++s) sum += ws[(size_t)s * total + i];
  out[i] = sum;
}

int launch_gemv(const void* x, const void* w, float* c, float* ws, int m,
                int n, int k, int tb, int nsplit, cudaStream_t s,
                int e = 1) {
  if (m < 1 || m > 16 || k % GEMV_UNIT != 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr) || e < 1 || e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + GEMV_COLS - 1) / GEMV_COLS, nsplit, e);
  auto X = static_cast<const bf16*>(x);
  auto W = static_cast<const bf16*>(w);
  if (tb)
    gemv_mma<true><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n, k,
                                                    nsplit);
  else
    gemv_mma<false><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n, k,
                                                     nsplit);
  if (nsplit > 1) {
    const long long total = (long long)e * m * n;
    gemv_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, c, total,
                                                                nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16, per operand.  transpose_a:
// A is stored (k, m); transpose_b: B is stored (n, k).  vec_a / vec_b: the
// caller certifies 16-byte aligned rows (base pointer aligned and the row
// length a multiple of 8 elements), allowing vector loads (wmma path).
extern "C" int repro_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, int transpose_a, int transpose_b,
                          int a_dtype, int b_dtype, int vec_a, int vec_b,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* C = static_cast<float*>(c);
  if ((a_dtype != 0 && a_dtype != 1) || (b_dtype != 0 && b_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dtype == 1 && b_dtype == 1 && !transpose_a) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    auto A = static_cast<const __nv_bfloat16*>(a);
    auto B = static_cast<const __nv_bfloat16*>(b);
    if (transpose_b)
      gemm_bf16<true><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k, vec_a,
                                               vec_b);
    else
      gemm_bf16<false><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k, vec_a,
                                                vec_b);
  } else if (a_dtype == 0 && b_dtype == 0) {
    launch_fma<float, float>(a, b, C, m, n, k, transpose_a, transpose_b, s);
  } else if (a_dtype == 0) {
    launch_fma<float, __nv_bfloat16>(a, b, C, m, n, k, transpose_a,
                                     transpose_b, s);
  } else if (b_dtype == 0) {
    launch_fma<__nv_bfloat16, float>(a, b, C, m, n, k, transpose_a,
                                     transpose_b, s);
  } else {
    launch_fma<__nv_bfloat16, __nv_bfloat16>(a, b, C, m, n, k, transpose_a,
                                             transpose_b, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile path: a, b bf16, or one of them the hi part of a split f32
// operand whose mid and lo parts are a_mid, a_lo (or b_mid, b_lo; null
// otherwise); every row stride a multiple of 16 bytes, bases 16-byte
// aligned, k >= 1.
extern "C" int repro_gemm_tc(const void* a, const void* a_mid,
                             const void* a_lo, const void* b,
                             const void* b_mid, const void* b_lo, void* c,
                             int m, int n, int k, int transpose_a,
                             int transpose_b, void* stream) {
  if ((a_mid && b_mid) || (a_mid && !a_lo) || (b_mid && !b_lo) || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const as[3] = {a, a_mid, a_lo};
  const void* const bs[3] = {b, b_mid, b_lo};
  return tc::launch_tile(as, bs, static_cast<float*>(c), m, n, k,
                         transpose_a, transpose_b,
                         static_cast<cudaStream_t>(stream));
}

// The decode rows: x (m <= 16, k) bf16 against w (k, n), or (n, k) with
// transpose_b, bf16; k % 32 == 0, rows 16-byte aligned; the k range split
// over nsplit blocks whose partials (ws: nsplit x m x n f32, needed when
// nsplit > 1) a second pass sums in split order.
extern "C" int repro_gemv(const void* x, const void* w, void* c, void* ws,
                          int m, int n, int k, int transpose_b, int nsplit,
                          void* stream) {
  return tc::launch_gemv(x, w, static_cast<float*>(c),
                         static_cast<float*>(ws), m, n, k, transpose_b,
                         nsplit, static_cast<cudaStream_t>(stream));
}

// The expert form: x (e, m, k) times w (e, k, n), bf16, into c (e, m, n)
// f32, expert by expert.  route 0: the tile path (rows of a multiple of 16
// bytes, bases 16-byte aligned, k >= 1); route 1: the decode rows (m <=
// 16, k % 32 == 0; ws: nsplit x e x m x n f32 when nsplit > 1, the
// partials summed in split order).
extern "C" int repro_expert_gemm(const void* x, const void* w, void* c,
                                 void* ws, int e, int m, int n, int k,
                                 int route, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return tc::launch_gemv(x, w, static_cast<float*>(c),
                           static_cast<float*>(ws), m, n, k, 0, nsplit, s,
                           e);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_tile_expert(x, w, static_cast<float*>(c), e, m, n, k, s);
}

// The three bf16 parts (hi, mid, lo) of n f32 values (16-byte aligned).
extern "C" int repro_split_bf16(const void* g, void* hi, void* mid, void* lo,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const long long threads = 256, per = threads * 4;
  tc::split_bf16<<<(unsigned)((n + per - 1) / per), (unsigned)threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(hi),
      static_cast<__nv_bfloat16*>(mid), static_cast<__nv_bfloat16*>(lo), n);
  return static_cast<int>(cudaGetLastError());
}
