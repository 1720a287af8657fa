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
// more lift of the same blocked product; and the two expert GEMMs of
// _pallas_expert_bwd, dx = g w^T and dw = x^T g, on the split route.  Its
// head form replaces emit_pallas on head_gemm_expr (src/repro/kernels/
// ops.py, head_matmul: MLA decode's absorbed products x (m, h, k) @ w (k,
// h, n), or w (n, h, k) read transposed, -> (h, m, n), the weight a
// head-middle slice of the stored (kv_rank, h, nope + v) table).  Its
// int8 routes (the int8 tile and the int8 decode rows) replace emit_pallas
// at acc_dtype int32 (src/repro/kernels/emit.py:183-190, the MXU's exact
// s8 x s8 -> s32 sums) on the 2-D, expert and head forms.
//
// Layouts: A is row-major (m, k), or with transpose_a row-major (k, m)
// read as its transpose in place.  B is row-major (k, n), or with
// transpose_b row-major (n, k), read in its stored layout: neither the
// (256000, 2048) tied embedding table nor the vocab-sized logits gradient
// is ever copied transposed.  C is row-major (m, n) float32; the caller
// casts to its out dtype.
//
// Operand types: A and B are each float32 or bfloat16, or both float16
// (the tile route and the head form's tile only, the f16 flag of
// repro_gemm_tc and repro_head_gemm_tc), or both int8 (into int32: the
// int8 tile, with the K-major pack where it needs one, and the int8
// decode rows of the head form).  In a training
// step the cotangent reaching the VJP products is f32 (the primal returns
// f32; the cast to bf16 sits outside) while weights and activations are
// bf16.
//
// Precision contract.  bf16 x bf16 and f16 x f16: every product is exact
// in f32 (8- or 11-bit significands) and the sums are f32.  f32 x f32: exact f32 FMA (no TF32).  Mixed (f32 x bf16):
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
//         f16 x f16 (m > 16, both operands TMA-readable; ops.gemm_route)
//         takes the same kernel with float16 tensor maps and f16 wgmma,
//         one product a term; past F16_PROMOTE_K terms at BN = 128 with
//         each stage promoted as on the split route.
//   split one f32 operand: the tile path with that operand's three parts
//         (three wgmmas a k-step, the bf16 operand's tile read once),
//         BN = 128, 3 stages, and the per-stage f32 promotion above.  The
//         parts are written at a row pitch of a multiple of 8 elements, so
//         TMA reads them whatever the f32 operand's own row (whisper's
//         51865-wide logits gradient); only the bf16 operand must suit
//         TMA.
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
//         sized by the E x n/64 blocks.  Its VJP forms (the f32 cotangent
//         g (E, cap, f) against bf16 x and w; repro_expert_gemm_split)
//         take the split path's tile through the same rank-3 maps: dx =
//         g w^T with g's three parts as A and w read K-major in its
//         stored (E, d, f) layout, dw = x^T g with x read MN-major in its
//         stored (E, cap, d) layout and g's parts as B, so k = cap is the
//         ragged edge that zero-fills inside each expert.
//   the head form (repro_head_gemm, bf16 x bf16, m <= 16): the decode-row
//         kernel with the head as grid axis z, each operand read through
//         its row and head strides (a multiple of 16 bytes), so a slice
//         of a weight table is streamed in place, never copied.  Past 16
//         rows (repro_head_gemm_tc): the tile path with the heads' tiles
//         one after another in the persistent walk (the expert form's
//         walk), x (m, h, k) read K-major and w read K-major ((n, h, k),
//         transpose_b) or MN-major ((k, h, n)), each through a rank-3 map
//         built from the view's own strides with its dimensions in stride
//         order, (inner, head, row): the head is the map's middle
//         coordinate and a box of (64, 1, rows) is the same 2-D tile in
//         shared memory, so each head's ragged row and k edges read as
//         zeros; C (h, m, n) f32 goes out on the expert form's map.  No
//         operand is copied, k is not split, and one launch does all the
//         heads.  The tile stays 128 rows high: at MLA's decode batches
//         (m = 17-128) the rows past m are zeros that cost the tensor
//         cores a few hundred cycles a tile, against a load and a store
//         that bound it.  float16 x float16 (repro_head_gemm_tc's f16
//         flag) takes the same tile with float16 maps and f16 wgmma at
//         every m, k <= F16_PROMOTE_K (no promotion): there is no float16
//         decode-row kernel, and at m = 4 the tile is one 128-row tile a
//         head whose 124 padding rows TMA fills with zeros.
//   fma   f32 x f32, and the forms whose bf16 operand TMA cannot read (a
//         stored row length not a multiple of 8 elements, a base not
//         16-byte aligned, k = 0) but bf16 x bf16 without transpose_a:
//         exact f32 FMA (gemm_fma, namespace `exact` below: tiles by the
//         width, a cp.async ring, k split where the tiles do not fill the
//         card, a row form at most 16 rows).
//   wmma  bf16 x bf16 without transpose_a that TMA cannot read: the
//         first nvcuda::wmma 64x64 tiles (gemm_bf16).
//   int8 tile  every int8 x int8 product (the route of ops.apply with
//         acc_dtype int32: 2-D with either operand transposed, or a stack
//         of any transposes; repro_gemm_int8_tc): the expert form's
//         persistent walk and rank-3 maps on int8 (a stage is 128 k of the
//         same 128-byte swizzled rows, so ring, barriers and descriptor
//         steps are bf16's), wgmma m64nNk32 s8 x s8 -> s32, C int32 out
//         through an int32 map.  8-bit wgmma takes K-major operands only:
//         A (m, k) and B stored (n, k) with rows of a multiple of 16 bytes
//         and 16-byte bases are read in place; any other operand (B stored
//         (k, n), A stored (k, m), k % 16 != 0, an unaligned base) is first
//         written K-major at a row pitch of k rounded up to 16 by the pack
//         (pack_kmajor_int8, repro_pack_kmajor_int8: one pass over the
//         operand), and the tile reads the packed rows at that pitch.
//         Exact: integer products and sums wrap past 2^31 as the
//         reference's int32 accumulator does (emit_pallas at acc_dtype
//         int32), and the zeros past k add nothing.
//   int8 decode rows  the int8 head form at m <= 16 rows, k % 32 == 0
//         (repro_head_gemm_s8): the decode rows' weight stream on mma.sync
//         m16n8k32 s8 -> s32 (gemv_mma_s8), each operand through its row
//         and head strides, the k split's int32 partials summed by
//         gemv_reduce.
//   int8 form  (repro_gemm_int8, namespace i8 below; no route takes it)
//         mma.sync s8 x s8 -> s32 with per-stage transposes in shared
//         memory: the first int8 design, kept as the timed comparison on
//         the same operands until the benchmark's simplification removes
//         it.
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
// crossover, and the padding of cap to 256 rows wastes 6%.  The head form
// streams 1.31 MB a product at minicpm3-4b's decode (0.0004 ms at 3.35
// TB/s): the launch, not the card, bounds it.  Past 16 rows its tile
// route is bytes-bound too: q_lat at 64 rows reads 1.64 MB and writes 2.62
// MB (0.0013 ms at 3.35 TB/s), in 80 tiles of one 64-deep stage each, so
// what remains is a TMA load's and a store's latency a tile.  The int8
// tile is bytes-bound wherever its int32 output is wider than its inputs:
// at e = 16 stacks of 1024^3 it reads 32 MB and writes 64 MB (0.0300 ms
// at 3.35 TB/s) for 34 G integer operations (0.0174 ms at 1979 TOPS), so
// its C leaves by TMA stores that drain under the next tile's products; a
// 2-D int8 product of 4096^3 is operations-bound (137 G operations, 0.0694
// ms at 1979 TOPS), and a B stored (k, n) adds the pack's round trip (32
// MB, 0.0100 ms at 3.35 TB/s), which a transposer warpgroup between TMA
// and wgmma would save.
#include <cooperative_groups.h>
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

// out = the sum of the nsplit partials, in split order (no atomics:
// reruns are the same bits); int32 partials (the int8 decode rows) are
// added with wrapping adds, as an int32 accumulator's
template <typename T>
__global__ void gemv_reduce(const T* __restrict__ ws, T* __restrict__ out,
                            long long total, int nsplit) {
  using Sum = std::conditional_t<std::is_same_v<T, int32_t>, uint32_t, T>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  Sum sum = static_cast<Sum>(ws[i]);
#pragma unroll 8
  for (int s = 1; s < nsplit; ++s)
    sum += static_cast<Sum>(ws[(size_t)s * total + i]);
  out[i] = static_cast<T>(sum);
}

// ---------------------------------------------------------------------------
// The exact-f32 FMA kernels: every f32 x f32 product, and the bf16 or mixed
// forms whose bf16 operand TMA cannot read.  f32 FMA on the CUDA cores (no
// TF32, no bf16 parts: the MoE routings depend on f32 router logits).
//
// What bounds them on an H100: f32 FMA at 67 TFLOP/s where a product is
// large (4096^3: 2.05 ms), else the bytes of the larger operand (a
// router's (2048, 5120) activations, 42 MB: 0.0125 ms) or, at decode's two
// rows, the launch.  The first FMA kernel took one 128 x 128 tile a block and
// walked k serially by 8 with two barriers a step and no copy in flight,
// so the routers' grids held 1-16 blocks on 132 SMs.  Here:
//   - the tile's width follows n: 128 x 128, 128 x 64 (n <= 64: deepseek's
//     64 experts), 256 x 16 (n <= 16: llama4's 16), 256 threads, each an
//     8 x 8, 8 x 4 or 4 x 4 patch of outputs;
//   - k is staged 32 at a time through a three-stage cp.async ring, one
//     barrier a stage: 16-byte copies where a stored row and the base are
//     16-byte aligned, 4-byte ones otherwise, the ragged edges zero-filled
//     by the copies' source size; bf16 operands are widened by the threads
//     into the same f32 tiles;
//   - each operand stays in shared memory in its stored orientation
//     (A (m, k) or (k, m), B (k, n) or (n, k)) and a thread reads two k
//     a step, as a float2 along k or as float4s across its 4-row (column)
//     groups, so no operand is transposed on the way in;
//   - where the output tiles are fewer than the SMs, k is split over
//     blocks (ops.fma_splits: two blocks a SM), each writing its partial,
//     and gemv_reduce adds them in split order (reruns are the same bits).
// The row form (at most 16 rows, no transpose_a: the decode routers) is
// the f32 twin of gemv_mma on the CUDA cores, below.  Measured on an
// H100: the k split of a tile through a cluster's shared
// memory ran slower than the workspace and second pass at every router
// shape, BK of 16 or 8 and 4-6 stages gained nothing, and the row form's
// time was fixed by its code size (every instruction fetched cold, once a
// launch) until its unrolled rows were bounded by the rows it takes.
// ---------------------------------------------------------------------------

namespace exact {

constexpr int THREADS = 256, BK = 32, STAGES = 3, PAD = 4;
enum Form { ROWS = 0, T256x16 = 1, T128x64 = 2, T128x128 = 3 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of a stored
// row-major matrix (R rows of C, ld elements apart) into tile[ROWS][COLS +
// PAD] f32, zero past R and C.  f32 by cp.async (16 bytes with vec: rows
// 16-byte aligned), bf16 widened by the threads.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ src,
                                      long long ld, int R, int C, int r0,
                                      int c0, bool vec) {
  constexpr int P = COLS + PAD;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CH = COLS / 4;
#pragma unroll
      for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
        const int r = e / CH, c = (e % CH) * 4;
        const int gr = r0 + r, gc = c0 + c;
        int bytes = gr < R ? 4 * (C - gc) : 0;
        bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
        cp_async16(tile + r * P + c,
                   bytes ? src + (size_t)gr * ld + gc : src, bytes);
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
        const int r = e / COLS, c = e % COLS;
        const int gr = r0 + r, gc = c0 + c;
        const bool in = gr < R && gc < C;
        cp_async4(tile + r * P + c, in ? src + (size_t)gr * ld + gc : src,
                  in ? 4 : 0);
      }
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const int gr = r0 + r, gc = c0 + c;
      tile[r * P + c] =
          gr < R && gc < C ? to_f(src[(size_t)gr * ld + gc]) : 0.f;
    }
  }
}

// The row form's k split summed in split order: in a cluster of the
// nsplit <= MAX_CLUSTER blocks of one column block, each
// block leaves its `count` partial sums in its shared `part`, and block
// rank r adds elements r * THREADS + t, ... over the ranks 0, 1, ... in
// order (all ranks' loads issued first), read through distributed shared
// memory, handing each total to out(e, v): one launch, no workspace, the
// same bits as gemv_reduce's pass over a workspace.
constexpr int MAX_CLUSTER = 8;

template <typename Out>
__device__ __forceinline__ void cluster_fold(float* part, int count,
                                             Out out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  for (int e = rank * THREADS + threadIdx.x; e < count;
       e += cs * THREADS) {
    float v[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < cs) v[r] = *cl.map_shared_rank(part + e, r);
    float sum = v[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < cs) sum += v[r];
    out(e, sum);
  }
  cl.sync();            // no block leaves while another reads its part
}

template <int BM, int BN, bool TA, bool TB>
struct Tiles {
  // stored orientation: A (BM, BK) or (BK, BM); B (BK, BN) or (BN, BK)
  static constexpr int A = TA ? BK * (BM + PAD) : BM * (BK + PAD);
  static constexpr int B = TB ? BN * (BK + PAD) : BK * (BN + PAD);
  static constexpr int STAGE = A + B;
  static constexpr size_t BYTES = (size_t)STAGES * STAGE * 4;
};

// C (or split z's partial in ws) = op(A) op(B) over this split's k-steps,
// one BM x BN tile a block (blockIdx.x columns, .y rows, .z the split).
// Thread (ty, tx) holds rows ty + TY i (A stored (m, k)) or the 4-row
// groups ty * 4 + 4 TY q (A stored (k, m)), and columns tx + TX j (B
// stored (n, k)) or the groups tx * 4 + 4 TX q (B stored (k, n)).
// With more than one split (gridDim.z), split z writes its partial to ws
// and gemv_reduce adds them.
template <typename AT, typename BT, bool TA, bool TB, int BM, int BN, int TM,
          int TN, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
gemm_fma(const AT* __restrict__ A, const BT* __restrict__ B,
         float* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
         int vec_a, int vec_b) {
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == THREADS, "a thread a TM x TN patch");
  static_assert((!TA || TM % 4 == 0) && (TB || TN % 4 == 0),
                "4-row (column) groups");
  using L = Tiles<BM, BN, TA, TB>;
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  const int per = (KT + gridDim.z - 1) / gridDim.z;
  const int kt0 = blockIdx.z * per;
  const int nk = max(0, min(KT, kt0 + per) - kt0);

  auto load = [&](int i) {             // k-step kt0 + i into its stage
    if (i < nk) {
      float* st = smem + (i % STAGES) * L::STAGE;
      const int k0 = (kt0 + i) * BK;
      if (TA)
        stage<AT, BK, BM>(st, A, M, K, M, k0, m0, vec_a);
      else
        stage<AT, BM, BK>(st, A, K, M, K, m0, k0, vec_a);
      if (TB)
        stage<BT, BN, BK>(st + L::A, B, K, N, K, n0, k0, vec_b);
      else
        stage<BT, BK, BN>(st + L::A, B, N, K, N, k0, n0, vec_b);
    }
    cp_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);
  for (int i = 0; i < nk; ++i) {
    cp_wait<STAGES - 2>();             // this thread's copies of step i
    __syncthreads();                   // everyone's; step i - 1 is done
    load(i + STAGES - 1);              // into step i - 1's stage
    const float* As = smem + (i % STAGES) * L::STAGE;
    const float* Bs = As + L::A;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float a[2][TM], b[2][TN];
      if (TA) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int q = 0; q < TM / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(
                As + (kk + s) * (BM + PAD) + q * 4 * TY + ty * 4);
            a[s][4 * q] = v.x, a[s][4 * q + 1] = v.y;
            a[s][4 * q + 2] = v.z, a[s][4 * q + 3] = v.w;
          }
      } else {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              As + (ty + TY * r) * (BK + PAD) + kk);
          a[0][r] = v.x, a[1][r] = v.y;
        }
      }
      if (TB) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const float2 v = *reinterpret_cast<const float2*>(
              Bs + (tx + TX * c) * (BK + PAD) + kk);
          b[0][c] = v.x, b[1][c] = v.y;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int q = 0; q < TN / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + (kk + s) * (BN + PAD) + q * 4 * TX + tx * 4);
            b[s][4 * q] = v.x, b[s][4 * q + 1] = v.y;
            b[s][4 * q + 2] = v.z, b[s][4 * q + 3] = v.w;
          }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(a[s][r], b[s][c], acc[r][c]);
    }
  }
  cp_wait<0>();

  float* dst = gridDim.z == 1 ? C : ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm =
        m0 + (TA ? (r / 4) * 4 * TY + ty * 4 + r % 4 : ty + TY * r);
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn =
          n0 + (TB ? tx + TX * c : (c / 4) * 4 * TX + tx * 4 + c % 4);
      if (gn < N) dst[(size_t)gm * N + gn] = acc[r][c];
    }
  }
}

constexpr int ROW_MAX = 16, WARPS = THREADS / 32, ROW_UNROLL = 16;
//: A's k range staged a chunk in shared memory: ROW_CHUNK / M columns
constexpr int ROW_CHUNK = 8192;

// 4 consecutive elements of a row at p (n of them valid, < 4 at an edge):
// one 16-byte load with VEC (f32, p 16-byte aligned and n >= 4)
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4(const T* p, int n) {
  if constexpr (VEC) {
    if (n >= 4) return *reinterpret_cast<const float4*>(p);
  }
  return make_float4(n > 0 ? to_f(p[0]) : 0.f, n > 1 ? to_f(p[1]) : 0.f,
                     n > 2 ? to_f(p[2]) : 0.f, n > 3 ? to_f(p[3]) : 0.f);
}

// The row form: out (M <= MR <= 16, N) = A (M, K) op(B), latency-bound
// (MR bounds the unrolled code: 2 or 4 for the decode rows, which run it
// once a launch, every instruction fetched cold), so each
// thread issues a round of ROW_UNROLL 16-byte loads of B before it waits
// on any (an f32 A's chunk copied to shared memory by cp.async meanwhile),
// and a block's share of k is as a rule one round.  The k range is split
// over the nsplit <= MAX_CLUSTER blocks blockIdx.x of a cluster, whose
// partials fold in split order there (cluster_fold): one launch, where a
// second pass over a workspace would cost as much again at decode's two
// rows; blockIdx.y is the column block.  A's k range is staged a chunk at a
// time in shared memory.
//   !TB (B stored (K, N)), 128 columns a block: `lpr` lanes (4 columns
//   each) cover a row of the block's columns and a warp 32 / lpr rows at
//   once, the warps on interleaved rows; the sums are folded over the
//   lanes of a column (xor shuffles) and over the warps in warp order.
//   TB (B stored (N, K)), 32 columns a block: a warp owns 4 columns and
//   its lanes walk k, 4 elements a lane, folded by an xor-shuffle tree.
template <typename AT, typename BT, bool TB, bool VEC, int MR>
__global__ void __launch_bounds__(THREADS)
gemm_fma_rows(const AT* __restrict__ A, const BT* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  constexpr int COLS = TB ? 32 : 128;
  constexpr int U = TB ? ROW_UNROLL / 4 : ROW_UNROLL;   // k steps a round
  __shared__ __align__(16) float as[ROW_CHUNK];
  __shared__ __align__(16) float part[MR * COLS];
  static_assert(MR <= ROW_MAX, "at most ROW_MAX rows");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ns = gridDim.x;
  const int per = ((K + ns - 1) / ns + 3) / 4 * 4;   // 16-byte aligned
  const int kb = blockIdx.x * per, ke = min(K, kb + per);
  const int kc = (ROW_CHUNK / M) / 4 * 4;       // a chunk's k, a multiple of 4
  const int nb = blockIdx.y * COLS;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  // !TB: this lane's 4 columns and k row within the warp's rows
  int lpr = 1;
  while (lpr < 32 && lpr * 4 < min(N - nb, COLS)) lpr *= 2;
  const int rw = 32 / lpr, kr = lane / lpr, n4 = nb + (lane % lpr) * 4;
  // the k a round covers, from this thread's first k
  const int step = TB ? 128 : WARPS * rw, k1 = TB ? lane * 4 : warp * rw + kr;
  const int n0 = nb + warp * 4;                 // TB: this warp's columns
  for (int c0 = kb; c0 < ke; c0 += kc) {
    const int len = min(ke, c0 + kc) - c0;
    const int ld = (len + 3) / 4 * 4;           // the chunk's row in `as`
    const int rounds = (len + step * U - 1) / (step * U);
    __syncthreads();                            // the last chunk is read
    if constexpr (std::is_same<AT, float>::value) {
      // f32 A: its chunk copied by cp.async, in flight beside B's loads
      for (int e = threadIdx.x; e < M * ld; e += THREADS) {
        const int r = e / ld, kk = e % ld;
        const bool in = kk < len;
        cp_async4(as + e, in ? A + (size_t)r * K + c0 + kk : A, in ? 4 : 0);
      }
      cp_commit();
    }
    for (int rd = 0; rd < rounds; ++rd) {
      const int kbase = rd * step * U + k1;
      float4 b[U][TB ? 4 : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kbase + u * step;
#pragma unroll
        for (int c = 0; c < (TB ? 4 : 1); ++c) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (TB)
            b[u][c] = kk < len && n0 + c < N
                          ? load4<VEC>(B + (size_t)(n0 + c) * K + c0 + kk,
                                       len - kk)
                          : z;
          else
            b[u][c] = kk < len ? load4<VEC>(B + (size_t)(c0 + kk) * N + n4,
                                            N - n4)
                               : z;
        }
      }
      if (rd == 0) {                            // stage the chunk of A
        if constexpr (std::is_same<AT, float>::value) {
          cp_wait<0>();                         // (copied before B's loads)
        } else {
          for (int e = threadIdx.x; e < M * ld; e += THREADS) {
            const int r = e / ld, kk = e % ld;
            as[e] = kk < len ? to_f(A[(size_t)r * K + c0 + kk]) : 0.f;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kbase + u * step;
        if (kk >= len) break;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r >= M) break;
          if constexpr (TB) {
            const float4 a =
                *reinterpret_cast<const float4*>(as + r * ld + kk);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float t = acc[r][c];
              t = fmaf(a.x, b[u][c].x, t);
              t = fmaf(a.y, b[u][c].y, t);
              t = fmaf(a.z, b[u][c].z, t);
              acc[r][c] = fmaf(a.w, b[u][c].w, t);
            }
          } else {
            const float a = as[r * ld + kk];
            acc[r][0] = fmaf(a, b[u][0].x, acc[r][0]);
            acc[r][1] = fmaf(a, b[u][0].y, acc[r][1]);
            acc[r][2] = fmaf(a, b[u][0].z, acc[r][2]);
            acc[r][3] = fmaf(a, b[u][0].w, acc[r][3]);
          }
        }
      }
    }
  }
  // fold this block's sums into part[M][COLS]
  if constexpr (!TB) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        for (int off = lpr; off < 32; off *= 2)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    for (int w = 0; w < WARPS; ++w) {          // the warps in order
      if (warp == w && kr == 0) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r < M)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float* q = part + r * COLS + (lane % lpr) * 4 + j;
              *q = w == 0 ? acc[r][j] : *q + acc[r][j];
            }
      }
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && r < M) part[r * COLS + warp * 4 + c] = v;
      }
    __syncthreads();
  }
  auto out = [&](int e, float v) {
    const int r = e / COLS, n = nb + e % COLS;
    if (r < M && n < N) C[(size_t)r * N + n] = v;
  };
  if (ns == 1) {
    for (int e = threadIdx.x; e < M * COLS; e += THREADS) out(e, part[e]);
  } else {
    cluster_fold(part, M * COLS, out);
  }
}

// A kernel launched with its k split as a cluster of `cs` blocks along
// grid axis x
template <typename... P, typename... Args>
cudaError_t launch_cluster(void (*kern)(P...), dim3 grid, size_t smem,
                           cudaStream_t s, int cs, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<P>(args)...);
}

template <typename AT, typename BT, bool TA, bool TB, int BM, int BN, int TM,
          int TN, int MINB>
int launch_tile(const void* a, const void* b, float* c, float* ws, int m,
                int n, int k, int vec_a, int vec_b, int nsplit,
                cudaStream_t s) {
  using L = Tiles<BM, BN, TA, TB>;
  auto kern = gemm_fma<AT, BT, TA, TB, BM, BN, TM, TN, MINB>;
  static bool sized = false;               // once a kernel (host time)
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  if (nsplit > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, nsplit);
  kern<<<grid, THREADS, L::BYTES, s>>>(static_cast<const AT*>(a),
                                       static_cast<const BT*>(b), c, ws, m,
                                       n, k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, typename BT, bool TA, bool TB>
int launch_form(int form, const void* a, const void* b, float* c, float* ws,
                int m, int n, int k, int vec_a, int vec_b, int nsplit,
                cudaStream_t s) {
  constexpr bool F32 =
      std::is_same<AT, float>::value && std::is_same<BT, float>::value;
  if (form == ROWS) {
    if (TA || m > ROW_MAX || nsplit > MAX_CLUSTER || ws != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(nsplit, (n + (TB ? 31 : 127)) / (TB ? 32 : 128));
    auto A = static_cast<const AT*>(a);
    auto B = static_cast<const BT*>(b);
    auto kern = gemm_fma_rows<AT, BT, TB, false, ROW_MAX>;
    if constexpr (F32) {
      if (m <= 2)
        kern = vec_b ? gemm_fma_rows<AT, BT, TB, true, 2>
                     : gemm_fma_rows<AT, BT, TB, false, 2>;
      else if (m <= 4)
        kern = vec_b ? gemm_fma_rows<AT, BT, TB, true, 4>
                     : gemm_fma_rows<AT, BT, TB, false, 4>;
      else if (vec_b)
        kern = gemm_fma_rows<AT, BT, TB, true, ROW_MAX>;
    }
    return static_cast<int>(
        launch_cluster(kern, grid, 0, s, nsplit, A, B, c, m, n, k));
  }
  if (nsplit > 65535 || (m + 127) / 128 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // two blocks a SM (128 registers) but where B stored (n, k) meets A
  // stored (m, k): both read along k, and 128 registers spill there
  if (form == T128x128)
    return launch_tile<AT, BT, TA, TB, 128, 128, 8, 8, TB && !TA ? 1 : 2>(
        a, b, c, ws, m, n, k, vec_a, vec_b, nsplit, s);
  if constexpr (F32) {
    if (form == T128x64)
      return launch_tile<AT, BT, TA, TB, 128, 64, 8, 4, 2>(
          a, b, c, ws, m, n, k, vec_a, vec_b, nsplit, s);
    if (form == T256x16)
      return launch_tile<AT, BT, TA, TB, 256, 16, 4, 4, 1>(
          a, b, c, ws, m, n, k, vec_a, vec_b, nsplit, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename AT, typename BT>
int launch(int form, const void* a, const void* b, float* c, float* ws,
           int m, int n, int k, int ta, int tb, int vec_a, int vec_b,
           int nsplit, cudaStream_t s) {
  int err;
  if (ta && tb)
    err = launch_form<AT, BT, true, true>(form, a, b, c, ws, m, n, k, vec_a,
                                          vec_b, nsplit, s);
  else if (ta)
    err = launch_form<AT, BT, true, false>(form, a, b, c, ws, m, n, k, vec_a,
                                           vec_b, nsplit, s);
  else if (tb)
    err = launch_form<AT, BT, false, true>(form, a, b, c, ws, m, n, k, vec_a,
                                           vec_b, nsplit, s);
  else
    err = launch_form<AT, BT, false, false>(form, a, b, c, ws, m, n, k,
                                            vec_a, vec_b, nsplit, s);
  if (err != 0 || nsplit == 1 || form == ROWS) return err;
  const long long total = (long long)m * n;
  gemv_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, c, total,
                                                              nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace exact

// ---------------------------------------------------------------------------
// The tensor-core forms: the tile path (bf16 x bf16, and bf16 x the three
// bf16 parts of a split f32 operand) and the decode rows' weight stream
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TBM = 128, TBK = 64;
// float16 products are exact in f32 as bf16 ones are, but the tensor cores
// add each k16 step's sum into the f32 accumulator without rounding to
// nearest, each add dropping up to 2^-23 of the partial sum, all one way:
// up to 8192 terms (512 adds) that stays near 2^-14 of the sum, within the
// card tests' 1e-4 of max|C|; past it each 64-k stage is promoted with f32
// adds, as on the split route
constexpr int F16_PROMOTE_K = 8192;

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
// B stored (K, N) (not TB); F16: float16 operands, else bf16.  An int32
// accumulator takes int8 operands (s8 x s8 -> s32, k32 a step), both
// K-major: 8-bit wgmma has no transpose bits.
template <int BN, int TA, int TB, bool F16, typename Acc>
__device__ __forceinline__ void wgmma_tile(Acc (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (std::is_same_v<Acc, int32_t>) {
    static_assert(TA == 0 && TB == 1 && !F16, "int8 wgmma: K-major only");
    wgmma_s8<BN>(d, a, b, scale_d);
  } else if constexpr (BN == 256) {
    wgmma_ss_t256<TA, 1 - TB, F16>(d, a, b, scale_d);
  } else {
    wgmma_ss_t128<TA, 1 - TB, F16>(d, a, b, scale_d);
  }
}

// a pair of accumulator entries as one 8-byte store
__device__ __forceinline__ float2 pair2(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ int2 pair2(int32_t x, int32_t y) {
  return make_int2(x, y);
}

// C = op(A) op(B), 128 x BN tiles over all of K, a persistent block
// walking its tiles.  A stored (M, K) (TA = 0,
// K-major) or (K, M) (TA = 1, MN-major); B stored (N, K) (TB = 1,
// K-major) or (K, N) (TB = 0, MN-major).  A split f32 operand comes as its
// three bf16 parts (PA or PB = 3): three wgmmas a k-step into the same
// accumulator, the other operand's tile read once.
// EX: the expert form, E products op(A[e]) (M, K) op(B[e]) (K, N) -> C[e]
// (M, N): the tiles of expert e follow those of e - 1, and A, B and C are
// rank-3 tensor maps with the expert outermost, so each expert's ragged
// k, row and column edges read as zeros (and stores clip) inside that
// expert.  Three forms: the forward (bf16 x bf16, A (M, K), B (K, N)) and
// its two VJP forms, dx = g w^T (A the split f32 g (M, K), B w stored (N,
// K)) and dw = x^T g (A x stored (K, M), B the split g (K, N)).
// F16: both operands float16 (the 2-D form or the head form, unsplit):
// the same ring, swizzle and warps, wgmma on f16.  PROMOTE: each 64-k
// stage's products go to a fresh tile of registers, added into the
// accumulator with f32 adds (the split route always; 2-D float16 past
// F16_PROMOTE_K).  HM: the head form, E = the heads; A's and B's maps have
// the head as their middle coordinate (box (c, head, row)), C's is the
// expert form's.  I8: the int8 tile, the expert form's x w^T on int8
// operands (both K-major, as 8-bit wgmma wants them): a stage is 128 k of
// the same 128-byte rows (so the ring's bytes, the swizzle and the
// descriptors' 32-byte k-steps are bf16's), wgmma s8 x s8 into int32
// accumulators, C int32 through an int32 map.
template <int BN, int TA, int TB, int PA, int PB, bool EX = false,
          bool F16 = false, bool PROMOTE = (PA * PB > 1), bool HM = false,
          bool I8 = false>
__global__ void __launch_bounds__(384, 1)
gemm_tc(const __grid_constant__ TileMaps maps, void* __restrict__ Cv, int M,
        int N, int K, int tma_c, int n_fast, int E) {
  static_assert(!EX || (TA == 0 && TB == 0 && PA == 1 && PB == 1) ||
                    (TA == 0 && TB == 1 && PA == 1 && PB == 1) ||
                    (TA == 0 && TB == 1 && PA == 3 && PB == 1) ||
                    (TA == 1 && TB == 0 && PA == 1 && PB == 3),
                "the expert and head forms: x w, x w^T, g w^T (g split), "
                "x^T g (g split)");
  static_assert(!HM || (EX && TA == 0 && PA == 1 && PB == 1 && !PROMOTE),
                "the head form: x w or x w^T, unsplit, bf16 or float16");
  static_assert(!F16 || (PA == 1 && PB == 1 && (!EX || HM)),
                "float16 takes the 2-D or the head form, unsplit");
  static_assert(!I8 || (EX && !HM && !F16 && !PROMOTE && TA == 0 &&
                        TB == 1 && PA == 1 && PB == 1),
                "int8 takes the stacked x w^T form, both operands K-major");
  static_assert(!PROMOTE || BN == 128, "the stage tiles fit at BN = 128");
  using L = TileSmem<BN, PA, PB>;
  using Acc = std::conditional_t<I8, int32_t, float>;
  using Acc2 = decltype(pair2(Acc(), Acc()));
  Acc* const C = static_cast<Acc*>(Cv);
  constexpr int S = L::STAGES;
  // k elements a stage: a 128-byte row of bf16 / f16, or of int8
  constexpr int KS = I8 ? 2 * TBK : TBK;
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

  const int KT = (K + KS - 1) / KS;
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
    // the head form's few tiles a block are latency-bound: fetch the
    // maps while the barriers settle
    if constexpr (HM) {
      prefetch_map(&maps.a[0]);
      prefetch_map(&maps.b[0]);
      if (tma_c) prefetch_map(&maps.c);
    }
  }
  __syncthreads();

  // Persistent: block b takes output tiles b, b + gridDim.x, ...; the
  // ring's k-steps count on across tiles, so the producer loads the next
  // tile while the consumers store this one.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full by TMA ----
    setmaxnreg_dec<24>();
    // a rank-3 box at (c, row, matrix e): the head form's maps take the
    // head as their middle coordinate
    auto load3 = [&](void* dst, const CUtensorMap* map, uint64_t* bar,
                     int c, int r, int e) {
      if constexpr (HM)
        tma_load_3d(dst, map, bar, c, e, r);
      else
        tma_load_3d(dst, map, bar, c, r, e);
    };
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int e, m0, n0;
        origin(tile, e, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S, k0 = kt * KS;
          mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full + s, L::STAGE);
#pragma unroll
          for (int h = 0; h < PA; ++h) {
            if constexpr (TA && EX) {
              tma_load_3d(a_tile(s, h), &maps.a[h], full + s, m0, k0, e);
              tma_load_3d(a_tile(s, h) + 8192, &maps.a[h], full + s,
                          m0 + 64, k0, e);
            } else if constexpr (TA) {
              tma_load_2d(a_tile(s, h), &maps.a[h], full + s, m0, k0);
              tma_load_2d(a_tile(s, h) + 8192, &maps.a[h], full + s,
                          m0 + 64, k0);
            } else if constexpr (EX) {
              load3(a_tile(s, h), &maps.a[h], full + s, k0, m0, e);
            } else {
              tma_load_2d(a_tile(s, h), &maps.a[h], full + s, k0, m0);
            }
          }
#pragma unroll
          for (int h = 0; h < PB; ++h) {
            if constexpr (TB && EX) {
              load3(b_tile(s, h), &maps.b[h], full + s, k0, n0, e);
            } else if constexpr (TB) {
              tma_load_2d(b_tile(s, h), &maps.b[h], full + s, k0, n0);
            } else {
#pragma unroll
              for (int c = 0; c < BN / 64; ++c) {
                if constexpr (EX)
                  load3(b_tile(s, h) + c * 8192, &maps.b[h], full + s,
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
    // k (the vocab), so there (and for float16 past F16_PROMOTE_K) each
    // stage's products go to a fresh tile of registers, added into `acc`
    // in f32 while the next stage runs.
    Acc acc[BN / 2];
    int it0 = 0;                  // the ring's k-steps before this tile
    // stage it0 + kt's products into d
    auto issue = [&](int kt, Acc (&d)[BN / 2]) {
      const int it = it0 + kt, s = it % S;
      mbar_wait(full + s, (it / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
#pragma unroll
        for (int ha = 0; ha < PA; ++ha)
#pragma unroll
          for (int hb = 0; hb < PB; ++hb)
            wgmma_tile<BN, TA, TB, F16>(
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
      for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
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
        Acc t0[BN / 2], t1[BN / 2];
        // stage kt's products are in `t`: add them, release the stage
        auto fold = [&](int kt, Acc (&t)[BN / 2]) {
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
      // the head form at m <= 64 (MLA's decode batches): the second
      // warpgroup's rows are all past M, and nothing of them is stored
      if constexpr (HM) {
        if (m0 + wg * 64 >= M) continue;
      }

      // C (f32, or int32 from the int8 tile, in the same layout): thread
      // (warp, lane) holds rows 16 warp + lane / 4 (+ 8), columns 8 j + 2
      // (lane % 4) (+ 1).  With tma_c, 64 columns at a time go through
      // the warpgroup's staging buffer and out by TMA (which clips the
      // ragged edge), so the stores drain while the next tile's products
      // run; else they are stored from registers, masked.
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
              Acc* dst = reinterpret_cast<Acc*>(
                  cw + (cl / 32) * 8192 + rr * 128 +
                  (((cb / 4) ^ (rr % 8)) << 4) + (cb % 4) * 4);
              *reinterpret_cast<Acc2*>(dst) =
                  pair2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
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
          Acc* row = C + ((size_t)e * M + r) * N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = n0 + 8 * j + 2 * (lane % 4);
            const Acc x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
            if (pairs && c + 1 < N) {
              *reinterpret_cast<Acc2*>(row + c) = pair2(x0, x1);
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

template <int BN, int TA, int TB, int PA, int PB, bool EX = false,
          bool F16 = false, bool PROMOTE = (PA * PB > 1), bool HM = false,
          bool I8 = false>
int launch_tile_t(const TileMaps& maps, void* c, int m, int n, int k,
                  int tma_c, int n_fast, cudaStream_t s, int e = 1) {
  constexpr size_t smem = TileSmem<BN, PA, PB>::BYTES;
  auto kern = gemm_tc<BN, TA, TB, PA, PB, EX, F16, PROMOTE, HM, I8>;
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

template <int BN, int PA, int PB, bool F16 = false,
          bool PROMOTE = (PA * PB > 1)>
int launch_tile_parts(int ta, int tb, const TileMaps& maps, float* c, int m,
                      int n, int k, int tma_c, int n_fast, cudaStream_t s) {
  if (ta && tb)
    return launch_tile_t<BN, 1, 1, PA, PB, false, F16, PROMOTE>(
        maps, c, m, n, k, tma_c, n_fast, s);
  if (ta)
    return launch_tile_t<BN, 1, 0, PA, PB, false, F16, PROMOTE>(
        maps, c, m, n, k, tma_c, n_fast, s);
  if (tb)
    return launch_tile_t<BN, 0, 1, PA, PB, false, F16, PROMOTE>(
        maps, c, m, n, k, tma_c, n_fast, s);
  return launch_tile_t<BN, 0, 0, PA, PB, false, F16, PROMOTE>(
      maps, c, m, n, k, tma_c, n_fast, s);
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

// BN of the tiles over e (m, n) outputs (a 2-D product is e = 1): 256
// where the 256-wide tiles fill the SMs, else 128
static inline int tile_bn(int e, int m, int n) {
  const long long tiles256 =
      (long long)e * ((m + TBM - 1) / TBM) * ((n + 255) / 256);
  return tiles256 >= sm_count() ? 256 : 128;
}

// The tile path; `a[1..2]` / `b[1..2]` the mid and lo parts of a split
// operand (null when it is bf16); a_ld / b_ld the stored rows' pitch; f16:
// both operands float16 (none split).  BN = 256 where its tiles fill the
// SMs (nothing split, no promotion), else 128.  C leaves by TMA when its
// rows are a multiple of 16 bytes.
int launch_tile(const void* const a[3], const void* const b[3], float* c,
                int m, int n, int k, int ta, int tb, int a_ld, int b_ld,
                int f16, cudaStream_t s) {
  const int pa = a[1] ? 3 : 1, pb = b[1] ? 3 : 1;
  if (f16 && (pa != 1 || pb != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool promote = f16 && k > F16_PROMOTE_K;
  const int bn = pa == 1 && pb == 1 && !promote ? tile_bn(1, m, n) : 128;
  TileMaps maps;
  int err = 0;
  for (int h = 0; h < pa && err == 0; ++h)
    err = ta ? encode_matrix_map(&maps.a[h], a[h], k, m, 64, a_ld, f16)
             : encode_matrix_map(&maps.a[h], a[h], m, k, TBM, a_ld, f16);
  for (int h = 0; h < pb && err == 0; ++h)
    err = tb ? encode_matrix_map(&maps.b[h], b[h], n, k, bn, b_ld, f16)
             : encode_matrix_map(&maps.b[h], b[h], k, n, 64, b_ld, f16);
  const int tma_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (err == 0 && tma_c) err = encode_out_map(&maps.c, c, m, n);
  if (err != 0) return err;
  const int n_fast = (long long)m * pa > (long long)n * pb;   // A larger
  if (promote)
    return launch_tile_parts<128, 1, 1, true, true>(ta, tb, maps, c, m, n, k,
                                                    tma_c, n_fast, s);
  if (f16 && bn == 256)
    return launch_tile_parts<256, 1, 1, true>(ta, tb, maps, c, m, n, k,
                                              tma_c, n_fast, s);
  if (f16)
    return launch_tile_parts<128, 1, 1, true>(ta, tb, maps, c, m, n, k,
                                              tma_c, n_fast, s);
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

// The element types of the rank-3 maps: 16-bit operands, int8 operands,
// and the 4-byte outputs
enum class Elem { bf16, f16, s8, f32, s32 };

// The rank-3 map of E (rows, cols) matrices whose rows lie row_st
// elements apart and whose matrices lie mat_st apart, the columns
// contiguous (operands in boxes of box_rows rows x 128 bytes, 64 bf16 or
// f16 or 128 int8, 128-byte swizzled; the f32 or int32 output in boxes of
// 64 rows x 32 columns, swizzled as the staging buffer is written): what
// lies past a matrix's rows or columns reads as zeros (or is not stored),
// whatever the next matrix or the view's other columns hold.  The
// dimensions go in stride order: (cols, rows, E), box (c, r, e), where
// the matrices are stacked (mid
// false, the expert form); (cols, E, rows), box (c, e, r), where the
// matrix axis lies between the two (mid, the head form's head-middle
// views: a (m, h, k) activation, a (k, h, n) or (n, h, k) slice of a
// weight table), which is the same 2-D box in shared memory.  Needs a
// 16-byte aligned base and both strides a multiple of 16 bytes.
static inline int encode_rank3_map(CUtensorMap* map, const void* base,
                                   int E, int rows, int cols,
                                   long long row_st, long long mat_st,
                                   int box_rows, Elem el, bool mid) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool out = el == Elem::f32 || el == Elem::s32;
  const cuuint64_t es = out ? 4 : el == Elem::s8 ? 1 : 2;
  const cuuint32_t inner = (cuuint32_t)(128 / es);  // one swizzled row
  const cuuint64_t dims[3] = {(cuuint64_t)cols,
                              (cuuint64_t)(mid ? E : rows),
                              (cuuint64_t)(mid ? rows : E)};
  const cuuint64_t strides[2] = {(cuuint64_t)(mid ? mat_st : row_st) * es,
                                 (cuuint64_t)(mid ? row_st : mat_st) * es};
  const cuuint32_t box[3] = {inner, mid ? 1u : (cuuint32_t)box_rows,
                             mid ? (cuuint32_t)box_rows : 1u};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      el == Elem::f32   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : el == Elem::s32 ? CU_TENSOR_MAP_DATA_TYPE_INT32
      : el == Elem::s8  ? CU_TENSOR_MAP_DATA_TYPE_UINT8   // bytes as stored
      : el == Elem::f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = fn(
      map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      !out && (cols * es) % 128 == 0 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                                     : CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// E row-major (rows, cols) matrices one after another (the expert form)
static inline int encode_expert_map(CUtensorMap* map, const void* base,
                                    int E, int rows, int cols, int box_rows,
                                    Elem el) {
  return encode_rank3_map(map, base, E, rows, cols, cols,
                          (long long)rows * cols, box_rows, el, false);
}

// C's rank-3 map over e row-major (m, n) outputs of `el` (f32 or s32),
// where TMA can store the rows (n a multiple of 4, a 16-byte base;
// *tma_c says so); else the epilogue stores them itself
static inline int encode_stack_out(TileMaps& maps, void* c, int e, int m,
                                   int n, Elem el, int* tma_c) {
  *tma_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  return *tma_c ? encode_expert_map(&maps.c, c, e, m, n, 64, el) : 0;
}

// The expert forms on the tile path, c (E, m, n) f32 = op(a) op(b) per
// expert: the forward x (E, m, k) w (E, k, n), bf16 (BN = 256 where its
// tiles fill the SMs); dx = g w^T, a = g (E, m, k) as its three bf16
// parts, b = w stored (E, n, k) (tb); dw = x^T g, a = x stored (E, k, m)
// (ta), b = g (E, k, n) as its three parts.  Other forms are refused.
int launch_tile_expert(const void* const a[3], const void* const b[3],
                       float* c, int e, int m, int n, int k, int ta, int tb,
                       cudaStream_t s) {
  const int pa = a[1] ? 3 : 1, pb = b[1] ? 3 : 1;
  const bool fwd = pa == 1 && pb == 1 && !ta && !tb;
  const bool dx = pa == 3 && pb == 1 && !ta && tb;
  const bool dw = pa == 1 && pb == 3 && ta && !tb;
  if (!(fwd || dx || dw)) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = fwd ? tile_bn(e, m, n) : 128;
  TileMaps maps;
  int err = 0;
  for (int h = 0; h < pa && err == 0; ++h)
    err = ta ? encode_expert_map(&maps.a[h], a[h], e, k, m, 64, Elem::bf16)
             : encode_expert_map(&maps.a[h], a[h], e, m, k, TBM, Elem::bf16);
  for (int h = 0; h < pb && err == 0; ++h)
    err = tb ? encode_expert_map(&maps.b[h], b[h], e, n, k, bn, Elem::bf16)
             : encode_expert_map(&maps.b[h], b[h], e, k, n, 64, Elem::bf16);
  int tma_c = 0;
  if (err == 0) err = encode_stack_out(maps, c, e, m, n, Elem::f32, &tma_c);
  if (err != 0) return err;
  const int n_fast = (long long)m * pa > (long long)n * pb;   // A larger
  if (dx)
    return launch_tile_t<128, 0, 1, 3, 1, true>(maps, c, m, n, k, tma_c,
                                                n_fast, s, e);
  if (dw)
    return launch_tile_t<128, 1, 0, 1, 3, true>(maps, c, m, n, k, tma_c,
                                                n_fast, s, e);
  if (bn == 256)
    return launch_tile_t<256, 0, 0, 1, 1, true>(maps, c, m, n, k, tma_c,
                                                n_fast, s, e);
  return launch_tile_t<128, 0, 0, 1, 1, true>(maps, c, m, n, k, tma_c,
                                              n_fast, s, e);
}

template <bool F16>
int launch_head_t(int tb, int bn, const TileMaps& maps, float* c, int m,
                  int n, int k, int tma_c, int n_fast, cudaStream_t s, int h) {
  if (tb && bn == 256)
    return launch_tile_t<256, 0, 1, 1, 1, true, F16, false, true>(
        maps, c, m, n, k, tma_c, n_fast, s, h);
  if (tb)
    return launch_tile_t<128, 0, 1, 1, 1, true, F16, false, true>(
        maps, c, m, n, k, tma_c, n_fast, s, h);
  if (bn == 256)
    return launch_tile_t<256, 0, 0, 1, 1, true, F16, false, true>(
        maps, c, m, n, k, tma_c, n_fast, s, h);
  return launch_tile_t<128, 0, 0, 1, 1, true, F16, false, true>(
      maps, c, m, n, k, tma_c, n_fast, s, h);
}

// The head form on the tile path, c (h, m, n) f32 = x[:, e] w[:, e] per
// head e: x (m, h, k) bf16 (f16: both operands float16), rows x_row and
// heads x_head elements apart; w (k, h, n), or (n, h, k) with tb, rows
// (its first axis) w_row and heads w_head apart (BN = 256 where its tiles
// fill the SMs).  Every stride is that of a real axis: the caller gives
// an axis of one element the stride its contiguous copy would have.
// float16 takes no promotion: k is at most F16_PROMOTE_K.
int launch_tile_head(const void* x, const void* w, float* c, int h, int m,
                     int n, int k, int tb, long long x_row, long long x_head,
                     long long w_row, long long w_head, int f16,
                     cudaStream_t s) {
  if (f16 && k > F16_PROMOTE_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Elem el = f16 ? Elem::f16 : Elem::bf16;
  const int bn = tile_bn(h, m, n);
  TileMaps maps;
  int err = encode_rank3_map(&maps.a[0], x, h, m, k, x_row, x_head, TBM, el,
                             true);
  if (err == 0)
    err = tb ? encode_rank3_map(&maps.b[0], w, h, n, k, w_row, w_head, bn,
                                el, true)
             : encode_rank3_map(&maps.b[0], w, h, k, n, w_row, w_head, 64,
                                el, true);
  int tma_c = 0;
  if (err == 0) err = encode_stack_out(maps, c, h, m, n, Elem::f32, &tma_c);
  if (err != 0) return err;
  const int n_fast = m > n;                      // A larger
  return f16 ? launch_head_t<true>(tb, bn, maps, c, m, n, k, tma_c, n_fast,
                                   s, h)
             : launch_head_t<false>(tb, bn, maps, c, m, n, k, tma_c, n_fast,
                                    s, h);
}

// The int8 tile, c (e, m, n) int32 = a[e] b[e]^T: a (e, m, k) and b (e, n,
// k) int8, both K-major (8-bit wgmma reads no other), each matrix's rows
// a_ld / b_ld bytes apart (a multiple of 16: TMA's row stride; the K-major
// pack's k_pad, or k where an operand is read in place) and its matrices
// rows x ld apart, bases 16-byte aligned; the expert form's persistent
// walk and rank-3 maps, BN = 256 where its tiles fill the SMs.  The maps
// span k columns, so the k loop covers k_pad and TMA's zero fill past k
// (or the pack's zeros) adds nothing.  Exact: every product and sum is an
// integer.
int launch_tile_int8(const void* a, const void* b, int32_t* c, int e, int m,
                     int n, int k, long long a_ld, long long b_ld,
                     cudaStream_t s) {
  const int bn = tile_bn(e, m, n);
  TileMaps maps;
  int err = encode_rank3_map(&maps.a[0], a, e, m, k, a_ld, m * a_ld, TBM,
                             Elem::s8, false);
  if (err == 0)
    err = encode_rank3_map(&maps.b[0], b, e, n, k, b_ld, n * b_ld, bn,
                           Elem::s8, false);
  int tma_c = 0;
  if (err == 0) err = encode_stack_out(maps, c, e, m, n, Elem::s32, &tma_c);
  if (err != 0) return err;
  const int n_fast = m > n;                      // A larger
  if (bn == 256)
    return launch_tile_t<256, 0, 1, 1, 1, true, false, false, false, true>(
        maps, c, m, n, k, tma_c, n_fast, s, e);
  return launch_tile_t<128, 0, 1, 1, 1, true, false, false, false, true>(
      maps, c, m, n, k, tma_c, n_fast, s, e);
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

// rows x cols f32 (rows cols apart) -> the three parts, rows `pitch`
// (a multiple of 8) apart, zeros past cols: eight columns a thread, one
// 16-byte store a part
__global__ void split_bf16(const float* __restrict__ g, bf16* __restrict__ hi,
                           bf16* __restrict__ mid, bf16* __restrict__ lo,
                           long long rows, int cols, int pitch) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = pitch / 8;
  if (v >= rows * per) return;
  const long long r = v / per;
  const int c0 = (int)(v % per) * 8;
  const float* src = g + r * cols + c0;
  float x[8];
  if (c0 + 8 <= cols && cols % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const float4 p = *reinterpret_cast<const float4*>(src);
    const float4 q = *reinterpret_cast<const float4*>(src + 4);
    x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w;
    x[4] = q.x, x[5] = q.y, x[6] = q.z, x[7] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = c0 + e < cols ? src[e] : 0.f;
  }
  uint32_t h[4], m[4], w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bf16 h0, m0, w0, h1, m1, w1;
    split3(x[2 * e], h0, m0, w0);
    split3(x[2 * e + 1], h1, m1, w1);
    h[e] = __bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
    m[e] = __bfloat16_as_ushort(m0) | ((uint32_t)__bfloat16_as_ushort(m1) << 16);
    w[e] = __bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
  }
  const long long o = r * pitch + c0;
  *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(mid + o) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(lo + o) = make_uint4(w[0], w[1], w[2], w[3]);
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

__device__ __forceinline__ uint4 ld_stream(const void* p) {
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
// blockIdx.z is the expert.  The head form stacks one product a head,
// each operand read through its strides (st): x rows x_row apart and
// heads x_ex apart, w's stored rows (k, or n with TB) w_row apart and
// heads w_ex apart, so a slice of a (K, H, N) table is read in place; out
// (H, M, N).
struct GemvStrides {
  long long x_row, x_ex, w_row, w_ex;
};

template <bool TB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
         float* __restrict__ out, float* __restrict__ ws, int M, int N,
         int K, int nsplit, GemvStrides st) {
  __shared__ float red[GEMV_WARPS - 1][32][33];
  const size_t ex = blockIdx.z;
  x += ex * st.x_ex;
  w += ex * st.w_ex;
  out += ex * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * GEMV_COLS;
  const int units = K / GEMV_UNIT;
  const int per = (units + nsplit - 1) / nsplit;
  const int u0 = blockIdx.y * per, u1 = min(units, u0 + per);
  const bool row0 = g < M, row1 = g + 8 < M;
  const bf16* x0 = x + g * st.x_row;
  const bf16* x1 = x + (g + 8) * st.x_row;
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
        wv[j] = n < N ? ld_stream(w + n * st.w_row + k0 + 8 * t) : zero;
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
          wr[h][r] = col_ok ? ld_stream(w + (k0 + 16 * h + 4 * t + r) * st.w_row +
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

// st: null for row-major operands (x (e, m, k), w (e, k, n) or (e, n, k))
int launch_gemv(const void* x, const void* w, float* c, float* ws, int m,
                int n, int k, int tb, int nsplit, cudaStream_t s,
                int e = 1, const GemvStrides* st = nullptr) {
  if (m < 1 || m > 16 || k % GEMV_UNIT != 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr) || e < 1 || e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemvStrides dense = {k, (long long)m * k, tb ? k : n,
                             (long long)k * n};
  const GemvStrides& S = st ? *st : dense;
  const dim3 grid((n + GEMV_COLS - 1) / GEMV_COLS, nsplit, e);
  auto X = static_cast<const bf16*>(x);
  auto W = static_cast<const bf16*>(w);
  if (tb)
    gemv_mma<true><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n, k,
                                                    nsplit, S);
  else
    gemv_mma<false><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n, k,
                                                     nsplit, S);
  if (nsplit > 1) {
    const long long total = (long long)e * m * n;
    gemv_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, c, total,
                                                                nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the int8 decode rows: the head form's m <= 16 rows in int8 ----
//
// The int8 twin of gemv_mma for K1's head form at acc_dtype int32 (MLA's
// absorbed products with int8 operands, at most 16 rows): x and w read
// through the same row and head strides (GemvStrides, bytes here), the
// weight streamed once with 16-byte non-allocating loads into mma.sync
// m16n8k32 s8 x s8 -> s32 fragments.  Bound, as the bf16 rows: the bytes
// of the weight (q_lat's 0.66 MB at minicpm3-4b's decode, 0.0002 ms at
// 3.35 TB/s), in truth the launch; one launch (and the split's int32
// reduce) where K9's integer TILE ran on row-major copies at one IMAD a
// term.
//   TB (w stored (N, K), q_lat): units of 64 k; thread (g, t) loads k 16 t
//   .. 16 t + 15 of the unit of row n = nb + 8 j + g and of x's rows g and
//   g + 8, and its two halves are two m16n8k32 products, the k order
//   permuted alike in x and w (every product is paired once, so the
//   integer sums are the same); a last unit of 32 k reads zeros in its
//   upper half.  64 columns a block, as gemv_mma.
//   !TB (w stored (K, N), out): units of 32 k, one m16n8k32 product; thread
//   (g, t) loads columns nb + 16 g .. + 15 of k rows 4 t .. 4 t + 3 and 16 +
//   4 t .. + 3 (eight 16-byte loads) and turns each column's four bytes of
//   a k quad into one fragment word by a 4 x 4 byte transpose (__byte_perm,
//   as i8::transpose below); tile j is the columns nb + 16 g + j, 128
//   columns a block, N a multiple of 16.
// The four warps' sums are added in warp order; with nsplit > 1 a block
// writes its split's partial into the int32 workspace, summed by
// gemv_reduce.  Integer adds wrap (two's complement, as the reference's
// int32 accumulator) and are associative: any order gives the same bits.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four rows' words w[0..3] (4 bytes each, one column a byte) -> o[j], the
// four rows' bytes of column j (row i in byte i)
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t u0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u1 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, u0, 0x5410);
  o[1] = __byte_perm(t0, u0, 0x7632);
  o[2] = __byte_perm(t1, u1, 0x5410);
  o[3] = __byte_perm(t1, u1, 0x7632);
}

// columns a block and k a unit of the int8 decode rows (ops.K1_GEMV8)
__host__ __device__ constexpr int gemv8_cols(bool tb) {
  return tb ? 64 : 128;
}
__host__ __device__ constexpr int gemv8_unit(bool tb) {
  return tb ? 64 : 32;
}

template <bool TB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_mma_s8(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            int32_t* __restrict__ out, int32_t* __restrict__ ws, int M,
            int N, int K, int nsplit, GemvStrides st) {
  constexpr int NT = TB ? 8 : 16;              // n8 tiles a warp
  constexpr int UNIT = gemv8_unit(TB);
  __shared__ int32_t red[GEMV_WARPS - 1][4 * NT][33];
  const size_t ex = blockIdx.z;
  x += ex * st.x_ex;
  w += ex * st.w_ex;
  out += ex * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * gemv8_cols(TB);
  const int units = (K + UNIT - 1) / UNIT;
  const int per = (units + nsplit - 1) / nsplit;
  const int u0 = blockIdx.y * per, u1 = min(units, u0 + per);
  const bool row0 = g < M, row1 = g + 8 < M;
  const int8_t* x0 = x + g * st.x_row;
  const int8_t* x1 = x + (g + 8) * st.x_row;
  int32_t acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);

#pragma unroll 2
  for (int u = u0 + warp; u < u1; u += GEMV_WARPS) {
    const int k0 = u * UNIT;
    if constexpr (TB) {
      const bool in = k0 + 16 * t < K;     // a last unit of 32 k: zeros
      uint4 wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb + 8 * j + g;
        wv[j] = in && n < N ? ld_stream(w + n * st.w_row + k0 + 16 * t)
                            : zero;
      }
      const uint4 xa = in && row0 ? *reinterpret_cast<const uint4*>(
                                        x0 + k0 + 16 * t)
                                  : zero;
      const uint4 xb = in && row1 ? *reinterpret_cast<const uint4*>(
                                        x1 + k0 + 16 * t)
                                  : zero;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_s8(acc[j], xa.x, xb.x, xa.y, xb.y, wv[j].x, wv[j].y);
        mma_s8(acc[j], xa.z, xb.z, xa.w, xb.w, wv[j].z, wv[j].w);
      }
    } else {
      const bool col_ok = nb + 16 * g < N;
      uint4 wr[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wr[h][r] = col_ok ? ld_stream(w + (k0 + 16 * h + 4 * t + r) *
                                                st.w_row + nb + 16 * g)
                            : zero;
      auto x32 = [&](const int8_t* row, bool ok, int kk) {
        return ok ? *reinterpret_cast<const uint32_t*>(row + kk) : 0u;
      };
      const uint32_t xa0 = x32(x0, row0, k0 + 4 * t);
      const uint32_t xa1 = x32(x0, row0, k0 + 16 + 4 * t);
      const uint32_t xb0 = x32(x1, row1, k0 + 4 * t);
      const uint32_t xb1 = x32(x1, row1, k0 + 16 + 4 * t);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t rows[4] = {word(wr[h][0], q), word(wr[h][1], q),
                                    word(wr[h][2], q), word(wr[h][3], q)};
          transpose4x4(rows, b[h]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          mma_s8(acc[4 * q + jj], xa0, xb0, xa1, xb1, b[0][jj], b[1][jj]);
      }
    }
  }

  // the warps' sums in warp order (wrapping adds)
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp - 1][4 * j + e][lane] = acc[j][e];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int q = 0; q < GEMV_WARPS - 1; ++q)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = static_cast<int32_t>(
            static_cast<uint32_t>(acc[j][e]) +
            static_cast<uint32_t>(red[q][4 * j + e][lane]));
  int32_t* dst = nsplit == 1
                     ? out
                     : ws + ((size_t)blockIdx.y * gridDim.z + ex) * M * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);
      const int n = TB ? nb + 8 * j + 2 * t + (e % 2)
                       : nb + 16 * (2 * t + (e % 2)) + j;
      if (r < M && n < N) dst[(size_t)r * N + n] = acc[j][e];
    }
}

int launch_gemv_s8(const void* x, const void* w, int32_t* c, int32_t* ws,
                   int m, int n, int k, int tb, int nsplit, cudaStream_t s,
                   int e, const GemvStrides& st) {
  if (m < 1 || m > 16 || k < 32 || k % 32 != 0 || n < 1 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr) || e < 1 || e > 65535 ||
      (!tb && n % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = gemv8_cols(tb);
  const dim3 grid((n + cols - 1) / cols, nsplit, e);
  auto X = static_cast<const int8_t*>(x);
  auto W = static_cast<const int8_t*>(w);
  if (tb)
    gemv_mma_s8<true><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n, k,
                                                       nsplit, st);
  else
    gemv_mma_s8<false><<<grid, GEMV_WARPS * 32, 0, s>>>(X, W, c, ws, m, n,
                                                        k, nsplit, st);
  if (nsplit > 1) {
    const long long total = (long long)e * m * n;
    gemv_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, c, total,
                                                                nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the K-major pack of an int8 operand for the int8 tile ----
//
// No TPU kernel: the int8 tile's input stage.  8-bit wgmma reads K-major
// operands only, and TMA rows of a multiple of 16 bytes from a 16-byte
// base.  An operand stored MN-major (B (k, n); A (k, m) with transpose_a;
// either as a stack) is written once K-major into a workspace (rows,
// k_pad), k_pad = k rounded up to 16, zeros past k (the sums stay exact, as
// TMA's zero fill keeps them); so is a K-major one whose rows or base TMA
// cannot read (k % 16 != 0, an unaligned base).  Bound: its bytes, each
// read and written once (32 MB for a 4096^2 pair, 0.0100 ms at 3.35
// TB/s): a 64 x 64-byte tile a block, one 16-byte load and one 16-byte
// store a thread (byte loads only at a ragged or unaligned edge); an
// MN-major tile goes through shared memory and is transposed there once, 4
// x 4 bytes a thread by byte permutes (transpose4x4), where the int8
// form transposes every stage in every block that reads it.  The
// transposed tile's 16-byte chunks are XOR-swizzled by row, so the
// threads' 4-byte writes spread over the banks and the 16-byte reads stay
// whole.
constexpr int PACK = 64, PACK_PITCH = PACK + 16;

template <bool MN>
__global__ void __launch_bounds__(256)
pack_kmajor_int8(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                 int rows, int k, int kp, long long ld, long long mat_st,
                 int vec) {
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * PACK, r0 = blockIdx.y * PACK;
  src += (long long)blockIdx.z * mat_st;
  dst += (long long)blockIdx.z * rows * kp;
  // 16 bytes of a stored row from element c on, zeros past its n elements
  auto load16 = [&](long long off, int c, int n) {
    if (vec && c + 16 <= n)
      return *reinterpret_cast<const uint4*>(src + off + c);
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (c + i < n)
        v[i / 4] |= (uint32_t)(uint8_t)src[off + c + i] << (8 * (i % 4));
    return make_uint4(v[0], v[1], v[2], v[3]);
  };
  const int r = tid / 4, q = tid % 4;          // a 16-byte chunk of a row
  if constexpr (MN) {
    __shared__ __align__(16) uint8_t raw[PACK * PACK_PITCH];   // [k][mn]
    __shared__ __align__(16) uint8_t tr[PACK * PACK];          // [mn][k]
    *reinterpret_cast<uint4*>(raw + r * PACK_PITCH + 16 * q) =
        k0 + r < k ? load16((long long)(k0 + r) * ld, r0 + 16 * q, rows)
                   : make_uint4(0, 0, 0, 0);
    __syncthreads();
    // the 4 x 4 block (k 4 kb.., mn 4 mb..); mn row 4 mb + j's chunk c
    // lands at chunk c ^ (mb % 4) of its row
    const int kb = tid / 16, mb = tid % 16;
    uint32_t wv[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = *reinterpret_cast<const uint32_t*>(
          raw + (4 * kb + i) * PACK_PITCH + 4 * mb);
    transpose4x4(wv, o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(tr + (4 * mb + j) * PACK +
                                   (((kb / 4) ^ (mb % 4)) * 16) +
                                   (kb % 4) * 4) = o[j];
    __syncthreads();
    if (r0 + r < rows && k0 + 16 * q < kp)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * kp + k0 +
                                16 * q) = *reinterpret_cast<const uint4*>(
          tr + r * PACK + ((q ^ ((r / 4) % 4)) * 16));
  } else {
    if (r0 + r < rows && k0 + 16 * q < kp)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * kp + k0 +
                                16 * q) =
          load16((long long)(r0 + r) * ld, k0 + 16 * q, k);
  }
}

}  // namespace tc


// ---- the int8 form: int8 x int8 -> int32, exact --------------------------
//
// The counterpart of emit_pallas at acc_dtype = int32 (the MXU's s8 x s8
// -> s32 product, preferred_element_type=int32): every product and every
// sum is an exact integer (wrapping past 2^31, as the reference's int32
// accumulator does).  A block computes a 128 x 128 tile of C with 8 warps
// (4 along m, 2 along n, 32 x 64 each) on mma.sync m16n8k32 s8 -> s32,
// over k in 64-deep stages of a three-stage ring.  mma.sync takes A row-
// major and B "col" (n-major), so both tiles are wanted K-contiguous in
// shared memory: an operand stored with k contiguous (A (m, k), B (n, k)
// with transpose_b) is copied as it lies; one stored with k strided (A
// (k, m) with transpose_a, B (k, n)) is copied as it lies and then
// transposed in shared memory, 4 x 4 bytes at a time by byte permutes.
// Copies are 16-byte cp.async where the contiguous extent is a multiple
// of 16 bytes and the base 16-byte aligned (the ring keeps two stages in
// flight), else byte loads through registers (ragged shapes), zero-filled
// past the matrix either way.  The expert form runs the same kernel with
// the expert as grid axis z, each operand's experts stored one after
// another.  Since the int8 tile took every int8 product (with the K-major
// pack for the operands 8-bit wgmma cannot read), no route reaches this
// form: it stays as the comparison on the same operands (chip_smoke.py's
// int8_form_ms), at 8% of its operations bound at 4096^3.
namespace i8 {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int KP = BK + 16;         // pitch of a K-contiguous tile row
constexpr int MNP = BM + 16;        // pitch of a copied MN-contiguous row
constexpr int TILE = BM * KP;       // bytes of a stage of one operand
constexpr int SMEM = (2 * STAGES + 2) * TILE;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand of a block: rows r0.. of its M (A) or N (B) axis.
struct Operand {
  const int8_t* p;   // this expert's matrix
  int rows;          // extent of the M / N axis
  int k;             // extent of K
  bool kmaj;         // stored with K contiguous
  bool vec;          // 16-byte copies
};

// Copy stage k0 of rows r0..r0+127 as it lies in memory: K-contiguous
// into t[r][KP], MN-contiguous into t[k][MNP].
__device__ __forceinline__ void fetch(const Operand& o, unsigned char* t,
                                      long long r0, long long k0) {
  if (o.kmaj) {
    const long long ld = o.k;
    if (o.vec) {
      for (int c = threadIdx.x; c < BM * BK / 16; c += THREADS) {
        const int r = c / (BK / 16), j = c % (BK / 16) * 16;
        const bool ok = r0 + r < o.rows && k0 + j < o.k;
        cp16(t + r * KP + j, ok ? o.p + (r0 + r) * ld + k0 + j : o.p, ok);
      }
    } else {
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, j = e % BK;
        const bool ok = r0 + r < o.rows && k0 + j < o.k;
        t[r * KP + j] = ok ? o.p[(r0 + r) * ld + k0 + j] : 0;
      }
    }
  } else {
    const long long ld = o.rows;
    if (o.vec) {
      for (int c = threadIdx.x; c < BK * BM / 16; c += THREADS) {
        const int kr = c / (BM / 16), j = c % (BM / 16) * 16;
        const bool ok = k0 + kr < o.k && r0 + j < o.rows;
        cp16(t + kr * MNP + j, ok ? o.p + (k0 + kr) * ld + r0 + j : o.p, ok);
      }
    } else {
      for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
        const int kr = e / BM, j = e % BM;
        const bool ok = k0 + kr < o.k && r0 + j < o.rows;
        t[kr * MNP + j] = ok ? o.p[(k0 + kr) * ld + r0 + j] : 0;
      }
    }
  }
}

// raw[k][MNP] -> out[mn][KP], a 4 x 4 byte block at a time
__device__ __forceinline__ void transpose(const unsigned char* raw,
                                          unsigned char* out) {
  for (int blk = threadIdx.x; blk < (BK / 4) * (BM / 4); blk += THREADS) {
    const int kb = blk / (BM / 4), mb = blk % (BM / 4);
    uint32_t w[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(raw + (4 * kb + i) * MNP +
                                                4 * mb);
    tc::transpose4x4(w, o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(out + (4 * mb + j) * KP + 4 * kb) = o[j];
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
gemm_int8(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
          int32_t* __restrict__ c, int m, int n, int k, int ta, int tb,
          int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring_a = smem;
  unsigned char* ring_b = smem + STAGES * TILE;
  unsigned char* t_a = smem + 2 * STAGES * TILE;
  unsigned char* t_b = t_a + TILE;
  const long long e = blockIdx.z;
  const Operand A = {a + e * m * (long long)k, m, k, !ta, vec_a != 0};
  const Operand B = {b + e * n * (long long)k, n, k, tb != 0, vec_b != 0};
  const long long m0 = (long long)blockIdx.y * BM, n0 =
      (long long)blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % 4 * 32, wn = warp / 4 * 64;
  int acc[2][8][4] = {};

  const int nk = (k + BK - 1) / BK;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) {
      fetch(A, ring_a + p * TILE, m0, (long long)p * BK);
      fetch(B, ring_b + p * TILE, n0, (long long)p * BK);
    }
    commit();
  }
  for (int s = 0; s < nk; ++s) {
    const int cur = s % STAGES;
    wait<STAGES - 2>();
    __syncthreads();   // stage s is in; every warp is done with stage s - 1
    if (s + STAGES - 1 < nk) {
      const int nxt = (s + STAGES - 1) % STAGES;
      fetch(A, ring_a + nxt * TILE, m0, (long long)(s + STAGES - 1) * BK);
      fetch(B, ring_b + nxt * TILE, n0, (long long)(s + STAGES - 1) * BK);
    }
    commit();
    const unsigned char* fa = ring_a + cur * TILE;
    const unsigned char* fb = ring_b + cur * TILE;
    if (!A.kmaj) transpose(fa, t_a);
    if (!B.kmaj) transpose(fb, t_b);
    if (!A.kmaj || !B.kmaj) __syncthreads();
    if (!A.kmaj) fa = t_a;
    if (!B.kmaj) fb = t_b;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* r = fa + (wm + 16 * i + g) * KP + kk + 4 * t4;
        af[i][0] = ld32(r);
        af[i][1] = ld32(r + 8 * KP);
        af[i][2] = ld32(r + 16);
        af[i][3] = ld32(r + 8 * KP + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* r = fb + (wn + 8 * j + g) * KP + kk + 4 * t4;
        bf[j][0] = ld32(r);
        bf[j][1] = ld32(r + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[i][j], af[i], bf[j]);
    }
  }

  int32_t* out = c + e * m * (long long)n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + 16 * i + g + 8 * h;
        const long long col = n0 + wn + 8 * j + 2 * t4;
        if (row >= m) continue;
        if (col < n) out[row * n + col] = acc[i][j][2 * h];
        if (col + 1 < n) out[row * n + col + 1] = acc[i][j][2 * h + 1];
      }
}

}  // namespace i8

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a_dtype / b_dtype: 0 = float32, 1 = bfloat16, per operand.  transpose_a:
// A is stored (k, m); transpose_b: B is stored (n, k).  vec_a / vec_b: the
// caller certifies 16-byte aligned rows (base pointer aligned and the row
// length a multiple of 16 bytes), allowing 16-byte copies.  bf16 x bf16
// without transpose_a runs gemm_bf16 (form < 0); every other form the FMA
// kernel's `form` (exact::Form, ops.fma_form) with k split over nsplit blocks
// (ops.fma_splits), the partials summed in split order: a tile's through
// ws (nsplit x m x n f32) and a second pass, the row form's in the
// cluster of its (at most 8) splits, ws null.
extern "C" int repro_gemm(const void* a, const void* b, void* c, void* ws,
                          int m, int n, int k, int transpose_a,
                          int transpose_b, int a_dtype, int b_dtype,
                          int vec_a, int vec_b, int form, int nsplit,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* C = static_cast<float*>(c);
  float* W = static_cast<float*>(ws);
  if ((a_dtype != 0 && a_dtype != 1) || (b_dtype != 0 && b_dtype != 1) ||
      nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dtype == 1 && b_dtype == 1 && !transpose_a) {
    if (form >= 0 || nsplit != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    auto A = static_cast<const __nv_bfloat16*>(a);
    auto B = static_cast<const __nv_bfloat16*>(b);
    if (transpose_b)
      gemm_bf16<true><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k, vec_a,
                                               vec_b);
    else
      gemm_bf16<false><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k, vec_a,
                                                vec_b);
    return static_cast<int>(cudaGetLastError());
  }
  using bf = __nv_bfloat16;
  if (a_dtype == 0 && b_dtype == 0)
    return exact::launch<float, float>(form, a, b, C, W, m, n, k, transpose_a,
                                     transpose_b, vec_a, vec_b, nsplit, s);
  if (a_dtype == 0)
    return exact::launch<float, bf>(form, a, b, C, W, m, n, k, transpose_a,
                                  transpose_b, vec_a, vec_b, nsplit, s);
  if (b_dtype == 0)
    return exact::launch<bf, float>(form, a, b, C, W, m, n, k, transpose_a,
                                  transpose_b, vec_a, vec_b, nsplit, s);
  return exact::launch<bf, bf>(form, a, b, C, W, m, n, k, transpose_a,
                             transpose_b, vec_a, vec_b, nsplit, s);
}

// The tile path: a, b bf16, or one of them the hi part of a split f32
// operand whose mid and lo parts are a_mid, a_lo (or b_mid, b_lo; null
// otherwise), or (f16 = 1) a, b both float16 and neither split; a_ld /
// b_ld the stored rows' pitch in elements (the parts of a split operand
// may be padded past its logical row), each a multiple of 8, bases
// 16-byte aligned, k >= 1.
extern "C" int repro_gemm_tc(const void* a, const void* a_mid,
                             const void* a_lo, const void* b,
                             const void* b_mid, const void* b_lo, void* c,
                             int m, int n, int k, int transpose_a,
                             int transpose_b, int a_ld, int b_ld, int f16,
                             void* stream) {
  if ((a_mid && b_mid) || (a_mid && !a_lo) || (b_mid && !b_lo) || k < 1 ||
      a_ld % 8 != 0 || b_ld % 8 != 0 || (f16 != 0 && f16 != 1) ||
      a_ld < (transpose_a ? m : k) || b_ld < (transpose_b ? k : n))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const as[3] = {a, a_mid, a_lo};
  const void* const bs[3] = {b, b_mid, b_lo};
  return tc::launch_tile(as, bs, static_cast<float*>(c), m, n, k,
                         transpose_a, transpose_b, a_ld, b_ld, f16,
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
  const void* const as[3] = {x, nullptr, nullptr};
  const void* const bs[3] = {w, nullptr, nullptr};
  return tc::launch_tile_expert(as, bs, static_cast<float*>(c), e, m, n, k,
                                0, 0, s);
}

// The head form: x (m, h, k) times w (k, h, n), or (n, h, k) with
// transpose_b, bf16, into c (h, m, n) f32, head by head, each operand read
// through its strides (elements; the last axis contiguous): x_row and
// x_head of x's m and h axes, w_row and w_head of w's first and h axes.
// m <= 16, k % 32 == 0, every stride a multiple of 8 elements and the
// bases 16-byte aligned; ws: nsplit x h x m x n f32 when nsplit > 1, the
// partials summed in split order.
extern "C" int repro_head_gemm(const void* x, const void* w, void* c,
                               void* ws, int h, int m, int n, int k,
                               int transpose_b, int nsplit, long long x_row,
                               long long x_head, long long w_row,
                               long long w_head, void* stream) {
  if ((x_row | x_head | w_row | w_head) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (!transpose_b && n % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::GemvStrides st = {x_row, x_head, w_row, w_head};
  return tc::launch_gemv(x, w, static_cast<float*>(c),
                         static_cast<float*>(ws), m, n, k, transpose_b,
                         nsplit, static_cast<cudaStream_t>(stream), h, &st);
}

// The head form's tile route: x (m, h, k) times w (k, h, n), or (n, h, k)
// with transpose_b, bf16, or (f16 = 1) both float16 with k at most
// F16_PROMOTE_K, into c (h, m, n) f32, strides as repro_head_gemm takes
// them (of real axes: an axis of one element is given the stride of its
// contiguous copy), each a positive multiple of 8 elements, bases 16-byte
// aligned, k and (without transpose_b) n multiples of 8.
extern "C" int repro_head_gemm_tc(const void* x, const void* w, void* c,
                                  int h, int m, int n, int k,
                                  int transpose_b, long long x_row,
                                  long long x_head, long long w_row,
                                  long long w_head, int f16, void* stream) {
  if (h < 1 || m < 1 || n < 1 || k < 8 || k % 8 != 0 ||
      (!transpose_b && n % 8 != 0) || x_row <= 0 || x_head <= 0 ||
      w_row <= 0 || w_head <= 0 || (x_row | x_head | w_row | w_head) % 8 ||
      (f16 != 0 && f16 != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_tile_head(x, w, static_cast<float*>(c), h, m, n, k,
                              transpose_b, x_row, x_head, w_row, w_head, f16,
                              static_cast<cudaStream_t>(stream));
}

// The expert VJP forms on the split route, c (e, m, n) f32: dx = g w^T
// (a, a_mid, a_lo the parts of g (e, m, k); b = w stored (e, n, k);
// transpose_b) and dw = x^T g (a = x stored (e, k, m), transpose_a; b,
// b_mid, b_lo the parts of g (e, k, n)).  Rows of a multiple of 16 bytes,
// bases 16-byte aligned, k >= 1.
extern "C" int repro_expert_gemm_split(const void* a, const void* a_mid,
                                       const void* a_lo, const void* b,
                                       const void* b_mid, const void* b_lo,
                                       void* c, int e, int m, int n, int k,
                                       int transpose_a, int transpose_b,
                                       void* stream) {
  if (e < 1 || k < 1 || (a_mid && !a_lo) || (b_mid && !b_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const as[3] = {a, a_mid, a_lo};
  const void* const bs[3] = {b, b_mid, b_lo};
  return tc::launch_tile_expert(as, bs, static_cast<float*>(c), e, m, n, k,
                                transpose_a, transpose_b,
                                static_cast<cudaStream_t>(stream));
}

// The three bf16 parts (hi, mid, lo) of a rows x cols f32 matrix (rows
// cols apart), each written rows `pitch` apart (a multiple of 8, >= cols;
// 16-byte aligned part bases), zeros past cols.
extern "C" int repro_split_bf16(const void* g, void* hi, void* mid, void* lo,
                                long long rows, int cols, int pitch,
                                void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (pitch % 8 != 0 || pitch < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = 256, vecs = rows * (pitch / 8);
  tc::split_bf16<<<(unsigned)((vecs + threads - 1) / threads),
                   (unsigned)threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(hi),
      static_cast<__nv_bfloat16*>(mid), static_cast<__nv_bfloat16*>(lo), rows,
      cols, pitch);
  return static_cast<int>(cudaGetLastError());
}

// The int8 tile: a (e, m, k) times b (e, n, k) read as its transpose,
// int8, into c (e, m, n) int32 (e = 1: one 2-D product); each operand
// K-major with its rows a_ld / b_ld bytes apart (multiples of 16, at least
// k: the K-major pack's k_pad, or k for an operand read in place) and its
// matrices rows x ld apart; every base 16-byte aligned.  Exact integer
// products and sums (wrapping past 2^31).
extern "C" int repro_gemm_int8_tc(const void* a, const void* b, void* c,
                                  int e, int m, int n, int k, int a_ld,
                                  int b_ld, void* stream) {
  if (e < 1 || m < 1 || n < 1 || k < 1 || a_ld < k || b_ld < k ||
      a_ld % 16 != 0 || b_ld % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_tile_int8(a, b, static_cast<int32_t*>(c), e, m, n, k,
                              a_ld, b_ld, static_cast<cudaStream_t>(stream));
}

// The K-major pack of e int8 matrices for the int8 tile: src stored
// MN-major (mn = 1: each matrix (k, rows), rows contiguous) or K-major (mn
// = 0: (rows, k)), stored rows ld bytes apart and matrices mat_st apart;
// dst (e, rows, kp) K-major, kp a multiple of 16 at least k, zeros past
// k, 16-byte aligned.
extern "C" int repro_pack_kmajor_int8(const void* src, void* dst, int e,
                                      int rows, int k, int kp, long long ld,
                                      long long mat_st, int mn,
                                      void* stream) {
  if (e < 1 || e > 65535 || rows < 1 || k < 1 || kp < k || kp % 16 != 0 ||
      (rows + tc::PACK - 1) / tc::PACK > 65535 || (mn != 0 && mn != 1) ||
      reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                  ld % 16 == 0 && mat_st % 16 == 0;
  const dim3 grid((kp + tc::PACK - 1) / tc::PACK,
                  (rows + tc::PACK - 1) / tc::PACK, e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto S = static_cast<const int8_t*>(src);
  auto D = static_cast<int8_t*>(dst);
  if (mn)
    tc::pack_kmajor_int8<true><<<grid, 256, 0, s>>>(S, D, rows, k, kp, ld,
                                                    mat_st, vec);
  else
    tc::pack_kmajor_int8<false><<<grid, 256, 0, s>>>(S, D, rows, k, kp, ld,
                                                     mat_st, vec);
  return static_cast<int>(cudaGetLastError());
}

// The int8 head form at m <= 16 rows (the int8 decode rows): x (m, h, k)
// times w (k, h, n), or (n, h, k) with transpose_b, int8, into c (h, m, n)
// int32, head by head, each operand read through its strides (bytes; the
// last axis contiguous) as repro_head_gemm takes them; k % 32 == 0, every
// stride a multiple of 16 and the bases 16-byte aligned, n % 16 == 0
// without transpose_b; ws: nsplit x h x m x n int32 when nsplit > 1, the
// partials summed with wrapping adds.
extern "C" int repro_head_gemm_s8(const void* x, const void* w, void* c,
                                  void* ws, int h, int m, int n, int k,
                                  int transpose_b, int nsplit,
                                  long long x_row, long long x_head,
                                  long long w_row, long long w_head,
                                  void* stream) {
  if ((x_row | x_head | w_row | w_head) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::GemvStrides st = {x_row, x_head, w_row, w_head};
  return tc::launch_gemv_s8(x, w, static_cast<int32_t*>(c),
                            static_cast<int32_t*>(ws), m, n, k, transpose_b,
                            nsplit, static_cast<cudaStream_t>(stream), h,
                            st);
}

// The int8 form: a (e, m, k), or (e, k, m) with transpose_a, times b (e, k,
// n), or (e, n, k) with transpose_b, int8, into c (e, m, n) int32, each
// expert's matrices stored one after another (e = 1: one 2-D product).
// Exact integer products and sums (wrapping past 2^31).  No route takes
// it (the int8 tile does): kept as the timed comparison beside the tile.
extern "C" int repro_gemm_int8(const void* a, const void* b, void* c, int e,
                               int m, int n, int k, int transpose_a,
                               int transpose_b, void* stream) {
  if (e < 1 || m < 0 || n < 0 || k < 0 || e > 65535 ||
      (m + i8::BM - 1) / i8::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0)
    return static_cast<int>(
        cudaMemsetAsync(c, 0, sizeof(int32_t) * (size_t)e * m * n, s));
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        i8::gemm_int8, cudaFuncAttributeMaxDynamicSharedMemorySize, i8::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  // the contiguous extent of each stored row: k where K is contiguous
  const int a_row = transpose_a ? m : k, b_row = transpose_b ? k : n;
  const int vec_a = aligned(a) && a_row % 16 == 0;
  const int vec_b = aligned(b) && b_row % 16 == 0;
  const dim3 grid((n + i8::BN - 1) / i8::BN, (m + i8::BM - 1) / i8::BM, e);
  i8::gemm_int8<<<grid, i8::THREADS, i8::SMEM, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(c), m, n, k, transpose_a, transpose_b, vec_a,
      vec_b);
  return static_cast<int>(cudaGetLastError());
}
