// K1: the (mul, add) GEMM  C[m, n] = sum_k A[m, k] * B[k, n]   (f32 out)
//
// Replaces: src/repro/kernels/emit.py, emit_pallas, (mul, add) branch (the
// blocked einsum into an f32 accumulator that ops.matmul reaches through
// _pallas_matmul_f32, including its transpose_b form for the tied logits
// head), and the two VJP forms of src/repro/kernels/ops.py: _gemm_tb
// (a @ b.T) and _gemm_ta (a.T @ b, the transposed-first-operand schedule
// of both weight gradients).
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
// bf16: as in the reference's einsum, a bf16 operand is widened to f32
// exactly in its tile load and the product accumulates in f32.  The f32
// operand is never rounded to bf16.
//
// What bounds it on an H100: at prefill and training row counts the
// products are compute-bound (989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s f32 outside them); at decode (m = slots = 4) every product is a
// GEMV that must stream the weight once (gemma-2b: ~5.0 GB of bf16 weights
// per decode step, 1.5 ms at 3.35 TB/s), so device-memory bandwidth bounds
// it.
//
// Design: bf16 x bf16 without transpose_a: one 128-thread block per 64x64
// output tile, a k-step of 32 through shared memory, nvcuda::wmma
// 16x16x16 fragments with an f32 accumulator (each warp owns a 32x32
// quarter); 16-byte vector loads where the rows allow it, masked scalars on
// ragged edges.  Every other form (f32, mixed, transpose_a): one
// 256-thread block per 128x128 output tile, a k-step of 8, each operand
// widened to f32 as it is staged k-major in shared memory, 8x8 outputs per
// thread in registers by plain f32 FMA (no TF32), so the f32 contract
// holds exactly.  Any m, n, k works.  Neither path pipelines its loads,
// and decode's m = 4 wastes 60 of 64 tile rows: later work (TMA + wgmma, a
// split-k GEMV path, tensor-core products for the f32 cotangent).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
