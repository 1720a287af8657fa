// K1: the (mul, add) GEMM  C[m, n] = sum_k A[m, k] * B[k, n]   (f32 out)
//
// Replaces: src/repro/kernels/emit.py, emit_pallas, (mul, add) branch (the
// blocked einsum into an f32 accumulator that ops.matmul reaches through
// _pallas_matmul_f32, including its transpose_b form for the tied logits
// head).
//
// Layouts: A is row-major (m, k).  B is row-major (k, n), or with
// transpose_b row-major (n, k), read in its stored layout: the (256000,
// 2048) tied embedding table is never copied transposed.  C is row-major
// (m, n) float32; the caller casts to its out dtype.
//
// What bounds it on an H100: at prefill (m = prompt length) the products
// are compute-bound on the tensor cores (989 TFLOP/s bf16); at decode
// (m = slots = 4) every product is a GEMV that must stream the weight once
// (gemma-2b: ~5.0 GB of bf16 weights per decode step, 1.5 ms at 3.35 TB/s),
// so device-memory bandwidth bounds it.
//
// Design: one 128-thread block per 64x64 output tile, a k-step of 32
// through shared memory.  bf16 inputs use nvcuda::wmma 16x16x16 fragments
// with an f32 accumulator (each warp owns a 32x32 quarter); f32 inputs use
// plain f32 FMA (no TF32) on a 64x64 tile with a k-step of 16, 4x4 outputs
// per thread.  Loads are 16-byte vectors where the rows allow it, masked
// scalars on ragged edges, so any m, n, k works.  The simple kernel does
// not pipeline its loads and wastes 60 of 64 tile rows at decode: both are
// later work (TMA + wgmma, a split-k GEMV path).
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

constexpr int FBK = 16, FTHREADS = 256;

template <bool TB>
__global__ void __launch_bounds__(FTHREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
         float* __restrict__ C, int M, int N, int K) {
  // both tiles k-major so the inner loop reads rows of shared memory
  __shared__ float As[FBK][BM + 4];
  __shared__ float Bs[FBK][BN + 4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = threadIdx.x; e < BM * FBK; e += FTHREADS) {
      const int r = e / FBK, c = e % FBK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < BN * FBK; e += FTHREADS) {
      if (TB) {            // B stored (n, k)
        const int n = e / FBK, c = e % FBK;
        const int gn = n0 + n, gc = k0 + c;
        Bs[c][n] = (gn < N && gc < K) ? B[(size_t)gn * K + gc] : 0.f;
      } else {             // B stored (k, n)
        const int c = e / BN, n = e % BN;
        const int gn = n0 + n, gc = k0 + c;
        Bs[c][n] = (gn < N && gc < K) ? B[(size_t)gc * N + gn] : 0.f;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) C[(size_t)r * N + c] = acc[i][j];
    }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs.  vec_a / vec_b: the
// caller certifies 16-byte aligned rows (base pointer aligned and the row
// length a multiple of 8 elements), allowing vector loads.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, int transpose_b, int dtype, int vec_a,
                          int vec_b, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    auto A = static_cast<const __nv_bfloat16*>(a);
    auto B = static_cast<const __nv_bfloat16*>(b);
    if (transpose_b)
      gemm_bf16<true><<<grid, THREADS, 0, s>>>(A, B, static_cast<float*>(c),
                                               m, n, k, vec_a, vec_b);
    else
      gemm_bf16<false><<<grid, THREADS, 0, s>>>(A, B, static_cast<float*>(c),
                                                m, n, k, vec_a, vec_b);
  } else if (dtype == 0) {
    auto A = static_cast<const float*>(a);
    auto B = static_cast<const float*>(b);
    if (transpose_b)
      gemm_f32<true><<<grid, FTHREADS, 0, s>>>(A, B, static_cast<float*>(c),
                                               m, n, k);
    else
      gemm_f32<false><<<grid, FTHREADS, 0, s>>>(A, B, static_cast<float*>(c),
                                                m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
