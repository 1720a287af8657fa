// K5: batched paged decode: one query token per serving slot against the
// shared paged KV pool, online softmax over the slot's pages.
//
//   q (slots, KV, G, hd), k_pool / v_pool (pool_tokens, KV, hd),
//   pos (slots,) int32, tables (slots, width) int32  ->  out (slots, KV, G, hd) f32
//
// Replaces: src/repro/kernels/emit.py, _windowed_decode_kind (the decode
// recurrence kind that ops.paged_decode_batched reaches through
// _batched_decode_executor), with the page lookup of emit._index_map.  On the
// TPU the page table is static executor metadata lowered into BlockSpec
// index maps; here it is a runtime int32 tensor each block loads itself, so
// a newly allocated page recompiles nothing.
//
// What bounds it on an H100: it reads each live slot's K/V rows once
// ((pos + 1) * 2 * hd elements per KV head) and does 4 * G * hd flops per
// key, so it is bound by device-memory bytes; at gemma-2b's single KV head
// it launches only `slots` blocks (4 of 132 SMs), so at serving shapes it is
// latency-bound well above that bytes bound.  Splitting the key range across
// blocks (split-k with a second reduction pass) is later work.
//
// Design: one 256-thread block per (slot, KV head) owns the G query rows.
// It reads its POS and walks pages 0 .. pos / page through its table row,
// skipping pages wholly before the window (the dynamic block-skip of
// emit.py); keys inside a page are masked by kpos <= pos and the window.
// Keys are staged KT at a time in shared memory; each warp scores (row,
// key) pairs with a lane-strided dot, one warp per row updates the running
// max / denominator, and each thread carries one value column for all G
// rows, all in f32.  p is cast to the pool's dtype before P.V, as in
// emit.py.  A dead slot (pos == -1) runs no page and writes a zero row
// (0 / max(l, 1e-30)).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;
constexpr float MASK_NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// floats ahead of the K/V staging buffers (Q rows, scores, row state),
// rounded up to a multiple of 4 so the buffers start 16-byte aligned
__host__ __device__ __forceinline__ int float_region(int G, int hd, int kt) {
  return (G * hd + G * (kt + 1) + 3 * MAXG + 3) / 4 * 4;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int KT>
__global__ void __launch_bounds__(THREADS)
paged_decode(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ pos,
             const int* __restrict__ tables, float* __restrict__ out,
             int KV, int G, int hd, int page, int width, float scale,
             int window) {
  const int pitch = hd + 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // (G, hd)
  float* S = Qs + G * hd;                                  // (G, KT + 1)
  float* m_s = S + G * (KT + 1);
  float* l_s = m_s + MAXG;
  float* corr_s = l_s + MAXG;
  T* Ks = reinterpret_cast<T*>(Qs + float_region(G, hd, KT));  // (KT, pitch)
  T* Vs = Ks + KT * pitch;

  const int slot = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int vpos = pos[slot];
  const long long out_base = ((long long)slot * KV + h) * G * hd;

  for (int e = tid; e < G * hd; e += THREADS)
    Qs[e] = to_f(q[out_base + e]);
  if (tid < G) {
    m_s[tid] = MASK_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAXG];
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  const int last = vpos < 0 ? -1 : vpos / page;
  for (int p = 0; p <= last && p < width; ++p) {
    // dynamic block-skip: the page's newest key is already out of the window
    if (window > 0 && p * page + page - 1 <= vpos - window) continue;
    const long long row0 = (long long)tables[slot * width + p] * page;
    for (int c0 = 0; c0 < page; c0 += KT) {
      const int nk = min(KT, page - c0);
      constexpr int PER_VEC = 16 / sizeof(T);
      const int vecs = hd / PER_VEC;
      for (int e = tid; e < nk * vecs; e += THREADS) {
        const int j = e / vecs, c = (e % vecs) * PER_VEC;
        const long long src = ((row0 + c0 + j) * KV + h) * hd + c;
        *reinterpret_cast<uint4*>(Ks + j * pitch + c) =
            *reinterpret_cast<const uint4*>(k_pool + src);
        *reinterpret_cast<uint4*>(Vs + j * pitch + c) =
            *reinterpret_cast<const uint4*>(v_pool + src);
      }
      __syncthreads();

      // scores: one (row, key) pair per warp at a time
      for (int e = warp; e < G * nk; e += WARPS) {
        const int g = e / nk, j = e % nk;
        float dot = 0.f;
        for (int d = lane; d < hd; d += 32)
          dot = fmaf(Qs[g * hd + d], to_f(Ks[j * pitch + d]), dot);
        dot = warp_sum(dot);
        if (lane == 0) {
          const int kp = p * page + c0 + j;
          const bool ok = kp <= vpos && (window <= 0 || kp > vpos - window);
          S[g * (KT + 1) + j] = ok ? dot * scale : MASK_NEG_INF;
        }
      }
      __syncthreads();

      // online-softmax update: one warp per row, one lane per key
      for (int g = warp; g < G; g += WARPS) {
        const float s = lane < nk ? S[g * (KT + 1) + lane] : MASK_NEG_INF;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float pr = lane < nk ? expf(s - m_new) : 0.f;
        const float l_tile = warp_sum(pr);
        if (lane < nk) S[g * (KT + 1) + lane] = round_to(pr, Ks);  // p in pool dtype
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + l_tile;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // P.V: thread `tid` owns value column `tid` for every row
      if (tid < hd) {
        for (int g = 0; g < G; ++g) {
          float a = acc[g] * corr_s[g];
          for (int j = 0; j < nk; ++j)
            a = fmaf(S[g * (KT + 1) + j], to_f(Vs[j * pitch + tid]), a);
          acc[g] = a;
        }
      }
      __syncthreads();
    }
  }

  if (tid < hd) {
    for (int g = 0; g < G; ++g)
      out[out_base + (long long)g * hd + tid] = acc[g] / fmaxf(l_s[g], 1e-30f);
  }
}

template <typename T, int KT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* pos, const int* tables, float* out, int slots, int KV,
           int G, int hd, int page, int width, float scale, int window,
           cudaStream_t s) {
  const int pitch = hd + 16 / (int)sizeof(T);
  const size_t smem = sizeof(float) * (size_t)float_region(G, hd, KT) +
                      sizeof(T) * 2 * (size_t)KT * pitch;
  auto kern = paged_decode<T, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KV, slots);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), pos, tables, out, KV, G, hd, page, width,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q and both pools alike); G <= 16,
// hd <= 256 and a multiple of 8; every table entry a slab of the pool.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* pos,
                                  const void* tables, void* out, int slots,
                                  int KV, int G, int hd, int page, int width,
                                  float scale, int window, int dtype,
                                  void* stream) {
  if (G > MAXG || hd > THREADS || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(tables);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return launch<__nv_bfloat16, 32>(q, k_pool, v_pool, p, t, o, slots, KV, G,
                                     hd, page, width, scale, window, s);
  if (dtype == 0)
    return launch<float, 16>(q, k_pool, v_pool, p, t, o, slots, KV, G, hd,
                             page, width, scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
