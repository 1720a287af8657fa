// K2: flash attention forward (online softmax) over the grouped-query layout
//
//   q (B, Sq, KV, G, hd), k / v (B, Sk, KV, hd)  ->  out (B, Sq, KV*G, hd)
//   optional export: m, l (B, KV, G, Sq) float32
//
// Replaces: src/repro/kernels/emit.py, _softmax_kind (the online-softmax
// recurrence kind that ops.attention reaches through the derived streaming
// schedule; prefill attention under attn_impl="pallas"), including its
// state export (emit.py:378-382, the attention_stats form): the final
// running max m and denominator l of every row, which the flash backward
// (flash_bwd.cu) rebuilds p from.  The export only adds two stores per
// row: the output is the same bit for bit with it on or off.
//
// What bounds it on an H100: at gemma-2b prefill shapes (G = 8 query heads
// over one KV head, hd = 256) the work is 4*Sq*Sk*G*hd/2 flops against
// (Sq*G + 2*Sk)*hd elements, i.e. compute-bound on paper; this first kernel
// runs its products on plain f32 FMA, so the CUDA cores (67 TFLOP/s f32)
// and shared-memory bandwidth bound it, far from the tensor cores' rate.
//
// Design: one 256-thread block per (batch, KV head, tile of 64 query rows),
// where a row is one (query position, group head) pair: the G heads of a
// KV head are consecutive rows, so each K/V tile is loaded once for all of
// them (MQA reads K/V once per tile, not G times).  A loop over key tiles
// of BN keys (64 bf16 / 32 f32) replaces the TPU's sequential grid axis; it
// starts at the window's first tile and stops at the causal diagonal (the
// block-skip).  Four threads share a row: each scores BN/4 keys, the row's
// running max / denominator are combined with warp shuffles, and each
// thread carries hd/4 accumulator columns in registers, all in f32.  As in
// emit.py, masked scores take MASK_NEG_INF, p is cast to V's dtype before
// P.V, and the flush divides by max(l, 1e-30).  Tensor-core products
// (wgmma) and a pipelined K/V ring are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int THREADS = 256;     // 4 threads per row
constexpr float MASK_NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of hd elements into shared memory (row pitch `pitch`);
// row i comes from `src + row_off(i)`, or is zero when row_off(i) < 0.
template <typename T, int HD, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src,
                                          int rows, RowOff row_off) {
  constexpr int PER_VEC = 16 / sizeof(T);
  constexpr int VECS = HD / PER_VEC;
  for (int v = threadIdx.x; v < rows * VECS; v += THREADS) {
    const int r = v / VECS, c = (v % VECS) * PER_VEC;
    const long long off = row_off(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src + off + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

template <typename T, int HD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
          int Sk, int KV, int G, float scale, int causal, int window) {
  constexpr int PITCH = HD + 16 / sizeof(T);   // 16-byte rows, staggered banks
  constexpr int KPT = BN / 4;                  // keys scored per thread
  constexpr int DPT = HD / 4;                  // acc columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * PITCH;
  T* Vs = Ks + BN * PITCH;
  float* Ps = reinterpret_cast<float*>(Vs + BN * PITCH);   // (BM, BN + 1)

  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r = threadIdx.x / 4, q4 = threadIdx.x % 4;
  const int row = r0 + r;
  const int qpos = row / G;
  const bool row_ok = row < rows;

  // q row (pos, g) lives at ((b*Sq + pos)*KV + kvh)*G*HD + g*HD; the
  // output's (B, Sq, KV*G, hd) row has the same offset
  auto q_off = [&](int i) -> long long {
    const int rr = r0 + i;
    if (rr >= rows) return -1;
    return ((long long)(b * Sq + rr / G) * KV + kvh) * G * HD +
           (long long)(rr % G) * HD;
  };
  load_rows<T, HD>(Qs, PITCH, q, BM, q_off);

  // key range this tile of rows can see (causal block-skip + window)
  const int qmin = r0 / G;
  const int qmax = min(Sq - 1, (min(r0 + BM, rows) - 1) / G);
  int kend = Sk, kstart = 0;
  if (causal) {
    kend = min(Sk, qmax + 1);
    if (window > 0) kstart = max(0, qmin - window + 1);
  }
  kstart = (kstart / BN) * BN;

  float m_run = MASK_NEG_INF, l_run = 0.f;
  float acc[DPT];
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = kstart; k0 < kend; k0 += BN) {
    auto kv_off = [&](int i) -> long long {
      const int kp = k0 + i;
      if (kp >= Sk) return -1;
      return ((long long)(b * Sk + kp) * KV + kvh) * HD;
    };
    load_rows<T, HD>(Ks, PITCH, k, BN, kv_off);
    load_rows<T, HD>(Vs, PITCH, v, BN, kv_off);
    __syncthreads();

    float s[KPT];
    float m_tile = MASK_NEG_INF;
    for (int j = 0; j < KPT; ++j) {
      const int c = q4 + 4 * j;
      const T* qr = Qs + r * PITCH;
      const T* kr = Ks + c * PITCH;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(to_f(qr[d]), to_f(kr[d]), dot);
      const int kp = k0 + c;
      bool ok = kp < Sk;
      if (causal) {
        ok = ok && kp <= qpos;
        if (window > 0) ok = ok && kp > qpos - window;
      }
      s[j] = ok ? dot * scale : MASK_NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m_run, m_tile);
    const float corr = expf(m_run - m_new);
    float l_tile = 0.f;
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - m_new);
      l_tile += p;
      Ps[r * (BN + 1) + q4 + 4 * j] = to_f(from_f<T>(p));   // p in V's dtype
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
    l_run = l_run * corr + l_tile;
    m_run = m_new;
    __syncthreads();

    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    for (int c = 0; c < BN; ++c) {
      const float p = Ps[r * (BN + 1) + c];
      const T* vr = Vs + c * PITCH + q4;
#pragma unroll 16
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, to_f(vr[4 * j]), acc[j]);
    }
    __syncthreads();
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* o = out + q_off(r);
    for (int j = 0; j < DPT; ++j) o[q4 + 4 * j] = from_f<T>(acc[j] * inv);
    if (m_out != nullptr && q4 == 0) {   // (b, kvh, g, pos) of (B, KV, G, Sq)
      const size_t idx = ((size_t)(b * KV + kvh) * G + row % G) * Sq + qpos;
      m_out[idx] = m_run;
      l_out[idx] = l_run;
    }
  }
}

template <typename T, int HD, int BN>
int launch(const void* q, const void* k, const void* v, void* out,
           float* m_out, float* l_out, int B, int Sq, int Sk, int KV, int G,
           float scale, int causal, int window, cudaStream_t s) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  const size_t smem = (size_t)(BM + 2 * BN) * PITCH * sizeof(T) +
                      (size_t)BM * (BN + 1) * sizeof(float);
  auto kern = flash_fwd<T, HD, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq * G + BM - 1) / BM, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, Sq, Sk,
      KV, G, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, float* m_out, float* l_out, int B, int Sq, int Sk,
                int KV, int G, float scale, int causal, int window,
                cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64, BN>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G,
                               scale, causal, window, s);
    case 128:
      return launch<T, 128, BN>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G,
                                scale, causal, window, s);
    case 256:
      return launch<T, 256, BN>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G,
                                scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); hd in
// {64, 128, 256}; all tensors contiguous and 16-byte aligned.  m_out and
// l_out: both null (no export) or both (B, KV, G, Sq) float32.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* m_out, void* l_out, int B,
                               int Sq, int Sk, int KV, int G, int hd,
                               float scale, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16, 64>(hd, q, k, v, out, mo, lo, B, Sq, Sk,
                                          KV, G, scale, causal, window, s);
  if (dtype == 0)
    return dispatch_hd<float, 32>(hd, q, k, v, out, mo, lo, B, Sq, Sk, KV, G,
                                  scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
