// K3 and K4: the flash-attention backward over the grouped-query layout
//
//   q, dO (B, Sq, KV, G, hd); k, v (B, Sk, KV, hd);
//   m, l, delta (B, KV, G, Sq) float32   (the forward's exported
//   statistics and delta = rowsum(dO * out))
//   K3 -> dq (B, Sq, KV, G, hd);  K4 -> dk, dv (B, Sk, KV, hd)
//
// Replaces: src/repro/kernels/emit.py, _flash_dq_kind (K3) and
// _flash_dkv_kind (K4), the two recurrence kinds that ops.attention's VJP
// (_flash_grouped_bwd) runs under attn_impl="pallas".
//
// Both rebuild p = exp(s - (m + log max(l, 1e-30))) in f32 from the
// recomputed, masked scores s = q.k * scale (masked scores take
// MASK_NEG_INF, as in the forward); unlike the forward, p is NOT rounded
// to V's dtype, as in the reference.  dS = p * (dO.v - delta).
//
// What bounds them on an H100: at gemma-2b training shapes (B = 2, S =
// 512, G = 8 query heads over one KV head, hd = 256) each kernel does 3
// (K3) or 4 (K4) products of 2*pairs*G*hd flops over a few MB of
// operands: compute-bound on paper (989 TFLOP/s bf16).  These first
// kernels run plain f32 FMA, so the CUDA cores (67 TFLOP/s f32) and
// shared-memory bandwidth bound them; tensor cores (wgmma) and TMA are
// later work.
//
// K3 design: one 256-thread block per (tile of 64 query rows, KV head,
// batch), where a row is one (query position, group head) pair, as in
// flash_fwd.cu, so each K/V tile is loaded once for the G heads.  A loop
// over key tiles (32 keys bf16, 16 f32) with the forward's causal/window
// block-skip replaces the TPU's sequential grid axis.  Four threads share
// a row: each scores BN/4 keys (q.k and dO.v), writes dS to shared memory,
// then carries hd/4 columns of the f32 dq accumulator in registers.  The
// scale is applied once at the end, then the cast to q's dtype.
//
// K4 design (the transposed weld): one 256-thread block owns a tile of 16
// keys of one (batch, KV head) and streams the query rows (position,
// group head) in tiles of 32.  Streaming every row of all G heads of the
// KV head sums their contributions in the block's own f32 accumulators,
// so dk and dv come out already reduced over the group: no atomics and no
// per-group (.., G, ..) intermediate (the reference emits per-group
// outputs and sums them afterwards).  Sixteen threads share a key: each
// scores two streamed rows, and each carries hd/16 columns of dk and of
// dv.  Rows past the end, like the reference's padded query rows, are
// always masked.  Only Sk/16 * KV * B blocks run (64 at the training
// shapes), under half the SMs: splitting the stream across blocks needs a
// second reduction pass, later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

// Copy `rows` rows of HD elements into shared memory (row pitch `pitch`);
// row i comes from `src + row_off(i)`, or is zero when row_off(i) < 0.
template <typename T, int HD, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src,
                                          int rows, RowOff row_off) {
  constexpr int PER_VEC = 16 / sizeof(T);
  constexpr int VECS = HD / PER_VEC;
  for (int e = threadIdx.x; e < rows * VECS; e += THREADS) {
    const int r = e / VECS, c = (e % VECS) * PER_VEC;
    const long long off = row_off(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src + off + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

template <typename T, int HD>
__device__ __forceinline__ float dot_row(const T* a, const T* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(to_f(a[d]), to_f(b[d]), acc);
  return acc;
}

__device__ __forceinline__ bool visible(int kp, int qp, int causal,
                                        int window) {
  if (!causal) return true;
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------------

constexpr int BM = 64;           // query rows per block (4 threads a row)

template <typename T, int HD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ m, const float* __restrict__ l,
         const float* __restrict__ delta, T* __restrict__ dq, int Sq,
         int Sk, int KV, int G, float scale, int causal, int window) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int KPT = BN / 4;                  // keys scored per thread
  constexpr int DPT = HD / 4;                  // dq columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + BM * PITCH;                     // dO rows
  T* Ks = Os + BM * PITCH;
  T* Vs = Ks + BN * PITCH;
  float* Ds = reinterpret_cast<float*>(Vs + BN * PITCH);   // (BM, BN + 1)

  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r = threadIdx.x / 4, q4 = threadIdx.x % 4;
  const int row = r0 + r;
  const int qpos = row / G;
  const bool row_ok = row < rows;

  // row (pos, g) of q, dO and dq: ((b*Sq + pos)*KV + kvh)*G*HD + g*HD
  auto q_off = [&](int i) -> long long {
    const int rr = r0 + i;
    if (rr >= rows) return -1;
    return ((long long)(b * Sq + rr / G) * KV + kvh) * G * HD +
           (long long)(rr % G) * HD;
  };
  load_rows<T, HD>(Qs, PITCH, q, BM, q_off);
  load_rows<T, HD>(Os, PITCH, dout, BM, q_off);

  float lse = 0.f, dl = 0.f;
  if (row_ok) {
    const size_t idx = ((size_t)(b * KV + kvh) * G + row % G) * Sq + qpos;
    lse = m[idx] + logf(fmaxf(l[idx], 1e-30f));
    dl = delta[idx];
  }

  // the forward's key range for this tile of rows (causal block-skip +
  // window): the backward visits exactly the blocks the forward did
  const int qmin = r0 / G;
  const int qmax = min(Sq - 1, (min(r0 + BM, rows) - 1) / G);
  int kend = Sk, kstart = 0;
  if (causal) {
    kend = min(Sk, qmax + 1);
    if (window > 0) kstart = max(0, qmin - window + 1);
  }
  kstart = (kstart / BN) * BN;

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

    for (int j = 0; j < KPT; ++j) {
      const int c = q4 + 4 * j;
      const float dot = dot_row<T, HD>(Qs + r * PITCH, Ks + c * PITCH);
      const float dpv = dot_row<T, HD>(Os + r * PITCH, Vs + c * PITCH);
      const int kp = k0 + c;
      const bool ok = kp < Sk && visible(kp, qpos, causal, window);
      const float s = ok ? dot * scale : MASK_NEG_INF;
      const float p = expf(s - lse);
      Ds[r * (BN + 1) + c] = p * (dpv - dl);
    }
    __syncthreads();

    for (int c = 0; c < BN; ++c) {
      const float ds = Ds[r * (BN + 1) + c];
      const T* kr = Ks + c * PITCH + q4;
#pragma unroll 16
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(ds, to_f(kr[4 * j]), acc[j]);
    }
    __syncthreads();
  }

  if (row_ok) {
    T* o = dq + q_off(r);
    for (int j = 0; j < DPT; ++j) o[q4 + 4 * j] = from_f<T>(acc[j] * scale);
  }
}

// ---------------------------------------------------------------------------
// K4: dk, dv (the transposed weld, reduced over the group in the block)
// ---------------------------------------------------------------------------

constexpr int BJ = 16;           // keys per block (16 threads a key)
constexpr int BI = 32;           // streamed query rows per tile

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ m, const float* __restrict__ l,
          const float* __restrict__ delta, T* __restrict__ dk,
          T* __restrict__ dv, int Sq, int Sk, int KV, int G, float scale,
          int causal, int window) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int TPK = THREADS / BJ;            // threads per key
  constexpr int RPT = BI / TPK;                // streamed rows per thread
  constexpr int DPT = HD / TPK;                // dk / dv columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BJ * PITCH;
  T* Qs = Vs + BJ * PITCH;
  T* Os = Qs + BI * PITCH;                     // dO rows
  float* Ps = reinterpret_cast<float*>(Os + BI * PITCH);   // (BJ, BI + 1)
  float* Ds = Ps + BJ * (BI + 1);                          // (BJ, BI + 1)
  float* lse_s = Ds + BJ * (BI + 1);                       // (BI,)
  float* dl_s = lse_s + BI;                                // (BI,)

  const int j0 = blockIdx.x * BJ, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int jl = threadIdx.x / TPK, t = threadIdx.x % TPK;
  const int kpos = j0 + jl;

  auto kv_off = [&](int i) -> long long {
    const int kp = j0 + i;
    if (kp >= Sk) return -1;
    return ((long long)(b * Sk + kp) * KV + kvh) * HD;
  };
  load_rows<T, HD>(Ks, PITCH, k, BJ, kv_off);
  load_rows<T, HD>(Vs, PITCH, v, BJ, kv_off);

  // streamed rows that can see a key of this tile (the forward's causal
  // and window block-skip with the roles swapped)
  int rstart = 0, rend = rows;
  if (causal) {
    rstart = j0 * G;                            // positions >= j0
    if (window > 0) {
      const int jmax = min(Sk, j0 + BJ) - 1;    // positions < jmax + window
      rend = min(rows, (jmax + window) * G);
    }
  }
  rstart = (rstart / BI) * BI;

  float dk_acc[DPT], dv_acc[DPT];
  for (int j = 0; j < DPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int r0 = rstart; r0 < rend; r0 += BI) {
    auto q_off = [&](int i) -> long long {
      const int rr = r0 + i;
      if (rr >= rows) return -1;
      return ((long long)(b * Sq + rr / G) * KV + kvh) * G * HD +
             (long long)(rr % G) * HD;
    };
    load_rows<T, HD>(Qs, PITCH, q, BI, q_off);
    load_rows<T, HD>(Os, PITCH, dout, BI, q_off);
    if (threadIdx.x < BI) {
      const int rr = r0 + threadIdx.x;
      float lse = 0.f, dl = 0.f;
      if (rr < rows) {
        const size_t idx =
            ((size_t)(b * KV + kvh) * G + rr % G) * Sq + rr / G;
        lse = m[idx] + logf(fmaxf(l[idx], 1e-30f));
        dl = delta[idx];
      }
      lse_s[threadIdx.x] = lse;
      dl_s[threadIdx.x] = dl;
    }
    __syncthreads();

    for (int i = 0; i < RPT; ++i) {
      const int c = t + TPK * i;
      const int rr = r0 + c;
      const float dot = dot_row<T, HD>(Ks + jl * PITCH, Qs + c * PITCH);
      const float dpv = dot_row<T, HD>(Vs + jl * PITCH, Os + c * PITCH);
      const bool ok = rr < rows && kpos < Sk &&
                      visible(kpos, rr / G, causal, window);
      const float s = ok ? dot * scale : MASK_NEG_INF;
      const float p = expf(s - lse_s[c]);
      Ps[jl * (BI + 1) + c] = p;
      Ds[jl * (BI + 1) + c] = p * (dpv - dl_s[c]);
    }
    __syncthreads();

    for (int c = 0; c < BI; ++c) {
      const float p = Ps[jl * (BI + 1) + c];
      const float ds = Ds[jl * (BI + 1) + c];
      const T* qr = Qs + c * PITCH + t;
      const T* orow = Os + c * PITCH + t;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        dk_acc[j] = fmaf(ds, to_f(qr[TPK * j]), dk_acc[j]);
        dv_acc[j] = fmaf(p, to_f(orow[TPK * j]), dv_acc[j]);
      }
    }
    __syncthreads();
  }

  if (kpos < Sk) {
    const long long off = kv_off(jl);
    for (int j = 0; j < DPT; ++j) {
      dk[off + t + TPK * j] = from_f<T>(dk_acc[j] * scale);
      dv[off + t + TPK * j] = from_f<T>(dv_acc[j]);
    }
  }
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* l, const float* delta, void* dq,
              int B, int Sq, int Sk, int KV, int G, float scale, int causal,
              int window, cudaStream_t s) {
  constexpr int BN = sizeof(T) == 2 ? 32 : 16;
  constexpr int PITCH = HD + 16 / sizeof(T);
  const size_t smem = (size_t)(2 * BM + 2 * BN) * PITCH * sizeof(T) +
                      (size_t)BM * (BN + 1) * sizeof(float);
  auto kern = flash_dq<T, HD, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq * G + BM - 1) / BM, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, l, delta,
      static_cast<T*>(dq), Sq, Sk, KV, G, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dk,
               void* dv, int B, int Sq, int Sk, int KV, int G, float scale,
               int causal, int window, cudaStream_t s) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  const size_t smem = (size_t)(2 * BJ + 2 * BI) * PITCH * sizeof(T) +
                      (size_t)(2 * BJ * (BI + 1) + 2 * BI) * sizeof(float);
  auto kern = flash_dkv<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BJ - 1) / BJ, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, l, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, KV, G, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// which = 0: K3 (out0 = dq); which = 1: K4 (out0 = dk, out1 = dv)
template <typename T, int HD>
int launch_which(int which, const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* l,
                 const float* delta, void* out0, void* out1, int B, int Sq,
                 int Sk, int KV, int G, float scale, int causal, int window,
                 cudaStream_t s) {
  if (which == 0)
    return launch_dq<T, HD>(q, k, v, dout, m, l, delta, out0, B, Sq, Sk, KV,
                            G, scale, causal, window, s);
  return launch_dkv<T, HD>(q, k, v, dout, m, l, delta, out0, out1, B, Sq, Sk,
                           KV, G, scale, causal, window, s);
}

template <typename T>
int dispatch_hd(int which, int hd, const void* q, const void* k,
                const void* v, const void* dout, const float* m,
                const float* l, const float* delta, void* out0, void* out1,
                int B, int Sq, int Sk, int KV, int G, float scale, int causal,
                int window, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_which<T, 64>(which, q, k, v, dout, m, l, delta, out0,
                                 out1, B, Sq, Sk, KV, G, scale, causal,
                                 window, s);
    case 128:
      return launch_which<T, 128>(which, q, k, v, dout, m, l, delta, out0,
                                  out1, B, Sq, Sk, KV, G, scale, causal,
                                  window, s);
    case 256:
      return launch_which<T, 256>(which, q, k, v, dout, m, l, delta, out0,
                                  out1, B, Sq, Sk, KV, G, scale, causal,
                                  window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* m, const void* l, const void* delta,
        void* out0, void* out1, int B, int Sq, int Sk, int KV, int G, int hd,
        float scale, int causal, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto M = static_cast<const float*>(m);
  auto L = static_cast<const float*>(l);
  auto D = static_cast<const float*>(delta);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(which, hd, q, k, v, dout, M, L, D, out0,
                                      out1, B, Sq, Sk, KV, G, scale, causal,
                                      window, s);
  if (dtype == 0)
    return dispatch_hd<float>(which, hd, q, k, v, dout, M, L, D, out0, out1,
                              B, Sq, Sk, KV, G, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike);
// m, l, delta float32 (B, KV, G, Sq); hd = vd in {64, 128, 256}; all
// tensors contiguous and 16-byte aligned.
extern "C" int repro_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* m, const void* l,
                              const void* delta, void* dq, int B, int Sq,
                              int Sk, int KV, int G, int hd, float scale,
                              int causal, int window, int dtype,
                              void* stream) {
  return run(0, q, k, v, dout, m, l, delta, dq, nullptr, B, Sq, Sk, KV, G,
             hd, scale, causal, window, dtype, stream);
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* m,
                               const void* l, const void* delta, void* dk,
                               void* dv, int B, int Sq, int Sk, int KV, int G,
                               int hd, float scale, int causal, int window,
                               int dtype, void* stream) {
  return run(1, q, k, v, dout, m, l, delta, dk, dv, B, Sq, Sk, KV, G, hd,
             scale, causal, window, dtype, stream);
}
