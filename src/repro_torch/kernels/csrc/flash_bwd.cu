// K3 and K4: the flash-attention backward over the grouped-query layout
//
//   q (B, Sq, KV, G, hd), dO (B, Sq, KV, G, vd); k (B, Sk, KV, hd),
//   v (B, Sk, KV, vd); m, l, delta (B, KV, G, Sq) float32   (the
//   forward's exported statistics and delta = rowsum(dO * out))
//   K3 -> dq (B, Sq, KV, G, hd);  K4 -> dk (B, Sk, KV, hd), dv (.., vd)
//
// Replaces: src/repro/kernels/emit.py, _flash_dq_kind (K3) and
// _flash_dkv_kind (K4), the two recurrence kinds that ops.attention's VJP
// (_flash_grouped_bwd) runs under attn_impl="pallas".
//
// Both rebuild p = exp(s - (m + log max(l, 1e-30))) in f32 from the
// recomputed, masked scores s = q.k * scale (masked scores take
// MASK_NEG_INF, as in the forward); unlike the forward, p is NOT rounded
// to V's dtype, as in the reference.  dS = p * (dO.v - delta).  The mask
// is the forward's (flash_fwd.cu): bidirectional with causal = 0, else
// causal, windowed, and re-admitting every pair below `prefix` (emit.py
// :541-551, :646); K3 widens its key range as K2 does, K4 its row range
// with the roles swapped (a key tile that starts below the prefix is seen
// from row 0).
//
// Widths: the q.k width hd and the value width vd are template parameters
// apart (the reference's kinds read vd from the value block, emit.py:529,
// :633), over the pairs of REPRO_FLASH_WIDTHS (hopper.cuh), MLA's (96, 64)
// among them.  K3 reads q, k at hd and dO, v at vd and writes dq at hd; K4
// writes dk at hd and dv at vd.  In the bf16 forms every product that
// contracts over a width runs width / 16 k-steps (6 at hd = 96), and a
// 96-wide row takes two 64-column swizzle tiles whose last 32 columns TMA
// fills with zeros.  The two products whose output width is hd (K3's dQ
// += dS K and K4's dK += dS^T Q) read K or Q MN-major, and a 128-byte
// swizzle atom is 64 columns wide, so at hd = 96 they run at N = 128 over
// the zero columns and store the first 96: 1/8 of K3's product work and
// 1/10 of K4's at MLA's widths.
//
// What bounds them on an H100: at gemma-2b training shapes (B = 2, S =
// 512, G = 8 query heads over one KV head, hd = 256) each kernel does 3
// (K3) or 4 (K4) products of 2*pairs*G*hd flops over a few MB of
// operands: bytes-bound on paper there (~4 us), operations-bound (989
// TFLOP/s bf16) at the window-2048 shape (B = 1, S = 4096, G = 16).
//
// K3, bf16 (dtype 1): K2's tensor-core design (flash_fwd.cu) in K2's
// orientation, rows are (query position, group head) pairs and the key
// tiles stream through a TMA ring, so each K/V tile serves the whole
// group.  Per consumer warpgroup of 64 rows the Q and dO tiles stay in
// shared memory (copied once with cp.async), and the rows' lse and delta
// sit in registers.  Per key tile two wgmma products give S = Q.K^T and
// dP = dO.V^T in f32 registers; p = exp(s - lse) (f32, not rounded) and
// dS = p (dP - delta) are formed in registers; then dQ += dS.K runs with
// dS as the register A operand and the K tile read MN-major from the ring
// (no transpose copy).  The tiles are software-pipelined as the
// forward's: S and dP of tile t run while dS of tile t - 1 folds into dQ.
// Precision of dS: the reference keeps dS in f32 for dS.K; here dS is
// rounded to bf16 for the tensor-core product (a relative 2^-9 a term,
// random in sign), which holds the card tests' 1e-2 and chip_smoke's
// tolerances with nothing loosened, so the hi/lo split into two bf16
// products is not needed.  Budgets at hd = 256: 32 keys a tile, dQ 128
// f32 registers a thread, S and dP 16 each, two dS tiles 8 each (240 a
// consumer thread through setmaxnreg); shared memory Q + dO 64 KB a
// warpgroup and 3 stages of 16 KB K + 16 KB V with two warpgroups (4
// with one); 64 keys a tile at hd <= 128.  One or two consumer
// warpgroups a block as K2 chooses them.  The scale is applied once in
// the flush, then the cast to q's dtype.
//
// K3, float32 (dtype 0): the first design, unchanged: one 256-thread
// block per (tile of 64 query rows, KV head, batch), a loop over key
// tiles of 16 keys with the forward's causal/window block-skip; four
// threads share a row: each scores BN/4 keys (q.k and dO.v) on plain f32
// FMA, writes dS to shared memory, then carries hd/4 columns of the f32
// dq accumulator in registers.
//
// K4, bf16 (dtype 1, G | 64): FlashAttention-3's dK/dV kernel in the
// grouped layout.  A block owns 64 keys of one (batch, KV head): K and V
// stay resident in swizzled shared memory (one TMA load each), and the
// streamed rows, (position, group head) pairs as K3's, come in tiles of
// 64 through a 2-stage (hd = 256) or 4-stage ring: Q and dO by TMA through
// a 5-D map of the (B, S, KV, G, hd) layout (hopper.cuh,
// encode_group_rows_map), the rows' lse and delta computed into shared
// memory by one producer warp.  Four products a tile, no transpose copy:
// S^T = K Q^T and dP^T = V dO^T (both operands K-major over hd), P^T =
// exp(S^T scale - lse) of the visible pairs (0 elsewhere) and dS^T = P^T
// (dP^T - delta) in f32 registers, then dV += P^T dO and dK += dS^T Q with
// P^T / dS^T rounded to bf16 as the register A operand and dO / Q read
// MN-major through wgmma's transpose bit.  Registers: dK and dV for 64
// keys at hd = 256 are 2 x 128 f32 a thread, more than one warpgroup
// holds, so the work is split over two consumer warpgroups without a
// product recomputed: warpgroup 0 forms S^T and P^T, hands P^T (f32,
// double-buffered, 16 KB a tile) to warpgroup 1 in shared memory over
// named barriers, and accumulates dV; warpgroup 1 forms dP^T, dS^T and
// accumulates dK (240 registers each by setmaxnreg, the producer 24).
// Filling the card: 64-key blocks give only Sk/64 x KV x B blocks (64 at
// recurrentgemma-9b's window shape, 16 at gemma-2b's training shape), so
// each key tile's row stream is split over nsplit blocks (ops.dkv_splits:
// enough for two blocks a SM); each split writes f32 partial dK/dV to a
// workspace and dkv_reduce sums them in split order, scales dk and casts
// (no float atomics: reruns are the same bits).  With nsplit = 1 the
// block writes bf16 directly.  Precision: the reference keeps p and dS in
// f32 for these products; here both are rounded to bf16 (a relative 2^-9
// a term, random in sign), which holds the unchanged tolerances.  What
// bounds it: the window shape's 4 products (0.2085 ms at 989 TFLOP/s);
// each tile's Q and dO (64 KB at hd = 256) stream from L2 for 8.4 MFLOP,
// 128 FLOP a byte, and the two warpgroups wait on each other once a tile.
//
// K4, float32 (and a G that does not divide 64): the first design (the
// transposed weld, plain f32 FMA from shared memory, bound by the CUDA
// cores and shared-memory bandwidth, as K3's f32 form): one 256-thread
// block owns a tile of 16 keys of one (batch, KV head) and streams the
// query rows (position, group head) in tiles of 32.  Streaming every row
// of all G heads of the KV head sums their contributions in the block's
// own f32 accumulators, so dk and dv come out already reduced over the
// group: no atomics and no per-group (.., G, ..) intermediate (the
// reference emits per-group outputs and sums them afterwards).  Sixteen
// threads share a key: each scores two streamed rows, and each carries
// hd/16 columns of dk and of dv.  Rows past the end, like the reference's
// padded query rows, are always masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// Copy `rows` rows of W elements into shared memory (row pitch `pitch`);
// row i comes from `src + row_off(i)`, or is zero when row_off(i) < 0.
template <typename T, int W, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src,
                                          int rows, RowOff row_off) {
  constexpr int PER_VEC = 16 / sizeof(T);
  constexpr int VECS = W / PER_VEC;
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
                                        int window, int prefix) {
  if (!causal) return true;
  return (kp <= qp && (window <= 0 || kp > qp - window)) ||
         (qp < prefix && kp < prefix);
}

// ---------------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------------

constexpr int BM = 64;           // query rows per block (4 threads a row)

template <typename T, int HD, int VD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ m, const float* __restrict__ l,
         const float* __restrict__ delta, T* __restrict__ dq, int Sq,
         int Sk, int KV, int G, float scale, int causal, int window,
         int prefix) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int VPITCH = VD + 16 / sizeof(T);
  constexpr int KPT = BN / 4;                  // keys scored per thread
  constexpr int DPT = HD / 4;                  // dq columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + BM * PITCH;                     // dO rows
  T* Ks = Os + BM * VPITCH;
  T* Vs = Ks + BN * PITCH;
  float* Ds = reinterpret_cast<float*>(Vs + BN * VPITCH);  // (BM, BN + 1)

  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r = threadIdx.x / 4, q4 = threadIdx.x % 4;
  const int row = r0 + r;
  const int qpos = row / G;
  const bool row_ok = row < rows;

  // row (pos, g) of q and dq: ((b*Sq + pos)*KV + kvh)*G*HD + g*HD; of dO
  // the same with VD
  auto row_off = [&](int i, int w) -> long long {
    const int rr = r0 + i;
    if (rr >= rows) return -1;
    return ((long long)(b * Sq + rr / G) * KV + kvh) * G * w +
           (long long)(rr % G) * w;
  };
  auto q_off = [&](int i) { return row_off(i, HD); };
  load_rows<T, HD>(Qs, PITCH, q, BM, q_off);
  load_rows<T, VD>(Os, VPITCH, dout, BM,
                   [&](int i) { return row_off(i, VD); });

  float lse = 0.f, dl = 0.f;
  if (row_ok) {
    const size_t idx = ((size_t)(b * KV + kvh) * G + row % G) * Sq + qpos;
    lse = m[idx] + logf(fmaxf(l[idx], 1e-30f));
    dl = delta[idx];
  }

  // the forward's key range for this tile of rows (causal block-skip,
  // window, prefix): the backward visits exactly the blocks the forward did
  const int qmin = r0 / G;
  const int qmax = min(Sq - 1, (min(r0 + BM, rows) - 1) / G);
  int kend = Sk, kstart = 0;
  if (causal) {
    kend = min(Sk, qmax + 1);
    if (window > 0) kstart = max(0, qmin - window + 1);
    if (qmin < prefix) {
      kend = max(kend, min(Sk, prefix));
      kstart = 0;
    }
  }
  kstart = (kstart / BN) * BN;

  float acc[DPT];
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = kstart; k0 < kend; k0 += BN) {
    auto kv_off = [&](int i, int w) -> long long {
      const int kp = k0 + i;
      if (kp >= Sk) return -1;
      return ((long long)(b * Sk + kp) * KV + kvh) * w;
    };
    load_rows<T, HD>(Ks, PITCH, k, BN, [&](int i) { return kv_off(i, HD); });
    load_rows<T, VD>(Vs, VPITCH, v, BN,
                     [&](int i) { return kv_off(i, VD); });
    __syncthreads();

    for (int j = 0; j < KPT; ++j) {
      const int c = q4 + 4 * j;
      const float dot = dot_row<T, HD>(Qs + r * PITCH, Ks + c * PITCH);
      const float dpv = dot_row<T, VD>(Os + r * VPITCH, Vs + c * VPITCH);
      const int kp = k0 + c;
      const bool ok = kp < Sk && visible(kp, qpos, causal, window, prefix);
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

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(THREADS)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ m, const float* __restrict__ l,
          const float* __restrict__ delta, T* __restrict__ dk,
          T* __restrict__ dv, int Sq, int Sk, int KV, int G, float scale,
          int causal, int window, int prefix) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int VPITCH = VD + 16 / sizeof(T);
  constexpr int TPK = THREADS / BJ;            // threads per key
  constexpr int RPT = BI / TPK;                // streamed rows per thread
  constexpr int DPT = HD / TPK;                // dk columns per thread
  constexpr int VPT = VD / TPK;                // dv columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BJ * PITCH;
  T* Qs = Vs + BJ * VPITCH;
  T* Os = Qs + BI * PITCH;                     // dO rows
  float* Ps = reinterpret_cast<float*>(Os + BI * VPITCH);  // (BJ, BI + 1)
  float* Ds = Ps + BJ * (BI + 1);                          // (BJ, BI + 1)
  float* lse_s = Ds + BJ * (BI + 1);                       // (BI,)
  float* dl_s = lse_s + BI;                                // (BI,)

  const int j0 = blockIdx.x * BJ, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int jl = threadIdx.x / TPK, t = threadIdx.x % TPK;
  const int kpos = j0 + jl;

  auto kv_off = [&](int i, int w) -> long long {
    const int kp = j0 + i;
    if (kp >= Sk) return -1;
    return ((long long)(b * Sk + kp) * KV + kvh) * w;
  };
  load_rows<T, HD>(Ks, PITCH, k, BJ, [&](int i) { return kv_off(i, HD); });
  load_rows<T, VD>(Vs, VPITCH, v, BJ, [&](int i) { return kv_off(i, VD); });

  // streamed rows that can see a key of this tile (the forward's causal,
  // window and prefix block-skip with the roles swapped: a tile that starts
  // below the prefix is seen from row 0)
  int rstart = 0, rend = rows;
  if (causal) {
    rstart = j0 * G;                            // positions >= j0
    if (window > 0) {
      const int jmax = min(Sk, j0 + BJ) - 1;    // positions < jmax + window
      rend = min(rows, (jmax + window) * G);
    }
    if (j0 < prefix) {
      rstart = 0;
      rend = max(rend, min(rows, prefix * G));
    }
  }
  rstart = (rstart / BI) * BI;

  float dk_acc[DPT], dv_acc[VPT];
  for (int j = 0; j < DPT; ++j) dk_acc[j] = 0.f;
  for (int j = 0; j < VPT; ++j) dv_acc[j] = 0.f;

  for (int r0 = rstart; r0 < rend; r0 += BI) {
    auto row_off = [&](int i, int w) -> long long {
      const int rr = r0 + i;
      if (rr >= rows) return -1;
      return ((long long)(b * Sq + rr / G) * KV + kvh) * G * w +
             (long long)(rr % G) * w;
    };
    load_rows<T, HD>(Qs, PITCH, q, BI, [&](int i) { return row_off(i, HD); });
    load_rows<T, VD>(Os, VPITCH, dout, BI,
                     [&](int i) { return row_off(i, VD); });
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
      const float dpv = dot_row<T, VD>(Vs + jl * VPITCH, Os + c * VPITCH);
      const bool ok = rr < rows && kpos < Sk &&
                      visible(kpos, rr / G, causal, window, prefix);
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
      const T* orow = Os + c * VPITCH + t;
      if constexpr (HD == VD) {
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dk_acc[j] = fmaf(ds, to_f(qr[TPK * j]), dk_acc[j]);
          dv_acc[j] = fmaf(p, to_f(orow[TPK * j]), dv_acc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          dk_acc[j] = fmaf(ds, to_f(qr[TPK * j]), dk_acc[j]);
#pragma unroll
        for (int j = 0; j < VPT; ++j)
          dv_acc[j] = fmaf(p, to_f(orow[TPK * j]), dv_acc[j]);
      }
    }
    __syncthreads();
  }

  if (kpos < Sk) {
    const long long ok = kv_off(jl, HD), ov = kv_off(jl, VD);
    for (int j = 0; j < DPT; ++j)
      dk[ok + t + TPK * j] = from_f<T>(dk_acc[j] * scale);
    for (int j = 0; j < VPT; ++j)
      dv[ov + t + TPK * j] = from_f<T>(dv_acc[j]);
  }
}

template <typename T, int HD, int VD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* l, const float* delta, void* dq,
              int B, int Sq, int Sk, int KV, int G, float scale, int causal,
              int window, int prefix, cudaStream_t s) {
  constexpr int BN = sizeof(T) == 2 ? 32 : 16;
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int VPITCH = VD + 16 / sizeof(T);
  const size_t smem =
      (size_t)(BM + BN) * (PITCH + VPITCH) * sizeof(T) +
      (size_t)BM * (BN + 1) * sizeof(float);
  auto kern = flash_dq<T, HD, VD, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq * G + BM - 1) / BM, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, l, delta,
      static_cast<T*>(dq), Sq, Sk, KV, G, scale, causal, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int VD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dk,
               void* dv, int B, int Sq, int Sk, int KV, int G, float scale,
               int causal, int window, int prefix, cudaStream_t s) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int VPITCH = VD + 16 / sizeof(T);
  const size_t smem = (size_t)(BJ + BI) * (PITCH + VPITCH) * sizeof(T) +
                      (size_t)(2 * BJ * (BI + 1) + 2 * BI) * sizeof(float);
  auto kern = flash_dkv<T, HD, VD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BJ - 1) / BJ, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, l, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, KV, G, scale, causal,
      window, prefix);
  return static_cast<int>(cudaGetLastError());
}

// which = 0: K3 (out0 = dq), its FMA form (f32 only: bf16 takes
// tc::dispatch_dq); which = 1: K4 (out0 = dk, out1 = dv)
template <typename T, int HD, int VD>
int launch_which(int which, const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* l,
                 const float* delta, void* out0, void* out1, int B, int Sq,
                 int Sk, int KV, int G, float scale, int causal, int window,
                 int prefix, cudaStream_t s) {
  if (which == 0) {
    if constexpr (std::is_same_v<T, float>)
      return launch_dq<T, HD, VD>(q, k, v, dout, m, l, delta, out0, B, Sq,
                                  Sk, KV, G, scale, causal, window, prefix,
                                  s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dkv<T, HD, VD>(q, k, v, dout, m, l, delta, out0, out1, B, Sq,
                               Sk, KV, G, scale, causal, window, prefix, s);
}

template <typename T>
int dispatch_widths(int which, int hd, int vd, const void* q, const void* k,
                    const void* v, const void* dout, const float* m,
                    const float* l, const float* delta, void* out0,
                    void* out1, int B, int Sq, int Sk, int KV, int G,
                    float scale, int causal, int window, int prefix,
                    cudaStream_t s) {
#define REPRO_CASE(H, V)                                                   \
  if (hd == H && vd == V)                                                  \
    return launch_which<T, H, V>(which, q, k, v, dout, m, l, delta, out0,   \
                                 out1, B, Sq, Sk, KV, G, scale, causal,     \
                                 window, prefix, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K3, bf16: the tensor-core form
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

// keys per tile: 32 at hd = 256 keeps dQ (128 f32 registers a thread),
// S and dP (16 each) and two dS tiles (8 each) under the consumers' 240
// (48 keys measured slower: spills and a 2-stage ring)
__host__ __device__ constexpr int keys_per_tile(int hd) {
  return hd == 256 ? 32 : 64;
}

// K/V ring depth: as many stages as fit beside the Q and dO tiles (3 at
// hd = vd = 256 with two consumer warpgroups, 4 with one), at most 4; hk
// and hv are the widths padded to whole 64-column tiles
__host__ __device__ constexpr int dq_stages(int hk, int hv, int nwg) {
  const int bn = keys_per_tile(hk);
  const int fit = (225 * 1024 - nwg * (int)(tile_bytes(64, hk) +
                                            tile_bytes(64, hv))) /
                  ((int)tile_bytes(bn, hk) + (int)tile_bytes(bn, hv));
  return fit < 4 ? fit : 4;
}

template <int HD, int VD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_dq_tc(const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const bf16* __restrict__ q, const bf16* __restrict__ dout,
            const float* __restrict__ m, const float* __restrict__ l,
            const float* __restrict__ delta, bf16* __restrict__ dq, int Sq,
            int Sk, int KV, int G, float scale, int causal, int window,
            int prefix) {
  constexpr int HK = pad64(HD), HV = pad64(VD);
  constexpr int BN = keys_per_tile(HK);
  constexpr uint32_t Q_BYTES = tile_bytes(64, HK);
  constexpr uint32_t O_BYTES = tile_bytes(64, HV);
  using Ring = KVRing<HK, HV, BN, dq_stages(HK, HV, NWG)>;
  const float scale_log2 = scale * LOG2E;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);           // NWG x Q_BYTES
  uint8_t* Os = Qs + NWG * Q_BYTES;            // dO rows, NWG x O_BYTES
  Ring ring(Os + NWG * O_BYTES);

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  // the forward's key tiles for this block's rows: the backward visits
  // exactly the tiles the forward did
  int kstart, ntiles;
  key_tiles(blockIdx.x * 64 * NWG, 64 * NWG, Sq, Sk, G, causal, window,
            prefix, BN, kstart, ntiles);

  if (threadIdx.x == NWG * 128) {
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
  }
  if (threadIdx.x == 0) ring.init(NWG * 128);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread keeps the K/V ring full ----
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128)
      ring.produce(&tm_k, &tm_v, ntiles, kstart, kvh, b);
  } else {
    // ---- consumers: 64 rows per warpgroup ----
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rw = blockIdx.x * 64 * NWG + wg * 64;   // its first row
    uint8_t* Qw = Qs + wg * Q_BYTES;
    uint8_t* Ow = Os + wg * O_BYTES;
    // row (pos, g) of q and dq: ((b*Sq + pos)*KV + kvh)*G*HD + g*HD; of dO
    // the same with VD
    auto row_off = [&](int row, int w) -> long long {
      if (row >= rows) return -1;
      return ((long long)(b * Sq + row / G) * KV + kvh) * G * w +
             (long long)(row % G) * w;
    };
    load_rows_sw128<HD>(Qw, q, tid,
                        [&](int i) { return row_off(rw + i, HD); });
    load_rows_sw128<VD>(Ow, dout, tid,
                        [&](int i) { return row_off(rw + i, VD); });

    const int row0 = rw + warp * 16 + lane / 4, row1 = row0 + 8;
    const int qp0 = row0 / G, qp1 = row1 / G;
    const int t4 = lane % 4;
    const int wq_lo = rw / G;
    const int wq_hi = (min(rw + 64, rows) - 1) / G;
    // the row's log-sum-exp (log2 domain) and delta, while the tiles land
    float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
    if (row0 < rows) {
      const size_t i0 = ((size_t)(b * KV + kvh) * G + row0 % G) * Sq + qp0;
      lse0 = m[i0] * LOG2E + log2f(fmaxf(l[i0], 1e-30f));
      dl0 = delta[i0];
    }
    if (row1 < rows) {
      const size_t i1 = ((size_t)(b * KV + kvh) * G + row1 % G) * Sq + qp1;
      lse1 = m[i1] * LOG2E + log2f(fmaxf(l[i1], 1e-30f));
      dl1 = delta[i1];
    }
    cp_async_wait_all();
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    const uint64_t dq_desc = make_desc(Qw, 16, 1024);
    const uint64_t do_desc = make_desc(Ow, 16, 1024);
    float acc[HK / 2];
    float sc[BN / 2], dp[BN / 2];
    uint32_t ds[BN / 16][4], dsn[BN / 16][4];
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;

    // S = Q K^T over hd and dP = dO V^T over vd, in steps of 16, both
    // K-major, committed as one group
    auto issue_s_dp = [&](int t) {
      const uint64_t dk = make_desc(ring.k_tile(t), 16, 1024);
      const uint64_t dv = make_desc(ring.v_tile(t), 16, 1024);
      ring.wait_k(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qo = (kk / 4) * 8192 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BN * 128 + (kk % 4) * 32;
        wgmma_ss<BN>(sc, dq_desc + (qo >> 4), dk + (ko >> 4), kk > 0);
      }
      ring.wait_v(t);
#pragma unroll
      for (int kk = 0; kk < VD / 16; ++kk) {
        const uint32_t qo = (kk / 4) * 8192 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BN * 128 + (kk % 4) * 32;
        wgmma_ss<BN>(dp, do_desc + (qo >> 4), dv + (ko >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of tile t over its keys in steps of 16, K read MN-major
    // (at N = HK: whole 64-column swizzle atoms)
    auto issue_dq = [&](int t, uint32_t (&da)[BN / 16][4]) {
      const uint64_t dk_mn = make_desc(ring.k_tile(t), BN * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_mn<HK>(acc, da[kk], dk_mn + ((kk * 2048) >> 4), 1);
      wgmma_commit();
    };
    // p = exp(s - lse) (f32, not rounded), dS = p (dP - delta), then dS
    // in bf16 into `da`, the A operand of dQ += dS K
    auto form_ds = [&](int t, uint32_t (&da)[BN / 16][4]) {
      const int k0 = kstart + t * BN;
      const bool need_mask =
          k0 + BN > Sk ||
          (causal && (k0 + BN - 1 > wq_lo ||
                      (window > 0 && k0 <= wq_hi - window)));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sc[4 * j + e];
          float c = sc[4 * j + 2 + e];
          if (need_mask) {
            const int kp = k0 + 8 * j + 2 * t4 + e;
            if (kp >= Sk || !visible(kp, qp0, causal, window, prefix))
              a = MASK_NEG_INF;
            if (kp >= Sk || !visible(kp, qp1, causal, window, prefix))
              c = MASK_NEG_INF;
          }
          // 2^(s * scale_log2 - lse) in one fused multiply-add; a masked
          // score gives 2^(-huge) = 0
          const float pa = exp2_fast(fmaf(a, scale_log2, -lse0));
          const float pc = exp2_fast(fmaf(c, scale_log2, -lse1));
          sc[4 * j + e] = pa * (dp[4 * j + e] - dl0);
          sc[4 * j + 2 + e] = pc * (dp[4 * j + 2 + e] - dl1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        da[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        da[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        da[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        da[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // Software pipeline inside the warpgroup, as the forward's: S and dP
    // of tile t run while dS of tile t - 1 folds into dQ; V of a stage is
    // released when dP is in, K when its dQ product is done.  dS
    // alternates between two register tiles, as the forward's P.
    auto step = [&](int t, uint32_t (&cur)[BN / 16][4],
                    uint32_t (&nxt)[BN / 16][4]) {
      issue_s_dp(t);
      issue_dq(t - 1, cur);
      wgmma_wait<1>();                         // S, dP of tile t are in
      fence_regs(sc);
      fence_regs(dp);
      ring.release_v(t);
      form_ds(t, nxt);
      wgmma_wait<0>();                         // dQ of tile t - 1 is done
      fence_regs(acc);
      fence_regs(cur);
      ring.release_k(t - 1);
    };
    auto finish = [&](uint32_t (&last)[BN / 16][4]) {
      fence_regs(acc);
      wgmma_fence();
      issue_dq(ntiles - 1, last);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(last);
      ring.release_k(ntiles - 1);
    };
    issue_s_dp(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    ring.release_v(0);
    form_ds(0, ds);
    int t = 1;
    for (; t + 1 < ntiles; t += 2) {
      step(t, ds, dsn);
      step(t + 1, dsn, ds);
    }
    if (t < ntiles) {
      step(t, ds, dsn);
      finish(dsn);
    } else {
      finish(ds);
    }

    // the scale once, then the cast to q's dtype
    const long long o0 = row_off(row0, HD), o1 = row_off(row1, HD);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (o0 >= 0)
        *reinterpret_cast<uint32_t*>(dq + o0 + col) =
            pack_bf16(acc[4 * j + 0] * scale, acc[4 * j + 1] * scale);
      if (o1 >= 0)
        *reinterpret_cast<uint32_t*>(dq + o1 + col) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

template <int HD, int VD, int NWG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* l, const float* delta, void* dq,
              int B, int Sq, int Sk, int KV, int G, float scale, int causal,
              int window, int prefix, cudaStream_t s) {
  constexpr int HK = pad64(HD), HV = pad64(VD);
  constexpr int BN = keys_per_tile(HK);
  CUtensorMap tm_k, tm_v;
  int err = encode_rows_map(&tm_k, k, B, Sk, KV, HD, BN);
  if (err == 0) err = encode_rows_map(&tm_v, v, B, Sk, KV, VD, BN);
  if (err != 0) return err;
  constexpr size_t smem =
      1024 + NWG * (tile_bytes(64, HK) + tile_bytes(64, HV)) +
      KVRing<HK, HV, BN, dq_stages(HK, HV, NWG)>::BYTES;
  auto kern = flash_dq_tc<HD, VD, NWG>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq * G + 64 * NWG - 1) / (64 * NWG), KV, B);
  kern<<<grid, 128 * (NWG + 1), smem, s>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      m, l, delta, static_cast<bf16*>(dq), Sq, Sk, KV, G, scale, causal,
      window, prefix);
  return static_cast<int>(cudaGetLastError());
}

// two consumer warpgroups (128-row blocks) once those blocks fill the SMs
template <int HD, int VD>
int launch_dq_rows(const void* q, const void* k, const void* v,
                   const void* dout, const float* m, const float* l,
                   const float* delta, void* dq, int B, int Sq, int Sk,
                   int KV, int G, float scale, int causal, int window,
                   int prefix, cudaStream_t s) {
  const long long blocks128 = (long long)((Sq * G + 127) / 128) * KV * B;
  if (blocks128 >= sm_count())
    return launch_dq<HD, VD, 2>(q, k, v, dout, m, l, delta, dq, B, Sq, Sk,
                                KV, G, scale, causal, window, prefix, s);
  return launch_dq<HD, VD, 1>(q, k, v, dout, m, l, delta, dq, B, Sq, Sk, KV,
                              G, scale, causal, window, prefix, s);
}

int dispatch_dq(int hd, int vd, const void* q, const void* k, const void* v,
                const void* dout, const float* m, const float* l,
                const float* delta, void* dq, int B, int Sq, int Sk, int KV,
                int G, float scale, int causal, int window, int prefix,
                cudaStream_t s) {
#define REPRO_CASE(H, V)                                                   \
  if (hd == H && vd == V)                                                  \
    return launch_dq_rows<H, V>(q, k, v, dout, m, l, delta, dq, B, Sq, Sk, \
                                KV, G, scale, causal, window, prefix, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K4, bf16: the tensor-core form
// ---------------------------------------------------------------------------

// A block's keys; the streamed rows of a row tile (32-row tiles in a
// 4-stage ring measured slower at hd = 256 than 64-row tiles in 2)
constexpr int DKV_KEYS = 64, DKV_ROWS = 64;

// The row tiles that can see a key of the tile at j0 (the forward's
// causal and window block-skip with the roles swapped): `t0` the first,
// `count` of them.  ops.dkv_row_tiles is the same rule in Python.
__device__ inline void dkv_row_tiles(int j0, int Sq, int Sk, int G,
                                     int causal, int window, int prefix,
                                     int& t0, int& count) {
  const int rows = Sq * G;
  int rstart = 0, rend = rows;
  if (causal) {
    rstart = j0 * G;                           // positions >= j0
    if (window > 0) {
      const int jmax = min(Sk, j0 + DKV_KEYS) - 1;
      rend = min(rows, (jmax + window) * G);   // positions < jmax + window
    }
    if (j0 < prefix) {                         // seen by every prefix row
      rstart = 0;
      rend = max(rend, min(rows, prefix * G));
    }
  }
  t0 = rstart / DKV_ROWS;
  count = max(0, (rend + DKV_ROWS - 1) / DKV_ROWS - t0);
}

// Shared memory: K and V resident, two f32 P^T tiles, the ring's Q and dO
// tiles (1024-byte aligned), its rows' statistics, the barriers; as many
// stages as fit, at most 4.  HK, HV: the widths padded to 64 columns.
template <int HK, int HV>
struct DkvSmem {
  static constexpr int R = DKV_ROWS;
  static constexpr uint32_t KT = tile_bytes(DKV_KEYS, HK);
  static constexpr uint32_t VT = tile_bytes(DKV_KEYS, HV);
  static constexpr uint32_t QROWS = tile_bytes(R, HK);
  static constexpr uint32_t OROWS = tile_bytes(R, HV);
  static constexpr uint32_t P = DKV_KEYS * R * 4;       // one f32 P^T tile
  static constexpr int FIT = (225 * 1024 - (int)(KT + VT) - 2 * (int)P) /
                             ((int)(QROWS + OROWS) + 8 * R);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t BYTES = 1024 + KT + VT + 2 * P +
                                  STAGES * (QROWS + OROWS + 8 * R) +
                                  (2 * STAGES + 1) * sizeof(uint64_t);
  static_assert(BYTES <= 232448, "K4 shared memory");
};

template <int N>
using Width = std::integral_constant<int, N>;

template <int HD, int VD>
__global__ void __launch_bounds__(384, 1)
flash_dkv_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ m, const float* __restrict__ l,
             const float* __restrict__ delta, bf16* __restrict__ dk,
             bf16* __restrict__ dv, float* __restrict__ ws, int Sq, int Sk,
             int KV, int G, float scale, int causal, int window, int prefix,
             int nsplit) {
  constexpr int HK = pad64(HD), HV = pad64(VD);
  using L = DkvSmem<HK, HV>;
  constexpr int S = L::STAGES, R = L::R;
  constexpr uint32_t CHUNK = R * 128;      // 64 columns of a row tile
  constexpr uint32_t STAGE = L::QROWS + L::OROWS;
  const float scale_log2 = scale * LOG2E;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + L::KT;
  float* Pbuf = reinterpret_cast<float*>(Vs + L::VT);     // 2 x 64 x R f32
  uint8_t* ring = reinterpret_cast<uint8_t*>(Pbuf + 2 * DKV_KEYS * R);
  auto q_tile = [&](int s) { return ring + s * STAGE; };
  auto do_tile = [&](int s) { return q_tile(s) + L::QROWS; };
  // lse (log2 domain) then delta of the stage's R rows
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(ring + S * STAGE) + s * 2 * R;
  };
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + S * (STAGE + 8 * R));
  uint64_t* empty = full + S;
  uint64_t* kv_full = empty + S;

  const int jt = blockIdx.x, split = blockIdx.y;
  const int kvh = blockIdx.z % KV, b = blockIdx.z / KV;
  const int j0 = jt * DKV_KEYS;
  const int rows = Sq * G;
  int t0, count;
  dkv_row_tiles(j0, Sq, Sk, G, causal, window, prefix, t0, count);
  const int per = (count + nsplit - 1) / nsplit;
  const int first = t0 + split * per;
  const int ntiles = max(0, min(count, (split + 1) * per) - split * per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1 + 32);           // the TMA thread + stats warp
      mbar_init(empty + s, 256);             // every consumer thread
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread streams Q / dO tiles by TMA, one warp
    // the rows' statistics ----
    setmaxnreg_dec<24>();
    const int tid = threadIdx.x - 256;
    if (tid == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      mbar_expect_tx(kv_full, L::KT + L::VT);
#pragma unroll
      for (int c = 0; c < HK / 64; ++c)
        tma_load_4d(Ks + c * 8192, &tm_k, kv_full, c * 64, kvh, j0, b);
#pragma unroll
      for (int c = 0; c < HV / 64; ++c)
        tma_load_4d(Vs + c * 8192, &tm_v, kv_full, c * 64, kvh, j0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S;
        const int pos0 = (first + i) * R / G;
        mbar_wait(empty + s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(full + s, STAGE);
#pragma unroll
        for (int c = 0; c < HK / 64; ++c)
          tma_load_5d(q_tile(s) + c * CHUNK, &tm_q, full + s, c * 64, 0, kvh,
                      pos0, b);
#pragma unroll
        for (int c = 0; c < HV / 64; ++c)
          tma_load_5d(do_tile(s) + c * CHUNK, &tm_do, full + s, c * 64, 0,
                      kvh, pos0, b);
      }
    } else if (tid >= 32 && tid < 64) {
      const int lane = tid - 32;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S;
        mbar_wait(empty + s, ((i / S) & 1) ^ 1);
        float* st = stats(s);
#pragma unroll
        for (int h = 0; h < R / 32; ++h) {
          const int r = (first + i) * R + lane + 32 * h;
          float lse = 0.f, dl = 0.f;
          if (r < rows) {
            const size_t idx =
                ((size_t)(b * KV + kvh) * G + r % G) * Sq + r / G;
            lse = m[idx] * LOG2E + log2f(fmaxf(l[idx], 1e-30f));
            dl = delta[idx];
          }
          st[lane + 32 * h] = lse;
          st[R + lane + 32 * h] = dl;
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dP^T, dS^T, dK
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int kp0 = j0 + warp * 16 + lane / 4, kp1 = kp0 + 8;   // its keys
    const uint64_t dk_desc = make_desc(Ks, 16, 1024);
    const uint64_t dv_desc = make_desc(Vs, 16, 1024);
    mbar_wait(kv_full, 0);

    // A warpgroup's loop and flush: its first product contracts over KC
    // columns (hd for S^T, vd for dP^T), its accumulator is N wide (HV for
    // dV, HK for dK) and W of its columns are stored (vd, hd)
    auto consume = [&](auto kc, auto nw, auto ww) {
      constexpr int KC = decltype(kc)::value, N = decltype(nw)::value;
      constexpr int W = decltype(ww)::value;
      float acc[N / 2];
      float sc[R / 2];
      uint32_t pa[R / 16][4];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S;
        const int r0 = (first + i) * R;
        mbar_wait(full + s, (i / S) & 1);
        const float* st = stats(s);
        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): 64 keys x R
        // rows, both operands K-major over KC
        const uint64_t a_desc = wg == 0 ? dk_desc : dv_desc;
        const uint64_t b_desc =
            make_desc(wg == 0 ? q_tile(s) : do_tile(s), 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint32_t oa = (kk / 4) * 8192 + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * CHUNK + (kk % 4) * 32;
          wgmma_ss<R>(sc, a_desc + (oa >> 4), b_desc + (ob >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        float* P = Pbuf + (i & 1) * (DKV_KEYS * R);
        if (wg == 0) {
          // P^T = exp(s * scale - lse) of the visible pairs, 0 elsewhere
          const bool need_mask =
              j0 + DKV_KEYS > Sk || r0 + R > rows ||
              (causal && (r0 / G < j0 + DKV_KEYS - 1 ||
                          (window > 0 && (r0 + R - 1) / G >= j0 + window)));
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int rl = 8 * j + 2 * t4 + e;
              const float lse = st[rl];
              float p0 = exp2_fast(fmaf(sc[4 * j + e], scale_log2, -lse));
              float p1 =
                  exp2_fast(fmaf(sc[4 * j + 2 + e], scale_log2, -lse));
              if (need_mask) {
                const int r = r0 + rl, qp = r / G;
                const bool row_ok = r < rows;
                if (!row_ok || kp0 >= Sk ||
                    !visible(kp0, qp, causal, window, prefix))
                  p0 = 0.f;
                if (!row_ok || kp1 >= Sk ||
                    !visible(kp1, qp, causal, window, prefix))
                  p1 = 0.f;
              }
              sc[4 * j + e] = p0;
              sc[4 * j + 2 + e] = p1;
            }
          }
          // hand P^T (f32) to warpgroup 1: thread i's values at [k][i], so
          // each of its threads reads the positions it holds itself
          if (i >= 2) named_bar_sync(3 + (i & 1), 256);
#pragma unroll
          for (int e = 0; e < R / 2; ++e) P[e * 128 + tid] = sc[e];
          named_bar_arrive(1 + (i & 1), 256);
        } else {
          // dS^T = P^T (dP^T - delta), P^T from warpgroup 0
          named_bar_sync(1 + (i & 1), 256);
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dl = st[R + 8 * j + 2 * t4 + e];
              sc[4 * j + e] =
                  P[(4 * j + e) * 128 + tid] * (sc[4 * j + e] - dl);
              sc[4 * j + 2 + e] =
                  P[(4 * j + 2 + e) * 128 + tid] * (sc[4 * j + 2 + e] - dl);
            }
          }
          if (i + 2 < ntiles) named_bar_arrive(3 + (i & 1), 256);
        }
        // dV += P^T dO (0) or dK += dS^T Q (1): the f32 tile rounded to
        // bf16 as the register A operand, dO / Q read MN-major (no
        // transpose copy) in whole 64-column swizzle atoms
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        const uint64_t mn_desc =
            make_desc(wg == 0 ? do_tile(s) : q_tile(s), CHUNK, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk)
          wgmma_rs_mn<N>(acc, pa[kk], mn_desc + ((kk * 2048) >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty + s);
      }

      // flush: dv (warpgroup 0) and dk (1, scaled once), in bf16 straight
      // to the outputs when the block is the key tile's only split, else
      // as f32 partials that dkv_reduce sums in split order (ws: nsplit dk
      // planes, then nsplit dv planes)
      const float mul = wg == 1 ? scale : 1.f;
      const size_t rows_kv = (size_t)gridDim.z * Sk;      // B * KV * Sk
      bf16* out = wg == 0 ? dv : dk;
      float* part = wg == 1 ? ws + split * rows_kv * HD
                            : ws + nsplit * rows_kv * HD +
                                  split * rows_kv * VD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = h ? kp1 : kp0;
        if (kp >= Sk) continue;
        const size_t o = ((size_t)(b * Sk + kp) * KV + kvh) * W;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float x0 = acc[4 * j + 2 * h] * mul;
          const float x1 = acc[4 * j + 2 * h + 1] * mul;
          if (nsplit == 1)
            *reinterpret_cast<uint32_t*>(out + o + col) = pack_bf16(x0, x1);
          else
            *reinterpret_cast<float2*>(part + o + col) = make_float2(x0, x1);
        }
      }
    };
    if constexpr (HD == VD) {
      consume(Width<HD>{}, Width<HK>{}, Width<HD>{});
    } else {
      if (wg == 0)
        consume(Width<HD>{}, Width<HV>{}, Width<VD>{});
      else
        consume(Width<VD>{}, Width<HK>{}, Width<HD>{});
    }
  }
}

// dk = bf16(sum of the dk partials), dv the same, over the splits in
// order (no atomics: reruns are the same bits); four elements a thread.
// plane_k, plane_v: the elements of dk and of dv (B * Sk * KV * hd, vd)
__global__ void dkv_reduce(const float* __restrict__ ws, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, size_t plane_k,
                           size_t plane_v, int nsplit) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  for (int which = 0; which < 2; ++which) {
    const size_t plane = which == 0 ? plane_k : plane_v;
    if (i >= plane) continue;
    const float* src = ws + (size_t)which * nsplit * plane_k + i;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < nsplit; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(src + s * plane);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    bf16* out = (which == 0 ? dk : dv) + i;
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(sum.x, sum.y);
    *reinterpret_cast<uint32_t*>(out + 2) = pack_bf16(sum.z, sum.w);
  }
}

template <int HD, int VD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dk,
               void* dv, float* ws, int B, int Sq, int Sk, int KV, int G,
               float scale, int causal, int window, int prefix, int nsplit,
               cudaStream_t s) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  constexpr int R = DKV_ROWS;
  int err = encode_group_rows_map(&tm_q, q, B, Sq, KV, G, HD, R);
  if (err == 0)
    err = encode_group_rows_map(&tm_do, dout, B, Sq, KV, G, VD, R);
  if (err == 0) err = encode_rows_map(&tm_k, k, B, Sk, KV, HD, DKV_KEYS);
  if (err == 0) err = encode_rows_map(&tm_v, v, B, Sk, KV, VD, DKV_KEYS);
  if (err != 0) return err;
  constexpr size_t smem = DkvSmem<pad64(HD), pad64(VD)>::BYTES;
  auto kern = flash_dkv_tc<HD, VD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sk + DKV_KEYS - 1) / DKV_KEYS, nsplit, B * KV);
  kern<<<grid, 384, smem, s>>>(
      tm_q, tm_do, tm_k, tm_v, m, l, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), ws, Sq, Sk, KV, G, scale, causal, window, prefix,
      nsplit);
  if (nsplit > 1) {
    const size_t plane_k = (size_t)B * Sk * KV * HD;
    const size_t plane_v = (size_t)B * Sk * KV * VD;
    const size_t most = plane_k > plane_v ? plane_k : plane_v;
    const int threads = 256;
    const unsigned blocks = (unsigned)((most / 4 + threads - 1) / threads);
    dkv_reduce<<<blocks, threads, 0, s>>>(ws, static_cast<bf16*>(dk),
                                          static_cast<bf16*>(dv), plane_k,
                                          plane_v, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dkv(int hd, int vd, const void* q, const void* k,
                 const void* v, const void* dout, const float* m,
                 const float* l, const float* delta, void* dk, void* dv,
                 float* ws, int B, int Sq, int Sk, int KV, int G, float scale,
                 int causal, int window, int prefix, int nsplit,
                 cudaStream_t s) {
  if (G <= 0 || DKV_ROWS % G != 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_CASE(H, V)                                                     \
  if (hd == H && vd == V)                                                    \
    return launch_dkv<H, V>(q, k, v, dout, m, l, delta, dk, dv, ws, B, Sq, Sk, \
                            KV, G, scale, causal, window, prefix, nsplit, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* m, const void* l, const void* delta,
        void* out0, void* out1, float* ws, int B, int Sq, int Sk, int KV,
        int G, int hd, int vd, float scale, int causal, int window,
        int prefix, int dtype, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto M = static_cast<const float*>(m);
  auto L = static_cast<const float*>(l);
  auto D = static_cast<const float*>(delta);
  if (which == 0 && dtype == 1)
    return tc::dispatch_dq(hd, vd, q, k, v, dout, M, L, D, out0, B, Sq, Sk,
                           KV, G, scale, causal, window, prefix, s);
  if (which == 1 && dtype == 1 && nsplit > 0)
    return tc::dispatch_dkv(hd, vd, q, k, v, dout, M, L, D, out0, out1, ws, B,
                            Sq, Sk, KV, G, scale, causal, window, prefix,
                            nsplit, s);
  if (dtype == 1)
    return dispatch_widths<__nv_bfloat16>(which, hd, vd, q, k, v, dout, M, L,
                                          D, out0, out1, B, Sq, Sk, KV, G,
                                          scale, causal, window, prefix, s);
  if (dtype == 0)
    return dispatch_widths<float>(which, hd, vd, q, k, v, dout, M, L, D, out0,
                                  out1, B, Sq, Sk, KV, G, scale, causal,
                                  window, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike);
// m, l, delta float32 (B, KV, G, Sq); (hd, vd) a pair of
// REPRO_FLASH_WIDTHS (hopper.cuh); all tensors contiguous and 16-byte
// aligned; window and prefix as the forward's (causal = 1 only).
extern "C" int repro_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* m, const void* l,
                              const void* delta, void* dq, int B, int Sq,
                              int Sk, int KV, int G, int hd, int vd,
                              float scale, int causal, int window, int prefix,
                              int dtype, void* stream) {
  return run(0, q, k, v, dout, m, l, delta, dq, nullptr, nullptr, B, Sq, Sk,
             KV, G, hd, vd, scale, causal, window, prefix, dtype, 0, stream);
}

// nsplit: 0 takes the FMA kernel (float32, or a G that does not divide
// 64); >= 1 the bf16 tensor-core kernel with each key tile's row stream
// split over nsplit blocks, whose f32 partials (ws: nsplit x B x Sk x KV x
// hd for dk, then nsplit x B x Sk x KV x vd for dv, needed when nsplit > 1)
// a second pass sums in split order.
extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* m,
                               const void* l, const void* delta, void* dk,
                               void* dv, void* ws, int B, int Sq, int Sk,
                               int KV, int G, int hd, int vd, float scale,
                               int causal, int window, int prefix, int dtype,
                               int nsplit, void* stream) {
  return run(1, q, k, v, dout, m, l, delta, dk, dv, static_cast<float*>(ws),
             B, Sq, Sk, KV, G, hd, vd, scale, causal, window, prefix, dtype,
             nsplit, stream);
}
