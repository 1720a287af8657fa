// K2: flash attention forward (online softmax) over the grouped-query layout
//
//   q (B, Sq, KV, G, hd), k (B, Sk, KV, hd), v (B, Sk, KV, vd)
//     ->  out (B, Sq, KV*G, vd)
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
// Two forms, chosen by dtype:
//
// bf16 (dtype 1): tensor cores.  What bounds it on an H100: the two
// products, 4*pairs*G*hd flops (989 TFLOP/s bf16 dense) against each
// input read once: at the window-2048 shape (B=1, S=4096, G=16, hd=256)
// the bound is 0.104 ms by operations; at gemma-2b's S=512 shapes the
// bound is bytes (~1-3 us), so launch and pipeline fill dominate there.
// Design: a block is NWG consumer warpgroups of 64 rows each plus one
// producer warpgroup; a row is one (query position, group head) pair, so
// the G heads of a KV head fill the M side of a tile and each K/V tile
// serves the whole group (GQA/MQA read K/V once per tile).
//   - Products on wgmma with f32 accumulators in registers: S = Q.K^T
//     (A = the warpgroup's Q tile in shared memory, B = the K tile, both
//     K-major) and O += P.V (A = P in registers, rounded to bf16 as the
//     reference's p.astype(v.dtype); B = the V tile read MN-major through
//     wgmma's transpose flag: no transpose copy).  The online-softmax
//     rescale stays in registers; row max and row sum reduce over the four
//     threads of a row with shuffles; scores run in the log2 domain
//     (exp2), the exported m is converted back.
//   - Inside a warpgroup the tiles are software-pipelined: S of tile t is
//     issued with P.V of tile t - 1 behind it, and the softmax of tile t
//     runs on the CUDA cores while that P.V runs on the tensor cores (P
//     of t - 1 and of t in separate registers); O is rescaled once P.V of
//     t - 1 is done.  Two warpgroups of a block also overlap each other.
//   - A ring of K/V stages (as many as fit beside the Q tiles, at most 4)
//     filled by one thread of the producer warpgroup with TMA (tensor
//     maps encoded per call from data_ptr(), 128-byte swizzle matching the
//     wgmma descriptors; rows past Sk read as zeros).  K and V have their
//     own full and empty mbarriers: S starts before V lands, and a stage's
//     K is released as soon as its scores are in.  The consumers copy
//     their Q rows once with cp.async (any G; rows past Sq*G zero-filled).
//   - Block-skip as the FMA form: the key range starts at the window's
//     first tile and stops at the causal diagonal; only tiles that cross
//     the diagonal, the window's edge or Sk apply the mask.
//   - Budgets at hd = 256: O is 128 f32 registers a thread; with two
//     consumer warpgroups a tile is 80 keys (S 40 registers, the two P
//     tiles 20 each), and setmaxnreg gives consumers 240 and the producer
//     24 (2 x 128 x 240 + 128 x 24 <= 65,536); shared memory is Q 32 KB a
//     warpgroup and two stages of 40 KB K + 40 KB V (224 KB).  With one
//     consumer warpgroup a tile is 64 keys (S 32, P 16 each) and the ring
//     3 stages of 32 + 32 KB.  At hd <= 128, 64 keys and up to 4 stages.
//   - Small grids: when 128-row blocks would not fill the SMs (gemma-2b's
//     prefill, B=1 and prompts of 51-175 tokens: Sq*G = 408-1400 rows;
//     its training shape, 64 blocks), a block has one consumer warpgroup
//     (64 rows), doubling the blocks; otherwise two.
// float32 (dtype 0): the first design, unchanged (the hybrid's and
// mamba2's f32 agreement runs it): one 256-thread block per (batch, KV
// head, tile of 64 query rows), a loop over key tiles of 32 keys, four
// threads a row, products on plain f32 FMA from shared memory (bound by
// the CUDA cores and shared-memory bandwidth).
//
// Widths: the q.k width hd and the value width vd are template parameters
// apart, as the reference's kind reads vd from the value block (emit.py
// :529): the pairs of REPRO_FLASH_WIDTHS (hopper.cuh), MLA's (96, 64)
// among them.  q and k are read at hd, v and out at vd.  In the bf16 form
// a 96-wide row takes two 64-column swizzle tiles (TMA fills K's columns
// 96-127 with zeros, for no extra device-memory traffic) and S = Q.K^T
// runs hd / 16 = 6 k-steps; P.V runs at N = vd.  O is vd / 2 registers a
// thread, and the key tile is chosen by vd (80 keys only at vd = 256).
//
// Both forms, as in emit.py: masked scores take MASK_NEG_INF (the bf16
// form adds their p = exp(MASK_NEG_INF - m) = 0 as an exact 0), p is cast
// to V's dtype before P.V, and the flush divides by max(l, 1e-30).
//
// The mask (emit.py:315-329): with causal = 0 every key is visible (the
// encoder's and cross-attention's bidirectional form, Sq and Sk free);
// else key j is visible from query i when j <= i (and j > i - window with
// a window), or when both lie below `prefix` (the prefix-LM form: the
// image patches attend to each other both ways).  The prefix re-admits
// key tiles above the diagonal: a row tile with a position below the
// prefix reads keys from 0 to at least the prefix's end (key_tiles), and
// every tile that crosses the diagonal already takes the element mask,
// so the prefix only widens the key range.  prefix = 0 is the causal
// form as it was, the same tiles and the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Copy `rows` rows of W elements into shared memory (row pitch `pitch`);
// row i comes from `src + row_off(i)`, or is zero when row_off(i) < 0.
template <typename T, int W, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src,
                                          int rows, RowOff row_off) {
  constexpr int PER_VEC = 16 / sizeof(T);
  constexpr int VECS = W / PER_VEC;
  for (int v = threadIdx.x; v < rows * VECS; v += THREADS) {
    const int r = v / VECS, c = (v % VECS) * PER_VEC;
    const long long off = row_off(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src + off + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

template <typename T, int HD, int VD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
          int Sk, int KV, int G, float scale, int causal, int window,
          int prefix) {
  constexpr int PITCH = HD + 16 / sizeof(T);   // 16-byte rows, staggered banks
  constexpr int VPITCH = VD + 16 / sizeof(T);
  constexpr int KPT = BN / 4;                  // keys scored per thread
  constexpr int DPT = VD / 4;                  // acc columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * PITCH;
  T* Vs = Ks + BN * PITCH;
  float* Ps = reinterpret_cast<float*>(Vs + BN * VPITCH);  // (BM, BN + 1)

  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
  const int r = threadIdx.x / 4, q4 = threadIdx.x % 4;
  const int row = r0 + r;
  const int qpos = row / G;
  const bool row_ok = row < rows;

  // q row (pos, g) lives at ((b*Sq + pos)*KV + kvh)*G*HD + g*HD; the
  // output's (B, Sq, KV*G, vd) row at the same index with VD
  auto row_off = [&](int i, int w) -> long long {
    const int rr = r0 + i;
    if (rr >= rows) return -1;
    return ((long long)(b * Sq + rr / G) * KV + kvh) * G * w +
           (long long)(rr % G) * w;
  };
  auto q_off = [&](int i) { return row_off(i, HD); };
  load_rows<T, HD>(Qs, PITCH, q, BM, q_off);

  // key range this tile of rows can see (causal block-skip + window; rows
  // below the prefix also see every key below it)
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

  float m_run = MASK_NEG_INF, l_run = 0.f;
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
      if (causal)
        ok = ok && ((kp <= qpos && (window <= 0 || kp > qpos - window)) ||
                    (qpos < prefix && kp < prefix));
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
      const T* vr = Vs + c * VPITCH + q4;
#pragma unroll 16
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, to_f(vr[4 * j]), acc[j]);
    }
    __syncthreads();
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* o = out + row_off(r, VD);
    for (int j = 0; j < DPT; ++j) o[q4 + 4 * j] = from_f<T>(acc[j] * inv);
    if (m_out != nullptr && q4 == 0) {   // (b, kvh, g, pos) of (B, KV, G, Sq)
      const size_t idx = ((size_t)(b * KV + kvh) * G + row % G) * Sq + qpos;
      m_out[idx] = m_run;
      l_out[idx] = l_run;
    }
  }
}

template <typename T, int HD, int VD, int BN>
int launch(const void* q, const void* k, const void* v, void* out,
           float* m_out, float* l_out, int B, int Sq, int Sk, int KV, int G,
           float scale, int causal, int window, int prefix, cudaStream_t s) {
  constexpr int PITCH = HD + 16 / sizeof(T);
  constexpr int VPITCH = VD + 16 / sizeof(T);
  const size_t smem = ((size_t)(BM + BN) * PITCH + (size_t)BN * VPITCH) *
                          sizeof(T) +
                      (size_t)BM * (BN + 1) * sizeof(float);
  auto kern = flash_fwd<T, HD, VD, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq * G + BM - 1) / BM, KV, B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, Sq, Sk,
      KV, G, scale, causal, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dispatch_widths(int hd, int vd, const void* q, const void* k,
                    const void* v, void* out, float* m_out, float* l_out,
                    int B, int Sq, int Sk, int KV, int G, float scale,
                    int causal, int window, int prefix, cudaStream_t s) {
#define REPRO_CASE(H, V)                                                    \
  if (hd == H && vd == V)                                                   \
    return launch<T, H, V, BN>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G, \
                               scale, causal, window, prefix, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

// keys per tile: 80 at vd = 256 with two consumer warpgroups (fewer, longer
// tiles where the grid is large; S 40 registers, two P tiles 20 each, O
// 128), else 64 (the small grids' latency is lower with shorter tiles)
__host__ __device__ constexpr int keys_per_tile(int vd, int nwg) {
  return vd == 256 && nwg == 2 ? 80 : 64;
}

// K/V ring depth: as many stages as fit beside the Q tiles (2 at hd = vd
// = 256), at most 4; hk and hv are the widths padded to whole 64-column
// tiles
__host__ __device__ constexpr int stages(int hk, int hv, int nwg) {
  const int bn = keys_per_tile(hv, nwg);
  const int fit = (225 * 1024 - nwg * (int)tile_bytes(64, hk)) /
                  ((int)tile_bytes(bn, hk) + (int)tile_bytes(bn, hv));
  return fit < 4 ? fit : 4;
}

__device__ __forceinline__ bool visible(int kp, int qp, int Sk, int causal,
                                        int window, int prefix) {
  if (kp >= Sk) return false;
  if (!causal) return true;
  return (kp <= qp && (window <= 0 || kp > qp - window)) ||
         (qp < prefix && kp < prefix);
}

template <int HD, int VD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const bf16* __restrict__ q, bf16* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
             int Sk, int KV, int G, float scale_log2, int causal,
             int window, int prefix) {
  constexpr int HK = pad64(HD), HV = pad64(VD);
  constexpr int BN = keys_per_tile(VD, NWG);
  constexpr uint32_t Q_BYTES = tile_bytes(64, HK);
  using Ring = KVRing<HK, HV, BN, stages(HK, HV, NWG)>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);           // NWG x Q_BYTES
  Ring ring(Qs + NWG * Q_BYTES);

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G;
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
    // row (pos, g) of q: ((b*Sq + pos)*KV + kvh)*G*HD + g*HD; of out the
    // same with VD
    auto row_off = [&](int row, int w) -> long long {
      if (row >= rows) return -1;
      return ((long long)(b * Sq + row / G) * KV + kvh) * G * w +
             (long long)(row % G) * w;
    };
    load_rows_sw128<HD>(Qw, q, tid,
                        [&](int i) { return row_off(rw + i, HD); });
    cp_async_wait_all();
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    const int row0 = rw + warp * 16 + lane / 4, row1 = row0 + 8;
    const int qp0 = row0 / G, qp1 = row1 / G;
    const int t4 = lane % 4;
    // the warpgroup's position range, for the tiles that need no mask
    const int wq_lo = rw / G;
    const int wq_hi = (min(rw + 64, rows) - 1) / G;

    const uint64_t dq = make_desc(Qw, 16, 1024);
    float m0 = MASK_NEG_INF, m1 = MASK_NEG_INF, l0 = 0.f, l1 = 0.f;
    float corr0 = 1.f, corr1 = 1.f;
    float o[HV / 2];
    float sc[BN / 2];
    uint32_t p[BN / 16][4], pn[BN / 16][4];
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;

    // S = Q K^T of tile t over hd in steps of 16 (32 bytes along a
    // swizzled row; 6 steps at hd = 96), committed as one group
    auto issue_s = [&](int t) {
      const uint64_t dk = make_desc(ring.k_tile(t), 16, 1024);
      ring.wait_k(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qo = (kk / 4) * 8192 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BN * 128 + (kk % 4) * 32;
        wgmma_ss<BN>(sc, dq + (qo >> 4), dk + (ko >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile t over its keys in steps of 16 (two 8-row groups),
    // V read MN-major; P from `pa`
    auto issue_pv = [&](int t, uint32_t (&pa)[BN / 16][4]) {
      const uint64_t dv = make_desc(ring.v_tile(t), BN * 128, 1024);
      ring.wait_v(t);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_mn<HV>(o, pa[kk], dv + ((kk * 2048) >> 4), 1);
      wgmma_commit();
    };
    // scale (log2 domain), mask and the online softmax of tile t's scores
    // in registers: updates m, l and corr, writes P (V's dtype) to `pa`
    auto softmax = [&](int t, uint32_t (&pa)[BN / 16][4]) {
      const int k0 = kstart + t * BN;
      const bool need_mask =
          k0 + BN > Sk ||
          (causal && (k0 + BN - 1 > wq_lo ||
                      (window > 0 && k0 <= wq_hi - window)));
      // max of the raw scores; a masked score is -inf, so it adds
      // 2^-inf = 0 below (exp(MASK_NEG_INF - m) of any row with a visible
      // key) and the running max, which starts at MASK_NEG_INF, stays
      // finite
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sc[4 * j + e];
          float c = sc[4 * j + 2 + e];
          if (need_mask) {
            const int kp = k0 + 8 * j + 2 * t4 + e;
            if (!visible(kp, qp0, Sk, causal, window, prefix)) a = -INFINITY;
            if (!visible(kp, qp1, Sk, causal, window, prefix)) c = -INFINITY;
          }
          sc[4 * j + e] = a;
          sc[4 * j + 2 + e] = c;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // the running max in the log2 domain (scale_log2 > 0 keeps the
      // order), then p = 2^(s * scale_log2 - max) in one fused multiply-add
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      corr0 = exp2_fast(m0 - mn0);
      corr1 = exp2_fast(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa0 = exp2_fast(fmaf(sc[4 * j + e], scale_log2, -mn0));
          const float pa1 =
              exp2_fast(fmaf(sc[4 * j + 2 + e], scale_log2, -mn1));
          ls0 += pa0;
          ls1 += pa1;
          sc[4 * j + e] = pa0;
          sc[4 * j + 2 + e] = pa1;
        }
      }
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
      // keys 16kk.. of rows row0 / row1, as the A operand of P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // Software pipeline inside the warpgroup: while P V of tile t - 1 runs
    // on the tensor cores, the scores of tile t are already in and their
    // softmax runs on the CUDA cores.  O is rescaled once P V of t - 1 is
    // done; K of a stage is released when its scores are in, V when its
    // product is.  P alternates between two register tiles (`cur` feeds
    // the product in flight, `nxt` takes the new softmax), so no copy.
    auto step = [&](int t, uint32_t (&cur)[BN / 16][4],
                    uint32_t (&nxt)[BN / 16][4]) {
      issue_s(t);
      issue_pv(t - 1, cur);
      wgmma_wait<1>();                         // S of tile t is in
      fence_regs(sc);
      ring.release_k(t);
      softmax(t, nxt);
      wgmma_wait<0>();                         // P V of tile t - 1 is done
      fence_regs(o);
      fence_regs(cur);
      ring.release_v(t - 1);
#pragma unroll
      for (int j = 0; j < HV / 8; ++j) {
        o[4 * j + 0] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
    };
    auto finish = [&](uint32_t (&last)[BN / 16][4]) {
      fence_regs(o);
      wgmma_fence();
      issue_pv(ntiles - 1, last);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(last);
      ring.release_v(ntiles - 1);
    };
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    ring.release_k(0);
    softmax(0, p);
    int t = 1;
    for (; t + 1 < ntiles; t += 2) {
      step(t, p, pn);
      step(t + 1, pn, p);
    }
    if (t < ntiles) {
      step(t, p, pn);
      finish(pn);
    } else {
      finish(p);
    }

    // flush: divide by max(l, 1e-30), bf16 pairs straight from registers
    // (staging them in shared memory for 16-byte stores measured slower)
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const long long o0 = row_off(row0, VD), o1 = row_off(row1, VD);
#pragma unroll
    for (int j = 0; j < VD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (o0 >= 0)
        *reinterpret_cast<uint32_t*>(out + o0 + col) =
            pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      if (o1 >= 0)
        *reinterpret_cast<uint32_t*>(out + o1 + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (m_out != nullptr && t4 == 0) {   // (b, kvh, g, pos) of (B, KV, G, Sq)
      if (o0 >= 0) {
        const size_t i0 = ((size_t)(b * KV + kvh) * G + row0 % G) * Sq + qp0;
        m_out[i0] = m0 * LN2;
        l_out[i0] = l0;
      }
      if (o1 >= 0) {
        const size_t i1 = ((size_t)(b * KV + kvh) * G + row1 % G) * Sq + qp1;
        m_out[i1] = m1 * LN2;
        l_out[i1] = l1;
      }
    }
  }
}

template <int HD, int VD, int NWG>
int launch(const void* q, const void* k, const void* v, void* out,
           float* m_out, float* l_out, int B, int Sq, int Sk, int KV, int G,
           float scale, int causal, int window, int prefix, cudaStream_t s) {
  constexpr int HK = pad64(HD), HV = pad64(VD);
  constexpr int BN = keys_per_tile(VD, NWG);
  CUtensorMap tm_k, tm_v;
  int err = encode_rows_map(&tm_k, k, B, Sk, KV, HD, BN);
  if (err == 0) err = encode_rows_map(&tm_v, v, B, Sk, KV, VD, BN);
  if (err != 0) return err;
  constexpr size_t smem = 1024 + NWG * tile_bytes(64, HK) +
                          KVRing<HK, HV, BN, stages(HK, HV, NWG)>::BYTES;
  auto kern = flash_fwd_tc<HD, VD, NWG>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq * G + 64 * NWG - 1) / (64 * NWG), KV, B);
  kern<<<grid, 128 * (NWG + 1), smem, s>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<bf16*>(out),
      m_out, l_out, Sq, Sk, KV, G, scale * LOG2E, causal, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

// two consumer warpgroups (128-row blocks) once those blocks fill the SMs
template <int HD, int VD>
int launch_rows(const void* q, const void* k, const void* v, void* out,
                float* m_out, float* l_out, int B, int Sq, int Sk, int KV,
                int G, float scale, int causal, int window, int prefix,
                cudaStream_t s) {
  const long long blocks128 = (long long)((Sq * G + 127) / 128) * KV * B;
  if (blocks128 >= sm_count())
    return launch<HD, VD, 2>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G,
                             scale, causal, window, prefix, s);
  return launch<HD, VD, 1>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G,
                           scale, causal, window, prefix, s);
}

int dispatch(int hd, int vd, const void* q, const void* k, const void* v,
             void* out, float* m_out, float* l_out, int B, int Sq, int Sk,
             int KV, int G, float scale, int causal, int window, int prefix,
             cudaStream_t s) {
#define REPRO_CASE(H, V)                                                   \
  if (hd == H && vd == V)                                                  \
    return launch_rows<H, V>(q, k, v, out, m_out, l_out, B, Sq, Sk, KV, G, \
                             scale, causal, window, prefix, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); (hd, vd) a
// pair of REPRO_FLASH_WIDTHS (hopper.cuh); all tensors contiguous and
// 16-byte aligned.  m_out and
// l_out: both null (no export) or both (B, KV, G, Sq) float32.  window and
// prefix apply with causal = 1 only (0: none).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* m_out, void* l_out, int B,
                               int Sq, int Sk, int KV, int G, int hd, int vd,
                               float scale, int causal, int window, int prefix,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  if (dtype == 1)
    return tc::dispatch(hd, vd, q, k, v, out, mo, lo, B, Sq, Sk, KV, G,
                        scale, causal, window, prefix, s);
  if (dtype == 0)
    return dispatch_widths<float, 32>(hd, vd, q, k, v, out, mo, lo, B, Sq, Sk,
                                      KV, G, scale, causal, window, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
