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
// ((pos + 1) * 2 * hd elements per KV head, or the window's) and does
// 4 * G * hd flops per key, so it is bound by device-memory bytes.  One
// block per (slot, KV head) would put 4 blocks on 132 SMs at gemma-2b's
// serving shape, each walking its pages alone.
//
// Design: split-k over pages (flash decoding), two launches.
//   decode_split: a block per (split, slot x KV head); split s of
//     ops.decode_splits(slots, KV, width) owns pages [s * per, (s + 1) * per)
//     of its slot's table (a host rule on the table's width, never on pos,
//     which is device data).  It runs the 16-key tiles of those pages that
//     hold a live key (the reference's dynamic block-skip: past pos, or
//     wholly behind the window, a tile never runs); a split with none, or a
//     dead slot's (pos == -1), writes an inert partial (m = MASK_NEG_INF,
//     l = 0) and exits.  Each warp of the block takes every W-th of those
//     tiles and streams them through its own ring of stages, a TMA bulk
//     copy a K or V row a lane completing on the stage's mbarrier (the
//     next tile's slab index read a step ahead), so no barrier stops the
//     block between tiles and no warp repeats another's work.  A warp
//     scores a tile for all G rows as S = Q K^T (mma.sync m16n8k16: M the
//     G rows, N the 16 keys, K = hd; its accumulator is already P^T's
//     register layout for the next product), runs the online softmax, and
//     adds out^T = V^T P^T over all value columns (M = 16 columns an mma, N
//     the G rows, 8 or 16, K the 16 keys).  p is rounded to the pool's
//     dtype before P V, as emit.py does; each tile's product lands in a
//     fresh accumulator added to the rescaled sum with round-to-nearest
//     arithmetic.  The f32 pool runs the same tiles with f32 fused
//     multiply-adds in the same register layout.  The warps' (m, l, acc)
//     are then folded in warp order into the split's partial.
//   decode_combine: folds the live splits' (m, l, acc) partials in split
//     order (the same bits on every run) and writes acc / max(l, 1e-30),
//     the reference's flush; a dead slot's row is 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int KT = 16;          // keys a tile: one mma's K depth
constexpr int MAXG = 16;
constexpr int MAXD = 256;
constexpr int MT = MAXD / 16;   // value-column tiles of the widest head
constexpr int COMBINE = 256;    // threads of the combine kernel (>= hd)
constexpr int PREFETCH = 16;    // partials a combine thread loads at once
constexpr int MAX_SPLITS = 1024;
constexpr float MASK_NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

// warps a block and stages a warp: the rings fill most of a SM's shared
// memory (one block a SM)
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int W = 4, STAGES = 3;
};
template <>
struct Cfg<float> {
  static constexpr int W = 3, STAGES = 2;
};

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* pos;
  const int* tables;
  float* out;
  float* part;    // acc (nsplit, SK, G, hd), then m and l (nsplit, SK, G)
  int slots, KV, G, hd, page, width, per, nsplit;
  float scale;
  int window;
};

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}
// elements a staged row: the columns rounded up to 16, one 16-byte pad
template <typename T>
__host__ __device__ __forceinline__ int pitch(int hd) {
  return round16(hd) + 16 / (int)sizeof(T);
}
// Q (MAXG, pitch), the f32 warps' p tiles, then the warps' rings
template <typename T>
__host__ __device__ __forceinline__ int p_floats() {
  return std::is_same<T, float>::value ? Cfg<T>::W * MAXG * (KT + 1) : 0;
}
template <typename T>
__host__ __device__ __forceinline__ size_t split_smem(int hd) {
  return sizeof(T) * (size_t)MAXG * pitch<T>(hd) +
         sizeof(float) * p_floats<T>() +
         sizeof(T) * (size_t)Cfg<T>::W * Cfg<T>::STAGES * 2 * KT *
             pitch<T>(hd);
}

using hopper::smem_u32;

// `bytes` (a multiple of 16) from global to shared memory as one bulk copy
// (TMA, no tensor map), counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using hopper::pack_bf16;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The tile holding view position x: page x / page, 16-key tile within it.
__device__ __forceinline__ int tile_of(int x, int page, int tpp) {
  return x / page * tpp + x % page / KT;
}

// The live tiles of a slot at position vpos >= 0, [lo, hi]: from the
// window's first key (or key 0) to the query's own, within the table.
__device__ __forceinline__ int2 live_tiles(const Args& a, int vpos,
                                           int tpp) {
  const int first = a.window > 0 ? max(0, vpos - a.window + 1) : 0;
  return make_int2(tile_of(first, a.page, tpp),
                   min(tile_of(vpos, a.page, tpp), a.width * tpp - 1));
}

// Register layout shared by both dtypes (mma.sync's m16n8 accumulator),
// with lane = 4 g + t:
//   scores s[j][i], key half j (keys 8j ..): i = 0, 1 -> row g, keys
//     8j + 2t, +1; i = 2, 3 -> row g + 8, the same keys;
//   out^T acc[mt][n][i], value-column tile mt, row tile n (rows 8n ..):
//     i = 0, 1 -> column 16 mt + g, rows 8n + 2t, +1; i = 2, 3 -> column
//     + 8, the same rows.
template <typename T, int NT>
__global__ void __launch_bounds__(Cfg<T>::W * 32)
decode_split(Args args) {
  constexpr int W = Cfg<T>::W, STAGES = Cfg<T>::STAGES, NTHR = W * 32;
  constexpr bool F32 = std::is_same<T, float>::value;
  // bf16 with G <= 8: the Q fragments stay in registers (32 of them)
  constexpr bool QREG = !F32 && NT == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[W * STAGES];
  const int P = pitch<T>(args.hd);
  T* qs = reinterpret_cast<T*>(smem);                   // (MAXG, P)
  float* ps = reinterpret_cast<float*>(qs + MAXG * P);  // f32 p tiles
  T* ring = reinterpret_cast<T*>(ps + p_floats<T>());
  const int split = blockIdx.x, sk = blockIdx.y;
  const int slot = sk / args.KV, kh = sk - slot * args.KV;
  const int G = args.G, hd = args.hd, page = args.page;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int vpos = args.pos[slot];
  const int tpp = (page + KT - 1) / KT;
  const size_t n_acc = (size_t)args.nsplit * args.slots * args.KV * G * hd;
  const size_t row0 = ((size_t)split * args.slots * args.KV + sk) * G;
  float* m_out = args.part + n_acc + row0;
  float* l_out = m_out + (size_t)args.nsplit * args.slots * args.KV * G;

  // this split's live tiles, [lo, hi]: the reference's block-skip
  int lo = split * args.per * tpp;
  int hi = min(args.width, (split + 1) * args.per) * tpp - 1;
  if (vpos >= 0) {
    const int2 live = live_tiles(args, vpos, tpp);
    lo = max(lo, live.x);
    hi = min(hi, live.y);
  }
  if (vpos < 0 || lo > hi) {
    if (tid < G) {
      m_out[tid] = MASK_NEG_INF;
      l_out[tid] = 0.f;
    }
    return;
  }
  const int mt_count = round16(hd) / 16;
  const int width16 = round16(hd);
  const T* qp = static_cast<const T*>(args.q) + (size_t)sk * G * hd;
  const T* kpool = static_cast<const T*>(args.k_pool);
  const T* vpool = static_cast<const T*>(args.v_pool);
  const int* table = args.tables + (size_t)slot * args.width;

  // Q's 16-byte pieces (zero past G and past hd), loaded now: they do not
  // wait for the page table
  constexpr int PER16 = 16 / sizeof(T);
  constexpr int QLOADS = (MAXG * MAXD / PER16 + NTHR - 1) / NTHR;
  const int qv = width16 / PER16;
  uint4 qreg[QLOADS];
#pragma unroll
  for (int i = 0; i < QLOADS; ++i) {
    const int e = tid + i * NTHR, r = e / qv, c = (e - r * qv) * PER16;
    qreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < MAXG * qv && r < G && c < hd)
      qreg[i] = __ldg(reinterpret_cast<const uint4*>(qp + r * hd + c));
  }

  // this warp's tiles: lo + warp + W i, i < nw
  const int nw = (hi - lo - warp + W) / W;
  T* wring = ring + (size_t)warp * STAGES * 2 * KT * P;
  uint64_t* wbar = bars + warp * STAGES;
  const size_t rs = (size_t)args.KV * hd;   // pool elements a token
  const uint32_t row_bytes = hd * sizeof(T);
  auto tile_at = [&](int i) { return lo + warp + W * i; };
  auto slab_of = [&](int i) { return __ldg(table + tile_at(i) / tpp); };
  // the warp's i-th tile into `stage`: K row j from lane j, V row j from
  // lane 16 + j, a bulk copy each counted on the stage's barrier; rows
  // past the page's end are zeroed instead (masked below, and 0 in P V)
  auto load = [&](int i, int stage, int slab_id) {
    const int c0 = (tile_at(i) % tpp) * KT;
    const int keys = min(KT, page - c0);
    uint64_t* bar = wbar + stage;
    if (lane == 0) hopper::mbar_expect_tx(bar, 2 * keys * row_bytes);
    __syncwarp();
    const int j = lane & (KT - 1);
    T* dst = wring + ((size_t)stage * 2 + (lane >= KT)) * KT * P + j * P;
    if (j < keys) {
      hopper::fence_proxy_async();
      bulk_copy(dst,
                (lane >= KT ? vpool : kpool) +
                    ((size_t)slab_id * page + c0 + j) * rs + (size_t)kh * hd,
                row_bytes, bar);
    } else {
      for (int c = 0; c < hd; c += PER16)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // the first tiles' copies go out before Q is staged
  int first_slab[STAGES - 1];
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    first_slab[i] = i < nw ? slab_of(i) : 0;
  if (lane == 0) {
    for (int i = 0; i < STAGES; ++i) hopper::mbar_init(wbar + i, 1);
    hopper::fence_barrier_init();
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < nw) load(i, i, first_slab[i]);
  int slab = STAGES - 1 < nw ? slab_of(STAGES - 1) : 0;
  // Q into shared memory; columns past hd (to the next 16) zero in every
  // stage, as the scores sum over them
#pragma unroll
  for (int i = 0; i < QLOADS; ++i) {
    const int e = tid + i * NTHR, r = e / qv, c = (e - r * qv) * PER16;
    if (e < MAXG * qv) *reinterpret_cast<uint4*>(qs + r * P + c) = qreg[i];
  }
  for (int e = tid; e < W * STAGES * 2 * KT; e += NTHR)
    for (int c = hd; c < width16; ++c) ring[e * P + c] = T(0.f);
  __syncthreads();

  const int mi = lane >> 3;   // ldmatrix: the matrix this lane addresses
  // Q (rows 0-7 | 8-15) x (columns 16 kk + 0-7 | 8-15)
  const T* qaddr = qs + ((mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
  uint32_t qa[QREG ? MT : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < MT; ++kk)
      if (kk < mt_count) {
        ldsm_x4(qa[kk], qaddr + 16 * kk);
        qa[kk][1] = qa[kk][3] = 0u;   // rows 8-15: past G
      }
  }

  float m_run[NT], l_run[NT];
  float acc[MT][NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m_run[n] = MASK_NEG_INF;
    l_run[n] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;

  for (int it = 0; it < nw; ++it) {
    const int stage = it % STAGES;
    hopper::mbar_wait(wbar + stage, (it / STAGES) & 1);
    __syncwarp();
    const int ahead = it + STAGES - 1;
    if (ahead < nw) load(ahead, ahead % STAGES, slab);
    if (ahead + 1 < nw) slab = slab_of(ahead + 1);

    const T* ks = wring + (size_t)stage * 2 * KT * P;
    const T* vs = ks + KT * P;
    const int tile = tile_at(it);
    const int p = tile / tpp, c0 = (tile - p * tpp) * KT;

    // scores S = Q K^T for the tile's 16 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (F32) {
      const float* q0 = reinterpret_cast<const float*>(qs) + g * P;
      for (int d = 0; d < hd; d += 4) {
#pragma unroll
        for (int r = 0; r < NT; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(q0 + 8 * r * P + d);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 k4 = *reinterpret_cast<const float4*>(
                  ks + (8 * j + 2 * t + e) * P + d);
              float x = s[j][2 * r + e];
              x = fmaf(a.x, k4.x, x);
              x = fmaf(a.y, k4.y, x);
              x = fmaf(a.z, k4.z, x);
              x = fmaf(a.w, k4.w, x);
              s[j][2 * r + e] = x;
            }
        }
      }
    } else {
      // K (keys 0-7 | 8-15) x (columns 16 kk + 0-7 | 8-15), four k-steps'
      // fragments loaded together; even and odd k-steps in separate
      // accumulators, two shorter chains of dependent products
      const T* kaddr = ks + ((mi >> 1) * 8 + (lane & 7)) * P + (mi & 1) * 8;
      float s1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k4 = 0; k4 < MT; k4 += 4) {
        uint32_t b[4][4], a[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u < mt_count) {
            ldsm_x4(b[u], kaddr + 16 * (k4 + u));
            if constexpr (!QREG) ldsm_x4(a[u], qaddr + 16 * (k4 + u));
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u < mt_count) {
            if constexpr (QREG) {
#pragma unroll
              for (int i = 0; i < 4; ++i) a[u][i] = qa[k4 + u][i];
            }
            float (&d)[2][4] = u & 1 ? s1 : s;
            mma(d[0], a[u], b[u][0], b[u][1]);
            mma(d[1], a[u], b[u][2], b[u][3]);
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += s1[j][i];
    }

    // the online softmax over the tile's live keys, rows g (and g + 8)
    float corr[NT], pr[NT][4];
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      float x[4], mx = MASK_NEG_INF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = 8 * (i >> 1) + 2 * t + (i & 1);
        const int kp = p * page + c0 + kk;
        const bool ok = c0 + kk < page && kp <= vpos &&
                        (args.window <= 0 || kp > vpos - args.window);
        x[i] = ok ? s[i >> 1][2 * r + (i & 1)] * args.scale : MASK_NEG_INF;
        mx = fmaxf(mx, x[i]);
      }
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[r][i] = expf(x[i] - m_new);
        sum += pr[r][i];
      }
      corr[r] = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr[r] + quad_sum(sum);
      m_run[r] = m_new;
    }

    // out^T += V^T P^T over every value-column tile
    float cs[NT][2];   // rescale of rows 8n + 2t, +1 (from lanes 8t, 8t + 4)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      cs[n][0] = __shfl_sync(0xffffffffu, corr[n], 8 * t);
      cs[n][1] = __shfl_sync(0xffffffffu, corr[n], 8 * t + 4);
    }
    if constexpr (F32) {
      float* pw = ps + warp * MAXG * (KT + 1);
#pragma unroll
      for (int r = 0; r < NT; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(g + 8 * r) * (KT + 1) + 8 * (i >> 1) + 2 * t + (i & 1)] =
              pr[r][i];
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= mt_count) continue;
        const float* v0 = reinterpret_cast<const float*>(vs) + 16 * mt + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* p0 = pw + (8 * n + 2 * t) * (KT + 1);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const float va = v0[kk * P], vb = v0[kk * P + 8];
            const float pa = p0[kk], pb = p0[KT + 1 + kk];
            d[0] = fmaf(pa, va, d[0]);
            d[1] = fmaf(pb, va, d[1]);
            d[2] = fmaf(pa, vb, d[2]);
            d[3] = fmaf(pb, vb, d[3]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][n][i] = __fmaf_rn(acc[mt][n][i], cs[n][i & 1], d[i]);
        }
      }
    } else {
      // P^T as B fragments: keys 2t, +1 and 8 + 2t, +1 of rows 8n + g
      uint32_t pb[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        pb[n][0] = pack_bf16(pr[n][0], pr[n][1]);
        pb[n][1] = pack_bf16(pr[n][2], pr[n][3]);
      }
      const T* vaddr = vs + ((mi >> 1) * 8 + (lane & 7)) * P + (mi & 1) * 8;
#pragma unroll
      for (int m4 = 0; m4 < MT; m4 += 4) {
        uint32_t a[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (m4 + u < mt_count) ldsm_x4_t(a[u], vaddr + 16 * (m4 + u));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (m4 + u >= mt_count) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma(d, a[u], pb[n][0], pb[n][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[m4 + u][n][i] =
                  __fmaf_rn(acc[m4 + u][n][i], cs[n][i & 1], d[i]);
          }
        }
      }
    }
  }

  // the warps' states, folded in warp order into the split's partial
  // (a warp without tiles holds m = MASK_NEG_INF, l = 0, acc = 0)
  __syncthreads();
  float* fa = reinterpret_cast<float*>(ring);   // (W, G, hd)
  float* fm = fa + W * G * hd;                  // (W, G)
  float* fl = fm + W * G;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_count) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * n + 2 * t + (i & 1), c = 16 * mt + g + 8 * (i >> 1);
        if (r < G && c < hd) fa[(warp * G + r) * hd + c] = acc[mt][n][i];
      }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < NT; ++r)
      if (g + 8 * r < G) {
        fm[warp * G + g + 8 * r] = m_run[r];
        fl[warp * G + g + 8 * r] = l_run[r];
      }
  }
  __syncthreads();
  // each warp's weight exp(m_w - m) a row, then the rows' m and l
  float* fw = fl + W * G;                       // (W, G)
  for (int r = tid; r < G; r += NTHR) {
    float mx = MASK_NEG_INF, l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, fm[w * G + r]);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = expf(fm[w * G + r] - mx);
      fw[w * G + r] = c;
      l = __fadd_rn(l, __fmul_rn(c, fl[w * G + r]));
    }
    m_out[r] = mx;
    l_out[r] = l;
  }
  __syncthreads();
  float* acc_out = args.part + row0 * hd;
  for (int e = tid; e < G * hd; e += NTHR) {
    const int r = e / hd;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w)
      a = __fadd_rn(a, __fmul_rn(fw[w * G + r], fa[w * G * hd + e]));
    acc_out[e] = a;
  }
}

// A block per (slot x KV head, row): the live splits' partials (those in
// the slot's live tile range; the others are inert) in split order, a
// thread a column.  Its first PREFETCH partials are loaded with the m and
// l values, before the weights exp(m_s - m) are known.
__global__ void __launch_bounds__(COMBINE) decode_combine(Args args) {
  __shared__ float cw[MAX_SPLITS], lw[MAX_SPLITS], red[COMBINE / 32];
  const int sk = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int G = args.G, hd = args.hd;
  float* out = args.out + ((size_t)sk * G + r) * hd;
  const int vpos = args.pos[sk / args.KV];
  if (vpos < 0) {
    if (d < hd) out[d] = 0.f;
    return;
  }
  const int tpp = (args.page + KT - 1) / KT;
  const int2 live = live_tiles(args, vpos, tpp);
  const int s0 = live.x / (args.per * tpp);
  const int n = live.y / (args.per * tpp) - s0 + 1;
  const size_t rows = (size_t)args.slots * args.KV * G;
  const size_t row = (size_t)sk * G + r;
  const float* acc = args.part + (s0 * rows + row) * hd + d;
  const size_t stride = rows * hd;
  float av[PREFETCH];
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i)
    av[i] = i < n && d < hd ? acc[i * stride] : 0.f;
  const float* m = args.part + (size_t)args.nsplit * stride + s0 * rows + row;
  const float* l = m + args.nsplit * rows;
  float mx = MASK_NEG_INF;
  for (int i = d; i < n; i += COMBINE) {
    cw[i] = m[i * rows];
    lw[i] = l[i * rows];
    mx = fmaxf(mx, cw[i]);
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((d & 31) == 0) red[d >> 5] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < COMBINE / 32; ++w) mx = fmaxf(mx, red[w]);
  for (int i = d; i < n; i += COMBINE) cw[i] = expf(cw[i] - mx);
  __syncthreads();
  if (d >= hd) return;
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i)
    if (i < n) {
      den = __fadd_rn(den, __fmul_rn(cw[i], lw[i]));
      num = __fadd_rn(num, __fmul_rn(cw[i], av[i]));
    }
#pragma unroll 16
  for (int i = PREFETCH; i < n; ++i) {
    den = __fadd_rn(den, __fmul_rn(cw[i], lw[i]));
    num = __fadd_rn(num, __fmul_rn(cw[i], acc[i * stride]));
  }
  out[d] = num / fmaxf(den, 1e-30f);
}

constexpr int MAX_DEVICES = 64;

template <typename T, int NT>
cudaError_t launch_split(const Args& a, cudaStream_t s) {
  // the shared-memory limit is an attribute of each device's function
  static bool attr[MAX_DEVICES] = {};
  auto kern = decode_split<T, NT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !attr[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)split_smem<T>(MAXD));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  kern<<<dim3(a.nsplit, a.slots * a.KV), Cfg<T>::W * 32, split_smem<T>(a.hd),
         s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t err = a.G > 8 ? launch_split<T, 2>(a, s)
                            : launch_split<T, 1>(a, s);
  if (err != cudaSuccess) return err;
  decode_combine<<<dim3(a.slots * a.KV, a.G), COMBINE, 0, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16 (q and both pools alike); G <= 16, hd <=
// 256 and a multiple of 8; every table entry a slab of the pool; part holds
// nsplit * slots * KV * G * (hd + 2) floats.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* pos,
                                  const void* tables, void* out, void* part,
                                  int slots, int KV, int G, int hd, int page,
                                  int width, int nsplit, float scale,
                                  int window, int dtype, void* stream) {
  Args a;
  a.slots = slots;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.page = page;
  a.width = width;
  a.nsplit = nsplit;
  a.window = window;
  if (a.G < 1 || a.G > MAXG || a.hd < 8 || a.hd > MAXD || a.hd % 8 != 0 ||
      a.slots < 1 || a.KV < 1 || a.slots * a.KV > 65535 || a.page < 1 ||
      a.width < 1 || a.nsplit < 1 || a.nsplit > min(a.width, MAX_SPLITS) ||
      !aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool))
    return static_cast<int>(cudaErrorInvalidValue);
  a.per = (a.width + a.nsplit - 1) / a.nsplit;
  if ((long long)(a.nsplit - 1) * a.per >= a.width)   // an empty split
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.pos = static_cast<const int*>(pos);
  a.tables = static_cast<const int*>(tables);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1   ? launch<__nv_bfloat16>(a, s)
                    : dtype == 0 ? launch<float>(a, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
