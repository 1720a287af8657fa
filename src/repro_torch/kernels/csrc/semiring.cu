// K9: the general-semiring contraction of a normal form
//
//   out[o] = fold_{k in contracted axes} combine(in_0[o, k], in_1[o, k], ..)
//
// over up to 4 out axes and 3 contracted axes, 1-3 operands; every operand
// element is cast to f32, the combine op (mul or add) pairs the operands
// left to right, the reduce op (add, max or min) folds the contracted axes
// from its identity (0, -inf, +inf) in f32, and the result is written in
// the out dtype (f32 or bf16).  With no contracted axis it is a pure
// pairing (Hadamard); with one operand a pure fold (a lone reduce).
//
// Replaces: src/repro/kernels/emit.py, emit_pallas with a semiring other
// than (mul, add): _general_combine (emit.py:125-145), the
// identity-initialised accumulator (emit.py:192-211) and its pallas_call
// (emit.py:217), with the pad/run/slice of emit_bundle (emit.py:1105-1146)
// that ops.apply reaches it through.  Here nothing is padded or copied:
// the caller (kernels/emit.py) passes descriptors with each operand's
// flat affine access (an int64 element stride per axis and a base offset,
// straight from the normal form's LeafSpec.access), so col-layout and
// transposed leaves and psi slabs are read in place, and the kernels mask
// past the logical extents, which is what the reference's padding with the
// inert element amounts to.
//
// Exactness: the pair rounds once (__fmul_rn / __fadd_rn) and max / min
// fold with PTX max.NaN / min.NaN, which propagate a NaN as torch.maximum
// and torch.amax do (fmaxf would drop it), so (add, max) and (add, min)
// equal their plain version bit for bit at any shape and in any fold
// order.  The tiled (mul, add) path multiplies on the tensor cores, each
// f32 operand as bf16 hi and lo parts (three products, within about 2^-16
// of each f32 product, far inside the sums' tolerance; an inf, a NaN or a
// finite value past bf16's range gives the inf, NaN or finite sum of f32
// FMAs (split2), but for an inf times a nonzero value below bf16's
// smallest subnormal, 2^-133: NaN where f32 gives inf); the other paths
// round the pair and the fold.  Every fold runs in a fixed order, so a sum
// gives the same bits on every run (no atomics).
//
// What bounds it on an H100: f32 runs outside the tensor cores, 67
// TFLOP/s, i.e. 33.5 T lane-instructions/s.  A tropical term is an add and
// a max, two instructions no FMA fuses: 2 M N K / 33.5e12 s (32.8 ms at
// 8192^3); a (mul, add) term is one FMA, 2 M N K / 67e12 s, or three bf16
// tensor-core products, 6 M N K / 989e12 s.  Hadamard, the
// outer and Kronecker products and a lone reduce are bound by their bytes
// at 3.35 TB/s.
//
// Design: one C call runs one to two descriptors (kernels/emit.py picks
// the path on the host, Launch.mode, and every copy width and split):
//  - TILE: two operands, one contracted axis, the M-side operand free of
//    the N axis and the N-side free of M (matmul forms, batched, col-layout
//    and psi leaves, masked edges).  One 256-thread block per 128x128 tile
//    of the last two out axes (leading out axes and the splits of K on
//    grid.z), 8x8 outputs a thread in registers from the identity.  K is
//    staged in slabs of 16 through a three-stage ring in shared memory
//    (slab s computed while s+1 and s+2 are in flight, one barrier a
//    slab), always as [k][row] f32, so the inner loop reads four 16-byte
//    vectors per 64 terms.  Each operand is read along its smaller stride
//    (row- and col-layout leaves alike coalesced), by 16-byte copies where
//    the host found that stride 1 and every chunk aligned: an f32 operand
//    read along its rows by cp.async straight into the slab; one read
//    along K by 16-byte loads into registers, stored transposed after the
//    slab's compute (a copy cannot scatter a chunk over 4 slab rows); a
//    bf16 operand into registers too, widened to f32 once where 16 threads
//    read it, not at every read.  Unaligned f32 operands take 4-byte
//    cp.async elements, unaligned bf16 ones element loads.  Past K the
//    slab holds each side's inert element (the pair gives the reduce's
//    identity), so the inner loop is unrolled with no mask; past M and N
//    nothing is stored.  (mul, add) reads the same slabs into mma.sync
//    m16n8k16 tiles (a warp 64 x 32), splitting each value into bf16 hi /
//    lo parts as it is read; each slab's products land in a fresh tile
//    added with round-to-nearest adds.  Where the tiles alone do not fill
//    the 132 SMs, K is split over blocks: each writes an f32 partial tile,
//    and a second kernel folds the partials in split order.
//  - MAP: no contracted axis, or only contracted extents of 1 (Hadamard,
//    outer, Kronecker).  A thread pairs a run of 4 consecutive outputs
//    along the last out axis, its coordinates found once a run; each
//    operand is read as one vector (aligned, stride 1), one broadcast
//    scalar (stride 0) or 4 strided scalars; the run is stored as one
//    vector.
//  - REDUCE: one contracted axis that no tile takes.  Contiguous in every
//    operand that walks it: a warp an output, lanes taking 4-wide vectors
//    (4 independent accumulators a lane, 4 vectors in flight), then a
//    fixed fold of the accumulators and a shuffle tree.  Strided: a block
//    takes a strip of 128 outputs along the last out axis (a lane 4, by
//    vector loads), its 8 warps interleaved rows of the contracted axis,
//    the warps' partials folded in warp order in shared memory; where the
//    strips do not fill the card, the axis is split over blocks and folded
//    by the second kernel.
//  - CHAIN: three operands and two contracted axes j, k, the first operand
//    walking j, the middle j and k, the last k, under a pair whose combine
//    distributes over its reduce ((mul, add), (add, max), (add, min)).  The
//    host hands two TILE descriptors: T = A (x) B over j into an f32
//    scratch buffer, then T (x) C over k, as the reference's (mul, add)
//    body contracts its einsum pairwise.  For the tropical pairs this is
//    bit for bit the nest: x -> rn(x + c) is monotone, so
//    max_k rn(max_j rn(a + b) + c) = max_{j,k} rn(rn(a + b) + c) (and min
//    alike), NaN included, but for one case: where a term of T is -inf
//    (+inf for min) from one j while another j wins, and c is +inf (-inf),
//    the nest pairs -inf with +inf into NaN and the factored form does not
//    (ROADMAP.md, Queue 3, deliberate deviations).
//  - THREAD: every other nest (contracted axes whose strides do not
//    chain, a 3-operand nest that is no chain; the host first merges
//    adjacent contracted axes that one flattened index walks, so a lone
//    reduce over adjacent axes is REDUCE's).  Where the contracted volume
//    is at least 32 (Desc.rows), a warp an output: its lanes walk the
//    flattened contracted index, the innermost axis fastest, so a
//    stride-1 innermost axis is read in whole 128-byte lines (one thread
//    an output read lines 16 KB apart and left the card mostly idle:
//    the (4096, 64, 64) max over (1, 2) took 16x torch.amax there), each
//    lane folding its own elements in order, 8 loads in flight, and the
//    lanes folded by a fixed xor-shuffle tree (reruns are the same bits).
//    Below 32, one thread an output through the read-only cache.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_IN = 3, MAX_OUT = 4, MAX_RED = 3, NAX = MAX_OUT + MAX_RED;
constexpr int TM = 128, TK = 16, TPAD = 4, TILE_THREADS = 256;
constexpr int THREAD_BLOCK = 64, BLOCK = 256, WARPS = BLOCK / 32;
constexpr int RUN = 4;                  // MAP / REDUCE: elements a vector
constexpr int STRIP = 32 * RUN;         // REDUCE columns: outputs a block
enum { MODE_TILE = 0, MODE_THREAD = 1, MODE_REDUCE = 2, MODE_MAP = 3 };
enum { SRC_TMP = 3 };                   // Desc.src: the chain's scratch

// must match kernels/emit.py, K9Desc
struct Desc {
  long long out_ext[MAX_OUT];  // right-aligned: unused leading slots 1
  long long red_ext[MAX_RED];  // right-aligned: the innermost axis last
  long long stride[MAX_IN][NAX];
  long long base[MAX_IN];
  long long out_stride[MAX_OUT];
  long long k_split;     // TILE / REDUCE: contracted elements a split
  int in_dtype[MAX_IN];  // 0 f32, 1 bf16
  int k_fast[MAX_IN];    // TILE: the operand is read along K
  int vec[MAX_IN];       // vector copies along the operand's fast axis
  int src[MAX_IN];       // 0-2 the inputs, 3 the chain's f32 scratch
  int n_in;
  int n_red;
  int out_dtype;
  int mode;
  int a_op, b_op;        // TILE: the M-side and N-side operand
  int splits;            // TILE / REDUCE: blocks along the contracted axis
  int rows;              // REDUCE: 1 a warp an output, 0 column strips
  int vec_out;           // vector stores along the last out axis
  int dst;               // 0 the output, 1 the chain's f32 scratch
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int COMB>
__device__ __forceinline__ float pair(float a, float b) {
  return COMB == 0 ? __fmul_rn(a, b) : __fadd_rn(a, b);
}

template <int RED>
__device__ __forceinline__ float fold(float acc, float v) {
  if (RED == 0) return __fadd_rn(acc, v);
  if (RED == 1) return max_nan(acc, v);
  return min_nan(acc, v);
}

template <int RED>
__device__ __forceinline__ float identity() {
  if (RED == 0) return 0.f;
  return RED == 1 ? -__int_as_float(0x7f800000) : __int_as_float(0x7f800000);
}

// What a TILE slab holds past K on the M side and the N side: their pair
// is the reduce's identity (0 * 0, 0 + 0, -inf + 0, -inf * 1, ...).
template <int COMB, int RED>
__device__ __forceinline__ float pad_a() {
  return RED == 0 ? 0.f : identity<RED>();
}

template <int COMB, int RED>
__device__ __forceinline__ float pad_b() {
  return (COMB == 0 && RED != 0) ? 1.f : 0.f;
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float load(const void* p, long long off,
                                      int dtype) {
  if (dtype == 0) return __ldg(static_cast<const float*>(p) + off);
  const unsigned short raw = __ldg(static_cast<const unsigned short*>(p) + off);
  return __uint_as_float(static_cast<unsigned>(raw) << 16);
}

// 4 consecutive elements at an offset aligned to 4 (16 bytes f32, 8 bf16)
__device__ __forceinline__ void load4(const void* p, long long off, int dtype,
                                      float (&v)[RUN]) {
  if (dtype == 0) {
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                              off));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(p) + off));
    v[0] = bf16_lo(q.x), v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y), v[3] = bf16_hi(q.y);
  }
}

// A run of 4 elements along an axis of stride s from off: one vector
// (vec), one broadcast scalar (s == 0) or `rem` (< 4 at an edge) scalars.
__device__ __forceinline__ void load_run(const void* p, long long off,
                                         long long s, int dtype, bool vec,
                                         long long rem, float (&v)[RUN]) {
  if (vec && rem >= RUN) {
    load4(p, off, dtype, v);
  } else if (s == 0) {
    const float x = load(p, off, dtype);
#pragma unroll
    for (int e = 0; e < RUN; ++e) v[e] = x;
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      v[e] = e < rem ? load(p, off + e * s, dtype) : 0.f;
  }
}

__device__ __forceinline__ void store(void* p, long long off, float v,
                                      int dtype) {
  if (dtype == 0)
    static_cast<float*>(p)[off] = v;
  else
    static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn(v);
}

// 4 consecutive outputs at an offset aligned to 4
__device__ __forceinline__ void store4(void* p, long long off,
                                       const float (&v)[RUN], int dtype) {
  if (dtype == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + off) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + off) = q;
  }
}

__device__ __forceinline__ const void* pick(const void* p0, const void* p1,
                                            const void* p2, int i) {
  return i == 0 ? p0 : (i == 1 ? p1 : p2);
}

// ---- TILE: staging ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
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

typedef float Slab[TK][TM + TPAD];   // [k][row] f32
constexpr int STAGES = 3;            // slab s computed, s+1 and s+2 in flight
constexpr int TILE_SMEM = 2 * STAGES * (int)sizeof(Slab);

// How one operand of a TILE block is staged: an f32 operand read along
// its rows by cp.async straight into the slab (16-byte chunks where the
// host found them aligned); an f32 operand read along K, aligned, by
// 16-byte loads into registers, stored transposed after the slab's
// compute (no copy can scatter a chunk over 4 slab rows); any other f32
// operand by 4-byte cp.async elements (which transpose too); a bf16
// operand through registers (raw, 8 to a 16-byte load), widened to f32
// when stored.
enum { ST_CP16 = 0, ST_CP4 = 1, ST_REG = 2 };

struct Operand {
  const void* p;
  long long off;    // element offset of (row 0 of the tile, k = 0)
  long long s_row, s_k;
  long long rows;   // rows of the tile inside the extent (may be <= 0)
  int k_fast, vec, how, bf16;
  float pad;        // past K
  unsigned r[8];    // ST_REG: a slab's raw elements
  // a slab inside K (fetch_full): this thread's first element (chunk) of
  // the next slab, the bytes between its elements (chunks) and from one
  // slab to the next, which of them lie inside the rows, and (ST_CP16)
  // the bytes of its chunk that do
  const char* cur;
  long long di, dk;
  unsigned rowmask;
  int bytes;
};

// The slab position (kk, r) of a thread's element i under the 8-element
// mappings (ST_CP4, bf16 element loads): along K 16 threads a row, along
// the rows 128 threads a slab row.
__device__ __forceinline__ int elem_kk(int k_fast, int i) {
  const int t = threadIdx.x;
  return k_fast ? (t & (TK - 1)) : (t >> 7) + 2 * i;
}

__device__ __forceinline__ int elem_r(int k_fast, int i) {
  const int t = threadIdx.x;
  return k_fast ? (t >> 4) + 16 * i : (t & (TM - 1));
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return static_cast<unsigned short>(__float_as_uint(x) >> 16);
}

// Start the copies of the slab [k0, k0 + TK) (k < kend) into dst; ST_REG
// operands load into registers (stored by commit).  Rows past the extent
// get zeros or the pad (their outputs are never stored).  Any slab: each
// element's address and bounds from the operand's strides.
__device__ __forceinline__ void fetch_edge(Operand& o, Slab& dst,
                                           long long k0, long long kend) {
  const int t = threadIdx.x;
  if (o.how == ST_CP16) {               // rows fast, stride 1, aligned
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * TILE_THREADS;
      const int kk = c >> 5, r = (c & 31) * 4;
      const long long k = k0 + kk;
      float* d = &dst[kk][r];
      if (k >= kend) {
        *reinterpret_cast<float4*>(d) = make_float4(o.pad, o.pad, o.pad, o.pad);
        continue;
      }
      const long long rem = o.rows - r;
      const int bytes = rem >= 4 ? 16 : (rem > 0 ? (int)rem * 4 : 0);
      const float* src = static_cast<const float*>(o.p) +
                         (bytes ? o.off + r + k * o.s_k : 0);
      cp16(d, src, bytes);
    }
  } else if (o.how == ST_CP4) {         // f32, element by element
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = elem_kk(o.k_fast, i), r = elem_r(o.k_fast, i);
      const long long k = k0 + kk;
      float* d = &dst[kk][r];
      if (k >= kend) {
        *d = o.pad;
        continue;
      }
      const bool ok = r < o.rows;
      const float* src = static_cast<const float*>(o.p) +
                         (ok ? o.off + r * o.s_row + k * o.s_k : 0);
      cp4(d, src, ok ? 4 : 0);
    }
  } else if (!o.bf16) {                 // f32 along K, 2 x 4 aligned
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * TILE_THREADS;
      const int r = c >> 2, kq = (c & 3) * 4;
      const long long k = k0 + kq;
      const float* src = static_cast<const float*>(o.p) + o.off +
                         r * o.s_row + k;
      if (r < o.rows && k + 4 <= kend) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
        o.r[4 * i] = q.x, o.r[4 * i + 1] = q.y;
        o.r[4 * i + 2] = q.z, o.r[4 * i + 3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o.r[4 * i + e] = __float_as_uint(
              (r < o.rows && k + e < kend) ? __ldg(src + e) : o.pad);
      }
    }
  } else if (o.vec) {                   // bf16: 8 along K or along rows
    const int r = o.k_fast ? (t >> 1) : (t & 15) * 8;
    const int kk = o.k_fast ? (t & 1) * 8 : (t >> 4);
    const long long k = k0 + kk;
    const long long at = o.off + r * o.s_row + k * o.s_k;
    const bool full = o.k_fast ? (r < o.rows && k + 8 <= kend)
                               : (k < kend && r + 8 <= o.rows);
    if (full) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const unsigned short*>(o.p) + at));
      o.r[0] = q.x, o.r[1] = q.y, o.r[2] = q.z, o.r[3] = q.w;
    } else {
      const unsigned short pad = bf16_bits(o.pad);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long ke = o.k_fast ? k + e : k;
        const long long re = o.k_fast ? r : r + e;
        const unsigned short v =
            (re < o.rows && ke < kend)
                ? __ldg(static_cast<const unsigned short*>(o.p) + o.off +
                        re * o.s_row + ke * o.s_k)
                : pad;
        o.r[e >> 1] = (e & 1) ? (o.r[e >> 1] | ((unsigned)v << 16)) : v;
      }
    }
  } else {                              // bf16, element by element
    const unsigned short pad = bf16_bits(o.pad);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = elem_kk(o.k_fast, i), r = elem_r(o.k_fast, i);
      const long long k = k0 + kk;
      const unsigned short v =
          (k < kend && r < o.rows)
              ? __ldg(static_cast<const unsigned short*>(o.p) + o.off +
                      r * o.s_row + k * o.s_k)
              : pad;
      o.r[i >> 1] = (i & 1) ? (o.r[i >> 1] | ((unsigned)v << 16)) : v;
    }
  }
}

// fetch for a slab inside K: the precomputed addresses advanced by a
// slab, only the rows checked (by the mask).
__device__ __forceinline__ void fetch_full(Operand& o, Slab& dst,
                                           long long k0, long long kend) {
  const int t = threadIdx.x;
  if (o.how == ST_CP16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp16(&dst[(t >> 5) + 8 * i][(t & 31) * 4],
           o.bytes ? o.cur + i * o.di : o.p, o.bytes);
  } else if (o.how == ST_CP4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = (o.rowmask >> i) & 1;
      cp4(&dst[elem_kk(o.k_fast, i)][elem_r(o.k_fast, i)],
          ok ? o.cur + i * o.di : o.p, ok ? 4 : 0);
    }
  } else if (!o.bf16) {                 // f32 along K, 2 x 4 aligned
    const unsigned pad = __float_as_uint(o.pad);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 q = make_uint4(pad, pad, pad, pad);
      if ((o.rowmask >> i) & 1)
        q = __ldg(reinterpret_cast<const uint4*>(o.cur + i * o.di));
      o.r[4 * i] = q.x, o.r[4 * i + 1] = q.y;
      o.r[4 * i + 2] = q.z, o.r[4 * i + 3] = q.w;
    }
  } else if (o.vec) {                   // bf16, 8 in one 16-byte load
    if (o.rowmask & 1) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(o.cur));
      o.r[0] = q.x, o.r[1] = q.y, o.r[2] = q.z, o.r[3] = q.w;
    } else {
      fetch_edge(o, dst, k0, kend);     // a chunk across the rows' end
    }
  } else {                              // bf16, element by element
    const unsigned short pad = bf16_bits(o.pad);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned short v =
          ((o.rowmask >> i) & 1)
              ? __ldg(reinterpret_cast<const unsigned short*>(o.cur +
                                                              i * o.di))
              : pad;
      o.r[i >> 1] = (i & 1) ? (o.r[i >> 1] | ((unsigned)v << 16)) : v;
    }
  }
}

__device__ __forceinline__ void fetch(Operand& o, Slab& dst, long long k0,
                                      long long kend) {
  if (k0 + TK <= kend)
    fetch_full(o, dst, k0, kend);
  else
    fetch_edge(o, dst, k0, kend);
  o.cur += o.dk;
}

// Store an ST_REG operand's registers into its slab, widened, as fetch
// mapped them.
__device__ __forceinline__ void commit(const Operand& o, Slab& dst) {
  const int t = threadIdx.x;
  if (o.how != ST_REG) return;
  if (!o.bf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * TILE_THREADS;
      const int r = c >> 2, kq = (c & 3) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[kq + e][r] = __uint_as_float(o.r[4 * i + e]);
    }
    return;
  }
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(o.r[i]);
    v[2 * i + 1] = bf16_hi(o.r[i]);
  }
  if (o.vec && o.k_fast) {
    const int r = t >> 1, kq = (t & 1) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[kq + e][r] = v[e];
  } else if (o.vec) {
    const int r = (t & 15) * 8, kk = t >> 4;
    *reinterpret_cast<float4*>(&dst[kk][r]) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&dst[kk][r + 4]) =
        make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[elem_kk(o.k_fast, i)][elem_r(o.k_fast, i)] = v[i];
  }
}

__device__ __forceinline__ Operand tile_operand(const Desc& d, const void* p,
                                                int i, int row_slot,
                                                long long l0, long long l1,
                                                long long row0,
                                                long long kbeg, float pad) {
  Operand o;
  o.p = p;
  o.s_row = d.stride[i][row_slot];
  o.s_k = d.stride[i][NAX - 1];
  o.off = d.base[i] + l0 * d.stride[i][0] + l1 * d.stride[i][1] +
          row0 * o.s_row;
  o.rows = d.out_ext[row_slot] - row0;
  o.k_fast = d.k_fast[i];
  o.vec = d.vec[i];
  o.bf16 = d.in_dtype[i] == 1;
  o.how = o.bf16 ? ST_REG
                 : (o.vec && !o.k_fast
                        ? ST_CP16
                        : (o.vec ? ST_REG : ST_CP4));
  o.pad = pad;
  // the fast path's first element (chunk) at k = kbeg, its steps and rows
  const int t = threadIdx.x, esize = o.bf16 ? 2 : 4;
  long long r0, kk0;
  int n = 1;
  long long dr = 0, dkk = 0;           // row and K steps between elements
  if (o.how == ST_CP16) {
    r0 = (t & 31) * 4, kk0 = t >> 5, dkk = 8, n = 2;
  } else if (o.how == ST_REG && !o.bf16) {
    r0 = t >> 2, kk0 = (t & 3) * 4, dr = 64, n = 2;
  } else if (o.vec) {                  // bf16 16-byte chunks
    r0 = o.k_fast ? (t >> 1) : (t & 15) * 8;
    kk0 = o.k_fast ? (t & 1) * 8 : (t >> 4);
  } else {                             // 8-element mappings
    r0 = elem_r(o.k_fast, 0), kk0 = elem_kk(o.k_fast, 0);
    dr = elem_r(o.k_fast, 1) - r0, dkk = elem_kk(o.k_fast, 1) - kk0, n = 8;
  }
  o.cur = static_cast<const char*>(p) +
          (o.off + r0 * o.s_row + (kbeg + kk0) * o.s_k) * esize;
  o.di = (dr * o.s_row + dkk * o.s_k) * esize;
  o.dk = TK * o.s_k * esize;
  o.rowmask = 0;
  const long long need = (o.how == ST_REG && o.bf16 && o.vec && !o.k_fast)
                             ? 8 : 1;   // a chunk along the rows: all 8
  for (int e = 0; e < n; ++e)
    if (r0 + e * dr + need <= o.rows) o.rowmask |= 1u << e;
  const long long rem = o.rows - r0;
  o.bytes = rem >= 4 ? 16 : (rem > 0 ? (int)rem * 4 : 0);
  return o;
}

// ---- TILE's (mul, add) products on the tensor cores --------------------------

// x, y as bf16 hi parts and the bf16 rounding of what they leave (lo):
// hi + lo is within 2^-16 of each value, so the three products hi.hi,
// hi.lo and lo.hi carry an f32 product to about 2^-16 of its size.  hi
// rounds to nearest and saturates at bf16's largest finite value
// (.satfinite), so a finite value past bf16's range keeps its excess in
// lo, and an inf is that largest value in hi and inf in lo: inf x y then
// reaches the sum through lo.hi as inf (NaN where y is 0), as in f32.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  asm("cvt.rn.satfinite.bf16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(y), "f"(x));
  const float2 hf =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 64 x 32 share of the 128 x 128 tile (warps 2 (M) x 4 (N)) as
// 4 x 4 mma.sync m16n8k16 tiles, its accumulators at acc[2 mi + ni / 2]
// [4 (ni % 2) + e] (e: the tile's c0-c3).
__device__ __forceinline__ int tc_row(int mi) {
  return (threadIdx.x >> 7) * 64 + mi * 16 + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int tc_col(int ni) {
  return ((threadIdx.x >> 5) & 3) * 32 + ni * 8;
}

// One 16-deep slab: each operand split into bf16 hi / lo parts as it is
// read, three products into a fresh tile that is added to the accumulator
// with round-to-nearest adds (the tensor cores' own sums round toward
// zero).  A side that came in as bf16 still takes its lo product: an inf
// there is carried by it (split2).
__device__ __forceinline__ void mma_slab(float (&acc)[8][8], const Slab& as,
                                         const Slab& bs) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = tc_col(ni) + g;
    split2(bs[2 * q][c], bs[2 * q + 1][c], bh[ni][0], bl[ni][0]);
    split2(bs[2 * q + 8][c], bs[2 * q + 9][c], bh[ni][1], bl[ni][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = tc_row(mi);
    uint32_t ah[4], al[4];
    split2(as[2 * q][r], as[2 * q + 1][r], ah[0], al[0]);
    split2(as[2 * q][r + 8], as[2 * q + 1][r + 8], ah[1], al[1]);
    split2(as[2 * q + 8][r], as[2 * q + 9][r], ah[2], al[2]);
    split2(as[2 * q + 8][r + 8], as[2 * q + 9][r + 8], ah[3], al[3]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(t, al, bh[ni][0], bh[ni][1]);
      mma_bf16(t, ah, bl[ni][0], bl[ni][1]);
      mma_bf16(t, ah, bh[ni][0], bh[ni][1]);
      float* a4 = &acc[2 * mi + (ni >> 1)][4 * (ni & 1)];
#pragma unroll
      for (int e = 0; e < 4; ++e) a4[e] = __fadd_rn(a4[e], t[e]);
    }
  }
}

// 2 consecutive outputs at an offset aligned to 2
__device__ __forceinline__ void store2(void* p, long long off, float x,
                                       float y, int dtype) {
  if (dtype == 0)
    *reinterpret_cast<float2*>(static_cast<float*>(p) + off) =
        make_float2(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) +
                                       off) = __floats2bfloat162_rn(x, y);
}

// ---- TILE -------------------------------------------------------------------

// Output (or, with splits, f32 partial) tile of rows m0.., columns n0...;
// TC: (mul, add) on the tensor cores (mma_slab), else FMA / pair-fold.
template <int COMB, int RED, bool TC>
__global__ void __launch_bounds__(TILE_THREADS)
k9_tile(const Desc d, const void* __restrict__ p0,
        const void* __restrict__ p1, const void* __restrict__ p2,
        void* __restrict__ out, float* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  Slab* sa = reinterpret_cast<Slab*>(smem);
  Slab* sb = sa + STAGES;
  const long long M = d.out_ext[2], N = d.out_ext[3], K = d.red_ext[2];
  const long long m0 = (long long)blockIdx.y * TM;
  const long long n0 = (long long)blockIdx.x * TM;
  const long long cell = blockIdx.z / d.splits;
  const int split = blockIdx.z % d.splits;
  const long long l0 = cell / d.out_ext[1], l1 = cell % d.out_ext[1];
  const long long kbeg = split * d.k_split;
  const long long kend = kbeg + d.k_split < K ? kbeg + d.k_split : K;
  Operand A = tile_operand(d, pick(p0, p1, p2, d.a_op), d.a_op, 2, l0, l1,
                           m0, kbeg, pad_a<COMB, RED>());
  Operand B = tile_operand(d, pick(p0, p1, p2, d.b_op), d.b_op, 3, l0, l1,
                           n0, kbeg, pad_b<COMB, RED>());
  // a thread's 8 rows: ra + 0..3 and rb + 0..3; its 8 columns likewise
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * 4, rb = ra + 64, ca = tx * 4, cb = ca + 64;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = identity<RED>();

  const long long nslab = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;
  // the ring's first two slabs; a group is committed per slab (empty past
  // the last) so that wait_group 1 always leaves only the next one open
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nslab) {
      fetch(A, sa[p], kbeg + p * TK, kend);
      fetch(B, sb[p], kbeg + p * TK, kend);
      commit(A, sa[p]);
      commit(B, sb[p]);
    }
    cp_commit();
  }
  int cur = 0;
  for (long long s = 0; s < nslab; ++s) {
    const int ahead = cur == 0 ? STAGES - 1 : cur - 1;   // (s + 2) % 3
    cp_wait<STAGES - 2>();
    __syncthreads();   // slab s is in; every thread is done with slab s - 1
    const bool more = s + STAGES - 1 < nslab;
    if (more) {
      fetch(A, sa[ahead], kbeg + (s + STAGES - 1) * TK, kend);
      fetch(B, sb[ahead], kbeg + (s + STAGES - 1) * TK, kend);
    }
    cp_commit();
    const Slab& as = sa[cur];
    const Slab& bs = sb[cur];
    if constexpr (TC) mma_slab(acc, as, bs);
#pragma unroll
    for (int kk = 0; kk < (TC ? 0 : TK); ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ra]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][rb]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][ca]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][cb]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (COMB == 0 && RED == 0)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          else
            acc[i][j] = fold<RED>(acc[i][j], pair<COMB>(a[i], b[j]));
        }
    }
    if (more) {
      commit(A, sa[ahead]);
      commit(B, sb[ahead]);
    }
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }

  // the tile: to its place in the output (or the scratch), or as an f32
  // partial to the split's slice of work
  const bool partial = d.splits > 1;
  void* dst = partial ? static_cast<void*>(work) : out;
  const int dtype = partial ? 0 : d.out_dtype;
  long long obase = l0 * d.out_stride[0] + l1 * d.out_stride[1];
  if (partial)
    obase += (long long)split * d.out_ext[0] * d.out_ext[1] * M * N;
  if constexpr (TC) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const long long gn = n0 + tc_col(ni) + 2 * (threadIdx.x & 3);
        const float* a4 = acc[2 * mi + (ni >> 1)] + 4 * (ni & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long gm = m0 + tc_row(mi) + 8 * h;
          if (gm >= M) continue;
          const long long row = obase + gm * d.out_stride[2];
          if (d.vec_out && gn + 2 <= N) {
            store2(dst, row + gn, a4[2 * h], a4[2 * h + 1], dtype);
          } else {
            if (gn < N) store(dst, row + gn, a4[2 * h], dtype);
            if (gn + 1 < N) store(dst, row + gn + 1, a4[2 * h + 1], dtype);
          }
        }
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gm = m0 + (i < 4 ? ra : rb) + (i & 3);
    if (gm >= M) continue;
    const long long row = obase + gm * d.out_stride[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gn = n0 + (h ? cb : ca);
      const float v[RUN] = {acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (d.vec_out && gn + RUN <= N) {
        store4(dst, row + gn, v, dtype);
      } else {
#pragma unroll
        for (int e = 0; e < RUN; ++e)
          if (gn + e < N)
            store(dst, row + (gn + e) * d.out_stride[3], v[e], dtype);
      }
    }
  }
}

// dst[i] = fold over the splits, in order, of work[s * n + i]
template <int RED>
__global__ void __launch_bounds__(BLOCK)
k9_fold(const float* __restrict__ work, long long n, int splits,
        void* __restrict__ dst, int dtype) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float v = work[i];
  for (int s = 1; s < splits; ++s) v = fold<RED>(v, work[s * n + i]);
  store(dst, i, v, dtype);
}


// ---- coordinates ------------------------------------------------------------

// a / b and a % b, in 32 bits where both fit
__device__ __forceinline__ long long divmod(long long a, long long b,
                                            long long& rem) {
  if (((unsigned long long)a | (unsigned long long)b) >> 32 == 0) {
    const unsigned q = (unsigned)a / (unsigned)b;
    rem = (long long)((unsigned)a - q * (unsigned)b);
    return q;
  }
  const long long q = a / b;
  rem = a - q * b;
  return q;
}

// The out slots 0-2 of a lead cell z (row-major over those slots).
__device__ __forceinline__ void lead_coords(const Desc& d, long long z,
                                            long long (&c)[3]) {
  long long r;
  z = divmod(z, d.out_ext[2], r);
  c[2] = r;
  c[0] = divmod(z, d.out_ext[1], r);
  c[1] = r;
}

__device__ __forceinline__ long long lead_offset(const Desc& d, int i,
                                                 const long long (&c)[3]) {
  return d.base[i] + c[0] * d.stride[i][0] + c[1] * d.stride[i][1] +
         c[2] * d.stride[i][2];
}

__device__ __forceinline__ long long out_offset(const Desc& d,
                                                const long long (&c)[3]) {
  return c[0] * d.out_stride[0] + c[1] * d.out_stride[1] +
         c[2] * d.out_stride[2];
}

// ---- MAP --------------------------------------------------------------------

template <int COMB, int N>
__global__ void __launch_bounds__(BLOCK)
k9_map(const Desc d, const void* __restrict__ p0,
       const void* __restrict__ p1, const void* __restrict__ p2,
       void* __restrict__ out) {
  const long long X = d.out_ext[3];
  const long long per_row = (X + RUN - 1) / RUN;
  const long long runs = d.out_ext[0] * d.out_ext[1] * d.out_ext[2] * per_row;
  const long long run = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (run >= runs) return;
  long long xr, c[3];
  lead_coords(d, divmod(run, per_row, xr), c);
  const long long x0 = xr * RUN, rem = X - x0;
  float v[RUN];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float w[RUN];
    load_run(pick(p0, p1, p2, i), lead_offset(d, i, c) + x0 * d.stride[i][3],
             d.stride[i][3], d.in_dtype[i], d.vec[i], rem, w);
#pragma unroll
    for (int e = 0; e < RUN; ++e) v[e] = i == 0 ? w[e] : pair<COMB>(v[e], w[e]);
  }
  const long long o = out_offset(d, c) + x0;
  if (d.vec_out && rem >= RUN) {
    store4(out, o, v, d.out_dtype);
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      if (e < rem) store(out, o + e, v[e], d.out_dtype);
  }
}

// ---- REDUCE -----------------------------------------------------------------

// The N operands' paired run of 4 at k (offsets off[] at k = 0): along the
// contracted axis (rows) or along the last out axis.
template <int COMB, int N>
__device__ __forceinline__ void paired_run(const Desc& d, const void* p0,
                                           const void* p1, const void* p2,
                                           const long long (&off)[MAX_IN],
                                           long long k, bool along_k,
                                           long long rem, float (&v)[RUN]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long sk = d.stride[i][NAX - 1];
    const long long s = along_k ? sk : d.stride[i][3];
    float w[RUN];
    load_run(pick(p0, p1, p2, i), off[i] + k * sk, s, d.in_dtype[i],
             d.vec[i], rem, w);
#pragma unroll
    for (int e = 0; e < RUN; ++e) v[e] = i == 0 ? w[e] : pair<COMB>(v[e], w[e]);
  }
}

// A warp an output; the contracted axis has stride 0 or 1 in every operand.
template <int COMB, int RED, int N>
__global__ void __launch_bounds__(BLOCK, 4)
k9_reduce_rows(const Desc d, const void* __restrict__ p0,
               const void* __restrict__ p1, const void* __restrict__ p2,
               void* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long X = d.out_ext[3];
  const long long o =
      (long long)blockIdx.x * WARPS + threadIdx.x / 32;   // the output
  if (o >= d.out_ext[0] * d.out_ext[1] * d.out_ext[2] * X) return;
  long long x, c[3];
  lead_coords(d, divmod(o, X, x), c);
  long long off[MAX_IN] = {0, 0, 0};
  bool vec = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    off[i] = lead_offset(d, i, c) + x * d.stride[i][3];
    if (d.stride[i][NAX - 1] != 0 && !d.vec[i]) vec = false;
  }
  const long long K = d.red_ext[2];
  float acc[RUN];
#pragma unroll
  for (int e = 0; e < RUN; ++e) acc[e] = identity<RED>();
  long long k_tail = 0;
  if (vec) {                 // 4-wide vectors, 4 in flight a lane
    const long long chunks = K / RUN;
    for (long long q = lane; q < chunks; q += 4 * 32) {
      float v[4][RUN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u * 32 < chunks)
          paired_run<COMB, N>(d, p0, p1, p2, off, (q + u * 32) * RUN, true,
                              RUN, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u * 32 < chunks)
#pragma unroll
          for (int e = 0; e < RUN; ++e) acc[e] = fold<RED>(acc[e], v[u][e]);
    }
    k_tail = chunks * RUN;
  }
  // scalars: the tail past the vectors (or all of K), 4 in flight a lane
  for (long long k = k_tail + lane; k < K; k += 4 * 32) {
    float v[4][RUN];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u * 32 < K)
        paired_run<COMB, N>(d, p0, p1, p2, off, k + u * 32, true, 1, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u * 32 < K) acc[u] = fold<RED>(acc[u], v[u][0]);
  }
  float r = fold<RED>(fold<RED>(acc[0], acc[1]), fold<RED>(acc[2], acc[3]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    r = fold<RED>(r, __shfl_xor_sync(0xffffffffu, r, s));
  if (lane == 0) store(out, out_offset(d, c) + x, r, d.out_dtype);
}

// A block a strip of STRIP outputs along the last out axis (a lane 4) and
// a split of the contracted axis, its warps on interleaved rows.
template <int COMB, int RED, int N>
__global__ void __launch_bounds__(BLOCK, 4)
k9_reduce_cols(const Desc d, const void* __restrict__ p0,
               const void* __restrict__ p1, const void* __restrict__ p2,
               void* __restrict__ out, float* __restrict__ work) {
  __shared__ float part[WARPS][STRIP];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long X = d.out_ext[3];
  const long long x0 = (long long)blockIdx.x * STRIP + lane * RUN;
  const int split = blockIdx.y;
  long long c[3];
  lead_coords(d, blockIdx.z, c);
  const long long K = d.red_ext[2];
  const long long kbeg = split * d.k_split;
  const long long kend = kbeg + d.k_split < K ? kbeg + d.k_split : K;
  long long off[MAX_IN] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < N; ++i)
    off[i] = lead_offset(d, i, c) + x0 * d.stride[i][3];
  float acc[RUN];
#pragma unroll
  for (int e = 0; e < RUN; ++e) acc[e] = identity<RED>();
  const long long rem = X - x0;
  if (rem > 0) {
    for (long long k = kbeg + w; k < kend; k += 4 * WARPS) {
      float v[4][RUN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * WARPS < kend)
          paired_run<COMB, N>(d, p0, p1, p2, off, k + u * WARPS, false, rem,
                              v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * WARPS < kend)
#pragma unroll
          for (int e = 0; e < RUN; ++e) acc[e] = fold<RED>(acc[e], v[u][e]);
    }
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) part[w][lane * RUN + e] = acc[e];
  __syncthreads();
  if (threadIdx.x >= STRIP) return;
  const long long xo = (long long)blockIdx.x * STRIP + threadIdx.x;
  if (xo >= X) return;
  float r = part[0][threadIdx.x];
#pragma unroll
  for (int v = 1; v < WARPS; ++v) r = fold<RED>(r, part[v][threadIdx.x]);
  const long long o = out_offset(d, c) + xo;
  if (d.splits > 1)
    work[(long long)split * d.out_ext[0] * d.out_ext[1] * d.out_ext[2] * X +
         o] = r;
  else
    store(out, o, r, d.out_dtype);
}

// ---- THREAD -----------------------------------------------------------------

// The operands' paired value at offsets off[] (left to right).
template <int COMB>
__device__ __forceinline__ float paired(const Desc& d, const void* p0,
                                        const void* p1, const void* p2,
                                        const long long (&off)[MAX_IN]) {
  float v = load(p0, off[0], d.in_dtype[0]);
  if (d.n_in > 1) v = pair<COMB>(v, load(p1, off[1], d.in_dtype[1]));
  if (d.n_in > 2) v = pair<COMB>(v, load(p2, off[2], d.in_dtype[2]));
  return v;
}

// Offsets of the output cell (lead cell z, last out index x) per operand
// and in the output; false past the out extents.  z < 65535^2 and every
// extent < 2^31, so the lead cell splits in 32-bit arithmetic.
__device__ __forceinline__ bool locate(const Desc& d, long long z,
                                       long long x, long long (&off)[MAX_IN],
                                       long long& ooff) {
  if (x >= d.out_ext[3] || z >= d.out_ext[0] * d.out_ext[1] * d.out_ext[2])
    return false;
  long long c[MAX_OUT];
  c[3] = x;
  unsigned zz = static_cast<unsigned>(z);
  for (int ax = 2; ax >= 0; --ax) {
    const unsigned e = static_cast<unsigned>(d.out_ext[ax]);
    if (e == 1) {
      c[ax] = 0;
      continue;
    }
    c[ax] = zz % e;
    zz /= e;
  }
  ooff = 0;
  for (int ax = 0; ax < MAX_OUT; ++ax) ooff += c[ax] * d.out_stride[ax];
  for (int i = 0; i < MAX_IN; ++i) {
    long long o = d.base[i];
    for (int ax = 0; ax < MAX_OUT; ++ax) o += c[ax] * d.stride[i][ax];
    off[i] = o;
  }
  return true;
}

template <int COMB, int RED>
__global__ void __launch_bounds__(THREAD_BLOCK)
k9_thread(const Desc d, const void* __restrict__ p0,
          const void* __restrict__ p1, const void* __restrict__ p2,
          void* __restrict__ out) {
  const long long z = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long x = (long long)blockIdx.x * THREAD_BLOCK + threadIdx.x;
  long long off[MAX_IN], ooff;
  if (!locate(d, z, x, off, ooff)) return;
  float acc;
  if (d.n_red == 0) {
    acc = paired<COMB>(d, p0, p1, p2, off);
  } else {
    acc = identity<RED>();
    for (long long k0 = 0; k0 < d.red_ext[0]; ++k0)
      for (long long k1 = 0; k1 < d.red_ext[1]; ++k1) {
        long long o[MAX_IN];
        for (int i = 0; i < MAX_IN; ++i)
          o[i] = off[i] + k0 * d.stride[i][4] + k1 * d.stride[i][5];
        const long long K2 = d.red_ext[2];
#pragma unroll 4
        for (long long k2 = 0; k2 < K2; ++k2) {
          long long q[MAX_IN];
          for (int i = 0; i < MAX_IN; ++i) q[i] = o[i] + k2 * d.stride[i][6];
          acc = fold<RED>(acc, paired<COMB>(d, p0, p1, p2, q));
        }
      }
  }
  store(out, ooff, acc, d.out_dtype);
}

// A warp an output cell: lane l folds the flattened contracted indices l,
// l + 32, ... (innermost axis fastest, THREAD_UNROLL loads in flight, one
// accumulator each), advanced by the mixed-radix digits of 32, then the
// accumulators fold in order and the lanes by an xor-shuffle tree.
constexpr int THREAD_UNROLL = 8;

template <int COMB, int RED>
__global__ void __launch_bounds__(BLOCK)
k9_thread_warp(const Desc d, const void* __restrict__ p0,
               const void* __restrict__ p1, const void* __restrict__ p2,
               void* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long o =
      (long long)blockIdx.x * WARPS + threadIdx.x / 32;   // the output
  long long xr;
  const long long z = divmod(o, d.out_ext[3], xr);
  long long off[MAX_IN], ooff;
  if (!locate(d, z, xr, off, ooff)) return;
  const long long K0 = d.red_ext[0], K1 = d.red_ext[1], K2 = d.red_ext[2];
  // the step of 32 in digits (c0, c1, c2), each below its radix
  long long c2, c1, t;
  t = divmod(32, K2, c2);
  const long long c0 = divmod(t, K1, c1);
  long long k2, k1;
  t = divmod(lane, K2, k2);
  long long k0 = divmod(t, K1, k1);
  float acc[THREAD_UNROLL];
#pragma unroll
  for (int u = 0; u < THREAD_UNROLL; ++u) acc[u] = identity<RED>();
  while (k0 < K0) {
    float v[THREAD_UNROLL];
    bool in[THREAD_UNROLL];
#pragma unroll
    for (int u = 0; u < THREAD_UNROLL; ++u) {
      in[u] = k0 < K0;
      if (in[u]) {
        long long q[MAX_IN];
#pragma unroll
        for (int i = 0; i < MAX_IN; ++i)
          q[i] = off[i] + k0 * d.stride[i][4] + k1 * d.stride[i][5] +
                 k2 * d.stride[i][6];
        v[u] = paired<COMB>(d, p0, p1, p2, q);
      }
      k2 += c2;
      const long long e2 = k2 >= K2;
      k2 -= e2 * K2;
      k1 += c1 + e2;
      const long long e1 = k1 >= K1;
      k1 -= e1 * K1;
      k0 += c0 + e1;
    }
#pragma unroll
    for (int u = 0; u < THREAD_UNROLL; ++u)
      if (in[u]) acc[u] = fold<RED>(acc[u], v[u]);
  }
  float r = acc[0];
#pragma unroll
  for (int u = 1; u < THREAD_UNROLL; ++u) r = fold<RED>(r, acc[u]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    r = fold<RED>(r, __shfl_xor_sync(0xffffffffu, r, s));
  if (lane == 0) store(out, ooff, r, d.out_dtype);
}

// ---- launch -----------------------------------------------------------------

constexpr long long GRID_YZ = 65535, GRID_X = 2147483647;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// fold the splits' partials into dst (row-major like the output)
template <int RED>
cudaError_t fold_splits(const Desc& d, const float* work, void* dst,
                        cudaStream_t st) {
  const long long n = d.out_ext[0] * d.out_ext[1] * d.out_ext[2] * d.out_ext[3];
  if (ceil_div(n, BLOCK) > GRID_X) return cudaErrorInvalidValue;
  k9_fold<RED><<<(unsigned)ceil_div(n, BLOCK), BLOCK, 0, st>>>(
      work, n, d.splits, dst, d.out_dtype);
  return cudaGetLastError();
}

template <int COMB, int RED>
cudaError_t launch(const Desc& d, const void* p0, const void* p1,
                   const void* p2, void* dst, float* work, cudaStream_t st) {
  const long long lead = d.out_ext[0] * d.out_ext[1] * d.out_ext[2];
  const long long n = lead * d.out_ext[3];
  if (d.splits < 1 || (d.splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (d.mode == MODE_TILE) {
    const long long gy = ceil_div(d.out_ext[2], TM);
    const long long gz = d.out_ext[0] * d.out_ext[1] * d.splits;
    if (gy > GRID_YZ || gz > GRID_YZ) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)ceil_div(d.out_ext[3], TM), (unsigned)gy,
                    (unsigned)gz);
    constexpr bool TC = COMB == 0 && RED == 0;
    static bool sized = false;    // once per instantiation and process
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          k9_tile<COMB, RED, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          TILE_SMEM);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    k9_tile<COMB, RED, TC><<<grid, TILE_THREADS, TILE_SMEM, st>>>(
        d, p0, p1, p2, dst, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || d.splits == 1) return err;
    return fold_splits<RED>(d, work, dst, st);
  }
  if (d.mode == MODE_MAP) {
    const long long runs = lead * ceil_div(d.out_ext[3], RUN);
    if (ceil_div(runs, BLOCK) > GRID_X) return cudaErrorInvalidValue;
    const unsigned g = (unsigned)ceil_div(runs, BLOCK);
    if (d.n_in == 1) k9_map<COMB, 1><<<g, BLOCK, 0, st>>>(d, p0, p1, p2, dst);
    if (d.n_in == 2) k9_map<COMB, 2><<<g, BLOCK, 0, st>>>(d, p0, p1, p2, dst);
    if (d.n_in == 3) k9_map<COMB, 3><<<g, BLOCK, 0, st>>>(d, p0, p1, p2, dst);
    return cudaGetLastError();
  }
  if (d.mode == MODE_REDUCE && d.rows) {
    if (ceil_div(n, WARPS) > GRID_X) return cudaErrorInvalidValue;
    const unsigned g = (unsigned)ceil_div(n, WARPS);
#define K9_ROWS(NI)                                                   \
  if (d.n_in == NI)                                                   \
    k9_reduce_rows<COMB, RED, NI><<<g, BLOCK, 0, st>>>(d, p0, p1, p2, dst);
    K9_ROWS(1) K9_ROWS(2) K9_ROWS(3)
#undef K9_ROWS
    return cudaGetLastError();
  }
  if (d.mode == MODE_REDUCE) {
    if (lead > GRID_YZ || d.splits > GRID_YZ) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)ceil_div(d.out_ext[3], STRIP),
                    (unsigned)d.splits, (unsigned)lead);
#define K9_COLS(NI)                                                   \
  if (d.n_in == NI)                                                   \
    k9_reduce_cols<COMB, RED, NI><<<grid, BLOCK, 0, st>>>(d, p0, p1, p2, dst, \
                                                         work);
    K9_COLS(1) K9_COLS(2) K9_COLS(3)
#undef K9_COLS
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || d.splits == 1) return err;
    return fold_splits<RED>(d, work, dst, st);
  }
  if (d.rows) {   // THREAD, a warp an output
    if (ceil_div(n, WARPS) > GRID_X) return cudaErrorInvalidValue;
    k9_thread_warp<COMB, RED><<<(unsigned)ceil_div(n, WARPS), BLOCK, 0, st>>>(
        d, p0, p1, p2, dst);
    return cudaGetLastError();
  }
  // THREAD, a thread an output: lead cells z = blockIdx.z * gridDim.y +
  // blockIdx.y (locate masks the overhang of the last z row)
  const long long gy = lead < GRID_YZ ? lead : GRID_YZ;
  const long long gz = ceil_div(lead, gy);
  if (gz > GRID_YZ) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(d.out_ext[3], THREAD_BLOCK),
                  (unsigned)gy, (unsigned)gz);
  k9_thread<COMB, RED><<<grid, THREAD_BLOCK, 0, st>>>(d, p0, p1, p2, dst);
  return cudaGetLastError();
}

bool valid(const Desc& d) {
  if (d.n_in < 1 || d.n_in > MAX_IN || d.n_red < 0 || d.n_red > MAX_RED ||
      d.mode < MODE_TILE || d.mode > MODE_MAP || d.dst < 0 || d.dst > 1 ||
      (d.mode == MODE_TILE && (d.n_in != 2 || d.n_red != 1)) ||
      (d.mode == MODE_REDUCE && d.n_red != 1) ||
      (d.mode != MODE_TILE && d.mode != MODE_REDUCE && d.splits != 1) ||
      (d.splits > 1 && d.k_split < 1))
    return false;
  for (int i = 0; i < MAX_OUT; ++i)
    if (d.out_ext[i] < 1) return false;
  for (int i = 0; i < MAX_RED; ++i)
    if (d.red_ext[i] < 0 || (d.mode == MODE_MAP && d.red_ext[i] != 1))
      return false;
  for (int i = 0; i < d.n_in; ++i)
    if (d.src[i] < 0 || d.src[i] > SRC_TMP) return false;
  return true;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// descs points at n_desc host K9Descs, run in order, each copied by value
// into its kernels' parameters: operand i of a descriptor reads input
// src[i] (p0-p2) or the f32 scratch tmp (src 3), and it writes out or tmp
// (dst); work holds the partials of a split contraction.  combine 0 mul /
// 1 add, reduce 0 add / 1 max / 2 min.
extern "C" int repro_semiring(const void* descs, int n_desc, const void* p0,
                              const void* p1, const void* p2, void* out,
                              void* tmp, void* work, int combine, int reduce,
                              void* stream) {
  const Desc* ds = static_cast<const Desc*>(descs);
  if (n_desc < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < n_desc; ++s)
    if (!valid(ds[s]) ||
        ((ds[s].dst == 1 || ds[s].src[0] == SRC_TMP ||
          ds[s].src[1] == SRC_TMP || ds[s].src[2] == SRC_TMP) &&
         tmp == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* bufs[4] = {p0, p1, p2, tmp};
  for (int s = 0; s < n_desc; ++s) {
    const Desc& d = ds[s];
    const void* in[MAX_IN];
    for (int i = 0; i < MAX_IN; ++i)
      in[i] = i < d.n_in ? bufs[d.src[i]] : nullptr;
    void* dst = d.dst ? tmp : out;
    float* w = static_cast<float*>(work);
    cudaError_t err = cudaErrorInvalidValue;
#define K9_CASE(C, R)                                         \
  if (combine == C && reduce == R)                            \
    err = launch<C, R>(d, in[0], in[1], in[2], dst, w, st);
    K9_CASE(0, 0) K9_CASE(0, 1) K9_CASE(0, 2)
    K9_CASE(1, 0) K9_CASE(1, 1) K9_CASE(1, 2)
#undef K9_CASE
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
