// K9: the general-semiring contraction of a normal form
//
//   out[o] = fold_{k in contracted axes} combine(in_0[o, k], in_1[o, k], ..)
//
// over up to 8 out axes and 6 contracted axes, 1-4 operands; every operand
// element is cast to f32, the combine op (mul or add) pairs the operands
// left to right, the reduce op (add, max or min) folds the contracted axes
// from its identity (0, -inf, +inf) in f32, and the result is written in
// the out dtype (f32, bf16 or f16).  With no contracted axis it is a pure
// pairing (Hadamard); with one operand a pure fold (a lone reduce).
// Operands are f32, bf16 or f16.  int8 operands under (mul, add) take the
// integer accumulator instead (Desc.acc): every path loads them as int,
// multiplies and sums in int32 (two's complement, so a sum past 2^31 wraps
// as an int32 accumulator does; exact otherwise) and writes int32 or the
// f32 rounding of the int32 sum.
//
// Replaces: src/repro/kernels/emit.py, emit_pallas with a semiring other
// than (mul, add): _general_combine (emit.py:125-145), the
// identity-initialised accumulator (emit.py:192-211) and its pallas_call
// (emit.py:217), with the pad/run/slice of emit_bundle (emit.py:1105-1146)
// that ops.apply reaches it through; and emit_pallas's (mul, add) body
// with preferred_element_type=int32 (emit.py:183-187, the int32 scratch
// at :226) for the forms K1's int8 form does not take.  Here nothing is
// padded or copied: the caller (kernels/emit.py) passes descriptors with
// each operand's flat affine access (an int64 element stride per axis and
// a base offset, straight from the normal form's LeafSpec.access), so
// col-layout and transposed leaves and psi slabs are read in place, and the
// kernels mask past the logical extents, which is what the reference's
// padding with the inert element amounts to.
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
// smallest subnormal, 2^-133: NaN where f32 gives inf; an f16 value is hi
// + lo exactly); the other paths round the pair and the fold.  Every fold
// runs in a fixed order, so a sum gives the same bits on every run (no
// atomics).  The integer paths are exact in any order.
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
//  - TILE: two operands, 1-6 contracted axes, the M-side operand free of
//    the N axis and the N-side free of M (matmul forms, batched, col-layout
//    and psi leaves, masked edges, contractions over axes whose strides do
//    not chain, such as A[i,a,b,c,d] B[d,c,b,a,j]).  K is the flattened
//    contracted index, the innermost axis fastest; over several axes
//    (k9_tile's MK) the first 32 threads decode each slab's 16 indices
//    once into a shared table of offsets per operand, a slab ahead of its
//    fetch, and every copy adds the table's offset where one axis adds k
//    times its stride (16-byte copies along K only where the innermost
//    axis has stride 1 and an extent the vector divides; the host
//    decides).  One 256-thread block per 128x128 tile
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
//    bf16 or f16 operand into registers too, widened to f32 once where 16
//    threads read it, not at every read.  Unaligned f32 operands take
//    4-byte cp.async elements, unaligned 16-bit ones element loads.  Past K
//    the slab holds each side's inert element (the pair gives the reduce's
//    identity), so the inner loop is unrolled with no mask; past M and N
//    nothing is stored.  (mul, add) reads the same slabs into mma.sync
//    m16n8k16 tiles (a warp 64 x 32), splitting each value into bf16 hi /
//    lo parts as it is read; each slab's products land in a fresh tile
//    added with round-to-nearest adds.  Where the tiles alone do not fill
//    the 132 SMs, K is split over blocks: each writes an f32 partial tile,
//    and a second kernel folds the partials in split order.  The integer
//    tile stages int8 elements one by one (and an int32 chain scratch as
//    f32 bits) into the same slabs as int32 bits and multiplies and adds
//    in int32 (IMAD), its partials int32.
//  - MAP: no contracted axis, or only contracted extents of 1 (Hadamard,
//    outer, Kronecker).  A run is 4 consecutive outputs along the last
//    out axis; a thread takes a span of runs (the host's Desc.span),
//    MAP_STEP (a block's threads) apart, so each step of a block stores one
//    contiguous stretch.  Its first run's coordinates are decoded once
//    (the run in its row, then each walked out slot, innermost first: a
//    mixed-radix number), by a multiplier and shift a digit that the host
//    computed into the descriptor; every further run adds the step's
//    digits (the host's too) with carries, and each operand's offset and
//    the output's by the host's step and carry offsets: no division and
//    no multiply a run.  Where the output's cells and every operand's
//    offsets fit in 31 bits the walk is 32-bit (the 6-axis Kronecker
//    product's old full decode a run took ~6 divisions and ~21 64-bit
//    multiply-adds for each 16 bytes stored, instruction-bound near its
//    bytes bound).  Each operand is read as one vector (aligned, stride 1),
//    one broadcast scalar (stride 0) or 4 strided scalars; the run is
//    stored as one vector, with a streaming hint (st.global.cs) where
//    the output passes the L2 (the host's stream_out), so it does not
//    evict the operands.
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
//    host hands two TILE descriptors: T = A (x) B over j into an f32 (int32
//    under the integer accumulator) scratch buffer, then T (x) C over k, as
//    the reference's (mul, add) body contracts its einsum pairwise.  For
//    the tropical pairs this is bit for bit the nest: x -> rn(x + c) is
//    monotone, so max_k rn(max_j rn(a + b) + c) = max_{j,k} rn(rn(a + b) +
//    c) (and min alike), NaN included, but for one case: where a term of T
//    is -inf (+inf for min) from one j while another j wins, and c is +inf
//    (-inf), the nest pairs -inf with +inf into NaN and the factored form
//    does not (ROADMAP.md, Queue 3, deliberate deviations).
//  - A nest of more than 4 operands comes as two descriptors too: a MAP
//    that pairs the first 4 into the scratch over the axes they walk, then
//    the scratch and the rest (the pair runs left to right either way, so
//    the value is the nest's, bit for bit).
//  - THREAD: every other nest (a lone reduce over axes whose strides do
//    not chain, a 3- or 4-operand nest that is no chain, a grid past the
//    CUDA limits; the host first merges adjacent contracted axes that one
//    flattened index walks, so a lone reduce over adjacent axes is
//    REDUCE's).  Where the contracted volume
//    is at least 32 (Desc.rows), a warp an output: its lanes walk the
//    flattened contracted index, the innermost axis fastest, so a
//    stride-1 innermost axis is read in whole 128-byte lines (one thread
//    an output read lines 16 KB apart and left the card mostly idle:
//    the (4096, 64, 64) max over (1, 2) took 16x torch.amax there), each
//    lane folding its own elements in order, 8 loads in flight, and the
//    lanes folded by a fixed xor-shuffle tree (reruns are the same bits).
//    Below 32, one thread an output through the read-only cache.  Both
//    walk the last 3 contracted slots where the nest has at most 3, else
//    all 6 (a template argument, so the common case keeps its short
//    index arithmetic).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_IN = 4, MAX_OUT = 8, MAX_RED = 6, NAX = MAX_OUT + MAX_RED;
constexpr int LAST = MAX_OUT - 1;       // the last out slot (TILE's N)
constexpr int ROW = MAX_OUT - 2;        // TILE's M slot
constexpr int KS = NAX - 1;             // the innermost contracted slot
constexpr int MAX_BUFS = 2 * MAX_IN - 1;   // inputs one call binds
constexpr int TM = 128, TK = 16, TPAD = 4, TILE_THREADS = 256;
constexpr int THREAD_BLOCK = 64, BLOCK = 256, WARPS = BLOCK / 32;
constexpr int RUN = 4;                  // MAP / REDUCE: elements a vector
constexpr int STRIP = 32 * RUN;         // REDUCE columns: outputs a block
enum { MODE_TILE = 0, MODE_THREAD = 1, MODE_REDUCE = 2, MODE_MAP = 3 };
enum { SRC_TMP = MAX_BUFS };            // Desc.src: the call's scratch
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I8 = 3, DT_I32 = 4 };

// must match kernels/emit.py, K9Desc
struct Desc {
  long long out_ext[MAX_OUT];  // right-aligned: unused leading slots 1
  long long red_ext[MAX_RED];  // right-aligned: the innermost axis last
  long long stride[MAX_IN][NAX];
  long long base[MAX_IN];
  long long out_stride[MAX_OUT];
  long long k_split;     // TILE / REDUCE: contracted elements a split
  int in_dtype[MAX_IN];  // DT_*: 0 f32, 1 bf16, 2 f16, 3 int8, 4 int32
  int k_fast[MAX_IN];    // TILE: the operand is read along K
  int vec[MAX_IN];       // vector copies along the operand's fast axis
  int src[MAX_IN];       // 0-6 the call's inputs, SRC_TMP its scratch
  int n_in;
  int n_red;
  int out_dtype;         // DT_*
  int mode;
  int a_op, b_op;        // TILE: the M-side and N-side operand
  int splits;            // TILE / REDUCE: blocks along the contracted axis
  int rows;              // REDUCE: 1 a warp an output, 0 column strips
  int vec_out;           // vector stores along the last out axis
  int dst;               // 0 the output, 1 the call's scratch
  int acc;               // 0 f32, 1 int32 ((mul, add) on int8)
  // MAP's walk (kernels/emit.py, map_walk): digit 0 the run in its row
  // (radix: the runs a row), digit p >= 1 out slot LAST - p; the last
  // walked digit takes what is left (no radix)
  long long walk_digit[MAX_OUT];             // a step's digits
  long long walk_step[MAX_IN + 1];           // a step's offset change:
                                             // each operand's, the output's
  long long walk_wrap[MAX_IN + 1][MAX_OUT];  // and more where digit p carries
  unsigned walk_mul[MAX_OUT];   // a / radix = (a walk_mul) >> walk_shift,
  int walk_shift[MAX_OUT];      // for a < 2^31
  int walk_top;          // the outermost digit a step adds to
  int narrow;            // MAP: 32-bit index arithmetic
  int stream_out;        // MAP: streaming vector stores
  int span;              // MAP: runs a thread
};

// one descriptor's operand buffers, by value in the kernels' parameters
struct Ins {
  const void* p[MAX_IN];
};

template <typename T>
constexpr bool IS_INT = std::is_same<T, int>::value;

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

// int32 products and sums wrap (unsigned arithmetic: no signed overflow)
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

template <int COMB, typename T>
__device__ __forceinline__ T pair(T a, T b) {
  if constexpr (IS_INT<T>)
    return wrap_mul(a, b);              // the integer path is (mul, add)
  else
    return COMB == 0 ? __fmul_rn(a, b) : __fadd_rn(a, b);
}

template <int RED, typename T>
__device__ __forceinline__ T fold(T acc, T v) {
  if constexpr (IS_INT<T>) {
    return wrap_add(acc, v);
  } else {
    if (RED == 0) return __fadd_rn(acc, v);
    if (RED == 1) return max_nan(acc, v);
    return min_nan(acc, v);
  }
}

template <int RED, typename T = float>
__device__ __forceinline__ T identity() {
  if constexpr (IS_INT<T>) {
    return 0;
  } else {
    if (RED == 0) return 0.f;
    return RED == 1 ? -__int_as_float(0x7f800000)
                    : __int_as_float(0x7f800000);
  }
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

// a 16-bit element (bf16 or f16) widened to f32, exactly
__device__ __forceinline__ float widen16(unsigned raw, int dtype) {
  raw &= 0xffffu;
  return dtype == DT_F16 ? __half2float(__ushort_as_half((unsigned short)raw))
                         : __uint_as_float(raw << 16);
}

// the 16-bit bits of a pad value (0, 1 or an inf: exact in both)
__device__ __forceinline__ unsigned short raw16(float x, int dtype) {
  return dtype == DT_F16 ? __half_as_ushort(__float2half_rn(x))
                         : static_cast<unsigned short>(__float_as_uint(x) >>
                                                       16);
}

template <typename T>
__device__ __forceinline__ T load(const void* p, long long off, int dtype) {
  if constexpr (IS_INT<T>) {
    if (dtype == DT_I8)
      return (int)__ldg(static_cast<const signed char*>(p) + off);
    return __ldg(static_cast<const int*>(p) + off);
  } else {
    if (dtype == DT_F32) return __ldg(static_cast<const float*>(p) + off);
    return widen16(__ldg(static_cast<const unsigned short*>(p) + off), dtype);
  }
}

// 4 consecutive elements at an offset aligned to 4 (16 bytes f32 / int32,
// 8 bf16 / f16, 4 int8)
template <typename T>
__device__ __forceinline__ void load4(const void* p, long long off, int dtype,
                                      T (&v)[RUN]) {
  if constexpr (IS_INT<T>) {
    if (dtype == DT_I8) {
      const char4 q = __ldg(reinterpret_cast<const char4*>(
          static_cast<const signed char*>(p) + off));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const int4 q =
          __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(p) +
                                              off));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    }
  } else if (dtype == DT_F32) {
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                              off));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(p) + off));
    v[0] = widen16(q.x, dtype), v[1] = widen16(q.x >> 16, dtype);
    v[2] = widen16(q.y, dtype), v[3] = widen16(q.y >> 16, dtype);
  }
}

// A run of 4 elements along an axis of stride s from off: one vector
// (vec), one broadcast scalar (s == 0) or `rem` (< 4 at an edge) scalars.
template <typename T>
__device__ __forceinline__ void load_run(const void* p, long long off,
                                         long long s, int dtype, bool vec,
                                         long long rem, T (&v)[RUN]) {
  if (vec && rem >= RUN) {
    load4<T>(p, off, dtype, v);
  } else if (s == 0) {
    const T x = load<T>(p, off, dtype);
#pragma unroll
    for (int e = 0; e < RUN; ++e) v[e] = x;
  } else {
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      v[e] = e < rem ? load<T>(p, off + e * s, dtype) : T(0);
  }
}

// An f32 value to an f32, bf16 or f16 output; an int32 sum to an int32 or
// (rounded to nearest) f32 one.
template <typename T>
__device__ __forceinline__ void store(void* p, long long off, T v,
                                      int dtype) {
  if constexpr (IS_INT<T>) {
    if (dtype == DT_I32)
      static_cast<int*>(p)[off] = v;
    else
      static_cast<float*>(p)[off] = __int2float_rn(v);
  } else {
    if (dtype == DT_F32)
      static_cast<float*>(p)[off] = v;
    else if (dtype == DT_BF16)
      static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn(v);
    else
      static_cast<__half*>(p)[off] = __float2half_rn(v);
  }
}

__device__ __forceinline__ unsigned pack16(float x, float y, int dtype) {
  if (dtype == DT_F16) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&b);
}

// 16 bytes (4 words) or 8 (2), plainly or with the evict-first streaming
// hint (cs: the data is written once and not read back soon)
__device__ __forceinline__ void st_v4(void* p, unsigned a, unsigned b,
                                      unsigned c, unsigned d, bool cs) {
  if (cs)
    asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "r"(a), "r"(b), "r"(c), "r"(d)
                 : "memory");
  else
    *static_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

__device__ __forceinline__ void st_v2(void* p, unsigned a, unsigned b,
                                      bool cs) {
  if (cs)
    asm volatile("st.global.cs.v2.b32 [%0], {%1, %2};\n" ::"l"(p), "r"(a),
                 "r"(b)
                 : "memory");
  else
    *static_cast<uint2*>(p) = make_uint2(a, b);
}

// 4 consecutive outputs at an offset aligned to 4 (cs: streaming)
template <typename T>
__device__ __forceinline__ void store4(void* p, long long off,
                                       const T (&v)[RUN], int dtype,
                                       bool cs = false) {
  if constexpr (IS_INT<T>) {
    if (dtype == DT_I32) {
      st_v4(static_cast<int*>(p) + off, v[0], v[1], v[2], v[3], cs);
    } else {
      st_v4(static_cast<float*>(p) + off,
            __float_as_uint(__int2float_rn(v[0])),
            __float_as_uint(__int2float_rn(v[1])),
            __float_as_uint(__int2float_rn(v[2])),
            __float_as_uint(__int2float_rn(v[3])), cs);
    }
  } else if (dtype == DT_F32) {
    st_v4(static_cast<float*>(p) + off, __float_as_uint(v[0]),
          __float_as_uint(v[1]), __float_as_uint(v[2]),
          __float_as_uint(v[3]), cs);
  } else {
    st_v2(static_cast<unsigned short*>(p) + off, pack16(v[0], v[1], dtype),
          pack16(v[2], v[3], dtype), cs);
  }
}

__device__ __forceinline__ const void* pick(const Ins& in, int i) {
  return i == 0 ? in.p[0] : (i == 1 ? in.p[1] : (i == 2 ? in.p[2] : in.p[3]));
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

// The cells of the out slots [0, NS): their extents' product.  W < NS:
// only the last W of them are in use (the host checked that the others
// have extent 1), and only those are read.
template <int NS, int W = NS>
__device__ __forceinline__ long long lead_cells(const Desc& d) {
  long long n = 1;
#pragma unroll
  for (int s = NS - W; s < NS; ++s) n *= d.out_ext[s];
  return n;
}

// Offsets of lead cell z (row-major over the out slots [0, NS)): per
// operand (its base included; the first N, those the kernel reads) and
// in the output.
template <int NS, int N = MAX_IN>
__device__ __forceinline__ void cell_offsets(const Desc& d, long long z,
                                             long long (&off)[MAX_IN],
                                             long long& ooff) {
#pragma unroll
  for (int i = 0; i < N; ++i) off[i] = d.base[i];
  ooff = 0;
#pragma unroll
  for (int s = NS - 1; s >= 0; --s) {
    const long long e = d.out_ext[s];
    if (e == 1) continue;
    long long c;
    if (z < e) {               // the outermost slot left: no division
      c = z;
      z = 0;
    } else {
      z = divmod(z, e, c);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) off[i] += c * d.stride[i][s];
    ooff += c * d.out_stride[s];
  }
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

typedef float Slab[TK][TM + TPAD];   // [k][row] f32 (int32 bits: integer)
constexpr int STAGES = 3;            // slab s computed, s+1 and s+2 in flight
constexpr int TILE_SMEM = 2 * STAGES * (int)sizeof(Slab);

// How one operand of a TILE block is staged: an f32 (or int32) operand
// read along its rows by cp.async straight into the slab (16-byte chunks
// where the host found them aligned); an f32 operand read along K,
// aligned, by 16-byte loads into registers, stored transposed after the
// slab's compute (no copy can scatter a chunk over 4 slab rows); any other
// f32 operand by 4-byte cp.async elements (which transpose too); a bf16 or
// f16 operand through registers (raw, 8 to a 16-byte load), widened to f32
// when stored; an int8 operand element by element into registers, stored
// as int32 bits (the integer tile only).
enum { ST_CP16 = 0, ST_CP4 = 1, ST_REG = 2, ST_I8 = 3 };

struct Operand {
  const void* p;
  long long off;    // element offset of (row 0 of the tile, k = 0)
  long long s_row, s_k;
  long long rows;   // rows of the tile inside the extent (may be <= 0)
  int k_fast, vec, how, half, dt;
  float pad;        // past K
  unsigned r[8];    // ST_REG / ST_I8: a slab's raw elements
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
// mappings (ST_CP4, ST_I8, 16-bit element loads): along K 16 threads a
// row, along the rows 128 threads a slab row.
__device__ __forceinline__ int elem_kk(int k_fast, int i) {
  const int t = threadIdx.x;
  return k_fast ? (t & (TK - 1)) : (t >> 7) + 2 * i;
}

__device__ __forceinline__ int elem_r(int k_fast, int i) {
  const int t = threadIdx.x;
  return k_fast ? (t >> 4) + 16 * i : (t & (TM - 1));
}

// Start the copies of the slab [k0, k0 + TK) (k < kend) into dst; ST_REG
// and ST_I8 operands load into registers (stored by commit).  Rows past
// the extent get zeros or the pad (their outputs are never stored).  Any
// slab: each element's address and bounds from the operand's strides.
// MK (several contracted axes): the offset of slab element kk along K is
// kt[kk] (k_offsets), not k * s_k; a 16-byte chunk along K stays inside
// one run of the innermost axis (the host's vector rule), so its elements
// lie kt[kk] + 0, 1, ...
template <typename T, bool MK = false>
__device__ __forceinline__ void fetch_edge(Operand& o, Slab& dst,
                                           long long k0, long long kend,
                                           const long long* kt = nullptr) {
  const int t = threadIdx.x;
  auto koff = [&](int kk, long long k) -> long long {
    if constexpr (MK)
      return kt[kk];
    else
      return k * o.s_k;
  };
  if constexpr (IS_INT<T>) {
    if (o.how == ST_I8) {               // the integer tile's int8 operand
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kk = elem_kk(o.k_fast, i), r = elem_r(o.k_fast, i);
        const long long k = k0 + kk;
        o.r[i] = (k < kend && r < o.rows)
                     ? (unsigned)(int)__ldg(
                           static_cast<const signed char*>(o.p) + o.off +
                           r * o.s_row + koff(kk, k))
                     : 0u;              // (mul, add) pads with 0
      }
      return;
    }
  }
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
                         (bytes ? o.off + r + koff(kk, k) : 0);
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
                         (ok ? o.off + r * o.s_row + koff(kk, k) : 0);
      cp4(d, src, ok ? 4 : 0);
    }
  } else if (!o.half) {                 // f32 along K, 2 x 4 aligned
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * TILE_THREADS;
      const int r = c >> 2, kq = (c & 3) * 4;
      const long long k = k0 + kq;
      const float* src = static_cast<const float*>(o.p) + o.off +
                         r * o.s_row + (MK ? kt[kq] : k);   // stride 1
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
  } else if (o.vec) {                   // 16-bit: 8 along K or along rows
    const int r = o.k_fast ? (t >> 1) : (t & 15) * 8;
    const int kk = o.k_fast ? (t & 1) * 8 : (t >> 4);
    const long long k = k0 + kk;
    const long long at = o.off + r * o.s_row + koff(kk, k);
    const bool full = o.k_fast ? (r < o.rows && k + 8 <= kend)
                               : (k < kend && r + 8 <= o.rows);
    if (full) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const unsigned short*>(o.p) + at));
      o.r[0] = q.x, o.r[1] = q.y, o.r[2] = q.z, o.r[3] = q.w;
    } else {
      const unsigned short pad = raw16(o.pad, o.dt);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ke = o.k_fast ? kk + e : kk;
        const long long re = o.k_fast ? r : r + e;
        const unsigned short v =
            (re < o.rows && k0 + ke < kend)
                ? __ldg(static_cast<const unsigned short*>(o.p) + o.off +
                        re * o.s_row + koff(ke, k0 + ke))
                : pad;
        o.r[e >> 1] = (e & 1) ? (o.r[e >> 1] | ((unsigned)v << 16)) : v;
      }
    }
  } else {                              // 16-bit, element by element
    const unsigned short pad = raw16(o.pad, o.dt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = elem_kk(o.k_fast, i), r = elem_r(o.k_fast, i);
      const long long k = k0 + kk;
      const unsigned short v =
          (k < kend && r < o.rows)
              ? __ldg(static_cast<const unsigned short*>(o.p) + o.off +
                      r * o.s_row + koff(kk, k))
              : pad;
      o.r[i >> 1] = (i & 1) ? (o.r[i >> 1] | ((unsigned)v << 16)) : v;
    }
  }
}

// fetch for a slab inside K: the precomputed addresses advanced by a
// slab, only the rows checked (by the mask).
template <typename T>
__device__ __forceinline__ void fetch_full(Operand& o, Slab& dst,
                                           long long k0, long long kend) {
  const int t = threadIdx.x;
  if constexpr (IS_INT<T>) {
    if (o.how == ST_I8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o.r[i] = ((o.rowmask >> i) & 1)
                     ? (unsigned)(int)__ldg(
                           reinterpret_cast<const signed char*>(o.cur +
                                                                i * o.di))
                     : 0u;
      return;
    }
  }
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
  } else if (!o.half) {                 // f32 along K, 2 x 4 aligned
    const unsigned pad = __float_as_uint(o.pad);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 q = make_uint4(pad, pad, pad, pad);
      if ((o.rowmask >> i) & 1)
        q = __ldg(reinterpret_cast<const uint4*>(o.cur + i * o.di));
      o.r[4 * i] = q.x, o.r[4 * i + 1] = q.y;
      o.r[4 * i + 2] = q.z, o.r[4 * i + 3] = q.w;
    }
  } else if (o.vec) {                   // 16-bit, 8 in one 16-byte load
    if (o.rowmask & 1) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(o.cur));
      o.r[0] = q.x, o.r[1] = q.y, o.r[2] = q.z, o.r[3] = q.w;
    } else {
      fetch_edge<T>(o, dst, k0, kend);  // a chunk across the rows' end
    }
  } else {                              // 16-bit, element by element
    const unsigned short pad = raw16(o.pad, o.dt);
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

// MK: every slab by its table of offsets (fetch_edge); else a slab inside
// K by the precomputed addresses
template <typename T, bool MK = false>
__device__ __forceinline__ void fetch(Operand& o, Slab& dst, long long k0,
                                      long long kend,
                                      const long long* kt = nullptr) {
  if constexpr (MK) {
    fetch_edge<T, true>(o, dst, k0, kend, kt);
    return;
  }
  if (k0 + TK <= kend)
    fetch_full<T>(o, dst, k0, kend);
  else
    fetch_edge<T>(o, dst, k0, kend);
  o.cur += o.dk;
}

// MK: the element offsets, in the M-side (row h = 0) and N-side (h = 1)
// operand, of the flattened contracted indices k0 .. k0 + TK - 1 (0 past
// kend), the innermost contracted slot fastest (THREAD's and
// run_descriptor's order): one index a thread of the first 2 TK, decoded
// once a slab in 32-bit arithmetic (the host keeps the volume below 2^31)
__device__ __forceinline__ void k_offsets(const Desc& d,
                                          long long (*tab)[TK], long long k0,
                                          long long kend) {
  const int t = threadIdx.x;
  if (t >= 2 * TK) return;
  const int h = t / TK, kk = t % TK;
  const int op = h ? d.b_op : d.a_op;
  long long off = 0;
  if (k0 + kk < kend) {
    unsigned k = (unsigned)(k0 + kk);
#pragma unroll
    for (int s = MAX_RED - 1; s >= 0; --s) {
      if (s < MAX_RED - d.n_red) break;
      const unsigned e = (unsigned)d.red_ext[s];
      const unsigned q = k / e;
      off += (long long)(k - q * e) * d.stride[op][MAX_OUT + s];
      k = q;
    }
  }
  tab[h][kk] = off;
}

// Store an ST_REG (ST_I8) operand's registers into its slab, widened (as
// int32 bits), as fetch mapped them.
template <typename T>
__device__ __forceinline__ void commit(const Operand& o, Slab& dst) {
  const int t = threadIdx.x;
  if constexpr (IS_INT<T>) {
    if (o.how == ST_I8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[elem_kk(o.k_fast, i)][elem_r(o.k_fast, i)] =
            __int_as_float((int)o.r[i]);
      return;
    }
  }
  if (o.how != ST_REG) return;
  if (!o.half) {
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
    v[2 * i] = widen16(o.r[i], o.dt);
    v[2 * i + 1] = widen16(o.r[i] >> 16, o.dt);
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

// lead: the operand's offset of the tile's lead cell (its base included)
template <typename T>
__device__ __forceinline__ Operand tile_operand(const Desc& d, const void* p,
                                                int i, int row_slot,
                                                long long lead,
                                                long long row0,
                                                long long kbeg, float pad) {
  Operand o;
  o.p = p;
  o.s_row = d.stride[i][row_slot];
  o.s_k = d.stride[i][KS];
  o.off = lead + row0 * o.s_row;
  o.rows = d.out_ext[row_slot] - row0;
  o.k_fast = d.k_fast[i];
  o.vec = d.vec[i];
  o.dt = d.in_dtype[i];
  o.half = o.dt == DT_BF16 || o.dt == DT_F16;
  const bool i8 = IS_INT<T> && o.dt == DT_I8;
  o.how = i8 ? ST_I8
             : (o.half ? ST_REG
                       : (o.vec && !o.k_fast ? ST_CP16
                                             : (o.vec ? ST_REG : ST_CP4)));
  o.pad = pad;
  // the fast path's first element (chunk) at k = kbeg, its steps and rows
  const int t = threadIdx.x, esize = i8 ? 1 : (o.half ? 2 : 4);
  long long r0, kk0;
  int n = 1;
  long long dr = 0, dkk = 0;           // row and K steps between elements
  if (o.how == ST_CP16) {
    r0 = (t & 31) * 4, kk0 = t >> 5, dkk = 8, n = 2;
  } else if (o.how == ST_REG && !o.half) {
    r0 = t >> 2, kk0 = (t & 3) * 4, dr = 64, n = 2;
  } else if (o.how == ST_REG && o.vec) {   // 16-bit 16-byte chunks
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
  const long long need = (o.how == ST_REG && o.half && o.vec && !o.k_fast)
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
  if (dtype == DT_F32)
    *reinterpret_cast<float2*>(static_cast<float*>(p) + off) =
        make_float2(x, y);
  else
    *reinterpret_cast<unsigned*>(static_cast<unsigned short*>(p) + off) =
        pack16(x, y, dtype);
}

// ---- TILE -------------------------------------------------------------------

// Output (or, with splits, partial) tile of rows m0.., columns n0...;
// TC: (mul, add) on the tensor cores (mma_slab), else FMA / pair-fold;
// T int: the integer tile (IMAD on int32 bits in the slabs).  MK: several
// contracted axes, K their flattened index (innermost fastest); each
// slab's operand offsets are decoded once into a table (k_offsets) a
// slab ahead of its fetch, one table a ring stage.
template <int COMB, int RED, bool TC, typename T, bool MK>
__global__ void __launch_bounds__(TILE_THREADS)
k9_tile(const Desc d, const Ins in, void* __restrict__ out,
        float* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long ktab[MK ? STAGES : 1][2][TK];
  Slab* sa = reinterpret_cast<Slab*>(smem);
  Slab* sb = sa + STAGES;
  const long long M = d.out_ext[ROW], N = d.out_ext[LAST];
  long long K = d.red_ext[MAX_RED - 1];
  if constexpr (MK) {
#pragma unroll
    for (int s = 0; s < MAX_RED - 1; ++s) K *= d.red_ext[s];
  }
  const long long m0 = (long long)blockIdx.y * TM;
  const long long n0 = (long long)blockIdx.x * TM;
  long long cell = blockIdx.z / d.splits;
  const int split = blockIdx.z % d.splits;
  // the lead cell's offsets in the two operands and the output
  long long la = d.base[d.a_op], lb = d.base[d.b_op], obase = 0;
#pragma unroll
  for (int s = ROW - 1; s >= 0; --s) {
    const long long e = d.out_ext[s];
    if (e == 1) continue;
    long long c;
    cell = divmod(cell, e, c);
    la += c * d.stride[d.a_op][s];
    lb += c * d.stride[d.b_op][s];
    obase += c * d.out_stride[s];
  }
  const long long kbeg = split * d.k_split;
  const long long kend = kbeg + d.k_split < K ? kbeg + d.k_split : K;
  Operand A = tile_operand<T>(d, pick(in, d.a_op), d.a_op, ROW, la, m0,
                              kbeg, pad_a<COMB, RED>());
  Operand B = tile_operand<T>(d, pick(in, d.b_op), d.b_op, LAST, lb, n0,
                              kbeg, pad_b<COMB, RED>());
  // a thread's 8 rows: ra + 0..3 and rb + 0..3; its 8 columns likewise
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = ty * 4, rb = ra + 64, ca = tx * 4, cb = ca + 64;
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = identity<RED, T>();

  const long long nslab = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;
  if constexpr (MK) {          // the tables of the ring's first 3 slabs
#pragma unroll
    for (int p = 0; p < STAGES; ++p) k_offsets(d, ktab[p], kbeg + p * TK, kend);
    __syncthreads();
  }
  // the ring's first two slabs; a group is committed per slab (empty past
  // the last) so that wait_group 1 always leaves only the next one open
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nslab) {
      fetch<T, MK>(A, sa[p], kbeg + p * TK, kend, ktab[MK ? p : 0][0]);
      fetch<T, MK>(B, sb[p], kbeg + p * TK, kend, ktab[MK ? p : 0][1]);
      commit<T>(A, sa[p]);
      commit<T>(B, sb[p]);
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
      fetch<T, MK>(A, sa[ahead], kbeg + (s + STAGES - 1) * TK, kend,
                   ktab[MK ? ahead : 0][0]);
      fetch<T, MK>(B, sb[ahead], kbeg + (s + STAGES - 1) * TK, kend,
                   ktab[MK ? ahead : 0][1]);
    }
    // slab s + 3's table into slab s's (last read by slab s's fetch, two
    // barriers ago); read after the next barrier
    if constexpr (MK)
      if (s + STAGES < nslab)
        k_offsets(d, ktab[cur], kbeg + (s + STAGES) * TK, kend);
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
          if constexpr (IS_INT<T>)
            acc[i][j] = wrap_add(
                acc[i][j], wrap_mul(__float_as_int(a[i]), __float_as_int(b[j])));
          else if (COMB == 0 && RED == 0)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          else
            acc[i][j] = fold<RED>(acc[i][j], pair<COMB>(a[i], b[j]));
        }
    }
    if (more) {
      commit<T>(A, sa[ahead]);
      commit<T>(B, sb[ahead]);
    }
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }

  // the tile: to its place in the output (or the scratch), or as a
  // partial (f32, or int32 bits) to the split's slice of work
  const bool partial = d.splits > 1;
  void* dst = partial ? static_cast<void*>(work) : out;
  const int dtype = partial ? (IS_INT<T> ? DT_I32 : DT_F32) : d.out_dtype;
  if (partial)
    obase += (long long)split * lead_cells<ROW>(d) * M * N;
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
          const long long row = obase + gm * d.out_stride[ROW];
          if (d.vec_out && gn + 2 <= N) {
            store2(dst, row + gn, a4[2 * h], a4[2 * h + 1], dtype);
          } else {
            if (gn < N) store<float>(dst, row + gn, a4[2 * h], dtype);
            if (gn + 1 < N)
              store<float>(dst, row + gn + 1, a4[2 * h + 1], dtype);
          }
        }
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gm = m0 + (i < 4 ? ra : rb) + (i & 3);
    if (gm >= M) continue;
    const long long row = obase + gm * d.out_stride[ROW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gn = n0 + (h ? cb : ca);
      const T v[RUN] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]};
      if (d.vec_out && gn + RUN <= N) {
        store4<T>(dst, row + gn, v, dtype);
      } else {
#pragma unroll
        for (int e = 0; e < RUN; ++e)
          if (gn + e < N)
            store<T>(dst, row + (gn + e) * d.out_stride[LAST], v[e], dtype);
      }
    }
  }
}

// dst[i] = fold over the splits, in order, of work[s * n + i] (T's bits)
template <int RED, typename T>
__global__ void __launch_bounds__(BLOCK)
k9_fold(const float* __restrict__ work, long long n, int splits,
        void* __restrict__ dst, int dtype) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const T* w = reinterpret_cast<const T*>(work);
  T v = w[i];
  for (int s = 1; s < splits; ++s) v = fold<RED, T>(v, w[s * n + i]);
  store<T>(dst, i, v, dtype);
}

// ---- MAP --------------------------------------------------------------------

// W: the lead out slots walked, the last W (MAP_SHORT where the nest has
// at most MAP_SHORT + 1 out axes, else all LAST)
constexpr int MAP_SHORT = 3;
// the runs between two of a thread's runs (must match kernels/emit.py's
// MAP_STEP; the host picks how many a thread takes, Desc.span)
constexpr int MAP_STEP = BLOCK;

// z / radix: by the host's multiplier and shift (32-bit walk, z < 2^31),
// else by division
template <typename I>
__device__ __forceinline__ I walk_div(const Desc& d, int p, I z, I radix) {
  if constexpr (sizeof(I) == 4)
    return (I)(((unsigned long long)z * d.walk_mul[p]) >> d.walk_shift[p]);
  else
    return z / radix;
}

// I: the walk's index type, unsigned (the host's narrow) or unsigned long
// long; offsets add modulo 2^32 (2^64), and every offset a run reads is in
// range, so the wrapped sums are the offsets
template <int COMB, int N, typename T, int W, typename I>
__global__ void __launch_bounds__(BLOCK)
k9_map(const Desc d, const Ins in, void* __restrict__ out) {
  constexpr int P = W + 1;                   // the run's digit, W slots
  const long long X = d.out_ext[LAST];
  const I per_row = (I)((X + RUN - 1) / RUN);
  const long long runs = lead_cells<LAST, W>(d) * (long long)per_row;
  long long run = (long long)blockIdx.x * MAP_STEP * d.span + threadIdx.x;
  if (run >= runs) return;
  auto radix = [&](int p) -> I {
    return p == 0 ? per_row : (I)d.out_ext[LAST - p];
  };
  // the first run: its digits, then the offsets they give
  I dig[P], off[MAX_IN], oo;
  I z = (I)run;
#pragma unroll
  for (int p = 0; p + 1 < P; ++p) {
    const I r = radix(p), q = walk_div<I>(d, p, z, r);
    dig[p] = z - q * r;
    z = q;
  }
  dig[P - 1] = z;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    I o = (I)d.base[i] + dig[0] * (I)(RUN * d.stride[i][LAST]);
#pragma unroll
    for (int p = 1; p < P; ++p) o += dig[p] * (I)d.stride[i][LAST - p];
    off[i] = o;
  }
  oo = dig[0] * (I)RUN;                      // out_stride[LAST] is 1
#pragma unroll
  for (int p = 1; p < P; ++p) oo += dig[p] * (I)d.out_stride[LAST - p];

  for (int j = 0;;) {
    const long long x0 = (long long)dig[0] * RUN, rem = X - x0;
    T v[RUN];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T w[RUN];
      load_run<T>(pick(in, i), (long long)off[i], d.stride[i][LAST],
                  d.in_dtype[i], d.vec[i], rem, w);
#pragma unroll
      for (int e = 0; e < RUN; ++e)
        v[e] = i == 0 ? w[e] : pair<COMB, T>(v[e], w[e]);
    }
    const long long o = (long long)oo;
    if (d.vec_out && rem >= RUN) {
      store4<T>(out, o, v, d.out_dtype, d.stream_out);
    } else {
#pragma unroll
      for (int e = 0; e < RUN; ++e)
        if (e < rem) store<T>(out, o + e, v[e], d.out_dtype);
    }
    if (++j == d.span) break;
    run += MAP_STEP;
    if (run >= runs) break;
    // add the step's digits, innermost first, with carries; past the
    // outermost digit the step adds to, only a carry goes on
    I carry = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p > d.walk_top && carry == 0) break;
      I t = dig[p] + (I)d.walk_digit[p] + carry;
      carry = 0;
      if (p + 1 < P && t >= radix(p)) {
        t -= radix(p);
        carry = 1;
#pragma unroll
        for (int i = 0; i < N; ++i) off[i] += (I)d.walk_wrap[i][p];
        oo += (I)d.walk_wrap[MAX_IN][p];
      }
      dig[p] = t;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) off[i] += (I)d.walk_step[i];
    oo += (I)d.walk_step[MAX_IN];
  }
}

// ---- REDUCE -----------------------------------------------------------------

// The N operands' paired run of 4 at k (offsets off[] at k = 0): along the
// contracted axis (rows) or along the last out axis.
template <int COMB, int N, typename T>
__device__ __forceinline__ void paired_run(const Desc& d, const Ins& in,
                                           const long long (&off)[MAX_IN],
                                           long long k, bool along_k,
                                           long long rem, T (&v)[RUN]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long sk = d.stride[i][KS];
    const long long s = along_k ? sk : d.stride[i][LAST];
    T w[RUN];
    load_run<T>(pick(in, i), off[i] + k * sk, s, d.in_dtype[i], d.vec[i],
                rem, w);
#pragma unroll
    for (int e = 0; e < RUN; ++e)
      v[e] = i == 0 ? w[e] : pair<COMB, T>(v[e], w[e]);
  }
}

// A warp an output; the contracted axis has stride 0 or 1 in every operand.
template <int COMB, int RED, int N, typename T>
__global__ void __launch_bounds__(BLOCK, 4)
k9_reduce_rows(const Desc d, const Ins in, void* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long X = d.out_ext[LAST];
  const long long o =
      (long long)blockIdx.x * WARPS + threadIdx.x / 32;   // the output
  if (o >= lead_cells<LAST>(d) * X) return;
  long long x, off[MAX_IN], ooff;
  cell_offsets<LAST, N>(d, divmod(o, X, x), off, ooff);
  bool vec = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    off[i] += x * d.stride[i][LAST];
    if (d.stride[i][KS] != 0 && !d.vec[i]) vec = false;
  }
  const long long K = d.red_ext[MAX_RED - 1];
  T acc[RUN];
#pragma unroll
  for (int e = 0; e < RUN; ++e) acc[e] = identity<RED, T>();
  long long k_tail = 0;
  if (vec) {                 // 4-wide vectors, 4 in flight a lane
    const long long chunks = K / RUN;
    for (long long q = lane; q < chunks; q += 4 * 32) {
      T v[4][RUN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u * 32 < chunks)
          paired_run<COMB, N, T>(d, in, off, (q + u * 32) * RUN, true, RUN,
                                 v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q + u * 32 < chunks)
#pragma unroll
          for (int e = 0; e < RUN; ++e)
            acc[e] = fold<RED, T>(acc[e], v[u][e]);
    }
    k_tail = chunks * RUN;
  }
  // scalars: the tail past the vectors (or all of K), 4 in flight a lane
  for (long long k = k_tail + lane; k < K; k += 4 * 32) {
    T v[4][RUN];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u * 32 < K)
        paired_run<COMB, N, T>(d, in, off, k + u * 32, true, 1, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u * 32 < K) acc[u] = fold<RED, T>(acc[u], v[u][0]);
  }
  T r = fold<RED, T>(fold<RED, T>(acc[0], acc[1]), fold<RED, T>(acc[2], acc[3]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    r = fold<RED, T>(r, __shfl_xor_sync(0xffffffffu, r, s));
  if (lane == 0) store<T>(out, ooff + x, r, d.out_dtype);
}

// A block a strip of STRIP outputs along the last out axis (a lane 4) and
// a split of the contracted axis, its warps on interleaved rows.
template <int COMB, int RED, int N, typename T>
__global__ void __launch_bounds__(BLOCK, 4)
k9_reduce_cols(const Desc d, const Ins in, void* __restrict__ out,
               float* __restrict__ work) {
  __shared__ T part[WARPS][STRIP];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long X = d.out_ext[LAST];
  const long long x0 = (long long)blockIdx.x * STRIP + lane * RUN;
  const int split = blockIdx.y;
  long long off[MAX_IN], ooff;
  cell_offsets<LAST, N>(d, blockIdx.z, off, ooff);
  const long long K = d.red_ext[MAX_RED - 1];
  const long long kbeg = split * d.k_split;
  const long long kend = kbeg + d.k_split < K ? kbeg + d.k_split : K;
#pragma unroll
  for (int i = 0; i < N; ++i) off[i] += x0 * d.stride[i][LAST];
  T acc[RUN];
#pragma unroll
  for (int e = 0; e < RUN; ++e) acc[e] = identity<RED, T>();
  const long long rem = X - x0;
  if (rem > 0) {
    for (long long k = kbeg + w; k < kend; k += 4 * WARPS) {
      T v[4][RUN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * WARPS < kend)
          paired_run<COMB, N, T>(d, in, off, k + u * WARPS, false, rem, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * WARPS < kend)
#pragma unroll
          for (int e = 0; e < RUN; ++e)
            acc[e] = fold<RED, T>(acc[e], v[u][e]);
    }
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) part[w][lane * RUN + e] = acc[e];
  __syncthreads();
  if (threadIdx.x >= STRIP) return;
  const long long xo = (long long)blockIdx.x * STRIP + threadIdx.x;
  if (xo >= X) return;
  T r = part[0][threadIdx.x];
#pragma unroll
  for (int v = 1; v < WARPS; ++v) r = fold<RED, T>(r, part[v][threadIdx.x]);
  const long long o = ooff + xo;
  if (d.splits > 1)
    store<T>(work, (long long)split * lead_cells<LAST>(d) * X + o, r,
             IS_INT<T> ? DT_I32 : DT_F32);
  else
    store<T>(out, o, r, d.out_dtype);
}

// ---- THREAD -----------------------------------------------------------------

// The first N operands' paired value at offsets off[] (left to right);
// N = 0: the descriptor's n_in of them.
template <int COMB, typename T, int N = 0>
__device__ __forceinline__ T paired(const Desc& d, const Ins& in,
                                    const long long (&off)[MAX_IN]) {
  T v = load<T>(in.p[0], off[0], d.in_dtype[0]);
#pragma unroll
  for (int i = 1; i < MAX_IN; ++i)
    if (N ? i < N : i < d.n_in)
      v = pair<COMB, T>(v, load<T>(pick(in, i), off[i], d.in_dtype[i]));
  return v;
}

// Offsets of the output cell (lead cell z, last out index x) per operand
// (the first N) and in the output; false past the out extents.
template <int N = MAX_IN>
__device__ __forceinline__ bool locate(const Desc& d, long long z,
                                       long long x, long long (&off)[MAX_IN],
                                       long long& ooff) {
  if (x >= d.out_ext[LAST] || z >= lead_cells<LAST>(d)) return false;
  cell_offsets<LAST, N>(d, z, off, ooff);
  ooff += x * d.out_stride[LAST];
#pragma unroll
  for (int i = 0; i < N; ++i) off[i] += x * d.stride[i][LAST];
  return true;
}

// R: the contracted slots walked, the last R (3, or MAX_RED where the nest
// has more than 3)
template <int COMB, int RED, typename T, int R>
__global__ void __launch_bounds__(THREAD_BLOCK)
k9_thread(const Desc d, const Ins in, void* __restrict__ out) {
  const long long z = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long x = (long long)blockIdx.x * THREAD_BLOCK + threadIdx.x;
  long long off[MAX_IN], ooff;
  if (!locate(d, z, x, off, ooff)) return;
  T acc;
  if (d.n_red == 0) {
    acc = paired<COMB, T>(d, in, off);
  } else {
    acc = identity<RED, T>();
    constexpr int R0 = MAX_RED - R;       // the first walked slot
    long long outer = 1;
#pragma unroll
    for (int s = R0; s < MAX_RED - 1; ++s) outer *= d.red_ext[s];
    const long long K = d.red_ext[MAX_RED - 1];
    for (long long q = 0; q < outer; ++q) {
      long long o[MAX_IN];
#pragma unroll
      for (int i = 0; i < MAX_IN; ++i) o[i] = off[i];
      long long rest = q;
#pragma unroll
      for (int s = MAX_RED - 2; s >= R0; --s) {
        const long long e = d.red_ext[s];
        if (e == 1) continue;
        long long c;
        rest = divmod(rest, e, c);
#pragma unroll
        for (int i = 0; i < MAX_IN; ++i) o[i] += c * d.stride[i][MAX_OUT + s];
      }
#pragma unroll 4
      for (long long k = 0; k < K; ++k) {
        long long p[MAX_IN];
#pragma unroll
        for (int i = 0; i < MAX_IN; ++i) p[i] = o[i] + k * d.stride[i][KS];
        acc = fold<RED, T>(acc, paired<COMB, T>(d, in, p));
      }
    }
  }
  store<T>(out, ooff, acc, d.out_dtype);
}

// A warp an output cell: lane l folds the flattened contracted indices l,
// l + 32, ... (innermost axis fastest, THREAD_UNROLL loads in flight, one
// accumulator each), advanced by the mixed-radix digits of 32, then the
// accumulators fold in order and the lanes by an xor-shuffle tree.  R as
// k9_thread's: digit j is the contracted slot MAX_RED - R + j.
constexpr int THREAD_UNROLL = 8;

template <int COMB, int RED, typename T, int R, int N>
__global__ void __launch_bounds__(BLOCK)
k9_thread_warp(const Desc d, const Ins in, void* __restrict__ out) {
  constexpr int R0 = MAX_RED - R;
  const int lane = threadIdx.x % 32;
  const long long o =
      (long long)blockIdx.x * WARPS + threadIdx.x / 32;   // the output
  long long xr;
  const long long z = divmod(o, d.out_ext[LAST], xr);
  long long off[MAX_IN], ooff;
  if (!locate<N>(d, z, xr, off, ooff)) return;
  // the step of 32 and the lane's start in digits, each below its radix
  // but the first, which takes the rest
  long long step[R], k[R];
  long long ts = 32, tl = lane;
#pragma unroll
  for (int j = R - 1; j > 0; --j) {
    ts = divmod(ts, d.red_ext[R0 + j], step[j]);
    tl = divmod(tl, d.red_ext[R0 + j], k[j]);
  }
  step[0] = ts, k[0] = tl;
  const long long K0 = d.red_ext[R0];
  T acc[THREAD_UNROLL];
#pragma unroll
  for (int u = 0; u < THREAD_UNROLL; ++u) acc[u] = identity<RED, T>();
  while (k[0] < K0) {
    T v[THREAD_UNROLL];
    bool inside[THREAD_UNROLL];
#pragma unroll
    for (int u = 0; u < THREAD_UNROLL; ++u) {
      inside[u] = k[0] < K0;
      if (inside[u]) {
        long long q[MAX_IN];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          q[i] = off[i];
#pragma unroll
          for (int j = 0; j < R; ++j)
            q[i] += k[j] * d.stride[i][MAX_OUT + R0 + j];
        }
        v[u] = paired<COMB, T, N>(d, in, q);
      }
      long long carry = 0;
#pragma unroll
      for (int j = R - 1; j > 0; --j) {
        const long long e = d.red_ext[R0 + j];
        k[j] += step[j] + carry;
        carry = k[j] >= e;
        k[j] -= carry * e;
      }
      k[0] += step[0] + carry;
    }
#pragma unroll
    for (int u = 0; u < THREAD_UNROLL; ++u)
      if (inside[u]) acc[u] = fold<RED, T>(acc[u], v[u]);
  }
  T r = acc[0];
#pragma unroll
  for (int u = 1; u < THREAD_UNROLL; ++u) r = fold<RED, T>(r, acc[u]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    r = fold<RED, T>(r, __shfl_xor_sync(0xffffffffu, r, s));
  if (lane == 0) store<T>(out, ooff, r, d.out_dtype);
}

// ---- launch -----------------------------------------------------------------

constexpr long long GRID_YZ = 65535, GRID_X = 2147483647;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

long long host_cells(const Desc& d, int ns) {
  long long n = 1;
  for (int s = 0; s < ns; ++s) n *= d.out_ext[s];
  return n;
}

// fold the splits' partials into dst (row-major like the output)
template <int RED, typename T>
cudaError_t fold_splits(const Desc& d, const float* work, void* dst,
                        cudaStream_t st) {
  const long long n = host_cells(d, MAX_OUT);
  if (ceil_div(n, BLOCK) > GRID_X) return cudaErrorInvalidValue;
  k9_fold<RED, T><<<(unsigned)ceil_div(n, BLOCK), BLOCK, 0, st>>>(
      work, n, d.splits, dst, d.out_dtype);
  return cudaGetLastError();
}

template <int COMB, int RED, typename T, int R>
cudaError_t launch_thread(const Desc& d, const Ins& in, void* dst,
                          cudaStream_t st) {
  const long long lead = host_cells(d, LAST);
  const long long n = lead * d.out_ext[LAST];
  if (d.rows) {   // a warp an output
    if (ceil_div(n, WARPS) > GRID_X) return cudaErrorInvalidValue;
    const unsigned g = (unsigned)ceil_div(n, WARPS);
#define K9_WARP(NI)                                                      \
  if (d.n_in == NI)                                                      \
    k9_thread_warp<COMB, RED, T, R, NI><<<g, BLOCK, 0, st>>>(d, in, dst);
    K9_WARP(1) K9_WARP(2) K9_WARP(3) K9_WARP(4)
#undef K9_WARP
    return cudaGetLastError();
  }
  // a thread an output: lead cells z = blockIdx.z * gridDim.y + blockIdx.y
  // (locate masks the overhang of the last z row)
  const long long gy = lead < GRID_YZ ? lead : GRID_YZ;
  const long long gz = ceil_div(lead, gy);
  if (gz > GRID_YZ) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(d.out_ext[LAST], THREAD_BLOCK),
                  (unsigned)gy, (unsigned)gz);
  k9_thread<COMB, RED, T, R><<<grid, THREAD_BLOCK, 0, st>>>(d, in, dst);
  return cudaGetLastError();
}

template <int COMB, int RED, typename T, bool MK>
cudaError_t launch_tile(const Desc& d, const Ins& in, void* dst, float* work,
                        dim3 grid, cudaStream_t st) {
  constexpr bool TC = !IS_INT<T> && COMB == 0 && RED == 0;
  auto kern = k9_tile<COMB, RED, TC, T, MK>;
  static bool sized = false;    // once per instantiation and process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kern<<<grid, TILE_THREADS, TILE_SMEM, st>>>(d, in, dst, work);
  return cudaGetLastError();
}

template <int COMB, int RED, typename T>
cudaError_t launch(const Desc& d, const Ins& in, void* dst, float* work,
                   cudaStream_t st) {
  const long long lead = host_cells(d, LAST);
  const long long n = lead * d.out_ext[LAST];
  if (d.splits < 1 || (d.splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (d.mode == MODE_TILE) {
    const long long gy = ceil_div(d.out_ext[ROW], TM);
    const long long gz = host_cells(d, ROW) * d.splits;
    if (gy > GRID_YZ || gz > GRID_YZ) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)ceil_div(d.out_ext[LAST], TM), (unsigned)gy,
                    (unsigned)gz);
    cudaError_t err = d.n_red > 1
                          ? launch_tile<COMB, RED, T, true>(d, in, dst, work,
                                                            grid, st)
                          : launch_tile<COMB, RED, T, false>(d, in, dst, work,
                                                             grid, st);
    if (err != cudaSuccess || d.splits == 1) return err;
    return fold_splits<RED, T>(d, work, dst, st);
  }
  if (d.mode == MODE_MAP) {
    const long long runs = lead * ceil_div(d.out_ext[LAST], RUN);
    const long long blocks = ceil_div(runs, (long long)MAP_STEP * d.span);
    if (blocks > GRID_X || (d.narrow && n >= (1LL << 31)))
      return cudaErrorInvalidValue;
    const unsigned g = (unsigned)blocks;
    const bool short_walk = host_cells(d, LAST - MAP_SHORT) == 1;
    using U32 = unsigned;
    using U64 = unsigned long long;
#define K9_MAP_W(NI, W)                                                  \
  if (d.narrow)                                                          \
    k9_map<COMB, NI, T, W, U32><<<g, BLOCK, 0, st>>>(d, in, dst);        \
  else                                                                   \
    k9_map<COMB, NI, T, W, U64><<<g, BLOCK, 0, st>>>(d, in, dst);
#define K9_MAP(NI)                                                       \
  if (d.n_in == NI && short_walk) {                                      \
    K9_MAP_W(NI, MAP_SHORT)                                              \
  }                                                                      \
  if (d.n_in == NI && !short_walk) {                                     \
    K9_MAP_W(NI, LAST)                                                   \
  }
    K9_MAP(1) K9_MAP(2) K9_MAP(3) K9_MAP(4)
#undef K9_MAP
#undef K9_MAP_W
    return cudaGetLastError();
  }
  if (d.mode == MODE_REDUCE && d.rows) {
    if (ceil_div(n, WARPS) > GRID_X) return cudaErrorInvalidValue;
    const unsigned g = (unsigned)ceil_div(n, WARPS);
#define K9_ROWS(NI)                                                   \
  if (d.n_in == NI)                                                   \
    k9_reduce_rows<COMB, RED, NI, T><<<g, BLOCK, 0, st>>>(d, in, dst);
    K9_ROWS(1) K9_ROWS(2) K9_ROWS(3) K9_ROWS(4)
#undef K9_ROWS
    return cudaGetLastError();
  }
  if (d.mode == MODE_REDUCE) {
    if (lead > GRID_YZ || d.splits > GRID_YZ) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)ceil_div(d.out_ext[LAST], STRIP),
                    (unsigned)d.splits, (unsigned)lead);
#define K9_COLS(NI)                                                        \
  if (d.n_in == NI)                                                        \
    k9_reduce_cols<COMB, RED, NI, T><<<grid, BLOCK, 0, st>>>(d, in, dst,   \
                                                             work);
    K9_COLS(1) K9_COLS(2) K9_COLS(3) K9_COLS(4)
#undef K9_COLS
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || d.splits == 1) return err;
    return fold_splits<RED, T>(d, work, dst, st);
  }
  if (d.n_red <= 3) return launch_thread<COMB, RED, T, 3>(d, in, dst, st);
  return launch_thread<COMB, RED, T, MAX_RED>(d, in, dst, st);
}

bool valid(const Desc& d, int n_ins) {
  if (d.n_in < 1 || d.n_in > MAX_IN || d.n_red < 0 || d.n_red > MAX_RED ||
      d.mode < MODE_TILE || d.mode > MODE_MAP || d.dst < 0 || d.dst > 1 ||
      d.acc < 0 || d.acc > 1 ||
      (d.mode == MODE_TILE && (d.n_in != 2 || d.n_red < 1)) ||
      (d.mode == MODE_REDUCE && d.n_red != 1) ||
      (d.mode != MODE_TILE && d.mode != MODE_REDUCE && d.splits != 1) ||
      (d.splits > 1 && d.k_split < 1))
    return false;
  for (int i = 0; i < MAX_OUT; ++i)
    if (d.out_ext[i] < 1) return false;
  long long volume = 1;
  for (int i = 0; i < MAX_RED; ++i) {
    if (d.red_ext[i] < 0 || (d.mode == MODE_MAP && d.red_ext[i] != 1))
      return false;
    volume *= d.red_ext[i];
  }
  // TILE decodes a flattened index over several axes in 32 bits
  if (d.mode == MODE_TILE && d.n_red > 1 && volume >= (1LL << 31))
    return false;
  // MAP's walk: the host's digits, shifts and index width
  if (d.mode == MODE_MAP) {
    if (d.walk_top < 0 || d.walk_top >= MAX_OUT || d.narrow < 0 ||
        d.narrow > 1 || d.stream_out < 0 || d.stream_out > 1 || d.span < 1)
      return false;
    for (int p = 0; p < MAX_OUT; ++p)
      if (d.walk_digit[p] < 0 ||
          (d.narrow && (d.walk_shift[p] < 31 || d.walk_shift[p] > 62)))
        return false;
  }
  for (int i = 0; i < d.n_in; ++i) {
    if (d.src[i] != SRC_TMP && (d.src[i] < 0 || d.src[i] >= n_ins))
      return false;
    const int dt = d.in_dtype[i];
    if (d.acc ? (dt != DT_I8 && dt != DT_I32) : (dt < DT_F32 || dt > DT_F16))
      return false;
  }
  if (d.acc ? (d.out_dtype != DT_I32 && d.out_dtype != DT_F32)
            : (d.out_dtype < DT_F32 || d.out_dtype > DT_F16))
    return false;
  return true;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// descs points at n_desc host K9Descs, run in order, each copied by value
// into its kernels' parameters: operand i of a descriptor reads input
// src[i] of the n_ins device pointers at ins (a host array), or the
// scratch tmp (src SRC_TMP: f32, or int32 under the integer accumulator),
// and it writes out or tmp (dst); work holds the partials of a split
// contraction.  combine 0 mul / 1 add, reduce 0 add / 1 max / 2 min; a
// descriptor with acc 1 takes (mul, add) only.
extern "C" int repro_semiring(const void* descs, int n_desc, const void* ins,
                              int n_ins, void* out, void* tmp, void* work,
                              int combine, int reduce, void* stream) {
  const Desc* ds = static_cast<const Desc*>(descs);
  const void* const* bufs = static_cast<const void* const*>(ins);
  if (n_desc < 1 || n_ins < 1 || n_ins > MAX_BUFS)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < n_desc; ++s) {
    const Desc& d = ds[s];
    bool reads_tmp = false;
    for (int i = 0; i < d.n_in && i < MAX_IN; ++i)
      reads_tmp |= d.src[i] == SRC_TMP;
    if (!valid(d, n_ins) || ((d.dst == 1 || reads_tmp) && tmp == nullptr) ||
        (d.acc && (combine != 0 || reduce != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < n_desc; ++s) {
    const Desc& d = ds[s];
    Ins in;
    for (int i = 0; i < MAX_IN; ++i)
      in.p[i] = i < d.n_in ? (d.src[i] == SRC_TMP ? tmp : bufs[d.src[i]])
                           : nullptr;
    void* dst = d.dst ? tmp : out;
    float* w = static_cast<float*>(work);
    cudaError_t err = cudaErrorInvalidValue;
    if (d.acc) {
      err = launch<0, 0, int>(d, in, dst, w, st);
    } else {
#define K9_CASE(C, R)                                         \
  if (combine == C && reduce == R)                            \
    err = launch<C, R, float>(d, in, dst, w, st);
      K9_CASE(0, 0) K9_CASE(0, 1) K9_CASE(0, 2)
      K9_CASE(1, 0) K9_CASE(1, 1) K9_CASE(1, 2)
#undef K9_CASE
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
