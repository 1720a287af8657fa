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
// the caller (kernels/emit.py) passes a descriptor with each operand's
// flat affine access (an int64 element stride per axis and a base offset,
// straight from the normal form's LeafSpec.access), so col-layout and
// transposed leaves and psi slabs are read in place, and the kernel masks
// past the logical extents, which is what the reference's padding with the
// inert element amounts to.
//
// Exactness: the pair rounds once (__fmul_rn / __fadd_rn) and max / min
// fold with PTX max.NaN / min.NaN, which propagate a NaN as torch.maximum
// and torch.amax do (fmaxf would drop it), so (add, max) and (add, min)
// equal their plain version bit for bit at any shape and in any fold
// order.  The tiled (mul, add) path fuses the pair and the fold into one
// FMA; the other paths round both.
//
// What bounds it on an H100: f32 runs outside the tensor cores, 67
// TFLOP/s, i.e. 33.5 T lane-instructions/s.  A tropical term is an add and
// a max, two instructions no FMA fuses: 2 M N K / 33.5e12 s (32.8 ms at
// 8192^3); a (mul, add) term is one FMA: 2 M N K / 67e12 s.  Hadamard and
// a lone reduce are bound by their bytes at 3.35 TB/s.
//
// Design (simple first): three paths, chosen by the caller (Launch.mode).
//  - TILE: two operands, one contracted axis, the M-side operand free of
//    the N axis and the N-side free of M (matmul forms, batched, outer).
//    One 256-thread block per 64x64 tile of the last two out axes, leading
//    out axes on grid.z; the contracted axis is staged through shared
//    memory in slabs of 32, each operand's tile loaded along its smaller
//    stride (coalesced for row- and col-layout leaves alike), widened to
//    f32; 4x4 outputs a thread in registers from the identity.
//  - THREAD: one thread per output, strided loads through the read-only
//    cache (Hadamard, 3 operands, several contracted axes).
//  - WARP: one warp per output, lanes striding a contiguous contracted
//    axis, then a shuffle fold (a lone reduce along rows).
// No path pipelines its loads or uses tensor cores: later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_IN = 3, MAX_OUT = 4, MAX_RED = 3, NAX = MAX_OUT + MAX_RED;
constexpr int TM = 64, TN = 64, TK = 32, TILE_THREADS = 256;
constexpr int THREAD_BLOCK = 64, WARP_BLOCK = 256;
enum { MODE_TILE = 0, MODE_THREAD = 1, MODE_WARP = 2 };

// must match kernels/emit.py, K9Desc
struct Desc {
  long long out_ext[MAX_OUT];  // right-aligned: unused leading slots 1
  long long red_ext[MAX_RED];  // right-aligned: the innermost axis last
  long long stride[MAX_IN][NAX];
  long long base[MAX_IN];
  long long out_stride[MAX_OUT];
  int in_dtype[MAX_IN];  // 0 f32, 1 bf16
  int n_in;
  int n_red;
  int out_dtype;
  int mode;
  int a_op, b_op;        // TILE: the M-side and N-side operand
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

__device__ __forceinline__ float load(const void* p, long long off,
                                      int dtype) {
  if (dtype == 0) return __ldg(static_cast<const float*>(p) + off);
  const unsigned short raw = __ldg(static_cast<const unsigned short*>(p) + off);
  return __uint_as_float(static_cast<unsigned>(raw) << 16);
}

__device__ __forceinline__ void store(void* p, long long off, float v,
                                      int dtype) {
  if (dtype == 0)
    static_cast<float*>(p)[off] = v;
  else
    static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ const void* pick(const void* p0, const void* p1,
                                            const void* p2, int i) {
  return i == 0 ? p0 : (i == 1 ? p1 : p2);
}

// Stage a (rows x TK) slab of one operand into smem[k][row], reading
// along whichever of its row / contracted strides is smaller.
__device__ __forceinline__ void stage(float (*dst)[TM + 4], const void* p,
                                      long long base, long long s_row,
                                      long long s_k, long long rows0,
                                      long long R, long long k0, long long K,
                                      int dtype) {
  const bool k_fast = llabs(s_k) <= llabs(s_row);
  for (int e = threadIdx.x; e < TM * TK; e += TILE_THREADS) {
    int r, c;
    if (k_fast) {
      c = e % TK;
      r = e / TK;
    } else {
      r = e % TM;
      c = e / TM;
    }
    const long long gr = rows0 + r, gk = k0 + c;
    dst[c][r] = (gr < R && gk < K) ? load(p, base + gr * s_row + gk * s_k,
                                          dtype)
                                   : 0.f;
  }
}

template <int COMB, int RED>
__global__ void __launch_bounds__(TILE_THREADS)
k9_tile(const Desc d, const void* __restrict__ p0,
            const void* __restrict__ p1, const void* __restrict__ p2,
            void* __restrict__ out) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  const int a = d.a_op, b = d.b_op;
  const void* pa = pick(p0, p1, p2, a);
  const void* pb = pick(p0, p1, p2, b);
  const long long M = d.out_ext[2], N = d.out_ext[3], K = d.red_ext[2];
  const long long m0 = (long long)blockIdx.y * TM;
  const long long n0 = (long long)blockIdx.x * TN;
  const long long l0 = blockIdx.z / d.out_ext[1];
  const long long l1 = blockIdx.z % d.out_ext[1];
  const long long abase =
      d.base[a] + l0 * d.stride[a][0] + l1 * d.stride[a][1];
  const long long bbase =
      d.base[b] + l0 * d.stride[b][0] + l1 * d.stride[b][1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = identity<RED>();

  for (long long k0 = 0; k0 < K; k0 += TK) {
    stage(As, pa, abase, d.stride[a][2], d.stride[a][6], m0, M, k0, K,
          d.in_dtype[a]);
    stage(Bs, pb, bbase, d.stride[b][3], d.stride[b][6], n0, N, k0, K,
          d.in_dtype[b]);
    __syncthreads();
    const int kmax = (K - k0 < TK) ? (int)(K - k0) : TK;  // mask past K
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (COMB == 0 && RED == 0)
            acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
          else
            acc[i][j] = fold<RED>(acc[i][j], pair<COMB>(ar[i], br[j]));
        }
    }
    __syncthreads();
  }
  const long long obase = l0 * d.out_stride[0] + l1 * d.out_stride[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gn = n0 + tx * 4 + j;
      if (gn < N)
        store(out, obase + gm * d.out_stride[2] + gn * d.out_stride[3],
              acc[i][j], d.out_dtype);
    }
  }
}

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

template <int COMB, int RED>
__global__ void __launch_bounds__(WARP_BLOCK)
k9_warp(const Desc d, const void* __restrict__ p0,
            const void* __restrict__ p1, const void* __restrict__ p2,
            void* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long z = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long x =
      (long long)blockIdx.x * (WARP_BLOCK / 32) + threadIdx.x / 32;
  long long off[MAX_IN], ooff;
  if (!locate(d, z, x, off, ooff)) return;
  float acc = identity<RED>();
  for (long long k = lane; k < d.red_ext[2]; k += 32) {
    long long q[MAX_IN];
    for (int i = 0; i < MAX_IN; ++i) q[i] = off[i] + k * d.stride[i][6];
    acc = fold<RED>(acc, paired<COMB>(d, p0, p1, p2, q));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc = fold<RED>(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  if (lane == 0) store(out, ooff, acc, d.out_dtype);
}

template <int COMB, int RED>
cudaError_t launch(const Desc& d, const void* p0, const void* p1,
                   const void* p2, void* out, cudaStream_t st) {
  if (d.mode == MODE_TILE) {
    const long long lead = d.out_ext[0] * d.out_ext[1];
    const long long gy = (d.out_ext[2] + TM - 1) / TM;
    if (lead > 65535 || gy > 65535) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((d.out_ext[3] + TN - 1) / TN), (unsigned)gy,
                    (unsigned)lead);
    k9_tile<COMB, RED><<<grid, TILE_THREADS, 0, st>>>(d, p0, p1, p2, out);
    return cudaGetLastError();
  }
  // lead cells z = blockIdx.z * gridDim.y + blockIdx.y (locate masks the
  // overhang of the last z row)
  const long long lead = d.out_ext[0] * d.out_ext[1] * d.out_ext[2];
  const long long gy = lead < 65535 ? lead : 65535;
  const long long gz = (lead + gy - 1) / gy;
  if (gz > 65535) return cudaErrorInvalidValue;
  const int per = d.mode == MODE_WARP ? WARP_BLOCK / 32 : THREAD_BLOCK;
  const dim3 grid((unsigned)((d.out_ext[3] + per - 1) / per), (unsigned)gy,
                  (unsigned)gz);
  if (d.mode == MODE_WARP)
    k9_warp<COMB, RED><<<grid, WARP_BLOCK, 0, st>>>(d, p0, p1, p2, out);
  else
    k9_thread<COMB, RED><<<grid, THREAD_BLOCK, 0, st>>>(d, p0, p1, p2,
                                                            out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// desc points at a host K9Desc, copied by value into the kernel's
// parameters; combine 0 mul / 1 add, reduce 0 add / 1 max / 2 min.
extern "C" int repro_semiring(const void* desc, const void* p0,
                              const void* p1, const void* p2, void* out,
                              int combine, int reduce, void* stream) {
  const Desc d = *static_cast<const Desc*>(desc);
  if (d.n_in < 1 || d.n_in > MAX_IN || d.n_red < 0 || d.n_red > MAX_RED ||
      (d.mode == MODE_TILE && (d.n_in != 2 || d.n_red != 1)) ||
      (d.mode == MODE_WARP && d.n_red != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < MAX_OUT; ++i)
    if (d.out_ext[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define K9_CASE(C, R)                                 \
  if (combine == C && reduce == R)                    \
    err = launch<C, R>(d, p0, p1, p2, out, st);
  K9_CASE(0, 0) K9_CASE(0, 1) K9_CASE(0, 2)
  K9_CASE(1, 0) K9_CASE(1, 1) K9_CASE(1, 2)
#undef K9_CASE
  return static_cast<int>(err);
}
