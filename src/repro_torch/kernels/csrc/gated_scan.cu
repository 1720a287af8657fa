// K8: the RG-LRU gated linear scan, forward and reverse, one kernel.
//
//   forward:  h_t = exp(log_a_t) * h_{t-1} + b_t,       h_{-1} = h0 (or 0)
//   reverse:  h_t = exp(log_a_{t+1}) * h_{t+1} + b_t,   h_S = h0 (or 0),
//             the gate one step ahead and 1 past the end
//
//   log_a, b (batch, S, w) f32, h0 (batch, w) f32 or null
//     ->  h (batch, S, w) f32, h_final (batch, w) f32 (h at the walk's end)
//
// Replaces: src/repro/kernels/emit.py, _gated_kind (the `gated` recurrence
// kind that ops.gated_scan reaches through _gated_executor and
// emit_recurrent) and its `gated_backward` registration (emit.py:923), which
// ops._gated_kernel_bwd runs on flipped, gate-shifted copies of the operands
// to get the cotangent recurrence dbar_t = dy_t + a_{t+1} dbar_{t+1}.  Here
// the reverse flag walks t from S-1 down to 0 in forward-order memory and
// reads the gate one step ahead, so the backward needs no flipped or shifted
// copies.
//
// What bounds it on an H100: it reads log_a and b and writes h, 12 bytes an
// element and 2 flops (plus one exp), so it is bound by device-memory bytes
// (B=1, S=4096, w=4096: 201 MB, 0.060 ms at 3.35 TB/s).  The recurrence is
// sequential in t and independent across (batch row, channel).
//
// Design: one thread per (batch row, channel) walks the sequence with h in a
// register; a block is one warp of 32 neighbouring channels, so each step's
// loads and store are one coalesced 128-byte row segment, and the
// B * w / 32 blocks spread over the SMs (128 blocks at B=1, w=4096: about
// one warp an SM, so occupancy is low and the kernel is latency-bound well
// above its bytes bound).  The loads do not depend on h: each thread loads
// UNROLL steps of log_a and b into registers one group ahead of the group
// it computes (two register buffers), so a group's loads are in flight while
// the previous group's chain of multiply-adds runs.  The multiply and the add
// round separately (no fused multiply-add), the arithmetic of the plain
// version `a * h + b`.  The TPU kernel's chunk-local associative scan with a
// re-base on the carried h, which fills the machine at B=1, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
constexpr int UNROLL = 16;

// Steps [i0, i0 + UNROLL) of the walk (step i is time S-1-i in reverse):
// b at the step's time, log_a at the gate's time (the step's own forward,
// one ahead in reverse; 0, a gate of 1, past the end or past the walk).
template <bool REVERSE>
__device__ __forceinline__ void load_group(const float* __restrict__ log_a,
                                           const float* __restrict__ b,
                                           size_t base, int S, int W, int i0,
                                           float (&la)[UNROLL],
                                           float (&bb)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + u;
    const int t = REVERSE ? S - 1 - i : i;
    const int tg = REVERSE ? t + 1 : t;
    const bool in = i < S;
    bb[u] = in ? __ldg(b + base + (size_t)t * W) : 0.f;
    la[u] = (in && tg < S) ? __ldg(log_a + base + (size_t)tg * W) : 0.f;
  }
}

template <bool REVERSE>
__device__ __forceinline__ void walk_group(float* __restrict__ h, size_t base,
                                           int S, int W, int i0,
                                           const float (&la)[UNROLL],
                                           const float (&bb)[UNROLL],
                                           float& carry) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + u;
    if (i < S) {
      const int t = REVERSE ? S - 1 - i : i;
      carry = __fadd_rn(__fmul_rn(expf(la[u]), carry), bb[u]);
      h[base + (size_t)t * W] = carry;
    }
  }
}

template <bool REVERSE>
__global__ void __launch_bounds__(THREADS)
gated_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_final, int S,
                  int W) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= W) return;
  const size_t base = (size_t)bi * S * W + c;
  float carry = h0 ? h0[(size_t)bi * W + c] : 0.f;
  float la0[UNROLL], bb0[UNROLL], la1[UNROLL], bb1[UNROLL];
  load_group<REVERSE>(log_a, b, base, S, W, 0, la0, bb0);
  for (int i0 = 0; i0 < S; i0 += 2 * UNROLL) {
    load_group<REVERSE>(log_a, b, base, S, W, i0 + UNROLL, la1, bb1);
    walk_group<REVERSE>(h, base, S, W, i0, la0, bb0, carry);
    load_group<REVERSE>(log_a, b, base, S, W, i0 + 2 * UNROLL, la0, bb0);
    walk_group<REVERSE>(h, base, S, W, i0 + UNROLL, la1, bb1, carry);
  }
  h_final[(size_t)bi * W + c] = carry;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h0 may be null (a zero entering state); reverse != 0 walks backwards.
extern "C" int repro_gated_scan(const void* log_a, const void* b,
                                const void* h0, void* h, void* h_final,
                                int batch, int S, int W, int reverse,
                                void* stream) {
  if (batch < 1 || batch > 65535 || S < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + THREADS - 1) / THREADS, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bp = static_cast<const float*>(b);
  const float* hp = static_cast<const float*>(h0);
  if (reverse)
    gated_scan_kernel<true><<<grid, THREADS, 0, st>>>(
        la, bp, hp, static_cast<float*>(h), static_cast<float*>(h_final), S,
        W);
  else
    gated_scan_kernel<false><<<grid, THREADS, 0, st>>>(
        la, bp, hp, static_cast<float*>(h), static_cast<float*>(h_final), S,
        W);
  return static_cast<int>(cudaGetLastError());
}
