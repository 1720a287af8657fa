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
// sequential in t and independent across (batch row, channel); a thread a
// channel walking all of S fills only B * w / 32 warps, too few loads in
// flight to stream at that rate.
//
// Design: chunk-parallel, as the TPU kernel's chunks (a scan inside the
// chunk, a re-base onto the carried state), in one pass.  A block owns a
// strip of STRIP channels (a thread each) over a chunk of L steps (1 <= L
// <= 1024: ops.default_gated_chunk derives L from the H100 table, 16 at
// recurrentgemma-9b's width), so the grid is batch x strips x chunks:
// 16384 blocks at B=1, S=4096, w=4096, L=16.  Each block
//   1. takes a ticket (an atomic counter): tickets run over the chunks in
//      walk order, so every chunk that a block waits for below has started;
//   2. stages its chunk's log_a and b tile in shared memory, PIECE steps
//      at a time (cp.async, 16-byte copies when w % 4 == 0 and the bases
//      are aligned, which the host decides), the gate rows one step ahead
//      in reverse;
//   3. walks its L steps from h = 0 to the chunk's aggregate (A_c, the
//      product of its gates; H_c, its last h), keeping a = exp(log_a) in
//      place of log_a when the chunk is one piece, and publishes (A_c, H_c)
//      behind a release flag;
//   4. forms its entering state h_in[c] = A_{c-1} h_in[c-1] + H_{c-1}, the
//      fold from h0 over every earlier chunk in chunk order: it starts from
//      the fold at the end of the previous group of GROUP chunks (published
//      by that group's last block) and folds its own group's earlier
//      aggregates onto it.  Every step of every fold is the same multiply
//      and add on the same values, so the state a block folds to is the
//      same bits whichever block computes it and whenever it runs: two runs
//      give the same bits, and no block reads more than GROUP aggregates;
//   5. re-walks its chunk (the staged tile, or each piece staged again and
//      its gates taken by the same expf) from h_in[c] with the plain walk's
//      own step (multiply and add rounded separately, no fused
//      multiply-add) and writes h once; the block holding the walk's last
//      step writes h_final from the same register, so h_final equals h's
//      last step bit for bit.
// The flags and the ticket live in a workspace that the host allocates and
// this entry clears on the stream (a memset node under graph capture).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 64;        // channels a block, one thread each
constexpr int PIECE = 64;        // steps staged at once (32 KB of tile)
constexpr int MAX_CHUNK = 1024;  // longest chunk
constexpr int GROUP = 8;       // chunks between published folds

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void set_flag(int* f) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(1)
               : "memory");
}

__device__ __forceinline__ void wait_flag(const int* f) {
  int v;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(f)
                 : "memory");
    if (v) return;
    __nanosleep(32);
  }
}

// one step of the walk: the plain version's `a * h + b`, rounded twice
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// The workspace: a ticket, then per (batch row, strip) a flag for each
// chunk's aggregate and for the fold at each chunk's end, then the
// aggregates (A, H) and the folds, each (batch, chunks, w) in walk order.
struct Work {
  int* ticket;
  int* agg_flag;
  int* fold_flag;
  float2* agg;
  float* fold;
};

__host__ __device__ __forceinline__ long long flag_ints(int batch, int W,
                                                        int C) {
  const long long n = 4 + 2LL * batch * ((W + STRIP - 1) / STRIP) * C;
  return (n + 3) / 4 * 4;   // the float region starts 16-byte aligned
}

__host__ __device__ __forceinline__ Work carve(void* ws, int batch, int W,
                                               int C) {
  Work k;
  int* base = static_cast<int*>(ws);
  const long long nf = (long long)batch * ((W + STRIP - 1) / STRIP) * C;
  k.ticket = base;
  k.agg_flag = base + 4;
  k.fold_flag = k.agg_flag + nf;
  k.agg = reinterpret_cast<float2*>(base + flag_ints(batch, W, C));
  k.fold = reinterpret_cast<float*>(k.agg + (long long)batch * C * W);
  return k;
}

template <bool REVERSE>
__global__ void __launch_bounds__(STRIP)
gated_chunk_scan(const float* __restrict__ log_a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_final, Work work, int batch, int S,
                 int W, int L, int C, int vec) {
  extern __shared__ __align__(16) float tile[];   // a: (piece, STRIP), b: after
  float* a_s = tile;
  float* b_s = tile + (L < PIECE ? L : PIECE) * STRIP;
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(work.ticket, 1);
  __syncthreads();

  // ticket -> (walk-order chunk k, batch row, strip), chunks slowest
  const int strips = (W + STRIP - 1) / STRIP;
  const int per_k = batch * strips;
  const int k = s_ticket / per_k;
  const int bi = (s_ticket - k * per_k) / strips;
  const int strip = s_ticket - k * per_k - bi * strips;
  const int chunk = REVERSE ? C - 1 - k : k;
  const int t0 = chunk * L;
  const int n = min(L, S - t0);
  const int c0 = strip * STRIP;
  const int cols = min(STRIP, W - c0);
  const int c = c0 + tid;
  const bool live = tid < cols;
  const size_t base = (size_t)bi * S * W + c0;

  // stage the chunk's rows, PIECE at a time: rows [r0, r0 + np) of b
  // (times t0 + r0 + i) and of log_a (the gate's times, one ahead in
  // reverse; past S a zero log, a gate of 1); channels past w are
  // zero-filled and never stored
  const int gate = REVERSE ? 1 : 0;
  auto stage = [&](int r0, int np) {
    if (vec) {
      constexpr int V = STRIP / 4;
      for (int e = tid; e < 2 * np * V; e += STRIP) {
        const int r = e / V, j = (e - r * V) * 4;
        const bool is_b = r >= np;
        const int i = is_b ? r - np : r;
        const int t = t0 + r0 + i + (is_b ? 0 : gate);
        const bool ok = t < S && j < cols;
        const float* src = (is_b ? b : log_a) + base + (size_t)t * W + j;
        cp16((is_b ? b_s : a_s) + i * STRIP + j, ok ? src : log_a, ok);
      }
    } else {
      for (int e = tid; e < 2 * np * STRIP; e += STRIP) {
        const int r = e / STRIP, j = e - r * STRIP;
        const bool is_b = r >= np;
        const int i = is_b ? r - np : r;
        const int t = t0 + r0 + i + (is_b ? 0 : gate);
        const bool ok = t < S && j < cols;
        const float* src = (is_b ? b : log_a) + base + (size_t)t * W + j;
        cp4((is_b ? b_s : a_s) + i * STRIP + j, ok ? src : log_a, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };
  // the pieces in walk order (each walked backwards in reverse); a chunk
  // of one piece is staged once and its gates kept as exp(log_a) for the
  // re-walk, a longer one is staged again piece by piece for the re-walk
  const int pieces = (n + PIECE - 1) / PIECE;
  const bool once = pieces == 1;
  auto piece = [&](int q, int& r0, int& np) {
    const int p = REVERSE ? pieces - 1 - q : q;
    r0 = p * PIECE;
    np = min(PIECE, n - r0);
  };

  // the chunk's aggregate, walking from h = 0 (each thread reads and
  // rewrites only its own column, so no barrier until the publish)
  float A = 1.f, H = 0.f;
  for (int q = 0; q < pieces; ++q) {
    int r0, np;
    piece(q, r0, np);
    if (!once) __syncthreads();   // every thread is done with the piece
    stage(r0, np);
#pragma unroll 8
    for (int s = 0; s < np; ++s) {
      const int i = (REVERSE ? np - 1 - s : s) * STRIP + tid;
      const float a = expf(a_s[i]);
      if (once) a_s[i] = a;
      A = __fmul_rn(A, a);
      H = step(a, H, b_s[i]);
    }
  }
  const long long row = (long long)bi * C;    // (batch row, chunk) rows
  const int flags = (bi * strips + strip) * C;
  if (live) __stcg(work.agg + (row + k) * W + c, make_float2(A, H));
  __syncthreads();
  if (tid == 0) set_flag(work.agg_flag + flags + k);

  // the entering state: the fold published at the previous group's end
  // (h0 or 0 in the first group), then this group's earlier aggregates
  const int g0 = k / GROUP * GROUP;
  if (tid == 0) {
    if (g0 > 0) wait_flag(work.fold_flag + flags + g0 - 1);
    for (int j = g0; j < k; ++j) wait_flag(work.agg_flag + flags + j);
  }
  __syncthreads();
  float hin = 0.f;
  if (live) {
    if (g0 > 0)
      hin = __ldcg(work.fold + (row + g0 - 1) * W + c);
    else if (h0 != nullptr)
      hin = h0[(size_t)bi * W + c];
    float2 g[GROUP - 1];
#pragma unroll
    for (int j = 0; j < GROUP - 1; ++j)
      if (g0 + j < k) g[j] = __ldcg(work.agg + (row + g0 + j) * W + c);
#pragma unroll
    for (int j = 0; j < GROUP - 1; ++j)
      if (g0 + j < k) hin = step(g[j].x, hin, g[j].y);
  }
  // a group's last chunk publishes the fold at its end for the next group
  if (k % GROUP == GROUP - 1 && k + 1 < C) {
    if (live) __stcg(work.fold + (row + k) * W + c, step(A, hin, H));
    __syncthreads();
    if (tid == 0) set_flag(work.fold_flag + flags + k);
  }

  // the re-walk from the entering state (the same gates, exp(log_a) of the
  // same staged values): h written once
  float hh = hin;
  float* out = h + base + (size_t)t0 * W + tid;
  for (int q = 0; q < pieces; ++q) {
    int r0, np;
    piece(q, r0, np);
    if (!once) {
      __syncthreads();
      stage(r0, np);
    }
#pragma unroll 8
    for (int s = 0; s < np; ++s) {
      const int i = REVERSE ? np - 1 - s : s;
      const float a = once ? a_s[i * STRIP + tid]
                           : expf(a_s[i * STRIP + tid]);
      hh = step(a, hh, b_s[i * STRIP + tid]);
      if (live) out[(size_t)(r0 + i) * W] = hh;
    }
  }
  if (live && k == C - 1) h_final[(size_t)bi * W + c] = hh;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of the workspace a call at (batch, S, w) with chunks of L steps
// needs (0 for a shape the kernel does not take).
extern "C" long long repro_gated_workspace(int batch, int S, int W, int L) {
  if (batch < 1 || S < 1 || W < 1 || L < 1 || L > MAX_CHUNK) return 0;
  const int C = (S + L - 1) / L;
  return 4 * flag_ints(batch, W, C) + 12LL * batch * C * W;
}

// h0 may be null (a zero entering state); reverse != 0 walks backwards;
// ws holds repro_gated_workspace(batch, S, W, L) bytes, 16-byte aligned.
extern "C" int repro_gated_scan(const void* log_a, const void* b,
                                const void* h0, void* h, void* h_final,
                                void* ws, long long ws_bytes, int batch,
                                int S, int W, int L, int reverse,
                                void* stream) {
  const long long need = repro_gated_workspace(batch, S, W, L);
  if (need == 0 || ws_bytes < need || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = (S + L - 1) / L;
  const long long blocks =
      (long long)batch * ((W + STRIP - 1) / STRIP) * C;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(ws, 0, 4 * flag_ints(batch, W, C), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Work work = carve(ws, batch, W, C);
  const int vec = W % 4 == 0 && aligned16(log_a) && aligned16(b);
  const size_t smem = 2 * sizeof(float) * (L < PIECE ? L : PIECE) * STRIP;
  const float* la = static_cast<const float*>(log_a);
  const float* bp = static_cast<const float*>(b);
  const float* hp = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h);
  float* hf = static_cast<float*>(h_final);
  if (reverse)
    gated_chunk_scan<true><<<(unsigned)blocks, STRIP, smem, st>>>(
        la, bp, hp, ho, hf, work, batch, S, W, L, C, vec);
  else
    gated_chunk_scan<false><<<(unsigned)blocks, STRIP, smem, st>>>(
        la, bp, hp, ho, hf, work, batch, S, W, L, C, vec);
  return static_cast<int>(cudaGetLastError());
}
