// K6, the Mamba-2 SSD chunked scan with the optional export of the state
// entering each chunk, and K7, its reverse scan (the backward of K6).  The
// two share one source so that K7 replays each chunk's decays with the
// very code (and so the same bits) that K6 ran.
//
// K6:  C, B (b, S, n), X (b, S, h, 64), dA (b, S, h), H0 (b, h, 64, n)
//      ->  y (b, S, h, 64), h_final (b, h, 64, n), [h_in (b, S / q, h, 64, n)]
// K7:  C, B, dY (b, S, h, 64), X, dA, Hin (b, S / q, h, 64, n) (K6's export),
//      dHf (b, h, 64, n)
//      ->  dX (b, S, h, 64), dh0 (b, h, 64, n), dB, dC (b, S, n),
//          ddA (b, S, h)
// All f32.  S is a multiple of the chunk q; q <= 256 at run time, any
// integer.
//
// Per chunk of q tokens and per head, with csh the in-chunk cumulative sum
// of dA, ind = exp(csh) and dec = exp(total - csh):
//   L[i, j] = exp(csh[i] - csh[j]) for j <= i, else 0,   P = (C B') . L
//   y[i]    = sum_j P[i, j] X[j] + ind[i] (C[i] . h)
//   h'      = exp(total) h + sum_j B[j] dec[j] X[j]
// and K7, per chunk (last to first), carrying the state cotangent dh
// (seeded from dHf, flushed as dh0), replays the chunk from its saved
// entering state Hc and chains every cotangent in the reference's terms:
//   dtotal = exp(total) sum(dh . Hc) + sum_j ddec[j] dec[j]
//   dXd = B dh',  dX = dXd dec + P' dY,  ddec[j] = dXd[j] . X[j]
//   dB = (dec X) dh' + dG' C,   dC = (ind dY) Hc + dG B,   dG = dP . L
//   dP = dY X',   dseg = tril(dP . G . L),
//   dcsh = -ddec dec + (dY . (C Hc')) ind + rowsum(dseg) - colsum(dseg)
//          (+ dtotal at q - 1),   ddA = reverse cumsum of dcsh,
//   dh <- exp(total) dh + C' (ind dY)
//
// Replaces: src/repro/kernels/emit.py, _ssd_kind (the `ssd` recurrence kind
// that ops.scan_ssd reaches through _ssd_executor, and with n_so == 2 the
// ssd_chk_form of _ssd_chk_executor: the h_in export, emit.py:429-430) and
// _ssd_backward_kind (the `ssd_backward` kind of ops._ssd_bwd_executor).
// On the TPU one grid cell holds the whole (h, p, n) state (1.5 MB at
// mamba2-780m's 48 x 64 x 128) in VMEM and the (h, q, q) decay and score
// blocks as values; neither fits a block's 227 KB here.  The reference
// streams K7's chunks in reverse by flipping five operands and four outputs
// in ops._ssd_kernel_bwd; here the block walks the chunk index backwards
// itself and reads and writes every tensor in forward order.
//
// What bounds them on an H100: f32 arithmetic.  Per (chunk, head) K6 does
// 2 q^2 p (P.X) + 4 q p n (readout, state update) flops, plus 2 q^2 n
// (scores) per chunk for all heads, about 17 MFLOP per head at q = 256,
// against 2 q p f32 in and out per head (B, C are shared): over 60 flops
// per byte, far above the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).  K7
// does about twice K6's flops per chunk beyond the replayed forward.  The
// products are f32 by the reference's contract, so they run on the FMA
// units, not the tensor cores.
//
// Design: one 256-thread block per (batch row, head) streams the chunks,
// the head's 64 x n state (K7: dh and Hc) in shared memory (32 KB each at
// n = 128), the chunk's rows tiled by 64.  Scores are 64 x 64 tiles in
// registers (4 x 4 per thread), weighted by L rebuilt from csh on the fly;
// tiles above the diagonal are skipped and entries with j > i are exact
// zeros, as the reference's exp(MASK_NEG_INF) is.  The scores C.B' are
// shared by all heads (one group); each block recomputes them for its head
// rather than reading them from a pass that computes them once per chunk:
// that keeps one kernel with no cross-block dependency at the cost of
// twice the P.X products.  dA's cumulative sum (and K7's reverse one of
// ddA) runs in order, by one thread, as torch.cumsum does.
//
// K6: for each row tile i and each column tile j <= i the block stages P
// in shared memory and accumulates P.X_j; the state update rides on the
// last row tile, whose column loop visits every B_j, X_j; the readout C.h
// uses the state before the update.  The export writes the state at the
// top of each chunk and touches nothing else, so y and h_final are the
// same bits with it on or off.
//
// K7: the outer loop walks the column tiles j: it holds dX_j and dB_j in
// registers while the inner loop walks the row tiles i >= j, rebuilding
// the scores, L, P, dP, dG and dseg of the (i, j) tile; dC_i gathers in
// this head's partial in device memory (each entry owned by one thread, so
// plain read-add-writes in a fixed order).  A last loop over the row tiles
// adds the terms of the entering state (the readout's cotangents and dh's
// update).  dB and dC sum over every head in the reference; here each
// block writes its head's partial and sum_heads sums the partials over the
// heads in order: no float atomics, so a rerun is the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int P = 64;          // head_dim
constexpr int NMAX = 128;      // widest state
constexpr int QMAX = 256;      // longest chunk
constexpr int T = 64;          // rows of a tile
constexpr int TS = T + 1;      // padded stride of a shared tile

// rows [r0, r0 + T) of a (., n) operand of this batch row, transposed into
// dst[k * TS + r]; rows at or past `rows` read as 0
__device__ __forceinline__ void load_rows_t(float* dst, const float* src,
                                            int r0, int rows, int n) {
  for (int e = threadIdx.x; e < T * n; e += THREADS) {
    const int r = e / n, k = e - r * n;
    dst[k * TS + r] = r0 + r < rows ? src[(size_t)(r0 + r) * n + k] : 0.f;
  }
}

// rows [r0, r0 + T) of this head's (., 64) slice of X into dst[r * TS + p]
__device__ __forceinline__ void load_head_rows(float* dst, const float* src,
                                               int r0, int rows, int H) {
  for (int e = threadIdx.x; e < T * P; e += THREADS) {
    const int r = e >> 6, p = e & 63;
    dst[r * TS + p] =
        r0 + r < rows ? src[(size_t)(r0 + r) * H * P + p] : 0.f;
  }
}

// a (p, n) state of device memory into dst[k * TS + p], and back
__device__ __forceinline__ void load_state(float* dst, const float* src,
                                           int n) {
  for (int e = threadIdx.x; e < P * n; e += THREADS) {
    const int p = e / n, k = e - p * n;
    dst[k * TS + p] = src[e];
  }
}

__device__ __forceinline__ void store_state(float* dst, const float* src,
                                            int n) {
  for (int e = threadIdx.x; e < P * n; e += THREADS) {
    const int p = e / n, k = e - p * n;
    dst[e] = src[k * TS + p];
  }
}

// csh, ind = exp(csh) and dec = exp(total - csh) of one chunk, (QMAX) each
// in shared memory; positions past q hold csh = total and zero weights.
// Returns exp(total).
__device__ float chunk_decays(float* csh, float* ind, float* dec,
                              const float* dA, int H, int q) {
  for (int i = threadIdx.x; i < q; i += THREADS) csh[i] = dA[(size_t)i * H];
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += csh[i];
      csh[i] = run;
    }
  }
  __syncthreads();
  const float total = csh[q - 1];
  for (int i = threadIdx.x; i < QMAX; i += THREADS) {
    if (i < q) {
      ind[i] = expf(csh[i]);
      dec[i] = expf(total - csh[i]);
    } else {
      csh[i] = total;
      ind[i] = 0.f;
      dec[i] = 0.f;
    }
  }
  __syncthreads();
  return expf(total);
}

// ---------------------------------------------------------------------------
// K6: the forward scan
// ---------------------------------------------------------------------------

struct ScanSmem {
  float* hs;    // (NMAX, TS): the state, [k][p]
  float* Cs;    // (NMAX, TS): C rows of the row tile, [k][i]
  float* Bs;    // (NMAX, TS): B rows of the column tile, [k][j]
  float* Xs;    // (T, TS): X rows of the column tile, [j][p]
  float* Ps;    // (T, TS): the weighted scores, [i][j]
  float* csh;   // (QMAX): cumulative log decay
  float* ind;   // (QMAX): exp(csh)
  float* dec;   // (QMAX): exp(total - csh)
};

constexpr int SCAN_SMEM_FLOATS = 3 * NMAX * TS + 2 * T * TS + 3 * QMAX;

__device__ __forceinline__ ScanSmem carve_scan(float* base) {
  ScanSmem s;
  s.hs = base;
  s.Cs = s.hs + NMAX * TS;
  s.Bs = s.Cs + NMAX * TS;
  s.Xs = s.Bs + NMAX * TS;
  s.Ps = s.Xs + T * TS;
  s.csh = s.Ps + T * TS;
  s.ind = s.csh + QMAX;
  s.dec = s.ind + QMAX;
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan(const float* __restrict__ C, const float* __restrict__ B,
         const float* __restrict__ X, const float* __restrict__ dA,
         const float* __restrict__ H0, float* __restrict__ y,
         float* __restrict__ hf, float* __restrict__ h_in, int S, int H,
         int n, int q) {
  extern __shared__ float smem_f[];
  const ScanSmem s = carve_scan(smem_f);
  const int hh = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nc = S / q, nt = (q + T - 1) / T;
  const size_t hoff = ((size_t)bi * H + hh) * P * n;

  load_state(s.hs, H0 + hoff, n);
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const size_t t0 = (size_t)bi * S + (size_t)c * q;   // first row
    if (h_in != nullptr)
      store_state(h_in + (((size_t)bi * nc + c) * H + hh) * P * n, s.hs, n);
    const float etot =
        chunk_decays(s.csh, s.ind, s.dec, dA + t0 * H + hh, H, q);
    const float* Cc = C + t0 * n;
    const float* Bc = B + t0 * n;
    const float* Xc = X + t0 * H * P + (size_t)hh * P;

    float sacc[4][8];            // state update, (p = ty + 16a, k = tx + 16b)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) sacc[a][b] = 0.f;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      const bool last = it == nt - 1;
      load_rows_t(s.Cs, Cc, i0, q, n);
      float acc[4][4];           // P.X, (i = ty + 16a, p = tx + 16c)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        load_rows_t(s.Bs, Bc, j0, q, n);
        load_head_rows(s.Xs, Xc, j0, q, H);
        __syncthreads();
        float g[4][4];           // scores, (i = ty + 16a, j = tx + 16b)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = s.Cs[k * TS + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = s.Bs[k * TS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) g[a][b] = fmaf(cv[a], bv[b], g[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            const float L =
                (j <= i && i < q) ? expf(s.csh[i] - s.csh[j]) : 0.f;
            s.Ps[(ty + 16 * a) * TS + tx + 16 * b] = __fmul_rn(g[a][b], L);
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < T; ++jj) {
          float pv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pv[a] = s.Ps[(ty + 16 * a) * TS + jj];
#pragma unroll
          for (int b = 0; b < 4; ++b) xv[b] = s.Xs[jj * TS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(pv[a], xv[b], acc[a][b]);
        }
        if (last) {              // B_j' (decay . X_j) into the new state
#pragma unroll 2
          for (int jj = 0; jj < T; ++jj) {
            const float d = s.dec[j0 + jj];
            float xd[4], bv[8];
#pragma unroll
            for (int a = 0; a < 4; ++a)
              xd[a] = __fmul_rn(s.Xs[jj * TS + ty + 16 * a], d);
#pragma unroll
            for (int b = 0; b < 8; ++b)
              bv[b] = s.Bs[(tx + 16 * b) * TS + jj];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 8; ++b)
                sacc[a][b] = fmaf(bv[b], xd[a], sacc[a][b]);
          }
        }
        __syncthreads();
      }

      // the readout of the entering state, C_i . h, then y
      float toff[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) toff[a][b] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = s.Cs[k * TS + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) hv[b] = s.hs[k * TS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            toff[a][b] = fmaf(cv[a], hv[b], toff[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= q) continue;
        float* yrow = y + (t0 + i) * H * P + (size_t)hh * P;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          yrow[tx + 16 * b] =
              __fadd_rn(acc[a][b], __fmul_rn(toff[a][b], s.ind[i]));
      }
      __syncthreads();
    }

    // h' = exp(total) h + B' (decay . X), each entry by its owner
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int k = tx + 16 * b;
        if (k < n) {
          float* hp = s.hs + k * TS + ty + 16 * a;
          *hp = __fadd_rn(__fmul_rn(etot, *hp), sacc[a][b]);
        }
      }
    __syncthreads();
  }

  store_state(hf + hoff, s.hs, n);
}

// ---------------------------------------------------------------------------
// K7: the reverse scan
// ---------------------------------------------------------------------------

struct BwdSmem {
  float* dhs;   // (NMAX, TS): the carried state cotangent, [k][p]
  float* hcs;   // (NMAX, TS): the chunk's entering state, [k][p]
  float* Cs;    // (NMAX, TS): C rows of a row tile, [k][i]
  float* Bs;    // (NMAX, TS): B rows of a column tile, [k][j]
  float* Xs;    // (T, TS): X rows of the column tile, [j][p]
  float* dYs;   // (T, TS): dY rows of the row tile, [i][p]
  float* Ps;    // (T, TS): P of the (i, j) tile, [i][j]
  float* dGs;   // (T, TS): dG of the tile
  float* dSs;   // (T, TS): dseg of the tile
  float* csh;   // (QMAX): cumulative log decay, later ddA
  float* ind;   // (QMAX): exp(csh)
  float* dec;   // (QMAX): exp(total - csh)
  float* rowacc;  // (QMAX): rowsum(dseg) + din_decay ind
  float* colacc;  // (QMAX): colsum(dseg)
  float* ddd;     // (QMAX): ddec dec
  float* red;     // (32): block reduction
};

constexpr int BWD_SMEM_FLOATS = 4 * NMAX * TS + 5 * T * TS + 6 * QMAX + 32;

__device__ __forceinline__ BwdSmem carve_bwd(float* base) {
  BwdSmem s;
  s.dhs = base;
  s.hcs = s.dhs + NMAX * TS;
  s.Cs = s.hcs + NMAX * TS;
  s.Bs = s.Cs + NMAX * TS;
  s.Xs = s.Bs + NMAX * TS;
  s.dYs = s.Xs + T * TS;
  s.Ps = s.dYs + T * TS;
  s.dGs = s.Ps + T * TS;
  s.dSs = s.dGs + T * TS;
  s.csh = s.dSs + T * TS;
  s.ind = s.csh + QMAX;
  s.dec = s.ind + QMAX;
  s.rowacc = s.dec + QMAX;
  s.colacc = s.rowacc + QMAX;
  s.ddd = s.colacc + QMAX;
  s.red = s.ddd + QMAX;
  return s;
}

// the sum over the 16 lanes of a half-warp that share one ty
__device__ __forceinline__ float row16_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd(const float* __restrict__ C, const float* __restrict__ B,
        const float* __restrict__ dY, const float* __restrict__ X,
        const float* __restrict__ dA, const float* __restrict__ Hin,
        const float* __restrict__ dHf, float* __restrict__ dX,
        float* __restrict__ dh0, float* __restrict__ ddA,
        float* __restrict__ dBp, float* __restrict__ dCp, int S, int H,
        int n, int q) {
  extern __shared__ float smem_f[];
  const BwdSmem s = carve_bwd(smem_f);
  const int hh = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nc = S / q, nt = (q + T - 1) / T;
  const size_t hoff = ((size_t)bi * H + hh) * P * n;
  // this head's (S, n) partials of dB and dC
  float* dBh = dBp + ((size_t)bi * H + hh) * S * n;
  float* dCh = dCp + ((size_t)bi * H + hh) * S * n;

  load_state(s.dhs, dHf + hoff, n);

  for (int c = nc - 1; c >= 0; --c) {
    const size_t t0 = (size_t)bi * S + (size_t)c * q;   // first row
    for (int i = tid; i < QMAX; i += THREADS)
      s.rowacc[i] = s.colacc[i] = s.ddd[i] = 0.f;
    const float etot =
        chunk_decays(s.csh, s.ind, s.dec, dA + t0 * H + hh, H, q);
    load_state(s.hcs, Hin + (((size_t)bi * nc + c) * H + hh) * P * n, n);
    const float* Cc = C + t0 * n;
    const float* Bc = B + t0 * n;
    const float* Xc = X + t0 * H * P + (size_t)hh * P;
    const float* dYc = dY + t0 * H * P + (size_t)hh * P;
    float* dXc = dX + t0 * H * P + (size_t)hh * P;
    float* dBc = dBh + (size_t)c * q * n;
    float* dCc = dCh + (size_t)c * q * n;
    __syncthreads();

    // exp(total) sum(dh . Hc), the state's share of dtotal
    {
      float part = 0.f;
      for (int e = tid; e < P * n; e += THREADS) {
        const int k = e >> 6, p = e & 63;
        part = fmaf(s.dhs[k * TS + p], s.hcs[k * TS + p], part);
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if ((tid & 31) == 0) s.red[tid >> 5] = part;
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) sum += s.red[w];
        s.red[THREADS / 32] = __fmul_rn(sum, etot);
      }
    }

    // column tiles j: dX_j, dB_j in registers; dC_i in the partial
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T;
      load_rows_t(s.Bs, Bc, j0, q, n);
      load_head_rows(s.Xs, Xc, j0, q, H);
      __syncthreads();
      float dxa[4][4];           // (j = ty + 16a, p = tx + 16c)
      float dba[4][8];           // (j = ty + 16a, k = tx + 16b)
      {
        float dxd[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) dxd[a][b] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float bv[4], dv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) bv[a] = s.Bs[k * TS + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) dv[b] = s.dhs[k * TS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              dxd[a][b] = fmaf(bv[a], dv[b], dxd[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int jl = ty + 16 * a, j = j0 + jl;
          const float d = s.dec[j];
          float part = 0.f;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            part = fmaf(dxd[a][b], s.Xs[jl * TS + tx + 16 * b], part);
            dxa[a][b] = __fmul_rn(dxd[a][b], d);
          }
          part = row16_sum(part);
          if (tx == 0 && j < q) s.ddd[j] = __fmul_rn(part, d);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) dba[a][b] = 0.f;
#pragma unroll 2
      for (int pp = 0; pp < P; ++pp) {
        float xd[4], dv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          xd[a] = __fmul_rn(s.Xs[(ty + 16 * a) * TS + pp],
                            s.dec[j0 + ty + 16 * a]);
#pragma unroll
        for (int b = 0; b < 8; ++b) dv[b] = s.dhs[(tx + 16 * b) * TS + pp];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) dba[a][b] = fmaf(dv[b], xd[a], dba[a][b]);
      }

      for (int it = jt; it < nt; ++it) {
        const int i0 = it * T;
        load_rows_t(s.Cs, Cc, i0, q, n);
        load_head_rows(s.dYs, dYc, i0, q, H);
        __syncthreads();
        {
          float g[4][4], dp[4][4];   // (i = ty + 16a, j = tx + 16b)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) g[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            float cv[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) cv[a] = s.Cs[k * TS + ty + 16 * a];
#pragma unroll
            for (int b = 0; b < 4; ++b) bv[b] = s.Bs[k * TS + tx + 16 * b];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                g[a][b] = fmaf(cv[a], bv[b], g[a][b]);
          }
#pragma unroll 4
          for (int pp = 0; pp < P; ++pp) {
            float yv[4], xv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
              yv[a] = s.dYs[(ty + 16 * a) * TS + pp];
#pragma unroll
            for (int b = 0; b < 4; ++b)
              xv[b] = s.Xs[(tx + 16 * b) * TS + pp];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                dp[a][b] = fmaf(yv[a], xv[b], dp[a][b]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty + 16 * a;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int j = j0 + tx + 16 * b;
              const bool on = j <= i && i < q;
              const float L = on ? expf(s.csh[i] - s.csh[j]) : 0.f;
              const int o = (ty + 16 * a) * TS + tx + 16 * b;
              s.Ps[o] = __fmul_rn(g[a][b], L);
              s.dGs[o] = __fmul_rn(dp[a][b], L);
              s.dSs[o] = on ? __fmul_rn(__fmul_rn(dp[a][b], g[a][b]), L)
                            : 0.f;
            }
          }
        }
        __syncthreads();
        // dX_j += P' dY_i;  dB_j += dG' C_i
#pragma unroll 2
        for (int ii = 0; ii < T; ++ii) {
          float pv[4], gv[4], yv[4], cv[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            pv[a] = s.Ps[ii * TS + ty + 16 * a];
            gv[a] = s.dGs[ii * TS + ty + 16 * a];
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) yv[b] = s.dYs[ii * TS + tx + 16 * b];
#pragma unroll
          for (int b = 0; b < 8; ++b) cv[b] = s.Cs[(tx + 16 * b) * TS + ii];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              dxa[a][b] = fmaf(pv[a], yv[b], dxa[a][b]);
#pragma unroll
            for (int b = 0; b < 8; ++b)
              dba[a][b] = fmaf(gv[a], cv[b], dba[a][b]);
          }
        }
        // dC_i (+)= dG B_j, into this head's partial
        {
          float dca[4][8];         // (i = ty + 16a, k = tx + 16b)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) dca[a][b] = 0.f;
#pragma unroll 2
          for (int jj = 0; jj < T; ++jj) {
            float gv[4], bv[8];
#pragma unroll
            for (int a = 0; a < 4; ++a) gv[a] = s.dGs[(ty + 16 * a) * TS + jj];
#pragma unroll
            for (int b = 0; b < 8; ++b) bv[b] = s.Bs[(tx + 16 * b) * TS + jj];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 8; ++b)
                dca[a][b] = fmaf(gv[a], bv[b], dca[a][b]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty + 16 * a;
            if (i >= q) continue;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              const int k = tx + 16 * b;
              if (k >= n) continue;
              float* o = dCc + (size_t)i * n + k;
              *o = jt == 0 ? dca[a][b] : __fadd_rn(*o, dca[a][b]);
            }
          }
        }
        // rowsum(dseg) for the tile's rows, colsum for its columns
        if (tid < T) {
          float r = 0.f;
          for (int jj = 0; jj < T; ++jj) r += s.dSs[tid * TS + jj];
          s.rowacc[i0 + tid] += r;
        } else if (tid < 2 * T) {
          const int jl = tid - T;
          float r = 0.f;
          for (int ii = 0; ii < T; ++ii) r += s.dSs[ii * TS + jl];
          s.colacc[j0 + jl] += r;
        }
        __syncthreads();
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
        if (j >= q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          dXc[(size_t)j * H * P + tx + 16 * b] = dxa[a][b];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int k = tx + 16 * b;
          if (k < n) dBc[(size_t)j * n + k] = dba[a][b];
        }
      }
    }

    // the entering state's terms: dC_i += (ind dY_i) Hc, the readout's
    // share of dcsh, and dh' = exp(total) dh + C' (ind dY)
    float dha[4][8];             // (p = ty + 16a, k = tx + 16b)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) dha[a][b] = 0.f;
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      load_rows_t(s.Cs, Cc, i0, q, n);
      load_head_rows(s.dYs, dYc, i0, q, H);
      __syncthreads();
      {
        float toff[4][4];        // C_i Hc', (i = ty + 16a, p = tx + 16c)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) toff[a][b] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[4], hv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = s.Cs[k * TS + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) hv[b] = s.hcs[k * TS + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              toff[a][b] = fmaf(cv[a], hv[b], toff[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int il = ty + 16 * a, i = i0 + il;
          float part = 0.f;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float* yp = s.dYs + il * TS + tx + 16 * b;
            part = fmaf(*yp, toff[a][b], part);
            *yp = __fmul_rn(*yp, s.ind[i]);        // dt_off, in place
          }
          part = row16_sum(part);
          if (tx == 0 && i < q)
            s.rowacc[i] = __fadd_rn(s.rowacc[i], __fmul_rn(part, s.ind[i]));
        }
      }
      __syncthreads();
      {
        float dca[4][8];         // (i = ty + 16a, k = tx + 16b)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) dca[a][b] = 0.f;
#pragma unroll 2
        for (int pp = 0; pp < P; ++pp) {
          float yv[4], hv[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) yv[a] = s.dYs[(ty + 16 * a) * TS + pp];
#pragma unroll
          for (int b = 0; b < 8; ++b) hv[b] = s.hcs[(tx + 16 * b) * TS + pp];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b)
              dca[a][b] = fmaf(yv[a], hv[b], dca[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          if (i >= q) continue;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int k = tx + 16 * b;
            if (k >= n) continue;
            float* o = dCc + (size_t)i * n + k;
            *o = __fadd_rn(*o, dca[a][b]);
          }
        }
      }
#pragma unroll 2
      for (int ii = 0; ii < T; ++ii) {
        float yv[4], cv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = s.dYs[ii * TS + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 8; ++b) cv[b] = s.Cs[(tx + 16 * b) * TS + ii];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) dha[a][b] = fmaf(cv[b], yv[a], dha[a][b]);
      }
      __syncthreads();
    }

    // dh <- exp(total) dh + C' dt_off, each entry by its owner
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int k = tx + 16 * b;
        if (k < n) {
          float* d = s.dhs + k * TS + ty + 16 * a;
          *d = __fadd_rn(__fmul_rn(etot, *d), dha[a][b]);
        }
      }

    // dcsh and its reverse cumulative sum, in order, by one thread
    if (tid == 0) {
      float dtotal = s.red[THREADS / 32];
      for (int j = 0; j < q; ++j) dtotal += s.ddd[j];
      float run = 0.f;
      for (int k = q - 1; k >= 0; --k) {
        float d = __fadd_rn(-s.ddd[k], s.rowacc[k]);
        d = __fadd_rn(d, -s.colacc[k]);
        if (k == q - 1) d = __fadd_rn(d, dtotal);
        run += d;
        s.csh[k] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < q; i += THREADS) ddA[(t0 + i) * H + hh] = s.csh[i];
    __syncthreads();
  }

  store_state(dh0 + hoff, s.dhs, n);
}

// dB[b, t, k] = sum over heads, in order, of the per-head partials; the
// same for dC
__global__ void __launch_bounds__(THREADS)
sum_heads(const float* __restrict__ dBp, const float* __restrict__ dCp,
          float* __restrict__ dB, float* __restrict__ dC, int batch, int S,
          int H, int n) {
  const size_t per = (size_t)S * n;
  const size_t total = (size_t)batch * per;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (size_t)gridDim.x * THREADS) {
    const size_t bi = e / per, r = e - bi * per;
    const float* pb = dBp + bi * H * per + r;
    const float* pc = dCp + bi * H * per + r;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      sb += pb[hh * per];
      sc += pc[hh * per];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h_in may be null (no export); head_dim 64, n <= 128, 1 <= q <= 256 and
// S a multiple of q.
extern "C" int repro_ssd_scan(const void* C, const void* B, const void* X,
                              const void* dA, const void* H0, void* y,
                              void* h_final, void* h_in, int batch, int S,
                              int H, int p, int n, int q, void* stream) {
  if (p != P || n < 1 || n > NMAX || q < 1 || q > QMAX || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = SCAN_SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan<<<dim3(H, batch), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(X), static_cast<const float*>(dA),
      static_cast<const float*>(H0), static_cast<float*>(y),
      static_cast<float*>(h_final), static_cast<float*>(h_in), S, H, n, q);
  return static_cast<int>(cudaGetLastError());
}

// dB_part, dC_part: (b, h, S, n) scratch for the per-head partials; head_dim
// 64, n <= 128, 1 <= q <= 256 and S a multiple of q.
extern "C" int repro_ssd_bwd(const void* C, const void* B, const void* dY,
                             const void* X, const void* dA, const void* Hin,
                             const void* dHf, void* dX, void* dh0, void* dB,
                             void* dC, void* ddA, void* dB_part,
                             void* dC_part, int batch, int S, int H, int p,
                             int n, int q, void* stream) {
  if (p != P || n < 1 || n > NMAX || q < 1 || q > QMAX || S % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = BWD_SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd<<<dim3(H, batch), THREADS, smem, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(dY), static_cast<const float*>(X),
      static_cast<const float*>(dA), static_cast<const float*>(Hin),
      static_cast<const float*>(dHf), static_cast<float*>(dX),
      static_cast<float*>(dh0), static_cast<float*>(ddA),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), S, H, n, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)batch * S * n;
  const int blocks = static_cast<int>(
      total / THREADS + 1 < 4096 ? total / THREADS + 1 : 4096);
  sum_heads<<<blocks, THREADS, 0, st>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<float*>(dB), static_cast<float*>(dC), batch, S, H, n);
  return static_cast<int>(cudaGetLastError());
}
