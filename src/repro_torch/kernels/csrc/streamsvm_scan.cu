// B1 on Hopper: one pass of Algorithm 1 for a bank of models over a shared
// stream, with a plain C interface (bound from Python with ctypes).
//
// Replaces the Algorithm-1 branch of
// src/repro/kernels/streamsvm_scan.py::_block_update (driven there by
// _kernel_many_tiled / streamsvm_scan_many_pallas).
//
// Layout. The bank axis is the parallel one: each CTA owns LANES models
// (one warp per model) and walks the whole stream in order, in internal
// blocks of BN = 32 rows (one row per thread of the warp). Nothing carries
// between CTAs. The block Gram G = X_blk X_blk^T is the same for every
// model, so a pre-pass kernel computes it once per block into global memory
// (it stays in L2) and every CTA reads its 32x32 block from there.
//
// Per block and model, as in the TPU kernel: h_k = <w, x_k>, g_k = y_k h_k;
// then, row by row, d^2 = |w|^2 - 2 g_j + G_jj + xi2 + 1/C, the update when
// d >= r (row valid, sign != 0), the rank-1 maintenance of g and the
// r / xi2 / |w|^2 / m recursions; finally the deferred
// w <- decay * w + sum_k alpha_k y_k x_k. Every thread of a warp carries the
// model's scalars and computes them identically, so the row loop needs no
// barrier: g_j and y_j reach all threads by warp shuffle.
//
// Every model's arithmetic is the same whichever CTA or warp it lands in,
// so the result does not depend on how the caller tiles the bank. All math
// is f32 on the CUDA cores (no TF32: it would flip d >= r decisions);
// bf16 stream tiles are upcast on load. The update is a branch, not a
// multiply by zero, because padded models carry r = +inf.
//
// Bound. Per row and model the work is ~4 D flops (h and the deferred
// update) plus O(BN) for g; at B = 600, D = 784 the card is bound by its
// f32 rate, but this simple kernel is held back by the dependent per-row
// chain (a shuffle, a sqrt and a divide per row) and by shared-memory
// operand traffic in the D loops. Both are left for a later change.
//
// B3, the fused Algorithm 2 (lookahead_kernel below), replaces the
// lookahead branch of the same _block_update with _bank_flush. It shares
// the Gram pre-pass and the layout: one warp per model, the h pass of each
// block staged as in B1. A violating row (Gram-form d >= r, valid, sign
// != 0) is pushed, as y_j x_j, into slot cnt of the model's L-row window in
// global memory (m counts at push). When the window holds L rows the warp
// flushes it farthest-first: the direct distance to every remaining point,
// the farthest absorbed (lowest slot on ties) if it lies on or outside the
// ball, else the whole window dropped; each absorb updates w in place and
// corrects g for the block's remaining rows, g_k <- (1-s) g_k +
// s y_k <p, x_k>. w changes in the middle of a block, so there is no
// deferred update on this path: the next block's staging reads the flushed
// rows after the block-end barrier. |w|^2 is recomputed as sum w^2 after a
// flush, and the partial windows are flushed once after the call's last
// row. Extra work over B1: ~L^2 D / 2 flops per flush for the distances
// and D flops per absorbed point and remaining row for g.
//
// B6 train (scan_ring_kernel below), bank_resident="hbm": replaces
// _kernel_many_hbm in src/repro/kernels/streamsvm_scan.py (the pallas_call
// of _call_many_hbm), B1 and B3 with the bank in device memory and (b_tile,
// D) slabs cycled through a 2-slot VMEM ring. Here the loops are inverted
// as on the TPU: persistent CTAs (n_ctas, by default one per SM) each own
// J tiles of LANES models (tile j of CTA c is c + j n_ctas) and walk the
// stream once for all of them. Per 32-row block a CTA stages each RDC-column
// chunk of the stream into shared memory once per pass over D and uses it
// for all J tiles: the h pass, then (Algorithm 1) the deferred update pass.
// The tiles' w chunks are the ring's unit: a pass is a sequence of steps
// (chunk-major, tile-minor), and the (LANES, RDC) chunk of step t + 1 is
// copied into the other of two shared-memory slots by cp.async before the
// compute on step t starts (the counterpart of pltpu.make_async_copy). New
// w values go from registers straight to device memory: a store does not
// hold the thread, and the slot it came from is free once the step's
// closing barrier passes. When J <= 2 and two whole (LANES, D) tiles fit,
// each tile owns a slot instead ("owned"): loaded once at the start,
// updated in shared memory, stored once at the end, as the TPU kernel does
// with <= 2 tiles. h and then alpha * y of each tile (LANES x 32 floats)
// and its scalars (r, xi2, |w|^2, decay, m, cnt) stay in shared memory
// between the passes. The lookahead branch (Algorithm 2) has the h pass
// only; its pushes and flushes are B3's flush_window on the w row in place
// (the owned slot, or device memory) and the windows stay in device memory
// as in B3. Each model's arithmetic is B1's / B3's operation for operation
// (h over d ascending, the row recursion, the deferred update's k order),
// so the ring equals B1 / B3 bit for bit at every J. Bound: B1's / B3's
// work; the ring saves the stream's re-reads (each block once per CTA, not
// once per 8 models) at the cost of barriers per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;     // rows per internal block: one per warp thread
constexpr int LANES = 8;   // models per CTA: one per warp
constexpr int DC = 128;    // feature columns staged per chunk
constexpr int THREADS = LANES * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// G[blk][j][k] = <x_{blk*BN+j}, x_{blk*BN+k}>; rows >= n read as zero.
template <typename T>
__global__ void __launch_bounds__(THREADS)
block_gram_kernel(const T* __restrict__ X, float* __restrict__ G, int n, int d) {
  __shared__ float xs[BN][DC + 1];
  const int tid = threadIdx.x;
  const int k = tid & 31;
  const int jb = tid >> 5;
  const long row0 = (long)blockIdx.x * BN;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < d; d0 += DC) {
    for (int e = tid; e < BN * DC; e += THREADS) {
      const int j = e / DC, c = e % DC;
      const long row = row0 + j;
      const int col = d0 + c;
      xs[j][c] = (row < n && col < d) ? ld(X, row * d + col) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < DC; ++c) {
      const float xk = xs[k][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[jb + 8 * i][c], xk, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) G[(row0 + jb + 8 * i) * BN + k] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ X, const T* __restrict__ Y,
            const float* __restrict__ G, float* __restrict__ W,
            float* __restrict__ R, float* __restrict__ XI2, int* __restrict__ M,
            const float* __restrict__ CINV, const float* __restrict__ GAIN,
            int n, int n_valid, int d) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float ws[LANES][DC + 1];
  __shared__ float gs[BN][BN + 1];
  __shared__ float ay[LANES][BN];
  const int tid = threadIdx.x;
  const int wl = tid >> 5;  // model within the CTA
  const int t = tid & 31;   // row within the block
  const long lane0 = (long)blockIdx.x * LANES;
  const long lane = lane0 + wl;
  float* w = W + lane * d;

  // |w|^2: strided partial sums, then an xor tree (every thread ends with
  // the same value, in the same order for every model).
  float wsq = 0.f;
  for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
  for (int off = 16; off > 0; off >>= 1) wsq += __shfl_xor_sync(FULL, wsq, off);

  float r = R[lane], xi2 = XI2[lane];
  const float cinv = CINV[lane], gain = GAIN[lane];
  int m = M[lane];

  const int nblocks = (n + BN - 1) / BN;
  for (int blk = 0; blk < nblocks; ++blk) {
    const long row0 = (long)blk * BN;
    const long row = row0 + t;

    // h = <w, x_row>, summed over D in ascending order.
    float h = 0.f;
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < BN * DC; e += THREADS) {
        const int j = e / DC, c = e % DC;
        const int col = d0 + c;
        xs[j][c] = (row0 + j < n && col < d) ? ld(X, (row0 + j) * d + col) : 0.f;
      }
      for (int e = tid; e < LANES * DC; e += THREADS) {
        const int l = e / DC, c = e % DC;
        const int col = d0 + c;
        ws[l][c] = col < d ? W[(lane0 + l) * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) h = fmaf(ws[wl][c], xs[t][c], h);
      __syncthreads();
    }
    for (int e = tid; e < BN * BN; e += THREADS)
      gs[e / BN][e % BN] = G[row0 * BN + e];
    const float ys = row < n ? ld(Y, lane * n + row) : 0.f;
    __syncthreads();

    float g = ys * h;
    float alpha = 0.f, decay = 1.f;
    for (int j = 0; j < BN; ++j) {
      const float gj = __shfl_sync(FULL, g, j);
      const float yj = __shfl_sync(FULL, ys, j);
      const float gjj = gs[j][j];
      const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
      const float dist = sqrtf(fmaxf(d2, 1e-12f));
      const bool upd = dist >= r && row0 + j < n_valid && yj != 0.0f;
      float s = 0.f;
      if (upd) s = 0.5f * (1.0f - r / dist);
      const float one_s = 1.0f - s;
      g = one_s * g + (s * yj) * (ys * gs[j][t]);
      alpha = (t == j) ? s : one_s * alpha;
      decay = decay * one_s;
      wsq = one_s * one_s * wsq + 2.0f * s * one_s * gj + s * s * gjj;
      if (upd) {
        r = r + 0.5f * (dist - r);
        m += 1;
      }
      xi2 = xi2 * one_s * one_s + s * s * gain;
    }

    // Deferred bank update: w <- decay * w + sum_k (alpha_k y_k) x_k.
    ay[wl][t] = alpha * ys;
    __syncwarp();
    const int left = n - (int)row0;
    const int kmax = left < BN ? left : BN;
    for (int c = t; c < d; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < kmax; ++k) acc = fmaf(ay[wl][k], ld(X, (row0 + k) * d + c), acc);
      w[c] = decay * w[c] + acc;
    }
    __syncthreads();  // w rows are read by every warp of the CTA next block
  }
  if (t == 0) {
    R[lane] = r;
    XI2[lane] = xi2;
    M[lane] = m;
  }
}

constexpr int LMAX = 1024;  // largest window: 32 mask words of 32 slots

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Farthest-first flush of one model's window by its warp (lane t). win
// holds cnt signed rows of length d (written by this kernel, so it is not
// read through the read-only cache); rm is the warp's 32-word mask of the
// slots still in the window. When k_lo < k_hi, lane t in [k_lo, k_hi)
// corrects g (its row's <w, y_t x_t>) for every absorbed point.
template <typename T>
__device__ void flush_window(float* __restrict__ w, const float* win,
                             int cnt, unsigned* rm, float& r, float& xi2,
                             float cinv, float gain, float& g, float ys,
                             const T* __restrict__ X, long row0, int k_lo,
                             int k_hi, int d, int t) {
  {
    const int lo = 32 * t;
    rm[t] = cnt <= lo ? 0u : (cnt - lo >= 32 ? FULL : (1u << (cnt - lo)) - 1u);
  }
  __syncwarp();
  for (int step = 0; step < cnt; ++step) {
    float best = __int_as_float(0xff800000);  // -inf
    int far = -1;
    for (int i = 0; i < cnt; ++i) {
      if (!((rm[i >> 5] >> (i & 31)) & 1u)) continue;
      const float* p = win + (long)i * d;
      float acc = 0.f;
      for (int c = t; c < d; c += 32) {
        const float e = w[c] - p[c];
        acc = fmaf(e, e, acc);
      }
      acc = warp_sum(acc);
      const float bd = sqrtf(fmaxf(acc + xi2 + cinv, 1e-12f));
      if (bd > best) {  // strict: the lowest slot wins a tie
        best = bd;
        far = i;
      }
    }
    // Empty, or the farthest point is enclosed and so is the rest: done.
    if (far < 0 || !(best >= r)) break;
    const float s = 0.5f * (1.0f - r / best);
    const float one_s = 1.0f - s;
    const float* p = win + (long)far * d;
    for (int c = t; c < d; c += 32) w[c] = one_s * w[c] + s * p[c];
    r = r + 0.5f * (best - r);
    xi2 = xi2 * one_s * one_s + s * s * gain;
    if (t >= k_lo && t < k_hi) {
      const long base = (row0 + t) * d;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int c = 0;
      for (; c + 4 <= d; c += 4) {
        a0 = fmaf(p[c], ld(X, base + c), a0);
        a1 = fmaf(p[c + 1], ld(X, base + c + 1), a1);
        a2 = fmaf(p[c + 2], ld(X, base + c + 2), a2);
        a3 = fmaf(p[c + 3], ld(X, base + c + 3), a3);
      }
      for (; c < d; ++c) a0 = fmaf(p[c], ld(X, base + c), a0);
      g = one_s * g + s * (ys * ((a0 + a1) + (a2 + a3)));
    }
    __syncwarp();
    if (t == 0) rm[far >> 5] &= ~(1u << (far & 31));
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lookahead_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                 const float* __restrict__ G, float* __restrict__ W,
                 float* __restrict__ R, float* __restrict__ XI2,
                 int* __restrict__ M, const float* __restrict__ CINV,
                 const float* __restrict__ GAIN, const int* __restrict__ LA,
                 float* __restrict__ BUF, int n, int n_valid, int d, int l_max) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float ws[LANES][DC + 1];
  __shared__ float gs[BN][BN + 1];
  __shared__ unsigned rmask[LANES][32];
  const int tid = threadIdx.x;
  const int wl = tid >> 5;  // model within the CTA
  const int t = tid & 31;   // row within the block
  const long lane0 = (long)blockIdx.x * LANES;
  const long lane = lane0 + wl;
  float* w = W + lane * d;
  float* win = BUF + lane * (long)l_max * d;

  float wsq = 0.f;
  for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
  wsq = warp_sum(wsq);

  float r = R[lane], xi2 = XI2[lane];
  const float cinv = CINV[lane], gain = GAIN[lane];
  const int L = LA[lane];
  int m = M[lane];
  int cnt = 0;  // rows in the window

  const int nblocks = (n + BN - 1) / BN;
  for (int blk = 0; blk < nblocks; ++blk) {
    const long row0 = (long)blk * BN;
    const long row = row0 + t;

    // h = <w, x_row>, summed over D in ascending order (as in B1).
    float h = 0.f;
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < BN * DC; e += THREADS) {
        const int j = e / DC, c = e % DC;
        const int col = d0 + c;
        xs[j][c] = (row0 + j < n && col < d) ? ld(X, (row0 + j) * d + col) : 0.f;
      }
      for (int e = tid; e < LANES * DC; e += THREADS) {
        const int l = e / DC, c = e % DC;
        const int col = d0 + c;
        ws[l][c] = col < d ? W[(lane0 + l) * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) h = fmaf(ws[wl][c], xs[t][c], h);
      __syncthreads();
    }
    for (int e = tid; e < BN * BN; e += THREADS)
      gs[e / BN][e % BN] = G[row0 * BN + e];
    const float ys = row < n ? ld(Y, lane * n + row) : 0.f;
    __syncthreads();

    float g = ys * h;
    const int left = n - (int)row0;
    const int kmax = left < BN ? left : BN;
    for (int j = 0; j < BN; ++j) {
      const float gj = __shfl_sync(FULL, g, j);
      const float yj = __shfl_sync(FULL, ys, j);
      const float gjj = gs[j][j];
      const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
      const float dist = sqrtf(fmaxf(d2, 1e-12f));
      // Uniform across the warp: every lane holds the model's scalars.
      if (!(dist >= r && row0 + j < n_valid && yj != 0.0f)) continue;
      float* p = win + (long)cnt * d;
      for (int c = t; c < d; c += 32) p[c] = yj * ld(X, (row0 + j) * d + c);
      __syncwarp();
      cnt += 1;
      m += 1;  // counted at push
      if (cnt >= L) {
        flush_window(w, win, cnt, rmask[wl], r, xi2, cinv, gain, g, ys, X,
                     row0, j + 1, kmax, d, t);
        cnt = 0;
        wsq = 0.f;
        for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
        wsq = warp_sum(wsq);
      }
    }
    __syncthreads();  // flushed w rows are read by every warp next block
  }
  if (cnt > 0) {  // the partial window, after the call's last row
    float g = 0.f;
    flush_window(w, win, cnt, rmask[wl], r, xi2, cinv, gain, g, 0.f, X, 0,
                 0, 0, d, t);
  }
  if (t == 0) {
    R[lane] = r;
    XI2[lane] = xi2;
    M[lane] = m;
  }
}

template <typename T>
int launch_lookahead(const void* X, const void* Y, void* G, void* W, void* R,
                     void* XI2, void* M, const void* CINV, const void* GAIN,
                     const void* LA, void* BUF, int n, int n_valid, int d,
                     int bp, int l_max, cudaStream_t s) {
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lookahead_kernel<T><<<bp / LANES, THREADS, 0, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R,
      (float*)XI2, (int*)M, (const float*)CINV, (const float*)GAIN,
      (const int*)LA, (float*)BUF, n, n_valid, d, l_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* Y, void* G, void* W, void* R, void* XI2,
           void* M, const void* CINV, const void* GAIN, int n, int n_valid,
           int d, int bp, cudaStream_t s) {
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T><<<bp / LANES, THREADS, 0, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R,
      (float*)XI2, (int*)M, (const float*)CINV, (const float*)GAIN, n,
      n_valid, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6 train: the ring
// ---------------------------------------------------------------------------

constexpr int RDC = 64;     // ring columns per chunk
constexpr int RING_ST = 6;  // scalars per model: r, xi2, wsq, decay, m, cnt

// Dynamic shared memory of scan_ring_kernel, in bytes: the two slots, then
// per tile h / alpha*y (LANES x BN) and the scalars, then (lookahead) the
// flush masks. Static: xs and gs.
size_t ring_dyn_bytes(int d, int jmax, int owned, int look) {
  const long dp = (long)(d + RDC - 1) / RDC * RDC;
  const long pitch = owned ? dp : RDC;
  return sizeof(float) * (2 * LANES * pitch + (long)jmax * LANES * (BN + RING_ST) +
                          (look ? LANES * 32 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of columns [c0, c0 + cols) of the LANES rows from lane0
// into dst (row pitch `pitch`), as one cp.async group of every thread;
// columns past d are zero-filled.
__device__ __forceinline__ void ring_load(float* dst, int pitch, const float* W,
                                          long lane0, int d, int c0, int cols,
                                          int tid) {
  for (int e = tid; e < LANES * cols; e += THREADS) {
    const int l = e / cols, c = e % cols;
    const int col = c0 + c;
    const bool ok = col < d;
    cp_async4(dst + l * pitch + c, W + (lane0 + l) * d + (ok ? col : 0), ok);
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void stage_x(float (*xs)[RDC + 1], const T* X,
                                        long row0, int n, int d, int c0, int tid) {
  for (int e = tid; e < BN * RDC; e += THREADS) {
    const int j = e / RDC, c = e % RDC;
    const int col = c0 + c;
    xs[j][c] = (row0 + j < n && col < d) ? ld(X, (row0 + j) * d + col) : 0.f;
  }
}

template <typename T, bool LOOK>
__global__ void __launch_bounds__(THREADS)
scan_ring_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                 const float* __restrict__ G, float* W, float* __restrict__ R,
                 float* __restrict__ XI2, int* __restrict__ M,
                 const float* __restrict__ CINV, const float* __restrict__ GAIN,
                 const int* __restrict__ LA, float* __restrict__ BUF, int n,
                 int n_valid, int d, int tiles, int jmax, int owned, int l_max) {
  __shared__ float xs[BN][RDC + 1];
  __shared__ float gs[BN][BN + 1];
  extern __shared__ float dyn[];
  const int dp = (d + RDC - 1) / RDC * RDC;
  const int pitch = owned ? dp : RDC;
  float* slots = dyn;                       // [2][LANES][pitch]
  float* hs = slots + 2 * LANES * pitch;    // [jmax][LANES][BN]
  float* st = hs + jmax * LANES * BN;       // [jmax][RING_ST][LANES]
  int* sti = (int*)st;
  unsigned* rmask = (unsigned*)(st + jmax * RING_ST * LANES);  // [LANES][32]
  float (*xsv)[RDC + 1] = xs;  // the lambdas below take it by value
  const int tid = threadIdx.x;
  const int wl = tid >> 5;  // model within a tile
  const int t = tid & 31;   // row within the block
  const int nct = gridDim.x;
  const int J = (tiles - (int)blockIdx.x + nct - 1) / nct;
  const int nchunks = dp / RDC;
  const int steps = nchunks * J;
  auto lane0 = [&](int j) { return (long)(blockIdx.x + j * nct) * LANES; };
  auto sv = [&](int j, int k) -> float& { return st[(j * RING_ST + k) * LANES + wl]; };
  auto si = [&](int j, int k) -> int& { return sti[(j * RING_ST + k) * LANES + wl]; };
  // The w row of model wl of tile j: its owned slot, or device memory.
  auto wrow = [&](int j) -> float* {
    return owned ? slots + (j * LANES + wl) * pitch : W + (lane0(j) + wl) * d;
  };

  for (int j = 0; j < J; ++j) {
    const long lane = lane0(j) + wl;
    const float* w = W + lane * d;
    float wsq = 0.f;
    for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
    wsq = warp_sum(wsq);
    if (t == 0) {
      sv(j, 0) = R[lane];
      sv(j, 1) = XI2[lane];
      sv(j, 2) = wsq;
      si(j, 4) = M[lane];
      si(j, 5) = 0;
    }
  }
  if (owned) {
    for (int j = 0; j < J; ++j)
      ring_load(slots + j * LANES * pitch, pitch, W, lane0(j), d, 0, dp, tid);
    cp_async_wait<0>();
  }
  __syncthreads();

  // One pass over D: for every step (chunk ch, tile j), body(j, c0, wsrc)
  // with the tile's (LANES, RDC) w chunk at wsrc (row pitch `pitch`).
  auto pass = [&](auto&& body, long row0) {
    if (!owned) ring_load(slots, RDC, W, lane0(0), d, 0, RDC, tid);
    int step = 0;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * RDC;
      stage_x(xsv, X, row0, n, d, c0, tid);
      for (int j = 0; j < J; ++j, ++step) {
        float* wsrc;
        if (owned) {
          wsrc = slots + j * LANES * pitch + c0;
        } else {
          if (step + 1 < steps) {  // prefetch step + 1 before computing step
            const int nj = (step + 1) % J, nc = (step + 1) / J;
            ring_load(slots + ((step + 1) & 1) * LANES * RDC, RDC, W, lane0(nj),
                      d, nc * RDC, RDC, tid);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          wsrc = slots + (step & 1) * LANES * RDC;
        }
        __syncthreads();  // xs and this step's slot are in place
        body(j, c0, wsrc);
        __syncthreads();  // the slot (and xs) may be refilled
      }
    }
  };

  const int nblocks = (n + BN - 1) / BN;
  for (int blk = 0; blk < nblocks; ++blk) {
    const long row0 = (long)blk * BN;
    const long row = row0 + t;

    // h = <w, x_row> for every tile, summed over D in ascending order.
    for (int j = 0; j < J; ++j) hs[(j * LANES + wl) * BN + t] = 0.f;
    pass(
        [&](int j, int c0, float* wsrc) {
          const float* wr = wsrc + wl * pitch;
          float h = hs[(j * LANES + wl) * BN + t];
#pragma unroll 8
          for (int c = 0; c < RDC; ++c) h = fmaf(wr[c], xsv[t][c], h);
          hs[(j * LANES + wl) * BN + t] = h;
        },
        row0);
    for (int e = tid; e < BN * BN; e += THREADS)
      gs[e / BN][e % BN] = G[row0 * BN + e];
    __syncthreads();

    const int left = n - (int)row0;
    const int kmax = left < BN ? left : BN;
    for (int j = 0; j < J; ++j) {
      const long lane = lane0(j) + wl;
      float* hj = hs + (j * LANES + wl) * BN;
      const float ys = row < n ? ld(Y, lane * n + row) : 0.f;
      float r = sv(j, 0), xi2 = sv(j, 1), wsq = sv(j, 2);
      int m = si(j, 4);
      const float cinv = CINV[lane], gain = GAIN[lane];
      float g = ys * hj[t];
      if constexpr (!LOOK) {
        float alpha = 0.f, decay = 1.f;
        for (int j2 = 0; j2 < BN; ++j2) {
          const float gj = __shfl_sync(FULL, g, j2);
          const float yj = __shfl_sync(FULL, ys, j2);
          const float gjj = gs[j2][j2];
          const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
          const float dist = sqrtf(fmaxf(d2, 1e-12f));
          const bool upd = dist >= r && row0 + j2 < n_valid && yj != 0.0f;
          float s = 0.f;
          if (upd) s = 0.5f * (1.0f - r / dist);
          const float one_s = 1.0f - s;
          g = one_s * g + (s * yj) * (ys * gs[j2][t]);
          alpha = (t == j2) ? s : one_s * alpha;
          decay = decay * one_s;
          wsq = one_s * one_s * wsq + 2.0f * s * one_s * gj + s * s * gjj;
          if (upd) {
            r = r + 0.5f * (dist - r);
            m += 1;
          }
          xi2 = xi2 * one_s * one_s + s * s * gain;
        }
        hj[t] = alpha * ys;
        if (t == 0) sv(j, 3) = decay;
      } else {
        const int L = LA[lane];
        int cnt = si(j, 5);
        float* w = wrow(j);
        float* win = BUF + lane * (long)l_max * d;
        for (int j2 = 0; j2 < BN; ++j2) {
          const float gj = __shfl_sync(FULL, g, j2);
          const float yj = __shfl_sync(FULL, ys, j2);
          const float gjj = gs[j2][j2];
          const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
          const float dist = sqrtf(fmaxf(d2, 1e-12f));
          // Uniform across the warp: every lane holds the model's scalars.
          if (!(dist >= r && row0 + j2 < n_valid && yj != 0.0f)) continue;
          float* p = win + (long)cnt * d;
          for (int c = t; c < d; c += 32) p[c] = yj * ld(X, (row0 + j2) * d + c);
          __syncwarp();
          cnt += 1;
          m += 1;  // counted at push
          if (cnt >= L) {
            flush_window(w, win, cnt, rmask + wl * 32, r, xi2, cinv, gain, g, ys,
                         X, row0, j2 + 1, kmax, d, t);
            cnt = 0;
            wsq = 0.f;
            for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
            wsq = warp_sum(wsq);
          }
        }
        if (t == 0) si(j, 5) = cnt;
      }
      if (t == 0) {
        sv(j, 0) = r;
        sv(j, 1) = xi2;
        sv(j, 2) = wsq;
        si(j, 4) = m;
      }
    }
    __syncthreads();  // alpha*y, decay and flushed w rows are read next

    if constexpr (!LOOK) {
      // Deferred update: w <- decay * w + sum_k (alpha_k y_k) x_k.
      pass(
          [&](int j, int c0, float* wsrc) {
            const float* ay = hs + (j * LANES + wl) * BN;
            const float decay = sv(j, 3);
            float* wr = wsrc + wl * pitch;
            float* wout = W + (lane0(j) + wl) * d + c0;
            for (int cc = t; cc < RDC && c0 + cc < d; cc += 32) {
              float acc = 0.f;
              for (int k = 0; k < kmax; ++k) acc = fmaf(ay[k], xsv[k][cc], acc);
              const float nw = decay * wr[cc] + acc;
              if (owned) wr[cc] = nw;
              else wout[cc] = nw;
            }
          },
          row0);
    }
  }
  for (int j = 0; j < J; ++j) {
    const long lane = lane0(j) + wl;
    float r = sv(j, 0), xi2 = sv(j, 1);
    if constexpr (LOOK) {
      const int cnt = si(j, 5);
      if (cnt > 0) {  // the partial window, after the call's last row
        float g = 0.f;
        flush_window(wrow(j), BUF + lane * (long)l_max * d, cnt, rmask + wl * 32,
                     r, xi2, CINV[lane], GAIN[lane], g, 0.f, X, 0, 0, 0, d, t);
      }
    }
    if (t == 0) {
      R[lane] = r;
      XI2[lane] = xi2;
      M[lane] = si(j, 4);
    }
  }
  if (owned) {
    __syncthreads();
    for (int j = 0; j < J; ++j)
      for (int e = tid; e < LANES * d; e += THREADS) {
        const int l = e / d, c = e % d;
        W[(lane0(j) + l) * d + c] = slots[(j * LANES + l) * pitch + c];
      }
  }
}

template <typename T, bool LOOK>
int launch_ring(const void* X, const void* Y, void* G, void* W, void* R, void* XI2,
                void* M, const void* CINV, const void* GAIN, const void* LA,
                void* BUF, int n, int n_valid, int d, int bp, int l_max,
                int n_ctas, int owned, cudaStream_t s) {
  const int tiles = bp / LANES;
  const int jmax = (tiles + n_ctas - 1) / n_ctas;
  const size_t dyn = ring_dyn_bytes(d, jmax, owned, LOOK);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan_ring_kernel<T, LOOK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_ring_kernel<T, LOOK><<<n_ctas, THREADS, dyn, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R,
      (float*)XI2, (int*)M, (const float*)CINV, (const float*)GAIN,
      (const int*)LA, (float*)BUF, n, n_valid, d, tiles, jmax, owned, l_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per internal block: the Gram scratch holds ceil(n / BN) * BN * BN
// floats.
int streamsvm_scan_block_rows() { return BN; }

// X (n, d) and Y (bp, n) in the stream dtype (f32, or bf16 when bf16 != 0);
// W (bp, d), R, XI2 (bp,) f32 and M (bp,) int32 are updated in place;
// CINV, GAIN (bp,) f32. bp must be a multiple of LANES. Returns the CUDA
// error of the launches (0 on success).
int streamsvm_scan_many(const void* X, const void* Y, void* G, void* W,
                        void* R, void* XI2, void* M, const void* CINV,
                        const void* GAIN, int n, int n_valid, int d, int bp,
                        int bf16, void* stream) {
  if (n <= 0 || d <= 0 || bp <= 0 || bp % LANES != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(X, Y, G, W, R, XI2, M, CINV, GAIN, n, n_valid, d, bp, s);
  return launch<float>(X, Y, G, W, R, XI2, M, CINV, GAIN, n, n_valid, d, bp, s);
}

// B3: as streamsvm_scan_many, plus LA (bp,) int32 per-model windows and
// BUF, scratch for the windows of bp * l_max * d floats. 1 <= l_max <= LMAX.
int streamsvm_scan_lookahead(const void* X, const void* Y, void* G, void* W,
                             void* R, void* XI2, void* M, const void* CINV,
                             const void* GAIN, const void* LA, void* BUF, int n,
                             int n_valid, int d, int bp, int l_max, int bf16,
                             void* stream) {
  if (n <= 0 || d <= 0 || bp <= 0 || bp % LANES != 0 || l_max < 1 || l_max > LMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_lookahead<__nv_bfloat16>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA,
                                           BUF, n, n_valid, d, bp, l_max, s);
  return launch_lookahead<float>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                 n_valid, d, bp, l_max, s);
}

// Largest lookahead window B3 takes.
int streamsvm_scan_lookahead_max() { return LMAX; }

// B6 train: as streamsvm_scan_many (l_max == 0, Algorithm 1) or
// streamsvm_scan_lookahead (l_max >= 1, Algorithm 2; LA and BUF as there),
// on n_ctas persistent CTAs (1 <= n_ctas <= bp / LANES) that cycle their
// tiles through the ring; owned != 0 gives each tile its own slot (at most
// two tiles per CTA). Returns the CUDA error of the launches; a layout
// beyond the card's shared memory is refused there and never runs.
int streamsvm_scan_ring(const void* X, const void* Y, void* G, void* W, void* R,
                        void* XI2, void* M, const void* CINV, const void* GAIN,
                        const void* LA, void* BUF, int n, int n_valid, int d,
                        int bp, int l_max, int n_ctas, int owned, int bf16,
                        void* stream) {
  const int tiles = bp / LANES;
  if (n <= 0 || d <= 0 || bp <= 0 || bp % LANES != 0 || l_max < 0 || l_max > LMAX ||
      n_ctas < 1 || n_ctas > tiles || (owned && (tiles + n_ctas - 1) / n_ctas > 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (l_max > 0) {
    if (bf16)
      return launch_ring<__nv_bfloat16, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                              n_valid, d, bp, l_max, n_ctas, owned, s);
    return launch_ring<float, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid,
                                    d, bp, l_max, n_ctas, owned, s);
  }
  if (bf16)
    return launch_ring<__nv_bfloat16, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                             n_valid, d, bp, 0, n_ctas, owned, s);
  return launch_ring<float, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d,
                                   bp, 0, n_ctas, owned, s);
}

// Dynamic shared memory the ring requests for jmax tiles per CTA.
long streamsvm_scan_ring_dyn_bytes(int d, int jmax, int owned, int look) {
  return (long)ring_dyn_bytes(d, jmax, owned, look);
}

// The ring's column chunk.
int streamsvm_scan_ring_chunk() { return RDC; }

}  // extern "C"
