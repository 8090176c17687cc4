// B1 on Hopper: one pass of Algorithm 1 for a bank of models over a shared
// stream, with a plain C interface (bound from Python with ctypes).
//
// Replaces the Algorithm-1 branch of
// src/repro/kernels/streamsvm_scan.py::_block_update (driven there by
// _kernel_many_tiled / streamsvm_scan_many_pallas).
//
// Layout. The bank axis is the parallel one: each CTA owns a few models
// (one warp per model in the row recursion) and walks the whole stream in
// order, in internal blocks of BN = 32 rows (one row per thread of the
// warp). Nothing carries between CTAs. The block Gram G = X_blk X_blk^T is
// the same for every model, so a pre-pass kernel computes it once per block
// into global memory (it stays in L2) and every CTA reads its 32x32 block
// from there. Three layouts give the same bits (the wrapper picks one per
// launch, streamsvm_scan.py::scan_plan): "resident" (scan_res_kernel, B1
// and B3), the CTA's (MPC, D) bank tile in shared memory for the whole
// launch, the stream copied ahead by cp.async and the D loops register-tiled;
// "chunked" (scan_kernel / lookahead_kernel, LANES = 8 models per CTA), the
// bank in device memory staged chunk by chunk, where no tile fits the
// budget; and, for B3 with few live models, "small" (lookahead_small_kernel),
// one CTA per live model.
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
// f32 rate. What holds the kernels back on the card is latency: the
// dependent per-row chain of the row recursion (a shuffle, a sqrt and a
// divide per row), and in the D loops the
// shared-memory reads, which one or two warps per SM cannot hide by
// switching. The resident layout keeps the tile out of device memory,
// copies the stream ahead, gives each thread a register tile (h: MPC / 4
// models x 2 rows; the deferred update: 4 models x MPC / 2 columns) and
// issues each unit's reads one unit ahead of its fmafs.
//
// B3, the fused Algorithm 2 (lookahead_kernel and the B3 instantiations of
// scan_res_kernel and lookahead_small_kernel below), replaces the lookahead
// branch of the same _block_update with _bank_flush. It shares the Gram
// pre-pass, the layouts and the h pass with B1. A violating row (Gram-form d >= r, valid, sign
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
// and D flops per absorbed point and remaining row for g. In the chunked
// and resident layouts the model's warp pushes and flushes, the window in
// device memory; in the small layout the whole CTA does (flush_cta), the
// window in shared memory where it fits.
//
// B6 train (scan_ring_kernel below), bank_resident="hbm": replaces
// _kernel_many_hbm in src/repro/kernels/streamsvm_scan.py (the pallas_call
// of _call_many_hbm), B1 and B3 with the bank in device memory and (b_tile,
// D) slabs cycled through a 2-slot VMEM ring. Here the loops are inverted
// as on the TPU: persistent CTAs (n_ctas, by default one per SM) each own
// J tiles of LANES models (tile j of CTA c is c + j n_ctas) and walk the
// stream once for all of them: each staged stream chunk serves every tile
// of the CTA, so the stream is read once per CTA, not once per 8 models.
// The passes are the resident layout's: the stream copied a chunk ahead by
// cp.async (stage_chunk), the Gram from the block's first step
// (stage_gram), the h pass register-tiled (h_tile) and the deferred update
// (update_chunk) on a warp pair per tile, the row recursion B1's / B3's
// (alg1_rows, alg2_rows_warp), a step loop that does not divide. Three
// layouts (the wrapper's ring_plan picks the first that fits the budget):
// "owned", J <= 2 tiles' whole rows in shared memory for the launch (with
// J = 1 the resident layout's work); "cycling", the w chunks of each step
// copied into one of three slots two steps ahead (16-byte copies where the
// rows are aligned), the new w written straight to device memory, up to 4
// tiles a step; and "lean", the cycling layout with 32-column chunks and
// one tile a step, at most 16,640 + 1,216 J bytes (1,024 more with
// lookahead) at J tiles per CTA, for budgets below the chunked kernels'.
// B3's windows stay in device memory, and its flushes rewrite w in place
// (the owned rows, or device memory). Each
// model's arithmetic is B1's / B3's operation for operation (h one
// ascending chain over d from 0.f, the recursion, the update's k order),
// so the ring equals B1 / B3 bit for bit at every J and in every layout.
// Bound: B1's / B3's work; what the ring saves is the stream's re-reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// The ball distance of row j in Gram form, d = sqrt(max(d^2, 1e-12)).
__device__ __forceinline__ float ball_dist(float wsq, float gj, float gjj, float xi2,
                                          float cinv) {
  const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
  return sqrtf(fmaxf(d2, 1e-12f));
}

// B1's row recursion over one 32-row block for one model, every layout: lane
// t of the model's warp holds row t's g, ys and alpha; gs is the block Gram
// at row pitch gp. The expressions are the TPU kernel's, as written once
// here, so the compiler contracts them the same way in every layout.
__device__ __forceinline__ void alg1_rows(float& g, float& alpha, float& decay, float& wsq,
                                          float& r, float& xi2, int& m, float ys,
                                          const float* gs, int gp, float cinv, float gain,
                                          long row0, int n_valid, int t) {
  for (int j = 0; j < BN; ++j) {
    const float gj = __shfl_sync(FULL, g, j);
    const float yj = __shfl_sync(FULL, ys, j);
    const float gjj = gs[j * gp + j];
    const float dist = ball_dist(wsq, gj, gjj, xi2, cinv);
    const bool upd = dist >= r && row0 + j < n_valid && yj != 0.0f;
    float s = 0.f;
    if (upd) s = 0.5f * (1.0f - r / dist);
    const float one_s = 1.0f - s;
    g = one_s * g + (s * yj) * (ys * gs[j * gp + t]);
    alpha = (t == j) ? s : one_s * alpha;
    decay = decay * one_s;
    wsq = one_s * one_s * wsq + 2.0f * s * one_s * gj + s * s * gjj;
    if (upd) {
      r = r + 0.5f * (dist - r);
      m += 1;
    }
    xi2 = xi2 * one_s * one_s + s * s * gain;
  }
}

// B3's rows over one block for one model served by its warp (the chunked
// and resident layouts): a violating row is pushed as y_j x_j into slot cnt
// of the window win (row pitch d), and a full window is flushed by the warp
// (flush_window), after which |w|^2 is recomputed.
template <typename T>
__device__ __forceinline__ void alg2_rows_warp(float* w, float* win, int& cnt, int& m,
                                               unsigned* rm, float& wsq, float& r, float& xi2,
                                               float& g, float ys, const float* gs, int gp,
                                               float cinv, float gain, int L, const T* X,
                                               long row0, int n, int n_valid, int d, int t) {
  const int left = n - (int)row0;
  const int kmax = left < BN ? left : BN;
  for (int j = 0; j < BN; ++j) {
    const float gj = __shfl_sync(FULL, g, j);
    const float yj = __shfl_sync(FULL, ys, j);
    const float gjj = gs[j * gp + j];
    const float dist = ball_dist(wsq, gj, gjj, xi2, cinv);
    // Uniform across the warp: every lane holds the model's scalars.
    if (!(dist >= r && row0 + j < n_valid && yj != 0.0f)) continue;
    float* p = win + (long)cnt * d;
    for (int c = t; c < d; c += 32) p[c] = yj * ld(X, (row0 + j) * d + c);
    __syncwarp();
    cnt += 1;
    m += 1;  // counted at push
    if (cnt >= L) {
      flush_window(w, win, cnt, rm, r, xi2, cinv, gain, g, ys, X, row0, j + 1, kmax, d, t);
      cnt = 0;
      wsq = 0.f;
      for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
      wsq = warp_sum(wsq);
    }
  }
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
    alg1_rows(g, alpha, decay, wsq, r, xi2, m, ys, &gs[0][0], BN + 1, cinv, gain, row0,
              n_valid, t);

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
    alg2_rows_warp(w, win, cnt, m, rmask[wl], wsq, r, xi2, g, ys, &gs[0][0], BN + 1, cinv,
                   gain, L, X, row0, n, n_valid, d, t);
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
// B1 and B3 with the CTA's bank tile resident (the "resident" layout), and
// B3 for a small bank (the "small" layout: one CTA for each live model)
// ---------------------------------------------------------------------------

constexpr int SMALL_THREADS = 256;  // the small layout's CTA
constexpr int SMALL_WARPS = SMALL_THREADS / 32;

// Elements of T in one 16-byte copy, and the row pitch (in elements) of a
// staged (BN, CW) chunk of the stream (CW = DC, or the ring's lean chunk):
// one copy more than CW, so that the 16-byte reads of 8 consecutive rows by
// a quarter warp fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }
template <typename T, int CW = DC>
__host__ __device__ constexpr int xpitch() { return CW + vec_of<T>(); }

// A w row in shared memory: D rounded up to 8 floats, zero past D (the h
// pass reads 4 or 8 columns at a time).
__host__ __device__ inline int wpitch(int d) { return (d + 7) / 8 * 8; }

template <typename T, int CW = DC>
__host__ __device__ constexpr size_t chunk_bytes() {
  return (size_t)BN * xpitch<T, CW>() * sizeof(T);
}

// Dynamic shared memory of the resident layout, in bytes: two stream
// chunks, the MPC-row bank tile, the block Gram, h / alpha*y (MPC x BN),
// then decay (B1) or the flush masks (B3). Static: none.
size_t res_dyn_bytes(int d, int mpc, int look, int bf16) {
  const size_t x = 2 * (bf16 ? chunk_bytes<__nv_bfloat16>() : chunk_bytes<float>());
  return x + sizeof(float) * ((size_t)mpc * wpitch(d) + BN * BN + mpc * BN +
                              (look ? mpc * 32 : mpc));
}

// Dynamic shared memory of the small layout, in bytes: two stream chunks,
// the model's w row, the block Gram, h / the g corrections (BN), the
// warps' farthest points (value and slot), the window mask (32 words),
// then the window (l_max w rows) when win_smem.
size_t small_dyn_bytes(int d, int l_max, int win_smem, int bf16) {
  const size_t x = 2 * (bf16 ? chunk_bytes<__nv_bfloat16>() : chunk_bytes<float>());
  return x + sizeof(float) * ((size_t)wpitch(d) + BN * BN + BN + 2 * SMALL_WARPS + 32 +
                              (win_smem ? (size_t)l_max * wpitch(d) : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Start the copy of rows [row0, row0 + BN) x columns [c0, c0 + CW) of X
// into dst (pitch xpitch<T, CW>()), raw (bf16 stays bf16), zero past n and
// d. vec16: rows and base 16-byte aligned (and so d a multiple of a copy):
// cp.async of 16 bytes, which the caller commits and waits for; otherwise
// plain element loads, complete at the caller's next barrier.
template <typename T, int NT, int CW = DC>
__device__ __forceinline__ void stage_chunk(T* dst, const T* __restrict__ X, long row0,
                                            int n, int d, int c0, int vec16, int tid) {
  constexpr int V = vec_of<T>();
  constexpr int P = xpitch<T, CW>();
  if (vec16) {
    for (int e = tid; e < BN * (CW / V); e += NT) {
      const int j = e / (CW / V), c = e % (CW / V) * V;
      const long row = row0 + j;
      const int col = c0 + c;
      const bool ok = row < n && col < d;
      cp_async16(dst + j * P + c, X + (ok ? row * d + col : 0), ok);
    }
  } else {
    for (int e = tid; e < BN * CW; e += NT) {
      const int j = e / CW, c = e % CW;
      const long row = row0 + j;
      const int col = c0 + c;
      dst[j * P + c] = (row < n && col < d) ? X[row * d + col] : zero_of<T>();
    }
  }
}

// Start the copy of one block's (BN, BN) Gram into gs.
template <int NT>
__device__ __forceinline__ void stage_gram(float* gs, const float* __restrict__ G, long row0,
                                           int tid) {
  for (int e = tid; e < BN * BN / 4; e += NT) cp_async16(gs + 4 * e, G + row0 * BN + 4 * e, true);
}

// 16 bytes of a staged row as floats (bf16 upcast exactly).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The h pass over one staged chunk, register-tiled: acc[i][j] carries
// <w_i, x_j> for RM models (w rows ws + i * mstride) and RR rows (staged
// rows xr + j * rstride), each its own fmaf chain in ascending column
// order. Each 16-byte read of a row feeds RM models and each of a w row RR
// rows. Reads go two copies at a time and are issued one such unit ahead
// of the fmafs that use them, so the shared-memory latency hides behind
// the previous unit's fmafs. cols: the chunk's columns rounded up to a
// copy (past d both w and x are zero, and h is never -0, so the padding
// adds exactly nothing). The reads ahead may pass cols, still inside the
// shared allocation; what they fetch there is never used.
template <typename T, int RM, int RR>
__device__ __forceinline__ void h_tile(float (&acc)[RM][RR], const float* ws, int mstride,
                                       const T* xr, int rstride, int cols) {
  constexpr int V = vec_of<T>();
  constexpr int U = 2 * V;  // columns a unit
  float xv[2][RR][U];
  float4 wv[2][RM][U / 4];
  auto fetch = [&](int c, float (&x)[RR][U], float4 (&w)[RM][U / 4]) {
#pragma unroll
    for (int j = 0; j < RR; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[V];
        load16(xr + j * rstride + c + h * V, v);
#pragma unroll
        for (int q = 0; q < V; ++q) x[j][h * V + q] = v[q];
      }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int v = 0; v < U / 4; ++v)
        w[i][v] = *reinterpret_cast<const float4*>(ws + i * mstride + c + 4 * v);
  };
  // The fmafs of the first nv4 * 4 columns of a unit.
  auto step = [&](auto nv4, const float (&x)[RR][U], const float4 (&w)[RM][U / 4]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RR; ++j)
#pragma unroll
        for (int v = 0; v < decltype(nv4)::value; ++v) {
          acc[i][j] = fmaf(w[i][v].x, x[j][4 * v], acc[i][j]);
          acc[i][j] = fmaf(w[i][v].y, x[j][4 * v + 1], acc[i][j]);
          acc[i][j] = fmaf(w[i][v].z, x[j][4 * v + 2], acc[i][j]);
          acc[i][j] = fmaf(w[i][v].w, x[j][4 * v + 3], acc[i][j]);
        }
  };
  using Full = std::integral_constant<int, U / 4>;
  using Half = std::integral_constant<int, V / 4>;
  fetch(0, xv[0], wv[0]);
  int c = 0;
  for (; c + 2 * U <= cols; c += 2 * U) {  // two units a trip: the buffers alternate
    fetch(c + U, xv[1], wv[1]);
    step(Full(), xv[0], wv[0]);
    fetch(c + 2 * U, xv[0], wv[0]);
    step(Full(), xv[1], wv[1]);
  }
  if (cols - c >= U) {  // one whole unit, and perhaps one copy, left
    fetch(c + U, xv[1], wv[1]);
    step(Full(), xv[0], wv[0]);
    if (cols - c > U) step(Half(), xv[1], wv[1]);
  } else if (cols > c) {  // one copy left
    step(Half(), xv[0], wv[0]);
  }
}

// The deferred update of one staged (BN, CW) chunk for 4 models (alpha*y
// rows ay + i * BN, decay dec[i]) and UC columns per thread, cbase + lane +
// 32 u of the chunk: each (model, column) one fmaf chain over the block's
// rows k ascending from 0.f, then w <- decay * w + acc, read from the rows
// wt + i * wp and written to wo + i * wop (the same rows, or the models' rows
// in device memory); wt and wo point at the chunk's first column, and only
// the chunk's first `cols` columns (those before D) are written. One read
// of x serves 4 models; one 16-byte read of alpha*y (4 rows of one model)
// serves UC columns. The reads of 4 rows are issued 4 rows ahead of their
// fmafs (and may pass kmax, inside the shared allocation; unused there).
template <typename T, int UC, int CW = DC>
__device__ __forceinline__ void update_chunk(const float* wt, int wp, float* wo, long wop,
                                             const float* ay, const float* dec, const T* xc,
                                             int cbase, int cols, int kmax, int lane) {
  constexpr int P = xpitch<T, CW>();
  const T* xl = xc + cbase + lane;
  float acc[4][UC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < UC; ++u) acc[i][u] = 0.f;
  float x[2][4][UC];
  float4 a[2][4];
  auto load = [&](int k, float (&xx)[4][UC], float4 (&aa)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < UC; ++u) xx[j][u] = to_f(xl[(k + j) * P + 32 * u]);
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = *reinterpret_cast<const float4*>(ay + i * BN + k);
  };
  auto fma4 = [&](const float (&xx)[4][UC], const float4 (&aa)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        acc[i][u] = fmaf(aa[i].x, xx[0][u], acc[i][u]);
        acc[i][u] = fmaf(aa[i].y, xx[1][u], acc[i][u]);
        acc[i][u] = fmaf(aa[i].z, xx[2][u], acc[i][u]);
        acc[i][u] = fmaf(aa[i].w, xx[3][u], acc[i][u]);
      }
  };
  const int k4 = kmax & ~3;  // rows taken 4 at a time
  load(0, x[0], a[0]);
  int k = 0;
  for (; k + 8 <= k4; k += 8) {  // two groups a trip: the buffers alternate
    load(k + 4, x[1], a[1]);
    fma4(x[0], a[0]);
    load(k + 8, x[0], a[0]);
    fma4(x[1], a[1]);
  }
  if (k < k4) {
    fma4(x[0], a[0]);
    k += 4;
  }
  for (; k < kmax; ++k) {
#pragma unroll
    for (int u = 0; u < UC; ++u) {
      const float xk = to_f(xl[k * P + 32 * u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][u] = fmaf(ay[i * BN + k], xk, acc[i][u]);
    }
  }
#pragma unroll
  for (int u = 0; u < UC; ++u) {
    const int cc = cbase + lane + 32 * u;
    if (cc >= cols) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) wo[i * wop + cc] = dec[i] * wt[i * wp + cc] + acc[i][u];
  }
}

// The resident layout of B1 (LOOK false) and B3 (LOOK true): MPC models per
// CTA, one warp each for the row recursion. The CTA's (MPC, D) bank tile is
// loaded into shared memory once, updated there (B1's deferred update, B3's
// flushes) and stored once at the end, as the ring's owned slots are. The
// stream goes through shared memory in (BN, DC) chunks, two buffers deep:
// per block the h pass over its chunks, then (B1) the deferred update over
// the same chunks again; chunk s + 1 is copied by cp.async while chunk s is
// consumed, and across the row recursion, which runs after the block's last
// h chunk (the block Gram is copied from its first h chunk on). Both passes run on warps 0 and 1 with register tiles, because
// shared-memory reads, not fmafs, bound them: the h pass gives each thread
// MPC / 4 models x 2 rows (h_tile), the deferred update 4 models x MPC / 2
// columns (update_chunk). B3's windows stay in device memory; its pushes
// and flushes are the chunked layout's (alg2_rows_warp) on the resident w
// row.
template <typename T, int MPC, bool LOOK>
__global__ void __launch_bounds__(MPC * 32)
scan_res_kernel(const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ G,
                float* __restrict__ W, float* __restrict__ R, float* __restrict__ XI2,
                int* __restrict__ M, const float* __restrict__ CINV,
                const float* __restrict__ GAIN, const int* __restrict__ LA,
                float* __restrict__ BUF, int n, int n_valid, int d, int l_max, int vec16) {
  static_assert(MPC == 4 || MPC == 8, "4 or 8 models per CTA");
  constexpr int NT = MPC * 32;
  constexpr int P = xpitch<T>();
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int wp = wpitch(d);
  T* xb = reinterpret_cast<T*>(smem);                                    // [2][BN][P]
  float* wt = reinterpret_cast<float*>(smem + 2 * chunk_bytes<T>());   // [MPC][wp]
  float* gs = wt + MPC * wp;                                             // [BN][BN]
  float* hs = gs + BN * BN;         // [MPC][BN]: h, then alpha * y
  float* dec = hs + MPC * BN;       // [MPC]: decay (B1)
  unsigned* rmask = reinterpret_cast<unsigned*>(dec);  // [MPC][32] (B3)
  const int tid = threadIdx.x;
  const int wl = tid >> 5;  // model within the CTA
  const int t = tid & 31;   // row within the block
  const long lane0 = (long)blockIdx.x * MPC;
  const long lane = lane0 + wl;
  const int nc = (d + DC - 1) / DC;
  const int per_block = (LOOK ? 1 : 2) * nc;  // chunk steps per block
  const int steps = (n + BN - 1) / BN * per_block;
  // Start the copy of chunk ch of block blk into buffer buf.
  auto stage = [&](int blk, int ch, int buf) {
    stage_chunk<T, NT>(xb + buf * BN * P, X, (long)blk * BN, n, d, ch * DC, vec16, tid);
  };

  stage(0, 0, 0);
  cp_async_commit();
  for (int e = tid; e < MPC * wp; e += NT) {
    const int l = e / wp, c = e % wp;
    wt[e] = c < d ? W[(lane0 + l) * d + c] : 0.f;
  }
  __syncthreads();
  float* w = wt + wl * wp;  // this warp's model
  float wsq = 0.f;
  for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
  wsq = warp_sum(wsq);
  float r = R[lane], xi2 = XI2[lane];
  const float cinv = CINV[lane], gain = GAIN[lane];
  int m = M[lane];
  int cnt = 0, L = 1;
  float* win = nullptr;
  if constexpr (LOOK) {
    L = LA[lane];
    win = BUF + lane * (long)l_max * d;
  }
  float hacc[MPC / 4][2];

  int blk = 0, within = 0;  // step s is step `within` of block blk
  for (int s = 0; s < steps; ++s) {
    const bool h_pass = within < nc, last_h = within == nc - 1;
    const int ch = h_pass ? within : within - nc;
    const long row0 = (long)blk * BN;
    const int nwithin = within + 1 == per_block ? 0 : within + 1;  // step s + 1
    const int nblk = nwithin == 0 ? blk + 1 : blk;
    cp_async_wait<0>();
    __syncthreads();  // chunk s is in place; every thread is past step s - 1
    if (h_pass && ch == 0) {  // the Gram, needed after the block's last h chunk
      stage_gram<NT>(gs, G, row0, tid);
      cp_async_commit();
    }
    if (s + 1 < steps) stage(nblk, nwithin < nc ? nwithin : nwithin - nc, (s + 1) & 1);
    cp_async_commit();
    const T* xc = xb + (s & 1) * BN * P;
    const int c0 = ch * DC;
    float ys = 0.f;
    if (last_h && row0 + t < n) ys = ld(Y, lane * n + row0 + t);
    if (h_pass) {
      // Warps 0 and 1, rows 16 w + rg + 8 j of lane 8 mg + rg, models mg + 4 i.
      if (wl < 2) {
        const int mg = t >> 3, rg = t & 7, row = 16 * wl + rg;
        if (ch == 0) {
#pragma unroll
          for (int i = 0; i < MPC / 4; ++i) hacc[i][0] = hacc[i][1] = 0.f;
        }
        const int cols = (min(DC, d - c0) + V - 1) / V * V;
        h_tile<T, MPC / 4, 2>(hacc, wt + mg * wp + c0, 4 * wp, xc + row * P, 8 * P, cols);
        if (last_h) {
#pragma unroll
          for (int i = 0; i < MPC / 4; ++i) {
            hs[(mg + 4 * i) * BN + row] = hacc[i][0];
            hs[(mg + 4 * i) * BN + row + 8] = hacc[i][1];
          }
        }
      }
    } else if (wl < 2) {
      // Deferred update of the chunk's columns by warps 0 and 1, 4 models x
      // MPC / 2 columns a thread: w <- decay * w + sum_k (alpha_k y_k) x_k.
      const int q = MPC == 8 ? wl : 0, cbase = MPC == 8 ? 0 : 64 * wl;
      const int left = n - (int)row0;
      float* wq = wt + 4 * q * wp + c0;
      update_chunk<T, MPC / 2>(wq, wp, wq, wp, hs + 4 * q * BN, dec + 4 * q, xc, cbase, d - c0,
                               left < BN ? left : BN, t);
    }
    if (last_h) {  // the row recursion of the block, one warp per model
      cp_async_wait<1>();  // the Gram (the next chunk may still be in flight)
      __syncthreads();
      float g = ys * hs[wl * BN + t];
      if constexpr (!LOOK) {
        float alpha = 0.f, decay = 1.f;
        alg1_rows(g, alpha, decay, wsq, r, xi2, m, ys, gs, BN, cinv, gain, row0, n_valid, t);
        hs[wl * BN + t] = alpha * ys;
        if (t == 0) dec[wl] = decay;
      } else {
        alg2_rows_warp(w, win, cnt, m, rmask + wl * 32, wsq, r, xi2, g, ys, gs, BN, cinv,
                       gain, L, X, row0, n, n_valid, d, t);
      }
    }
    blk = nblk;
    within = nwithin;
  }
  cp_async_wait<0>();
  if constexpr (LOOK) {
    if (cnt > 0) {  // the partial window, after the call's last row
      float g = 0.f;
      flush_window(w, win, cnt, rmask + wl * 32, r, xi2, cinv, gain, g, 0.f, X, 0, 0, 0, d, t);
    }
  }
  if (t == 0) {
    R[lane] = r;
    XI2[lane] = xi2;
    M[lane] = m;
  }
  __syncthreads();
  for (int e = tid; e < MPC * d; e += NT) {
    const int l = e / d, c = e % d;
    W[(lane0 + l) * d + c] = wt[l * wp + c];
  }
}

// Farthest-first flush of the small layout's window by the whole CTA (tid):
// per step every warp takes the remaining slots k, k + SMALL_WARPS, ...,
// each distance flush_window's lane-strided chain and xor tree; the
// farthest point is reduced across the warps on (distance, lowest slot),
// which is flush_window's strict > in slot order. w is updated elementwise,
// and each remaining row's g correction <p, x_k> is split over four
// threads, one per accumulator of flush_window, combined as
// (a0 + a1) + (a2 + a3); every warp then applies it to its copy of g.
// win: cnt rows at pitch wpw; rm, bv (2 * SMALL_WARPS words) and dots (BN)
// are shared scratch. Every thread holds the model's scalars.
template <typename T>
__device__ void flush_cta(float* w, const float* win, int wpw, int cnt, unsigned* rm,
                          float* bv, float* dots, float& r, float& xi2, float cinv, float gain,
                          float& g, float ys, const T* __restrict__ X, long row0, int k_lo,
                          int k_hi, int d, int tid) {
  const int t = tid & 31, wl = tid >> 5;
  int* bi = reinterpret_cast<int*>(bv + SMALL_WARPS);
  __syncthreads();  // the window's rows are in place; rm, bv and dots are free
  if (tid < 32) {
    const int lo = 32 * t;
    rm[t] = cnt <= lo ? 0u : (cnt - lo >= 32 ? FULL : (1u << (cnt - lo)) - 1u);
  }
  __syncthreads();
  for (int step = 0; step < cnt; ++step) {
    float best = __int_as_float(0xff800000);  // -inf
    int far = -1;
    for (int i = wl; i < cnt; i += SMALL_WARPS) {
      if (!((rm[i >> 5] >> (i & 31)) & 1u)) continue;
      const float* p = win + (long)i * wpw;
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
    if (t == 0) {
      bv[wl] = best;
      bi[wl] = far;
    }
    __syncthreads();
    best = __int_as_float(0xff800000);
    far = -1;
    for (int k = 0; k < SMALL_WARPS; ++k) {
      const int fk = bi[k];
      const float bk = bv[k];
      if (fk >= 0 && (bk > best || (bk == best && fk < far))) {
        best = bk;
        far = fk;
      }
    }
    // Empty, or the farthest point is enclosed and so is the rest: done.
    if (far < 0 || !(best >= r)) break;
    const float s = 0.5f * (1.0f - r / best);
    const float one_s = 1.0f - s;
    const float* p = win + (long)far * wpw;
    for (int c = tid; c < d; c += SMALL_THREADS) w[c] = one_s * w[c] + s * p[c];
    r = r + 0.5f * (best - r);
    xi2 = xi2 * one_s * one_s + s * s * gain;
    if (tid < 4 * BN) {  // row k_lo + tid / 4, accumulator tid % 4
      const int k = k_lo + (tid >> 2), q = tid & 3;
      float a = 0.f;
      if (k < k_hi) {
        const long base = (row0 + k) * d;
        const int d4 = d & ~3;
        for (int c = q; c < d4; c += 4) a = fmaf(p[c], ld(X, base + c), a);
        if (q == 0)
          for (int c = d4; c < d; ++c) a = fmaf(p[c], ld(X, base + c), a);
      }
      const float a1 = __shfl_down_sync(FULL, a, 1);
      const float a2 = __shfl_down_sync(FULL, a, 2);
      const float a3 = __shfl_down_sync(FULL, a, 3);
      if (q == 0 && k < k_hi) dots[k] = (a + a1) + (a2 + a3);
    }
    __syncthreads();
    if (t >= k_lo && t < k_hi) g = one_s * g + s * (ys * dots[t]);
    if (tid == 0) rm[far >> 5] &= ~(1u << (far & 31));
    __syncthreads();
  }
}

// B3's small layout: one CTA for each live model (lanes at or past n_live
// are padding and get no work). The CTA stages the stream as the resident
// layout does, its w row in shared memory; warp 0 runs the h pass (one row
// per lane), every warp runs the row recursion with the model's scalars (so
// a push or a flush is uniform across the CTA), the whole CTA copies each
// pushed row and flushes (flush_cta). The window lives in shared memory when
// win_smem, else in BUF.
template <typename T>
__global__ void __launch_bounds__(SMALL_THREADS)
lookahead_small_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                       const float* __restrict__ G, float* __restrict__ W,
                       float* __restrict__ R, float* __restrict__ XI2, int* __restrict__ M,
                       const float* __restrict__ CINV, const float* __restrict__ GAIN,
                       const int* __restrict__ LA, float* __restrict__ BUF, int n, int n_valid,
                       int d, int l_max, int win_smem, int vec16) {
  constexpr int NT = SMALL_THREADS;
  constexpr int P = xpitch<T>();
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int wp = wpitch(d);
  T* xb = reinterpret_cast<T*>(smem);                                   // [2][BN][P]
  float* w = reinterpret_cast<float*>(smem + 2 * chunk_bytes<T>());   // [wp]
  float* gs = w + wp;                                                   // [BN][BN]
  float* dots = gs + BN * BN;  // [BN]: h, then the g corrections
  float* bv = dots + BN;       // [2][SMALL_WARPS]
  unsigned* rm = reinterpret_cast<unsigned*>(bv + 2 * SMALL_WARPS);  // [32]
  const int tid = threadIdx.x;
  const int wl = tid >> 5;
  const int t = tid & 31;
  const long lane = blockIdx.x;
  const int wpw = win_smem ? wp : d;
  float* win = win_smem ? reinterpret_cast<float*>(rm + 32) : BUF + lane * (long)l_max * d;
  const int nc = (d + DC - 1) / DC;
  const int steps = (n + BN - 1) / BN * nc;
  auto stage = [&](int blk, int ch, int buf) {
    stage_chunk<T, NT>(xb + buf * BN * P, X, (long)blk * BN, n, d, ch * DC, vec16, tid);
  };

  stage(0, 0, 0);
  cp_async_commit();
  for (int c = tid; c < wp; c += NT) w[c] = c < d ? W[lane * d + c] : 0.f;
  __syncthreads();
  float wsq = 0.f;  // every warp computes it, in the same order
  for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
  wsq = warp_sum(wsq);
  float r = R[lane], xi2 = XI2[lane];
  const float cinv = CINV[lane], gain = GAIN[lane];
  const int L = LA[lane];
  int m = M[lane];
  int cnt = 0;
  float h[1][1];

  int blk = 0, ch = 0;  // step s is chunk ch of block blk
  for (int s = 0; s < steps; ++s, ch = ch + 1 == nc ? 0 : ch + 1, blk += ch == 0) {
    const bool last = ch == nc - 1;
    const long row0 = (long)blk * BN;
    cp_async_wait<0>();
    __syncthreads();
    if (ch == 0) {  // the Gram, needed after the block's last chunk
      stage_gram<NT>(gs, G, row0, tid);
      cp_async_commit();
    }
    if (s + 1 < steps) stage(last ? blk + 1 : blk, last ? 0 : ch + 1, (s + 1) & 1);
    cp_async_commit();
    float ys = 0.f;
    if (last && row0 + t < n) ys = ld(Y, lane * n + row0 + t);
    if (wl == 0) {
      if (ch == 0) h[0][0] = 0.f;
      const int c0 = ch * DC;
      const int cols = (min(DC, d - c0) + V - 1) / V * V;
      h_tile<T, 1, 1>(h, w + c0, 0, xb + (s & 1) * BN * P + t * P, 0, cols);
      if (last) dots[t] = h[0][0];
    }
    if (!last) continue;
    cp_async_wait<1>();
    __syncthreads();
    float g = ys * dots[t];
    const int left = n - (int)row0;
    const int kmax = left < BN ? left : BN;
    for (int j = 0; j < BN; ++j) {
      const float gj = __shfl_sync(FULL, g, j);
      const float yj = __shfl_sync(FULL, ys, j);
      const float gjj = gs[j * BN + j];
      const float dist = ball_dist(wsq, gj, gjj, xi2, cinv);
      // Uniform across the CTA: every thread holds the model's scalars.
      if (!(dist >= r && row0 + j < n_valid && yj != 0.0f)) continue;
      float* p = win + (long)cnt * wpw;
      for (int c = tid; c < d; c += NT) p[c] = yj * ld(X, (row0 + j) * d + c);
      cnt += 1;
      m += 1;  // counted at push
      if (cnt >= L) {
        flush_cta(w, win, wpw, cnt, rm, bv, dots, r, xi2, cinv, gain, g, ys, X, row0, j + 1,
                  kmax, d, tid);
        cnt = 0;
        wsq = 0.f;
        for (int c = t; c < d; c += 32) wsq = fmaf(w[c], w[c], wsq);
        wsq = warp_sum(wsq);
      }
    }
  }
  cp_async_wait<0>();
  if (cnt > 0) {  // the partial window, after the call's last row
    float g = 0.f;
    flush_cta(w, win, wpw, cnt, rm, bv, dots, r, xi2, cinv, gain, g, 0.f, X, 0, 0, 0, d, tid);
  }
  if (tid == 0) {
    R[lane] = r;
    XI2[lane] = xi2;
    M[lane] = m;
  }
  __syncthreads();
  for (int c = tid; c < d; c += NT) W[lane * d + c] = w[c];
}

template <typename T, int MPC, bool LOOK>
int launch_res(const void* X, const void* Y, void* G, void* W, void* R, void* XI2, void* M,
               const void* CINV, const void* GAIN, const void* LA, void* BUF, int n,
               int n_valid, int d, int bp, int l_max, int vec16, cudaStream_t s) {
  const size_t dyn = res_dyn_bytes(d, MPC, LOOK, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan_res_kernel<T, MPC, LOOK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_res_kernel<T, MPC, LOOK><<<bp / MPC, MPC * 32, dyn, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R, (float*)XI2, (int*)M,
      (const float*)CINV, (const float*)GAIN, (const int*)LA, (float*)BUF, n, n_valid, d,
      l_max, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_small(const void* X, const void* Y, void* G, void* W, void* R, void* XI2, void* M,
                 const void* CINV, const void* GAIN, const void* LA, void* BUF, int n,
                 int n_valid, int d, int n_live, int l_max, int win_smem, int vec16,
                 cudaStream_t s) {
  const size_t dyn = small_dyn_bytes(d, l_max, win_smem, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute((const void*)lookahead_small_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lookahead_small_kernel<T><<<n_live, SMALL_THREADS, dyn, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R, (float*)XI2, (int*)M,
      (const float*)CINV, (const float*)GAIN, (const int*)LA, (float*)BUF, n, n_valid, d, l_max,
      win_smem, vec16);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6 train: the ring
// ---------------------------------------------------------------------------

constexpr int RING_ST = 6;       // scalars per model: r, xi2, |w|^2, decay, m, cnt
constexpr int RING_SLOTS = 3;    // w slots: a step's, and two steps copied ahead
constexpr int RING_LEAN_DC = 32; // the lean layout's chunk columns
constexpr int RING_OWNED = 0, RING_CYCLING = 1, RING_LEAN = 2;  // the layouts
constexpr int RING_MAX_GROUP = 4;  // tiles a cycling step: one per warp pair

// Tiles a step of the cycling and lean layouts, whose w slots hold that
// many tiles' chunks (the owned layout holds every tile whole).
__host__ __device__ inline int ring_group(int layout, int jmax) {
  return layout == RING_LEAN ? 1 : (jmax < RING_MAX_GROUP ? jmax : RING_MAX_GROUP);
}

// Row pitch of a w slot: the cycling layout pads a row by one 16-byte copy,
// so that the 4 models a quarter warp reads fall in distinct banks; the lean
// layout does not, to stay within 16,640 + 1,216 J bytes.
template <int CW>
__host__ __device__ constexpr int ring_spitch() { return CW == DC ? CW + 4 : CW; }

// Dynamic shared memory of scan_ring_kernel, in bytes (it has no static
// bytes): two stream chunks (the lean layout's narrower), the block Gram,
// the w storage (owned: jmax whole tiles; else RING_SLOTS slots of
// ring_group tiles' chunks), h / alpha*y and the scalars of each tile, then
// (lookahead) the flush masks.
size_t ring_dyn_bytes(int d, int jmax, int layout, int look, int bf16) {
  const bool lean = layout == RING_LEAN;
  const size_t x = 2 * (lean ? (bf16 ? chunk_bytes<__nv_bfloat16, RING_LEAN_DC>()
                                     : chunk_bytes<float, RING_LEAN_DC>())
                             : (bf16 ? chunk_bytes<__nv_bfloat16>() : chunk_bytes<float>()));
  const size_t bank = layout == RING_OWNED ? (size_t)jmax * LANES * wpitch(d)
                      : (size_t)RING_SLOTS * ring_group(layout, jmax) * LANES *
                            (lean ? ring_spitch<RING_LEAN_DC>() : ring_spitch<DC>());
  return x + sizeof(float) * (BN * BN + bank + (size_t)jmax * LANES * (BN + RING_ST) +
                              (look ? LANES * 32 : 0));
}

// B6 train, Algorithm 1 (LOOK false) or 2, on the resident layout's passes.
// CTA c owns J tiles of LANES models (tile j is c + j * gridDim.x) and walks
// the stream once for all of them, in steps: per 32-row block the h pass
// over the (BN, CW) stream chunks, the row recursion of every tile, then
// (Algorithm 1) the deferred update over the same chunks again; each chunk
// is a step for every group of gt tiles (the warp pair q = wl / 2 takes
// the group's tile q, as warps 0 and 1 take the resident layout's 8
// models). The stream is copied one chunk ahead (stage_chunk), the Gram
// from the block's first step (stage_gram). owned: the tiles' whole rows
// live in shared memory for the launch (loaded once, stored once). Else the
// w chunk of each step is copied into one of RING_SLOTS slots two steps
// ahead, 16 bytes a copy where the rows allow it, and the update writes the
// new w straight to device memory; the copies start anew at each block
// (after a barrier), because the block's update or flushes rewrite w there.
// Each tile's h accumulates in hs between its chunks. The row recursion is
// B1's / B3's (alg1_rows, alg2_rows_warp), warp wl serving model wl of
// every tile, each tile's sign and scalars read one tile ahead.
template <typename T, bool LOOK, int CW>
__global__ void __launch_bounds__(THREADS)
scan_ring_kernel(const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ G,
                 float* W, float* __restrict__ R, float* __restrict__ XI2, int* __restrict__ M,
                 const float* __restrict__ CINV, const float* __restrict__ GAIN,
                 const int* __restrict__ LA, float* __restrict__ BUF, int n, int n_valid, int d,
                 int tiles, int jmax, int layout, int l_max, int xvec16) {
  constexpr int P = xpitch<T, CW>();
  constexpr int V = vec_of<T>();
  constexpr int SP = ring_spitch<CW>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int wp = wpitch(d);
  const bool owned = layout == RING_OWNED;
  const int slot_sz = ring_group(layout, jmax) * LANES * SP;
  T* xb = reinterpret_cast<T*>(smem);                                     // [2][BN][P]
  float* gs = reinterpret_cast<float*>(smem + 2 * chunk_bytes<T, CW>());  // [BN][BN]
  float* wb = gs + BN * BN;  // owned: [jmax][LANES][wp]; else [RING_SLOTS][tiles][LANES][SP]
  float* hs = wb + (owned ? jmax * LANES * wp : RING_SLOTS * slot_sz);  // [jmax][LANES][BN]
  float* st = hs + jmax * LANES * BN;                                    // [jmax][RING_ST][LANES]
  int* sti = reinterpret_cast<int*>(st);
  unsigned* rmask = reinterpret_cast<unsigned*>(st + jmax * RING_ST * LANES);  // [LANES][32]
  const int tid = threadIdx.x;
  const int wl = tid >> 5;  // model within a tile
  const int t = tid & 31;   // row within the block
  const int nct = gridDim.x;
  const int J = (tiles - (int)blockIdx.x + nct - 1) / nct;
  const int gt = owned ? J : min(ring_group(layout, jmax), J);  // tiles a step
  const int ngrp = (J + gt - 1) / gt;
  const int nc = (d + CW - 1) / CW;
  const int nblocks = (n + BN - 1) / BN;
  const int steps = nblocks * (LOOK ? 1 : 2) * nc * ngrp;
  const bool wvec16 = (d & 3) == 0;
  auto lane0 = [&](int j) { return (long)(blockIdx.x + j * nct) * LANES; };
  auto sv = [&](int j, int k) -> float& { return st[(j * RING_ST + k) * LANES + wl]; };
  auto si = [&](int j, int k) -> int& { return sti[(j * RING_ST + k) * LANES + wl]; };
  auto wrow = [&](int j) -> float* {  // the w row of model wl of tile j
    return owned ? wb + (j * LANES + wl) * wp : W + (lane0(j) + wl) * d;
  };
  auto stage = [&](int blk, int ch, int buf) {
    stage_chunk<T, THREADS, CW>(xb + buf * BN * P, X, (long)blk * BN, n, d, ch * CW, xvec16,
                                tid);
  };
  // Start the copy of w chunk ch of the tiles of group grp into slot sl,
  // zero past d: 16-byte cp.async where the rows are 16-byte aligned, else
  // element loads (complete at the caller's next barrier).
  auto load_w = [&](int grp, int ch, int sl) {
    const int j0 = grp * gt;
    const int rows = min(gt, J - j0) * LANES;
    float* dst = wb + sl * slot_sz;
    const int c0 = ch * CW;
    if (wvec16) {
      for (int e = tid; e < rows * (CW / 4); e += THREADS) {
        const int r = e / (CW / 4), c = e % (CW / 4) * 4;
        const int col = c0 + c;
        const bool ok = col < d;
        cp_async16(dst + r * SP + c, W + (lane0(j0 + r / LANES) + r % LANES) * d + (ok ? col : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < rows * CW; e += THREADS) {
        const int r = e / CW, c = e % CW;
        const int col = c0 + c;
        dst[r * SP + c] = col < d ? W[(lane0(j0 + r / LANES) + r % LANES) * d + col] : 0.f;
      }
    }
  };
  // Step (ph, ch, grp) -> the next one in the block; false past its end.
  auto next = [&](int& ph, int& ch, int& grp) {
    if (++grp < ngrp) return true;
    grp = 0;
    if (++ch < nc) return true;
    ch = 0;
    if (LOOK || ph == 1) return false;
    ph = 1;
    return true;
  };

  stage(0, 0, 0);
  cp_async_commit();
  if (owned)
    for (int j = 0; j < J; ++j)
      for (int e = tid; e < LANES * wp; e += THREADS) {
        const int l = e / wp, c = e % wp;
        wb[j * LANES * wp + e] = c < d ? W[(lane0(j) + l) * d + c] : 0.f;
      }
  __syncthreads();
  for (int j = 0; j < J; ++j) {
    const long lane = lane0(j) + wl;
    const float* w = wrow(j);
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

  // Step s is group grp of chunk ch of pass ph (0: h, 1: update) of block
  // blk; its stream chunk is in buffer xbuf, its w chunks in slot sl.
  int blk = 0, ph = 0, ch = 0, grp = 0, xbuf = 0, sl = 0;
  float ys = 0.f, cinv = 0.f, gain = 0.f;  // tile 0's, read ahead of the rows
  int L = 1;
  for (int s = 0; s < steps; ++s) {
    const long row0 = (long)blk * BN;
    const bool first = ph == 0 && ch == 0 && grp == 0;
    const bool last_h = ph == 0 && ch == nc - 1 && grp == ngrp - 1;
    const int sl1 = sl == RING_SLOTS - 1 ? 0 : sl + 1;
    const int sl2 = sl1 == RING_SLOTS - 1 ? 0 : sl1 + 1;
    if (!owned && first) {  // the block's first two steps' w, after its writers
      __syncthreads();
      load_w(0, 0, sl);
      cp_async_commit();
      int p1 = 0, c1 = 0, g1 = 0;
      if (next(p1, c1, g1)) load_w(g1, c1, sl1);
      cp_async_commit();
    }
    cp_async_wait<1>();  // all but the newest group: step s's chunks are in
    __syncthreads();     // and every thread is past step s - 1
    if (first) stage_gram<THREADS>(gs, G, row0, tid);
    if (grp == 0) {  // the next stream chunk, into the other buffer
      int nb = blk, nch = ch + 1;
      if (nch == nc) {
        nch = 0;
        if (LOOK || ph == 1) ++nb;
      }
      if (nb < nblocks) stage(nb, nch, xbuf ^ 1);
    }
    cp_async_commit();
    if (!owned) {  // step s + 2's w, when it lies in this block
      int p2 = ph, c2 = ch, g2 = grp;
      if (next(p2, c2, g2) && next(p2, c2, g2)) load_w(g2, c2, sl2);
    }
    cp_async_commit();
    if (last_h) {
      const long lane = lane0(0) + wl;
      ys = row0 + t < n ? ld(Y, lane * n + row0 + t) : 0.f;
      cinv = CINV[lane];
      gain = GAIN[lane];
      if constexpr (LOOK) L = LA[lane];
    }
    const T* xc = xb + xbuf * BN * P;
    const int c0 = ch * CW;
    const int q = wl >> 1, pl = wl & 1;
    const int j = grp * gt + q;
    if (q < gt && j < J) {
      float* wsrc = owned ? wb + j * LANES * wp + c0 : wb + sl * slot_sz + q * LANES * SP;
      const int wstr = owned ? wp : SP;
      if (ph == 0) {
        // h of tile j: warp pl of the pair takes rows 16 pl + rg + 8 r of
        // lane 8 mg + rg, models mg + 4 i.
        const int mg = t >> 3, rg = t & 7, row = 16 * pl + rg;
        float* hj = hs + j * LANES * BN;
        float acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][0] = ch == 0 ? 0.f : hj[(mg + 4 * i) * BN + row];
          acc[i][1] = ch == 0 ? 0.f : hj[(mg + 4 * i) * BN + row + 8];
        }
        const int cols = (min(CW, d - c0) + V - 1) / V * V;
        h_tile<T, 2, 2>(acc, wsrc + mg * wstr, 4 * wstr, xc + row * P, 8 * P, cols);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          hj[(mg + 4 * i) * BN + row] = acc[i][0];
          hj[(mg + 4 * i) * BN + row + 8] = acc[i][1];
        }
      } else {
        // The deferred update of tile j: warp pl of the pair takes models
        // 4 pl .. 4 pl + 3, every column of the chunk.
        const int left = n - (int)row0;
        const int kmax = left < BN ? left : BN;
        const float* ay = hs + (j * LANES + 4 * pl) * BN;
        const float* dec = st + (j * RING_ST + 3) * LANES + 4 * pl;
        float* wr = wsrc + 4 * pl * wstr;
        if (owned)
          update_chunk<T, CW / 32, CW>(wr, wstr, wr, wstr, ay, dec, xc, 0, d - c0, kmax, t);
        else
          update_chunk<T, CW / 32, CW>(wr, wstr, W + (lane0(j) + 4 * pl) * d + c0, d, ay, dec,
                                       xc, 0, d - c0, kmax, t);
      }
    }
    if (last_h) {  // the row recursion of every tile, warp wl serving model wl
      cp_async_wait<1>();  // the Gram (the next chunk may still be in flight)
      __syncthreads();     // and every tile's h
      for (int jj = 0; jj < J; ++jj) {
        const long lane = lane0(jj) + wl;
        const float ysj = ys, cinvj = cinv, gainj = gain;
        const int Lj = L;
        if (jj + 1 < J) {  // the next tile's, read ahead of this tile's rows
          const long nl = lane0(jj + 1) + wl;
          ys = row0 + t < n ? ld(Y, nl * n + row0 + t) : 0.f;
          cinv = CINV[nl];
          gain = GAIN[nl];
          if constexpr (LOOK) L = LA[nl];
        }
        float* hj = hs + (jj * LANES + wl) * BN;
        float r = sv(jj, 0), xi2 = sv(jj, 1), wsq = sv(jj, 2);
        int m = si(jj, 4);
        float g = ysj * hj[t];
        if constexpr (!LOOK) {
          float alpha = 0.f, decay = 1.f;
          alg1_rows(g, alpha, decay, wsq, r, xi2, m, ysj, gs, BN, cinvj, gainj, row0, n_valid, t);
          hj[t] = alpha * ysj;
          if (t == 0) sv(jj, 3) = decay;
        } else {
          int cnt = si(jj, 5);
          float* win = BUF + lane * (long)l_max * d;
          if (owned)  // two calls, so each knows where its w row lives
            alg2_rows_warp(wb + (jj * LANES + wl) * wp, win, cnt, m, rmask + wl * 32, wsq, r,
                           xi2, g, ysj, gs, BN, cinvj, gainj, Lj, X, row0, n, n_valid, d, t);
          else
            alg2_rows_warp(W + lane * d, win, cnt, m, rmask + wl * 32, wsq, r, xi2, g, ysj, gs,
                           BN, cinvj, gainj, Lj, X, row0, n, n_valid, d, t);
          if (t == 0) si(jj, 5) = cnt;
        }
        if (t == 0) {
          sv(jj, 0) = r;
          sv(jj, 1) = xi2;
          sv(jj, 2) = wsq;
          si(jj, 4) = m;
        }
      }
    }
    sl = sl1;
    if (++grp == ngrp) {
      grp = 0;
      xbuf ^= 1;
      if (++ch == nc) {
        ch = 0;
        if (LOOK || ph == 1) {
          ph = 0;
          ++blk;
        } else {
          ph = 1;
        }
      }
    }
  }
  cp_async_wait<0>();
  for (int j = 0; j < J; ++j) {
    const long lane = lane0(j) + wl;
    float r = sv(j, 0), xi2 = sv(j, 1);
    if constexpr (LOOK) {
      const int cnt = si(j, 5);
      if (cnt > 0) {  // the partial window, after the call's last row
        float g = 0.f;
        flush_window(wrow(j), BUF + lane * (long)l_max * d, cnt, rmask + wl * 32, r, xi2,
                     CINV[lane], GAIN[lane], g, 0.f, X, 0, 0, 0, d, t);
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
        W[(lane0(j) + l) * d + c] = wb[(j * LANES + l) * wp + c];
      }
  }
}

template <typename T, bool LOOK, int CW>
int launch_ring(const void* X, const void* Y, void* G, void* W, void* R, void* XI2, void* M,
                const void* CINV, const void* GAIN, const void* LA, void* BUF, int n,
                int n_valid, int d, int bp, int l_max, int n_ctas, int layout, int xvec16,
                cudaStream_t s) {
  const int tiles = bp / LANES;
  const int jmax = (tiles + n_ctas - 1) / n_ctas;
  const size_t dyn = ring_dyn_bytes(d, jmax, layout, LOOK, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan_ring_kernel<T, LOOK, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + BN - 1) / BN;
  block_gram_kernel<T><<<nblocks, THREADS, 0, s>>>((const T*)X, (float*)G, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_ring_kernel<T, LOOK, CW><<<n_ctas, THREADS, dyn, s>>>(
      (const T*)X, (const T*)Y, (const float*)G, (float*)W, (float*)R, (float*)XI2, (int*)M,
      (const float*)CINV, (const float*)GAIN, (const int*)LA, (float*)BUF, n, n_valid, d, tiles,
      jmax, layout, l_max, xvec16);
  return (int)cudaGetLastError();
}

template <typename T, bool LOOK>
int dispatch_ring(const void* X, const void* Y, void* G, void* W, void* R, void* XI2, void* M,
                  const void* CINV, const void* GAIN, const void* LA, void* BUF, int n,
                  int n_valid, int d, int bp, int l_max, int n_ctas, int layout, int xvec16,
                  cudaStream_t s) {
  if (layout == RING_LEAN)
    return launch_ring<T, LOOK, RING_LEAN_DC>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                              n_valid, d, bp, l_max, n_ctas, layout, xvec16, s);
  return launch_ring<T, LOOK, DC>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d, bp,
                                  l_max, n_ctas, layout, xvec16, s);
}

template <typename T>
int dispatch_res(const void* X, const void* Y, void* G, void* W, void* R, void* XI2, void* M,
                 const void* CINV, const void* GAIN, const void* LA, void* BUF, int n,
                 int n_valid, int d, int bp, int l_max, int mpc, int vec16, cudaStream_t s) {
  if (mpc == 8)
    return l_max > 0 ? launch_res<T, 8, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                               n_valid, d, bp, l_max, vec16, s)
                     : launch_res<T, 8, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                                n_valid, d, bp, 0, vec16, s);
  return l_max > 0 ? launch_res<T, 4, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                             n_valid, d, bp, l_max, vec16, s)
                   : launch_res<T, 4, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                              n_valid, d, bp, 0, vec16, s);
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
// on n_ctas persistent CTAs (1 <= n_ctas <= bp / LANES), each walking the
// stream once for its tiles. layout: RING_OWNED (each tile's whole rows in
// shared memory; at most two tiles per CTA), RING_CYCLING (the w chunks
// copied through the slots, ring_group tiles a step) or RING_LEAN (the same
// with 32-column chunks, one tile a step). xvec16 as streamsvm_scan_
// resident's vec16. Returns the CUDA error of the launches; a layout beyond
// the card's shared memory is refused there and never runs.
int streamsvm_scan_ring(const void* X, const void* Y, void* G, void* W, void* R, void* XI2,
                        void* M, const void* CINV, const void* GAIN, const void* LA, void* BUF,
                        int n, int n_valid, int d, int bp, int l_max, int n_ctas, int layout,
                        int xvec16, int bf16, void* stream) {
  const int tiles = bp / LANES;
  if (n <= 0 || d <= 0 || bp <= 0 || bp % LANES != 0 || l_max < 0 || l_max > LMAX ||
      n_ctas < 1 || n_ctas > tiles || layout < RING_OWNED || layout > RING_LEAN ||
      (layout == RING_OWNED && (tiles + n_ctas - 1) / n_ctas > 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (l_max > 0) {
    if (bf16)
      return dispatch_ring<__nv_bfloat16, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                                n_valid, d, bp, l_max, n_ctas, layout, xvec16, s);
    return dispatch_ring<float, true>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d,
                                      bp, l_max, n_ctas, layout, xvec16, s);
  }
  if (bf16)
    return dispatch_ring<__nv_bfloat16, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n,
                                               n_valid, d, bp, 0, n_ctas, layout, xvec16, s);
  return dispatch_ring<float, false>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d,
                                     bp, 0, n_ctas, layout, xvec16, s);
}

// Dynamic shared memory the ring requests for jmax tiles per CTA (its only
// shared memory), per layout as streamsvm_scan_ring takes it.
long streamsvm_scan_ring_dyn_bytes(int d, int jmax, int layout, int look, int bf16) {
  return (long)ring_dyn_bytes(d, jmax, layout, look, bf16);
}

// The resident layout (B1 for l_max == 0, B3's bank layout for l_max >= 1;
// arguments as streamsvm_scan_many / streamsvm_scan_lookahead): mpc (4 or
// 8, dividing bp) models per CTA with their (mpc, d) tile in shared memory.
// vec16 != 0 promises X 16-byte aligned with d * sizeof(element) a multiple
// of 16. Returns the CUDA error of the launches; a tile beyond the card's
// shared memory is refused there and never runs.
int streamsvm_scan_resident(const void* X, const void* Y, void* G, void* W, void* R, void* XI2,
                            void* M, const void* CINV, const void* GAIN, const void* LA,
                            void* BUF, int n, int n_valid, int d, int bp, int l_max, int mpc,
                            int vec16, int bf16, void* stream) {
  if (n <= 0 || d <= 0 || bp <= 0 || (mpc != 4 && mpc != 8) || bp % mpc != 0 || l_max < 0 ||
      l_max > LMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_res<__nv_bfloat16>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d,
                                       bp, l_max, mpc, vec16, s);
  return dispatch_res<float>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d, bp,
                             l_max, mpc, vec16, s);
}

// B3's small layout: one CTA for each of the first n_live lanes (the rest
// are padding, left as they are); the windows in shared memory when
// win_smem != 0, else in BUF (bp * l_max * d floats, as
// streamsvm_scan_lookahead). Other arguments as streamsvm_scan_resident.
int streamsvm_scan_lookahead_small(const void* X, const void* Y, void* G, void* W, void* R,
                                   void* XI2, void* M, const void* CINV, const void* GAIN,
                                   const void* LA, void* BUF, int n, int n_valid, int d,
                                   int n_live, int l_max, int win_smem, int vec16, int bf16,
                                   void* stream) {
  if (n <= 0 || d <= 0 || n_live <= 0 || l_max < 1 || l_max > LMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_small<__nv_bfloat16>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid,
                                       d, n_live, l_max, win_smem, vec16, s);
  return launch_small<float>(X, Y, G, W, R, XI2, M, CINV, GAIN, LA, BUF, n, n_valid, d, n_live,
                             l_max, win_smem, vec16, s);
}

// Dynamic shared memory the resident and small layouts request.
long streamsvm_scan_resident_dyn_bytes(int d, int mpc, int look, int bf16) {
  return (long)res_dyn_bytes(d, mpc, look, bf16);
}
long streamsvm_scan_small_dyn_bytes(int d, int l_max, int win_smem, int bf16) {
  return (long)small_dyn_bytes(d, l_max, win_smem, bf16);
}

}  // extern "C"
