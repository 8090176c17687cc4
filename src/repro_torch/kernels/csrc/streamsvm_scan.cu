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

}  // extern "C"
