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

}  // extern "C"
