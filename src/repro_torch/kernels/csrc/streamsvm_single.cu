// B4 on Hopper: one pass of Algorithm 1 for ONE model over a stream of
// label-signed rows, with a plain C interface (bound with ctypes).
//
// Replaces src/repro/kernels/streamsvm_scan.py::_kernel (driven there by
// streamsvm_scan_pallas).
//
// Layout. One model has only the stream axis, and its recursion is
// sequential in the rows, so one CTA of 256 threads walks the whole stream
// in internal blocks of BN = 32 rows. What does not depend on the model
// runs beside it: a pre-pass kernel computes every block's Gram of the
// signed rows, G_jk = <y_j x_j, y_k x_k>, over the whole card, into global
// memory. Per block, the CTA computes g_k = <w, y_k x_k> (8 warps, 4 rows
// each, lanes split D); then, row by row, as in the TPU kernel:
// d^2 = |w|^2 - 2 g_j + G_jj + xi2 + 1/C, the update when d >= r (row
// valid, sign != 0), the rank-1 maintenance of g and the r / xi2 (with the
// slack gain) / |w|^2 / m recursions, and the AXPY w <- (1-s) w + s y_j x_j
// on every updated row (no deferred update). Every thread computes the
// scalar chain identically, lane k of each warp holding g_k, so the row
// loop needs no barrier: g_j and y_j reach all threads by warp shuffle, and
// each thread updates only its own columns of w.
//
// All math is f32 on the CUDA cores (no TF32: it would flip d >= r
// decisions). m is an int32 (the TPU kernel carries it as an f32, exact to
// 2^24). Rows at or past n_valid and rows of sign 0 are inert.
//
// Bound. The stream is read once (N D 4 bytes) and the work is ~5 D flops
// per row, so the card is bound by its memory rate. One CTA on one SM walks
// the whole stream, so this kernel runs far from that bound: per row it
// pays a dependent chain (two shuffles, a sqrt, a divide) and, per block,
// a g pass over D whose global loads are latency-bound. That is the nature
// of a single sequential model; many models at once are B1's and B3's work.
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;       // rows per internal block
constexpr int THREADS = 256; // one CTA
constexpr int WARPS = THREADS / 32;
constexpr int DC = 128;      // feature columns staged per chunk (Gram pre-pass)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// G[blk][j][k] = <y_j x_j, y_k x_k> for the rows of block blk; rows >= n
// read as zero.
__global__ void __launch_bounds__(THREADS)
signed_gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ G, int n, int d) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float ys[BN];
  const int tid = threadIdx.x;
  const int k = tid & 31;
  const int jb = tid >> 5;
  const long row0 = (long)blockIdx.x * BN;
  if (tid < BN) ys[tid] = row0 + tid < n ? Y[row0 + tid] : 0.f;
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < d; d0 += DC) {
    for (int e = tid; e < BN * DC; e += THREADS) {
      const int j = e / DC, c = e % DC;
      const long row = row0 + j;
      const int col = d0 + c;
      xs[j][c] = (row < n && col < d) ? X[row * d + col] * ys[j] : 0.f;
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

// S = [r, xi2, 1/C, gain] and M = [m] are read at the start and r, xi2, m
// written back at the end; W (d,) is updated in place.
__global__ void __launch_bounds__(THREADS)
single_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              const float* __restrict__ G, float* __restrict__ W,
              float* __restrict__ S, int* __restrict__ M, int n, int n_valid,
              int d) {
  __shared__ float gs[BN][BN + 1];
  __shared__ float g0[BN];
  __shared__ float red[WARPS];
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int wp = tid >> 5;

  // |w|^2: strided partial sums, a warp tree, then the warps' sums in
  // order (every thread ends with the same value).
  float part = 0.f;
  for (int c = tid; c < d; c += THREADS) part = fmaf(W[c], W[c], part);
  part = warp_sum(part);
  if (t == 0) red[wp] = part;
  __syncthreads();
  float wsq = 0.f;
  for (int i = 0; i < WARPS; ++i) wsq += red[i];

  float r = S[0], xi2 = S[1];
  const float cinv = S[2], gain = S[3];
  int m = M[0];

  const int nblocks = (n + BN - 1) / BN;
  for (int blk = 0; blk < nblocks; ++blk) {
    const long row0 = (long)blk * BN;
    // g_k = y_k <x_k, w> for the block's rows: warp wp takes rows
    // wp, wp + 8, wp + 16, wp + 24.
    for (int k = wp; k < BN; k += WARPS) {
      const long row = row0 + k;
      float acc = 0.f;
      if (row < n)
        for (int c = t; c < d; c += 32) acc = fmaf(X[row * d + c], W[c], acc);
      acc = warp_sum(acc);
      if (t == 0) g0[k] = row < n ? Y[row] * acc : 0.f;
    }
    for (int e = tid; e < BN * BN; e += THREADS) gs[e / BN][e % BN] = G[row0 * BN + e];
    __syncthreads();

    float g = g0[t];
    const float yrow = row0 + t < n ? Y[row0 + t] : 0.f;
    for (int j = 0; j < BN; ++j) {
      const float gj = __shfl_sync(FULL, g, j);
      const float yj = __shfl_sync(FULL, yrow, j);
      const float gjj = gs[j][j];
      const float d2 = wsq - 2.0f * gj + gjj + xi2 + cinv;
      const float dist = sqrtf(fmaxf(d2, 1e-12f));
      // The same in every thread, so the branch does not diverge.
      if (dist >= r && row0 + j < n_valid && yj != 0.0f) {
        const float s = 0.5f * (1.0f - r / dist);
        const float one_s = 1.0f - s;
        g = one_s * g + s * gs[j][t];
        const float* xr = X + (row0 + j) * d;
        for (int c = tid; c < d; c += THREADS) W[c] = one_s * W[c] + s * (yj * xr[c]);
        wsq = one_s * one_s * wsq + 2.0f * s * one_s * gj + s * s * gjj;
        r = r + 0.5f * (dist - r);
        xi2 = xi2 * one_s * one_s + s * s * gain;
        m += 1;
      }
    }
    __syncthreads();  // every column of w is read by other warps next block
  }
  if (tid == 0) {
    S[0] = r;
    S[1] = xi2;
    M[0] = m;
  }
}

}  // namespace

extern "C" {

// Rows per internal block: the Gram scratch holds ceil(n / BN) * BN * BN
// floats.
int streamsvm_single_block_rows() { return BN; }

// X (n, d) and Y (n,) f32; W (d,) f32 updated in place; S (4,) f32
// [r, xi2, 1/C, gain] with r and xi2 updated; M (1,) int32 updated.
// G is scratch for the block Grams. Returns the CUDA error of the launches
// (0 on success).
int streamsvm_single(const void* X, const void* Y, void* G, void* W, void* S,
                     void* M, int n, int n_valid, int d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (n + BN - 1) / BN;
  signed_gram_kernel<<<nblocks, THREADS, 0, s>>>((const float*)X, (const float*)Y,
                                                 (float*)G, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  single_kernel<<<1, THREADS, 0, s>>>((const float*)X, (const float*)Y,
                                      (const float*)G, (float*)W, (float*)S,
                                      (int*)M, n, n_valid, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
