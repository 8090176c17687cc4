// B5 on Hopper: a tiled Gram block K = epilogue(A B^T) with the linear or
// RBF epilogue fused, with a plain C interface (bound from Python with
// ctypes).
//
// Replaces src/repro/kernels/gram.py::_kernel (gram_pallas), reached through
// repro.kernels.ops.gram: the kernelized bank's K_cs and K_tt blocks on
// every training tile, and predict_kernel_bank's one launch per served step.
//
// Layout. One CTA of 256 threads per TM x TN = 64 x 64 output tile; the grid
// is (ceil(N / 64), ceil(M / 64)). A and B are staged through shared memory
// in k-chunks of BK = 32 columns, stored transposed (k-major) so the inner
// loop reads one A value and one B value per row and column of the thread.
// Each thread keeps a 4 x 4 register micro-tile: rows ty + 16 i and columns
// tx + 16 j, so a warp's B reads hit 16 consecutive banks and its stores are
// 16 consecutive floats. bf16 A is upcast on load; B, the norms, gamma and
// the output are f32.
//
// Order of the sums. Every output element is one f32 sum over d in ascending
// order, acc = acc + a_d b_d with the product and the sum each rounded
// (__fmul_rn, __fadd_rn: no FMA contraction), in every CTA and for every M,
// N: an element's value does not depend on its place in the launch, so a
// launch over a slice of B's rows (the bank's s_tile chunks) gives the same
// bits as the whole launch, and it is the plain version's arithmetic. The
// row norms (row_norms_kernel below) are the same chain over a row with
// itself, so the RBF diagonal K(x, x) is exp(-gamma 0) = 1 exactly, as the
// reference's k(x, x) is. No tensor cores and no TF32: TF32 keeps about
// three digits and would flip the bank's dist >= r and eviction choices.
//
// Epilogue, in registers before the store, with the ragged edges masked:
//   linear  K = acc;
//   rbf     K = exp(-gamma * max(an_i + bn_j - 2 acc, 0)), the row norms
//           passed in (as gram_pallas takes them) and gamma an argument, so
//           a gamma sweep needs no rebuild. The clamp keeps NaN (as jnp's
//           maximum does) and the arithmetic is rounded op by op, as the
//           plain version computes it.
//
// Bound. 2 M N D operations against (M + N) D + M N f32 bytes: at the
// bank's K_cs launch (256 x 38,400 x 784) the card is bound by its f32 rate
// (0.23 ms at 67 TFLOP/s, counting a multiply and an add as two). This
// simple kernel issues each multiply and add on its own (the rounding the
// plain version has) and is held back by its shared-memory reads (eight per
// sixteen products); wgmma has no f32 mode without TF32, so a faster kernel
// would split f32 into TF32 parts or raise the register tile, later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;  // output rows per CTA
constexpr int TN = 64;  // output columns per CTA
constexpr int BK = 32;  // feature columns staged per chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ an, const float* __restrict__ bn,
            int m, int n, int d, int rbf, float gamma,
            float* __restrict__ out) {
  __shared__ float as[BK][TM + 1];
  __shared__ float bs[BK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long row0 = (long)blockIdx.y * TM;
  const long col0 = (long)blockIdx.x * TN;
  // Staging: each thread moves 8 values of A and 8 of B per chunk, a warp
  // reading 32 consecutive feature columns of one row.
  const int lc = tid & 31, lr = tid >> 5;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int kmax = d - k0 < BK ? d - k0 : BK;
#pragma unroll
    for (int p = 0; p < TM / 8; ++p) {
      const int r = lr + 8 * p;
      const long ra = row0 + r, rb = col0 + r;
      as[lc][r] = (lc < kmax && ra < m) ? ld(A, ra * d + k0 + lc) : 0.f;
      bs[lc][r] = (lc < kmax && rb < n) ? B[rb * d + k0 + lc] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kmax; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long r = row0 + ty + 16 * i;
    if (r >= m) continue;
    const float ar = rbf ? an[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long c = col0 + tx + 16 * j;
      if (c >= n) continue;
      float v = acc[i][j];
      if (rbf) {
        float d2 = __fsub_rn(__fadd_rn(ar, bn[c]), __fmul_rn(2.f, v));
        d2 = d2 < 0.f ? 0.f : d2;  // max(d2, 0), NaN kept
        v = expf(__fmul_rn(-gamma, d2));
      }
      out[r * n + c] = v;
    }
  }
}

// norms[i] = sum_d x_id x_id over d ascending, each step rounded as the
// Gram's chain; one thread per row.
template <typename T>
__global__ void row_norms_kernel(const T* __restrict__ X, int n, int d,
                                 float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int k = 0; k < d; ++k) {
    const float v = ld(X, i * d + k);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// out (n,) = squared row norms of X (n, d), f32 or (x_bf16) bf16.
int gram_row_norms(const void* X, int n, int d, float* out, int x_bf16,
                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (x_bf16)
    row_norms_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)X, n, d, out);
  else
    row_norms_kernel<float><<<blocks, threads, 0, stream>>>((const float*)X, n, d, out);
  return (int)cudaGetLastError();
}

// K (m, n) = epilogue(A (m, d) B (n, d)^T); an (m,), bn (n,) row norms
// (read only for rbf). a_bf16: A is bf16, else f32. Returns the CUDA error
// code of the launch (0 on success).
int gram(const void* A, const float* B, const float* an, const float* bn,
         int m, int n, int d, int rbf, float gamma, float* out, int a_bf16,
         cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  if (a_bf16)
    gram_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)A, B, an, bn, m, n, d, rbf, gamma, out);
  else
    gram_kernel<float><<<grid, THREADS, 0, stream>>>(
        (const float*)A, B, an, bn, m, n, d, rbf, gamma, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
