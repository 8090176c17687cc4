// B5 on Hopper: a tiled Gram block K = epilogue(A B^T) with the linear or
// RBF epilogue fused, with a plain C interface (bound from Python with
// ctypes).
//
// Replaces src/repro/kernels/gram.py::_kernel (gram_pallas), reached through
// repro.kernels.ops.gram: the kernelized bank's K_cs and K_tt blocks on
// every training tile, and predict_kernel_bank's one launch per served step.
//
// The product is tile_product.cuh's walk, the body B2 and B6 serve run: one
// CTA of 128 threads per output tile, 128 x 64 (large: 8 x 8 per thread, BK
// 16) where the launch gives at least two CTAs per SM, else 32 x 64 (small:
// 4 x 4, BK 32); A and B pass row-major through a 3-stage cp.async arena of
// 46,080 B with float4 shared reads, 16-byte copies where D and the pointers
// allow, bf16 A upcast on load. The grid is (ceil(N / 64), ceil(M / BM)); the
// K_cs launch and every served step (256 x 38,400 x 784) run 2 x 600 large
// CTAs, about 4.5 waves of two per SM.
//
// Order of the sums. Every element is one fmaf chain acc = fmaf(a_d, b_d,
// acc) over d ascending from 0.f, the ragged last step walking only the
// valid columns, in every CTA and for every M, N and tile: an element's value
// does not depend on its place in the launch, so a launch over a slice of B's
// rows (the bank's s_tile chunks) gives the bits of the whole launch, and
// linear B5 equals B2's scores on the same operands. The row norms
// (row_norms_kernel below) are the same chain over a row with itself, so
// K(x, x)'s accumulator equals |x|^2 bit for bit, d^2 = (n + n) - 2 n is 0
// exactly, and the RBF diagonal is exp(-gamma 0) = 1, as the reference's
// k(x, x) is. The plain version (gram_plain) computes the same fmaf chain on
// any device by an exact float64 emulation. No tensor cores, no TF32, no
// split over k: they change the bits, and the bank's dist >= r and eviction
// choices depend on them.
//
// Epilogue, in registers before the store, with the ragged edges masked:
//   linear  K = acc;
//   rbf     K = exp(-gamma * max(an_i + bn_j - 2 acc, 0)), the row norms
//           passed in (as gram_pallas takes them) and gamma an argument, so
//           a gamma sweep needs no rebuild. The clamp keeps NaN (as jnp's
//           maximum does) and the arithmetic is rounded op by op, as the
//           plain version computes it, so an element's value stays
//           independent of its place.
//
// Bound. 2 M N D operations (a fused multiply-add counted as two) against
// (M + N) D + M N f32 bytes: at the K_cs launch the card is bound by its f32
// rate, 0.23 ms at 67 TFLOP/s; at 10,000 x 38,400 x 784 9.0 ms. The walk's
// 8 x 8 tile makes 16 float4 shared loads per 256 fmaf, and its 220-255
// registers hold two CTAs per SM.
#include "tile_product.cuh"

namespace {

constexpr int NORM_ROWS = 128;  // rows per CTA of row_norms_kernel, one per thread
constexpr int NORM_BK = 32;     // columns per staged chunk

// VEC (16-byte copies) and RBF are template arguments: a kernel without the
// branches it does not take holds fewer registers (measured: 8 % faster at
// 10,000 x 38,400 x 784 on the H100).
template <class Tl, typename T, bool VEC, bool RBF>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ an, const float* __restrict__ bn, int m, int n, int d,
            float gamma, float* __restrict__ out) {
  __shared__ __align__(16) float arena[ARENA_FLOATS];
  const long row0 = (long)blockIdx.y * Tl::BM;
  const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
  walk<Tl>(A, B, m, n, d, row0, blockIdx.x, blockIdx.x + 1, VEC, arena,
           [&](int c0, const float (&acc)[Tl::TM][Tl::TN]) {
#pragma unroll
             for (int i = 0; i < Tl::TM; ++i) {
               const long r = row0 + ty + i * Tl::TY;
               if (r >= m) continue;
               const float ar = RBF ? an[r] : 0.f;
#pragma unroll
               for (int j = 0; j < Tl::TN; ++j) {
                 const int c = c0 + tx + j * Tl::TX;
                 if (c >= n) continue;
                 float v = acc[i][j];
                 if (RBF) {
                   float d2 = __fsub_rn(__fadd_rn(ar, bn[c]), __fmul_rn(2.f, v));
                   d2 = d2 < 0.f ? 0.f : d2;  // max(d2, 0), NaN kept
                   v = expf(__fmul_rn(-gamma, d2));
                 }
                 out[r * n + c] = v;
               }
             }
           });
}

// norms[i] = the Gram's chain over row i with itself. A CTA stages 128 rows
// 32 columns at a time through shared memory, then each thread runs its own
// row's chain over the chunk (rows padded to 33 floats: no bank conflicts).
// Where D is a multiple of 4 and X is f32 and 16-byte aligned, each thread
// copies eight 16-byte pieces per chunk (a warp reads four rows' whole
// 128-byte runs), loading the next chunk into registers before it runs the
// current one's chain; otherwise element by element.
constexpr int NORM_PIECES = NORM_ROWS * NORM_BK / 4 / NORM_ROWS;  // 16-byte pieces a thread

// Piece p of this thread in the chunk at column k0: row rr + 16 p, columns
// cc .. cc + 3 (zeros past n rows or d columns).
__device__ __forceinline__ void fetch_norm_chunk(float4 (&v)[NORM_PIECES], const float* X, int n,
                                                 int d, long r0, int rr, int cc, int k0) {
#pragma unroll
  for (int p = 0; p < NORM_PIECES; ++p) {
    const long r = r0 + rr + 16 * p;
    v[p] = r < n && k0 + cc < d ? *reinterpret_cast<const float4*>(X + r * d + k0 + cc)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NORM_ROWS)
row_norms_kernel(const T* __restrict__ X, int n, int d, float* __restrict__ out) {
  __shared__ float xs[NORM_ROWS][NORM_BK + 1];
  const int tid = threadIdx.x;
  const long r0 = (long)blockIdx.x * NORM_ROWS;
  float acc = 0.f;
  if constexpr (VEC) {  // T is float
    const int rr = tid / 8, cc = tid % 8 * 4;
    float4 v[NORM_PIECES];
    fetch_norm_chunk(v, X, n, d, r0, rr, cc, 0);
    for (int k0 = 0; k0 < d; k0 += NORM_BK) {
#pragma unroll
      for (int p = 0; p < NORM_PIECES; ++p) {
        float* x = &xs[rr + 16 * p][cc];
        x[0] = v[p].x;
        x[1] = v[p].y;
        x[2] = v[p].z;
        x[3] = v[p].w;
      }
      __syncthreads();
      if (k0 + NORM_BK < d)  // in flight during the chain
        fetch_norm_chunk(v, X, n, d, r0, rr, cc, k0 + NORM_BK);
      const int kv = min(NORM_BK, d - k0);
      for (int c = 0; c < kv; ++c) acc = fmaf(xs[tid][c], xs[tid][c], acc);
      __syncthreads();  // xs is rewritten by the next chunk
    }
  } else {
    for (int k0 = 0; k0 < d; k0 += NORM_BK) {
      const int kv = min(NORM_BK, d - k0);
      for (int e = tid; e < NORM_ROWS * NORM_BK; e += NORM_ROWS) {
        const int r = e / NORM_BK, c = e % NORM_BK;
        if (c < kv && r0 + r < n) xs[r][c] = Op<T>::ld1(X + (r0 + r) * d + k0 + c);
      }
      __syncthreads();
      for (int c = 0; c < kv; ++c) acc = fmaf(xs[tid][c], xs[tid][c], acc);
      __syncthreads();
    }
  }
  if (r0 + tid < n) out[r0 + tid] = acc;
}

template <class Tl, typename T, bool VEC, bool RBF>
void launch_as(const void* A, const float* B, const float* an, const float* bn, int m, int n,
               int d, float gamma, float* out, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + Tl::BM - 1) / Tl::BM);
  gram_kernel<Tl, T, VEC, RBF><<<grid, THREADS, 0, s>>>((const T*)A, B, an, bn, m, n, d, gamma,
                                                        out);
}

template <class Tl, typename T>
int launch(const void* A, const float* B, const float* an, const float* bn, int m, int n,
           int d, int rbf, float gamma, float* out, cudaStream_t s) {
  const bool vec = vectorized<T>(A, B, d);
  if (vec && rbf) launch_as<Tl, T, true, true>(A, B, an, bn, m, n, d, gamma, out, s);
  else if (vec) launch_as<Tl, T, true, false>(A, B, an, bn, m, n, d, gamma, out, s);
  else if (rbf) launch_as<Tl, T, false, true>(A, B, an, bn, m, n, d, gamma, out, s);
  else launch_as<Tl, T, false, false>(A, B, an, bn, m, n, d, gamma, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n,) = squared row norms of X (n, d), f32 or (x_bf16) bf16.
int gram_row_norms(const void* X, int n, int d, float* out, int x_bf16,
                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + NORM_ROWS - 1) / NORM_ROWS;
  if (x_bf16)
    row_norms_kernel<__nv_bfloat16, false><<<blocks, NORM_ROWS, 0, stream>>>(
        (const __nv_bfloat16*)X, n, d, out);
  else if (d % 4 == 0 && (size_t)X % 16 == 0)
    row_norms_kernel<float, true><<<blocks, NORM_ROWS, 0, stream>>>((const float*)X, n, d, out);
  else
    row_norms_kernel<float, false><<<blocks, NORM_ROWS, 0, stream>>>((const float*)X, n, d, out);
  return (int)cudaGetLastError();
}

// K (m, n) = epilogue(A (m, d) B (n, d)^T); an (m,), bn (n,) row norms
// (read only for rbf). a_bf16: A is bf16, else f32. The tile is chosen from
// M and N alone. Returns the CUDA error code of the launch (0 on success).
int gram(const void* A, const float* B, const float* an, const float* bn,
         int m, int n, int d, int rbf, float gamma, float* out, int a_bf16,
         cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const bool large = fills_card((long)((m + LARGE_BM - 1) / LARGE_BM) * ((n + BN - 1) / BN));
#define GRAM_ARGS A, B, an, bn, m, n, d, rbf, gamma, out, stream
  if (a_bf16)
    return large ? launch<Large, __nv_bfloat16>(GRAM_ARGS) : launch<Small, __nv_bfloat16>(GRAM_ARGS);
  return large ? launch<Large, float>(GRAM_ARGS) : launch<Small, float>(GRAM_ARGS);
#undef GRAM_ARGS
}

}  // extern "C"
