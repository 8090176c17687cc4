// P2 on Hopper, its step form: one sweep of Pegasos (the primal
// sub-gradient SVM of Shalev-Shwartz et al.) over a stream, in steps of k
// rows, with a plain C interface (bound with ctypes). The walk
// (csrc/streamsvm_single.cu, pegasos_single) is P2's layout where
// kernels.baselines.pegasos_plan takes it (k up to PEGASOS_WALK_MAX_K);
// this form runs the larger k.
//
// Replaces no TPU kernel: the reference computes it as a lax.scan over the
// steps (src/repro/baselines/pegasos.py:28-42), which an eager loop would
// pay in ~6 launches a step. Step t (of T = n / k) with
// eta = 1 / (lam (t + 1)):
//   viol_r = y_r <w, x_r> < 1 for the step's k rows, all against the same w;
//   w <- (1 - eta lam) w + (-eta / k) sum_r -(viol_r y_r) x_r;
//   w <- w min(1, (1 / sqrt(lam)) / max(|w|, 1e-12)).
// The scalars are computed in f32 with the reference's operations, each
// rounded on its own (no contraction into fma), so the kernel's and the
// plain version's step scalars are the same bits; so are the element-wise
// updates, whose products by viol_r y_r in {-1, 0, 1} are exact. Only the
// dot products and |w| sum in another order.
//
// Layout. The steps are sequential, so one CTA of 256 threads walks them.
// "staged" (STAGED): w in shared memory, and the stream in a ring of two
// slots of one step's k rows (and their signs), each filled by cp.async
// (16-byte copies where rows are 16-byte aligned, else 4-byte ones) one
// step ahead of its use: a step waits on its reductions and barriers, not
// on its copy, so a deeper ring buys nothing. "in place": w in device memory
// and the rows read where they lie, for a w or a step that does not fit.
// Per step: the k margins on the warps (a warp a row, lane-strided columns,
// one fmaf chain a lane and a fixed xor tree), a barrier, the masked
// update and |w|^2's partial sums (a thread a column, every 256th), a warp
// tree and a barrier, the projection. Three barriers a step.
//
// Bound. The stream is read once (n d 4 bytes) and each step does ~4 k d
// flops, so the card is bound by its memory rate. One CTA on one SM walks
// the steps, so the kernel runs far from that bound: it pays a dependent
// chain of reductions and barriers a step, while the copies run ahead.
// The walk defers the step's decay instead and pays one round a step with
// a violation.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING = 2;  // slots of the staged layout's ring
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until every group has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ inline int wpitch(int d) { return (d + 7) / 8 * 8; }

// Dynamic shared memory of pegasos_kernel, in bytes. Staged: the ring of
// RING steps' rows (k d floats each) and signs (k each), w (its pitch),
// the step's -(viol y) (k), the warps' partial sums. In place: the last two.
size_t pegasos_dyn_bytes(int d, int k, bool staged) {
  const size_t fixed = (size_t)k + WARPS;
  if (!staged) return sizeof(float) * fixed;
  return sizeof(float) * ((size_t)RING * k * d + (size_t)RING * k + wpitch(d) + fixed);
}

// X (T k, d), Y (T k,) f32; W (d,) f32, the start, updated in place; F
// (T k,) uint8 each row's violation, or null. lam: the regularizer.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
pegasos_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* __restrict__ W,
               unsigned char* __restrict__ F, int steps, int k, int d, float lam, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wp = tid >> 5;
  const long step_floats = (long)k * d;
  float* xs = smem;                                          // [RING][k][d]
  float* ys = xs + (STAGED ? RING * step_floats : 0);        // [RING][k]
  float* w = STAGED ? ys + RING * k : W;                     // [wpitch(d)]
  float* nvy = STAGED ? w + wpitch(d) : smem;                // [k]: -(viol y)
  float* part = nvy + k;                                     // [WARPS]

  // Start the copy of step u's rows and signs into slot u % RING, and
  // close the group.
  auto stage = [&](int u) {
    if (u < steps) {
      float* dst = xs + (long)(u % RING) * step_floats;
      const float* src = X + (long)u * step_floats;
      if (vec16) {
        for (long e = tid; e < step_floats / 4; e += THREADS)
          cp_async16(dst + 4 * e, src + 4 * e);
      } else {
        for (long e = tid; e < step_floats; e += THREADS) cp_async4(dst + e, src + e);
      }
      for (int r = tid; r < k; r += THREADS)
        cp_async4(ys + (u % RING) * k + r, Y + (long)u * k + r);
    }
    cp_async_commit();
  };

  if (STAGED) {
    stage(0);
    for (int c = tid; c < wpitch(d); c += THREADS) w[c] = c < d ? W[c] : 0.f;
  }
  const float radius = __fdiv_rn(1.0f, __fsqrt_rn(lam));
  const float kf = (float)k;

  for (int t = 0; t < steps; ++t) {
    if (STAGED) cp_async_wait_all();  // step t's group, the only one pending, has landed
    __syncthreads();  // (1) its rows are visible; every thread is past step t - 1
    if (STAGED) stage(t + 1);  // into the slot step t - 1 used
    const float* xt =
        STAGED ? xs + (long)(t % RING) * step_floats : X + (long)t * step_floats;
    const float* yt = STAGED ? ys + (t % RING) * k : Y + (long)t * k;
    const float tf = (float)t;
    const float eta = __fdiv_rn(1.0f, __fmul_rn(lam, __fadd_rn(tf, 1.0f)));
    const float factor = __fsub_rn(1.0f, __fmul_rn(eta, lam));
    const float coef = __fdiv_rn(-eta, kf);

    // The margins against the step's w: a warp a row.
    for (int r = wp; r < k; r += WARPS) {
      const float* xr = xt + (long)r * d;
      float h = 0.f;
      for (int c = lane; c < d; c += 32) h = fmaf(w[c], xr[c], h);
      h = warp_sum(h);
      if (lane == 0) {
        const float y = yt[r];
        const bool viol = __fmul_rn(y, h) < 1.0f;
        nvy[r] = -(viol ? y : 0.f);
        if (F != nullptr) F[(long)t * k + r] = viol;
      }
    }
    __syncthreads();  // (2)

    // The update, a thread a column, and |w|^2's partial sums.
    float q = 0.f;
    for (int c = tid; c < d; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < k; ++r) s = __fadd_rn(s, __fmul_rn(nvy[r], xt[(long)r * d + c]));
      const float v = __fadd_rn(__fmul_rn(factor, w[c]), __fmul_rn(coef, s));
      w[c] = v;
      q = fmaf(v, v, q);
    }
    q = warp_sum(q);
    if (lane == 0) part[wp] = q;
    __syncthreads();  // (3)
    float n2 = 0.f;
    for (int i = 0; i < WARPS; ++i) n2 += part[i];
    const float scale = fminf(1.0f, __fdiv_rn(radius, fmaxf(__fsqrt_rn(n2), 1e-12f)));
    for (int c = tid; c < d; c += THREADS) w[c] = __fmul_rn(w[c], scale);
  }
  if (STAGED) {
    cp_async_wait_all();
    __syncthreads();
    for (int c = tid; c < d; c += THREADS) W[c] = w[c];
  }
}

template <bool STAGED>
int launch(const void* X, const void* Y, void* W, void* F, int steps, int k, int d, float lam,
           int vec16, cudaStream_t s) {
  const size_t dyn = pegasos_dyn_bytes(d, k, STAGED);
  cudaError_t err = cudaFuncSetAttribute((const void*)pegasos_kernel<STAGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  pegasos_kernel<STAGED><<<1, THREADS, dyn, s>>>((const float*)X, (const float*)Y, (float*)W,
                                                 (unsigned char*)F, steps, k, d, lam, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel requests (its only shared memory): the
// staged layout (staged != 0) or the in-place one.
long pegasos_dyn_bytes_c(int d, int k, int staged) {
  return (long)pegasos_dyn_bytes(d, k, staged != 0);
}

// P2: one sweep of Pegasos over `steps` steps of k rows of X (steps k, d)
// f32 with signs Y (steps k,) f32; W (d,) f32 the start, updated in place;
// F (steps k,) uint8 each row's violation, or null. staged: the staged
// layout (nonzero) or the in-place one; vec16: X 16-byte aligned with d a
// multiple of 4. Returns the CUDA error of the launch (0 on success).
int pegasos_sweep(const void* X, const void* Y, void* W, void* F, int steps, int k, int d,
                  float lam, int staged, int vec16, void* stream) {
  if (steps <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return staged ? launch<true>(X, Y, W, F, steps, k, d, lam, vec16, s)
                : launch<false>(X, Y, W, F, steps, k, d, lam, vec16, s);
}

}  // extern "C"
