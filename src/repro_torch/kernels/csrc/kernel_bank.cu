// R1 on Hopper: the kernelized bank's core-set row recursion over one
// stream tile, with a plain C interface (bound from Python with ctypes).
//
// Replaces row_body in src/repro/core/kernel_bank.py (the lax.scan over a
// tile's block_n rows inside _fit_kernel_bank; no pl.pallas_call there). As
// eager torch on the card each row would cost some twenty small launches,
// over a million per pass at the bank's full width; here a tile is one
// launch.
//
// Layout. One warp per model walks the tile's rows in order. The model's S
// core-set slots, padded to a power of two sp, are spread over the lanes:
// slot lane + 32 j is the lane's slot j. Each slot has its coef, idx and
// in-tile row, and per row its kernel value, a product and a score. Where
// they live depends on S alone:
//   registers       sp <= 256 (J = sp / 32 <= 8 slots a lane, or one slot
//                   for sp <= 32; RegSlots, rows_kernel);
//   device memory   sp > 256: a (B, 6, sp) scratch the wrapper allocates,
//                   one model's row of it per warp (MemSlots,
//                   rows_wide_kernel).
// Both launch WARPS = 4 models per CTA and run the same row body. A lane
// touches only its own slots, so neither needs a barrier.
// Every lane computes the model's scalars (q, r, xi2, m) identically, so the
// row loop needs no barrier either. Per row:
//   kv  = K_tt[intile, i] for a slot filled earlier in this tile, else
//         K_cs[i, b, slot];
//   g   = sum coef * kv, a halving tree over the slots padded with zeros to
//         a power of two (in-lane levels, then shuffles);
//   d^2 = q - 2 y g + K_tt[i, i] + xi2 + 1/C, dist = sqrt(max(d^2, 1e-12));
//   the deferred seed (m == 0 forces s = 1), dist >= r, the slot choice and
//   the coef / idx / q / r / xi2 / m updates.
// The slot choice is a warp argmin with ties to the lowest slot: the
// smallest |coef| (free slots hold coef 0), or for "farthest-point" the
// smallest squared center distance q - 2 sign(coef) (Kbb coef) + Kbb_ss
// (free slots -inf), each Kbb row's product again a halving tree. Kbb, the
// (B, S, S) buffer Gram, lives in global memory (L2 at full width) and gets
// the replaced slot's row, column and diagonal after each insertion; a
// __syncwarp orders those writes before the next row reads them.
//
// Arithmetic. Every operation is rounded on its own (__fmul_rn, __fadd_rn,
// ...: no contraction into FMAs), in the order the plain version
// (kernel_bank_rows_plain) evaluates it, and the reductions are the same
// trees, so on the same K blocks the two agree bit for bit, wherever the
// slots live. A row that is inert (sign 0, or past the tile's valid rows)
// or does not update is skipped: its update is an exact no-op in the
// reference.
//
// Bound. It reads K_cs once (block_n B S f32, 39.3 MB per tile at B = 600,
// S = 64, block_n = 256) and K_tt, and writes the (B, S) state: ~12 us per
// tile at 3.35 TB/s; "farthest-point" adds 2 S^2 operations per updated row
// and model. Each warp's row chain (shuffles, a square root and a division
// per row) is latency-bound; 150 CTAs at B = 600 leave most SMs with one.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;         // models per CTA
constexpr int MAX_REG_SP = 256;  // padded slots held in registers
constexpr int SLOT_WORDS = 6;    // c, ix, it, kv, v, score per slot
constexpr unsigned FULL = 0xffffffffu;

// A lane's J slots in registers (all indices static once unrolled).
template <int J_>
struct RegSlots {
  static constexpr int J = J_;
  float c_[J], kv_[J], v_[J], sc_[J];
  int ix_[J], it_[J];
  __device__ __forceinline__ int nj() const { return J; }
  __device__ __forceinline__ float& c(int j) { return c_[j]; }
  __device__ __forceinline__ float& kv(int j) { return kv_[j]; }
  __device__ __forceinline__ float& v(int j) { return v_[j]; }
  __device__ __forceinline__ float& sc(int j) { return sc_[j]; }
  __device__ __forceinline__ int& ix(int j) { return ix_[j]; }
  __device__ __forceinline__ int& it(int j) { return it_[j]; }
};

// A lane's sp / 32 slots in device memory: the warp's six arrays of sp
// words, slot lane + 32 j at index lane + 32 j.
struct MemSlots {
  float* base;  // the warp's 6 sp words, offset by the lane
  int sp;
  __device__ __forceinline__ int nj() const { return sp / 32; }
  __device__ __forceinline__ float& c(int j) { return base[32 * j]; }
  __device__ __forceinline__ float& kv(int j) { return base[sp + 32 * j]; }
  __device__ __forceinline__ float& v(int j) { return base[2 * sp + 32 * j]; }
  __device__ __forceinline__ float& sc(int j) { return base[3 * sp + 32 * j]; }
  __device__ __forceinline__ int& ix(int j) { return reinterpret_cast<int*>(base)[4 * sp + 32 * j]; }
  __device__ __forceinline__ int& it(int j) { return reinterpret_cast<int*>(base)[5 * sp + 32 * j]; }
};

// Sum of v over the padded slots (sp of them, a power of two) by the halving
// tree x[t] += x[t + h], h = sp/2 ... 1; the result on every lane. With more
// than one slot per lane, sp is 32 nj, so the levels h >= 32 are the in-lane
// ones (slot j += slot j + h/32).
template <class Sl>
__device__ __forceinline__ float tree_sum(Sl& sl, int sp) {
#pragma unroll
  for (int hj = sl.nj() / 2; hj >= 1; hj /= 2)
#pragma unroll
    for (int j = 0; j < hj; ++j) sl.v(j) = __fadd_rn(sl.v(j), sl.v(j + hj));
  float x = sl.v(0);
  for (int h = (sp < 32 ? sp : 32) >> 1; h >= 1; h >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(FULL, x, h));
  return __shfl_sync(FULL, x, 0);
}

// First minimum of the scores over the slots: (value, slot) ordered by
// value, then slot.
template <class Sl>
__device__ __forceinline__ int warp_argmin(Sl& sl, int lane) {
  float best = sl.sc(0);
  int arg = lane;
#pragma unroll
  for (int j = 1; j < sl.nj(); ++j)
    if (sl.sc(j) < best) {
      best = sl.sc(j);
      arg = lane + 32 * j;
    }
  for (int off = 16; off >= 1; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, arg, off);
    if (ov < best || (ov == best && oi < arg)) {
      best = ov;
      arg = oi;
    }
  }
  return arg;
}

__device__ __forceinline__ float sign_of(float x) {
  return (float)(0.f < x) - (float)(x < 0.f);  // torch.sign: 0 for +-0
}

// The recursion of model bi over the tile, on the lane's slots sl.
template <class Sl>
__device__ __forceinline__ void rows(Sl& sl, int bi, int lane, const float* __restrict__ kcs,
                                     const float* __restrict__ ktt, const float* __restrict__ y,
                                     const float* __restrict__ c_inv,
                                     const float* __restrict__ gain, int* idx, float* coef,
                                     float* q, float* r, float* xi2, int* m, float* kbb, int b,
                                     int s_size, int sp, int bn, int n_valid, int base) {
  const bool farthest = kbb != nullptr;
#pragma unroll
  for (int j = 0; j < sl.nj(); ++j) {
    const int t = lane + 32 * j;
    const bool live = t < s_size;
    sl.c(j) = live ? coef[(long)bi * s_size + t] : 0.f;
    sl.ix(j) = live ? idx[(long)bi * s_size + t] : -1;
    sl.it(j) = -1;
  }
  float q_ = q[bi], r_ = r[bi], xi2_ = xi2[bi];
  int m_ = m[bi];
  const float ci = c_inv[bi], gn = gain[bi];
  float* kb = farthest ? kbb + (long)bi * s_size * s_size : nullptr;

  for (int i = 0; i < n_valid; ++i) {
    const float yn = y[(long)bi * bn + i];
    if (yn == 0.f) continue;  // inert row
#pragma unroll
    for (int j = 0; j < sl.nj(); ++j) {
      const int t = lane + 32 * j;
      sl.kv(j) = t >= s_size ? 0.f
                 : sl.it(j) >= 0 ? ktt[(long)sl.it(j) * bn + i]
                                 : kcs[((long)i * b + bi) * s_size + t];
      sl.v(j) = __fmul_rn(sl.c(j), sl.kv(j));
    }
    const float g = tree_sum(sl, sp);
    const float kd = ktt[(long)i * bn + i];
    const bool seed = m_ == 0;
    float d2 = __fsub_rn(q_, __fmul_rn(__fmul_rn(2.f, yn), g));
    d2 = __fadd_rn(__fadd_rn(__fadd_rn(d2, kd), xi2_), ci);
    const float dist = __fsqrt_rn(d2 < 1e-12f ? 1e-12f : d2);
    const bool upd = !seed && dist >= r_;
    if (!seed && !upd) continue;
    const float s =
        seed ? 1.f : __fmul_rn(0.5f, __fsub_rn(1.f, __fdiv_rn(r_, dist)));

    if (farthest) {
#pragma unroll
      for (int j = 0; j < sl.nj(); ++j) sl.sc(j) = CUDART_INF_F;
      for (int u = 0; u < s_size; ++u) {
#pragma unroll
        for (int j = 0; j < sl.nj(); ++j) {
          const int t = lane + 32 * j;
          sl.v(j) = t < s_size ? __fmul_rn(kb[(long)u * s_size + t], sl.c(j)) : 0.f;
        }
        const float gs = tree_sum(sl, sp);
#pragma unroll
        for (int j = 0; j < sl.nj(); ++j)
          if (lane + 32 * j == u)
            sl.sc(j) = sl.ix(j) >= 0
                ? __fadd_rn(__fsub_rn(q_, __fmul_rn(__fmul_rn(2.f, sign_of(sl.c(j))), gs)),
                            kb[(long)u * s_size + u])
                : -CUDART_INF_F;
      }
    } else {
#pragma unroll
      for (int j = 0; j < sl.nj(); ++j)
        sl.sc(j) = lane + 32 * j < s_size ? fabsf(sl.c(j)) : CUDART_INF_F;
    }
    const int slot = warp_argmin(sl, lane);

    if (farthest) {  // the slot's row and column become kv, its diagonal k(x_i, x_i)
#pragma unroll
      for (int j = 0; j < sl.nj(); ++j) {
        const int t = lane + 32 * j;
        if (t < s_size) {
          const float v = t == slot ? kd : sl.kv(j);
          kb[(long)slot * s_size + t] = v;
          kb[(long)t * s_size + slot] = v;
        }
      }
      __syncwarp();
    }
    const float om = __fsub_rn(1.f, s);
#pragma unroll
    for (int j = 0; j < sl.nj(); ++j) {
      sl.c(j) = __fmul_rn(sl.c(j), om);
      if (lane + 32 * j == slot) {
        sl.c(j) = __fmul_rn(s, yn);
        sl.ix(j) = base + i;
        sl.it(j) = i;
      }
    }
    const float a1 = __fmul_rn(__fmul_rn(om, om), q_);
    const float a2 = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, s), om), yn), g);
    const float a3 = __fmul_rn(__fmul_rn(s, s), kd);
    q_ = __fadd_rn(__fadd_rn(a1, a2), a3);
    if (upd) r_ = __fadd_rn(r_, __fmul_rn(0.5f, __fsub_rn(dist, r_)));
    xi2_ = __fadd_rn(__fmul_rn(xi2_, __fmul_rn(om, om)), __fmul_rn(__fmul_rn(s, s), gn));
    m_ += 1;
  }

#pragma unroll
  for (int j = 0; j < sl.nj(); ++j) {
    const int t = lane + 32 * j;
    if (t < s_size) {
      coef[(long)bi * s_size + t] = sl.c(j);
      idx[(long)bi * s_size + t] = sl.ix(j);
    }
  }
  if (lane == 0) {
    q[bi] = q_;
    r[bi] = r_;
    xi2[bi] = xi2_;
    m[bi] = m_;
  }
}

#define ROWS_PARAMS                                                                          \
  const float *__restrict__ kcs, const float *__restrict__ ktt, const float *__restrict__ y, \
      const float *__restrict__ c_inv, const float *__restrict__ gain, int *idx, float *coef, \
      float *q, float *r, float *xi2, int *m, float *kbb, int b, int s_size, int sp, int bn,   \
      int n_valid, int base
#define ROWS_ARGS \
  kcs, ktt, y, c_inv, gain, idx, coef, q, r, xi2, m, kbb, b, s_size, sp, bn, n_valid, base

template <int J>
__global__ void __launch_bounds__(32 * WARPS) rows_kernel(ROWS_PARAMS) {
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bi >= b) return;  // whole warps only
  RegSlots<J> sl;
  rows(sl, bi, lane, ROWS_ARGS);
}

// sp > MAX_REG_SP: each warp's slots in its model's (6, sp) rows of scratch.
__global__ void __launch_bounds__(32 * WARPS) rows_wide_kernel(ROWS_PARAMS, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bi >= b) return;
  MemSlots sl{scratch + (long)bi * SLOT_WORDS * sp + lane, sp};
  rows(sl, bi, lane, ROWS_ARGS);
}

int padded(int s_size) {
  int sp = 1;
  while (sp < s_size) sp <<= 1;
  return sp;
}

}  // namespace

extern "C" {

// Device-memory scratch the launch needs for B models of S slots (0 while
// the slots fit in registers, S <= 256).
long kernel_bank_rows_scratch_bytes(int b, int s_size) {
  const int sp = padded(s_size);
  return sp <= MAX_REG_SP ? 0 : (long)b * SLOT_WORDS * sp * sizeof(float);
}

// Advance the (B, S) core-set state over one tile, in place. kcs (bn, B, S),
// ktt (bn, bn), y (B, bn) signs; rows >= n_valid are inert; base is the
// stream index of the tile's row 0. kbb (B, S, S) for "farthest-point",
// null for "smallest-coef". scratch holds kernel_bank_rows_scratch_bytes.
// Returns the CUDA error code of the launch.
int kernel_bank_rows(const float* kcs, const float* ktt, const float* y,
                     const float* c_inv, const float* gain, int* idx,
                     float* coef, float* q, float* r, float* xi2, int* m,
                     float* kbb, int b, int s_size, int bn, int n_valid,
                     int base, float* scratch, cudaStream_t stream) {
  if (s_size < 1) return (int)cudaErrorInvalidValue;
  if (b <= 0 || n_valid <= 0) return 0;
  const int sp = padded(s_size);
  const dim3 grid((b + WARPS - 1) / WARPS), block(32 * WARPS);
  if (sp <= 32)
    rows_kernel<1><<<grid, block, 0, stream>>>(ROWS_ARGS);
  else if (sp <= 64)
    rows_kernel<2><<<grid, block, 0, stream>>>(ROWS_ARGS);
  else if (sp <= 128)
    rows_kernel<4><<<grid, block, 0, stream>>>(ROWS_ARGS);
  else if (sp <= MAX_REG_SP)
    rows_kernel<8><<<grid, block, 0, stream>>>(ROWS_ARGS);
  else if (scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  else
    rows_wide_kernel<<<grid, block, 0, stream>>>(ROWS_ARGS, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
