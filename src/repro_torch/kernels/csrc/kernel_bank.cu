// R1 on Hopper: the kernelized bank's core-set row recursion over one
// stream tile, with a plain C interface (bound from Python with ctypes).
//
// Replaces row_body in src/repro/core/kernel_bank.py (the lax.scan over a
// tile's block_n rows inside _fit_kernel_bank; no pl.pallas_call there). As
// eager torch on the card each row would cost some twenty small launches,
// over a million per pass at the bank's full width; here a tile is one
// launch.
//
// Per row i and model, in the plain version's order (kernel_bank_rows_plain):
//   kv  = K_tt[intile, i] for a slot filled earlier in this tile, else
//         K_cs[i, b, slot];
//   g   = sum coef * kv, a halving tree over the slots padded with zeros to
//         a power of two sp (gram.tree_sum);
//   d^2 = q - 2 y g + K_tt[i, i] + xi2 + 1/C, dist = sqrt(max(d^2, 1e-12));
//   the deferred seed (m == 0 forces s = 1), dist >= r, the slot choice and
//   the coef / idx / q / r / xi2 / m updates.
// The slot choice is a first minimum (ties to the lowest slot): the
// smallest |coef| (free slots hold coef 0), or for "farthest-point" the
// smallest squared center distance q - 2 sign(coef) (Kbb coef) + Kbb_ss
// (free slots -inf), each Kbb row's product again a halving tree. Kbb, the
// (B, S, S) buffer Gram, gets the replaced slot's row, column and diagonal
// after each insertion. A row that is inert (sign 0, or past the tile's
// valid rows) or does not update changes nothing: its update is an exact
// no-op in the reference. So the rows between two updates are independent.
//
// Arithmetic. Every operation is rounded on its own (__fmul_rn, __fadd_rn,
// ...: no contraction into FMAs), in the plain version's order, and every
// sum over slots is the same halving tree, so on the same K blocks every
// layout agrees with the plain version bit for bit.
//
// Layouts (kernels.kernel_bank.rows_plan picks one by bytes, before the
// launch):
//
// "staged" (rows_staged_kernel; sp <= 256, where its shared memory fits
// the budget). One warp per model, 2 consecutive models per CTA (MPC).
// The stream side is staged in 32-row blocks, two in flight: row i's K_cs
// slice of the CTA's models is one contiguous segment, copied by one bulk
// copy of the tensor memory accelerator onto the buffer's mbarrier (4-byte
// cp.async where S is not a multiple of 4) into a row whose pitch is an odd
// number of 16-byte units, so the float4 reads of eight lanes, eight rows
// apart, hit distinct banks. The last warp of the CTA to finish a block
// starts the copy of the block two ahead into its buffer. The model's
// coefs, idx and in-tile rows live in shared memory. Per block, lane l
// takes row l: it patches the row's in-tile slots from K_tt, evaluates g
// for its row against the model's state, then d^2 and dist; one ballot over
// the live rows that act (the seed, or dist >= r) gives the first updating
// row, which the whole warp applies (slot choice across the lanes, coef /
// idx / in-tile updates, the scalars), and the rest of the block is
// evaluated again from the row after it. A block with no acting row costs
// one evaluation and one ballot.
// The lane's g is the plain version's bits. The halving tree over sp leaves
// t ends with (T0 + T2) + (T1 + T3), where Tr is the halving tree over the
// leaves t = 4 j + r, j ascending; and a halving tree over n leaves equals
// the depth-first sum over its leaves in bit-reversed order whose partial
// sums merge like a binary counter, each add taking the earlier subtree and
// the later one (f32 addition commutes exactly). So one float4 read of kv
// and of the coefs feeds the four subtrees at once, and any sp needs only
// 4 log2(sp / 4) partial sums live, all in registers.
// "farthest-point" brings the model's S x S Kbb slab into shared memory on
// its first update in the tile, scores the slots lane-parallel (each lane
// its own slots' Kbb rows, by the same tree), updates the slab in place and
// writes it back at the end of the tile, only where the model updated.
//
// "registers" / "wide" (rows_kernel, rows_wide_kernel: the layouts of the
// first port, for S or budgets the staged layout does not fit). One warp
// per model walks the tile's rows in order with the slots spread over the
// lanes, slot lane + 32 j being the lane's slot j: in registers for
// sp <= 256 (RegSlots), else in a (B, 6, sp) device-memory scratch the
// wrapper allocates (MemSlots). Each row reads its K_cs slice from device
// memory and sums g by shuffles; Kbb stays in device memory, a __syncwarp
// ordering its writes before the next row reads them. 4 models per CTA, no
// shared memory.
//
// Bound. R1 reads K_cs once (block_n B S f32, 39.3 MB per tile at B = 600,
// S = 64, block_n = 256) and K_tt, and writes the (B, S) state: ~12 us per
// tile at 3.35 TB/s; "farthest-point" adds 2 S^2 operations per updated row
// and model, and the S x S Kbb slab read and written once for each model
// that updates in the tile. The staged layout's copies run a block ahead
// of the rows, so a tile costs per block one evaluation of 32 rows (S
// products and sums a lane) and per update one dependent step of the warp;
// the first layouts paid a device-memory read and a shuffle tree per row.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// The staged layout.

constexpr int BLK = 32;             // rows per staged block: one a lane
constexpr int NBUF = 2;             // staged blocks in flight
constexpr int MPC = 2;              // models (warps) per CTA
constexpr int STAGED_MAX_SP = 256;  // padded slots the staged trees unroll
constexpr int HEAD_WORDS = 8;       // NBUF mbarriers, NBUF release counts
constexpr int PATCH = 8;            // in-tile K_tt reads issued together

// S rounded up to whole 16-byte units.
__host__ __device__ inline int quad_up(int s) { return (s + 3) & ~3; }
// w words, or w + 4: whichever is an odd number of 16-byte units.
__host__ __device__ inline int odd_pitch(int w) { return (w / 4) % 2 ? w : w + 4; }

// Word offsets of the staged layout's dynamic shared memory: the header,
// NBUF blocks of BLK rows of rp words (model m's S values at m s4), the
// coefs (MPC x s4), for "farthest-point" the Kbb slabs (MPC x S rows of kp),
// then idx, the in-tile rows and the in-tile list (MPC x s4 ints each).
// Reads past a row or array (the tree's padded leaves, masked) stay inside
// the arrays that follow.
struct Staged {
  int s4, rp, kp;
  long bufs, coefs, slabs, ints, words;
  __host__ __device__ Staged(int s, bool far)
      : s4(quad_up(s)), rp(odd_pitch(MPC * quad_up(s))), kp(odd_pitch(quad_up(s))) {
    bufs = HEAD_WORDS;
    coefs = bufs + (long)NBUF * BLK * rp;
    slabs = coefs + (long)MPC * s4;
    ints = slabs + (far ? (long)MPC * s * kp : 0);
    words = ints + 3L * MPC * s4;
  }
};

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

// sum_t c[t] * kv[t] over t < s, padded with zeros to P leaves, by the
// halving tree of gram.tree_sum (see the header). FULL: s == P. kv and c
// are 16-byte aligned; without FULL the reads run to P - 1 and the leaves
// past s are masked to +0, as the plain version pads.
template <int P, bool FULL>
__device__ __forceinline__ float tree_dot(const float* kv, const float* c, int s) {
  if constexpr (P == 1) {
    return __fmul_rn(c[0], kv[0]);
  } else if constexpr (P == 2) {
    return __fadd_rn(__fmul_rn(c[0], kv[0]), __fmul_rn(c[1], kv[1]));
  } else {
    constexpr int N = P / 4, L = ilog2(N);
    float part[4][L > 0 ? L : 1];  // the open subtrees of each Tr, by level
    float top[4];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = bitrev(k, L);
      const float4 a = *reinterpret_cast<const float4*>(kv + 4 * j);
      const float4 w = *reinterpret_cast<const float4*>(c + 4 * j);
      float v[4] = {__fmul_rn(w.x, a.x), __fmul_rn(w.y, a.y), __fmul_rn(w.z, a.z),
                    __fmul_rn(w.w, a.w)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!FULL && 4 * j + r >= s) v[r] = 0.f;
        float x = v[r];
        int lvl = 0;
#pragma unroll
        for (; lvl < L && ((k >> lvl) & 1); ++lvl) x = __fadd_rn(part[r][lvl], x);
        if (lvl < L)
          part[r][lvl] = x;
        else
          top[r] = x;
      }
    }
    return __fadd_rn(__fadd_rn(top[0], top[2]), __fadd_rn(top[1], top[3]));
  }
}

template <int P>
__device__ __forceinline__ float tree_dot_s(const float* kv, const float* c, int s) {
  return s == P ? tree_dot<P, true>(kv, c, s) : tree_dot<P, false>(kv, c, s);
}

// The warp's first minimum of (score, slot) given each lane's own.
__device__ __forceinline__ int first_min(float best, int arg) {
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

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
// The barrier's arrival when every earlier cp.async of this thread is done.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One tile for the CTA's MPC models, warp w taking model blockIdx.x MPC + w.
// vec: S a multiple of 4 and kcs 16-byte aligned (bulk copies; else 4-byte
// cp.async); kvec: the same for kbb (the slab's copies).
template <int P, bool FAR>
__global__ void __launch_bounds__(32 * MPC) rows_staged_kernel(ROWS_PARAMS, int vec, int kvec) {
  extern __shared__ __align__(16) float smem[];
  const Staged L(s_size, FAR);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);  // [NBUF]
  int* released = reinterpret_cast<int*>(smem + 2 * NBUF);                // [NBUF]
  float* bufs = smem + L.bufs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * MPC;
  const int nm = min(MPC, b - b0);  // the CTA's models
  const int nblk = (n_valid + BLK - 1) / BLK;
  if (threadIdx.x == 0) {
    for (int k = 0; k < NBUF; ++k) {
      mbar_init(full + k, 32);
      released[k] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Block blk of the CTA's models into its buffer, by one warp: 32
  // arrivals on the buffer's barrier, one a lane. Bulk copies: lane l
  // copies row l's segment; 4-byte copies: the lanes spread over each row.
  auto stage = [&](int blk) {
    unsigned long long* bar = full + blk % NBUF;
    float* dst = bufs + (long)(blk % NBUF) * BLK * L.rp;
    if (vec) {
      const int row = blk * BLK + lane;
      if (row < n_valid) {
        const unsigned bytes = 4u * nm * s_size;
        mbar_expect_tx(bar, bytes);
        bulk_copy(dst + lane * L.rp, kcs + ((long)row * b + b0) * s_size, bytes, bar);
      } else {
        mbar_arrive(bar);
      }
    } else {
      for (int rr = 0; rr < BLK && blk * BLK + rr < n_valid; ++rr) {
        const float* src = kcs + ((long)(blk * BLK + rr) * b + b0) * s_size;
        for (int e = lane; e < nm * s_size; e += 32) {
          const int mm = e / s_size;
          cp_async4(dst + rr * L.rp + mm * L.s4 + (e - mm * s_size), src + e);
        }
      }
      cp_async_arrive(bar);
    }
  };
  if (warp == 0)
    for (int k = 0; k < NBUF && k < nblk; ++k) stage(k);
  if (warp >= nm) return;

  const int bi = b0 + warp;
  float* cf = smem + L.coefs + warp * L.s4;
  float* slab = smem + L.slabs + (long)warp * s_size * L.kp;  // FAR only
  int* ix = reinterpret_cast<int*>(smem + L.ints) + warp * L.s4;
  int* it = ix + MPC * L.s4;   // the slot's in-tile row, -1
  int* lst = it + MPC * L.s4;  // the slots filled in this tile, in order
  for (int t = lane; t < L.s4; t += 32) {
    const bool live = t < s_size;
    cf[t] = live ? coef[(long)bi * s_size + t] : 0.f;
    ix[t] = live ? idx[(long)bi * s_size + t] : -1;
    it[t] = -1;
  }
  float q_ = q[bi], r_ = r[bi], xi2_ = xi2[bi];
  int m_ = m[bi];
  const float ci = c_inv[bi], gn = gain[bi];
  float* kb = FAR ? kbb + (long)bi * s_size * s_size : nullptr;
  int nin = 0;             // entries of lst
  bool slab_in = false;    // FAR: the slab is in shared memory (and changed)
  __syncwarp();

  for (int blk = 0; blk < nblk; ++blk) {
    const int i = blk * BLK + lane;  // the lane's row
    const bool in = i < n_valid;
    const float yn = in ? y[(long)bi * bn + i] : 0.f;
    const float kd = in ? ktt[(long)i * bn + i] : 0.f;
    float* rows0 = bufs + (long)(blk % NBUF) * BLK * L.rp + warp * L.s4;
    float* row = rows0 + lane * L.rp;
    mbar_wait(full + blk % NBUF, (blk / NBUF) & 1);
    // The row's in-tile slots read K_tt: PATCH loads in flight at a time.
    for (int u0 = 0; in && u0 < nin; u0 += PATCH) {
      int tt[PATCH];
      float v[PATCH];
#pragma unroll
      for (int k = 0; k < PATCH; ++k) {
        tt[k] = u0 + k < nin ? lst[u0 + k] : -1;
        v[k] = tt[k] >= 0 ? ktt[(long)it[tt[k]] * bn + i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PATCH; ++k)
        if (tt[k] >= 0) row[tt[k]] = v[k];
    }
    unsigned rest = __ballot_sync(FULL, in && yn != 0.f);  // live rows not yet passed
    while (rest) {
      const float g = tree_dot_s<P>(row, cf, s_size);
      float d2 = __fsub_rn(q_, __fmul_rn(__fmul_rn(2.f, yn), g));
      d2 = __fadd_rn(__fadd_rn(__fadd_rn(d2, kd), xi2_), ci);
      const float dist = __fsqrt_rn(d2 < 1e-12f ? 1e-12f : d2);
      const bool seed = m_ == 0;
      const unsigned act = __ballot_sync(FULL, ((rest >> lane) & 1u) && (seed || dist >= r_));
      if (act == 0u) break;
      const int j = __ffs(act) - 1;
      const int ij = blk * BLK + j;
      const float kj = in ? ktt[(long)ij * bn + i] : 0.f;  // row j's in-tile value for row i
      const float yj = __shfl_sync(FULL, yn, j), gj = __shfl_sync(FULL, g, j);
      const float dj = __shfl_sync(FULL, dist, j), kdj = __shfl_sync(FULL, kd, j);
      const float s = seed ? 1.f : __fmul_rn(0.5f, __fsub_rn(1.f, __fdiv_rn(r_, dj)));
      __syncwarp();  // row j's in-tile values, written by lane j, for every lane

      float best = CUDART_INF_F;
      int arg = lane;
      if constexpr (FAR) {
        if (!slab_in) {  // the model's Kbb, rows at pitch kp
          if (kvec) {
            const int q4 = s_size / 4;
            for (int e = lane; e < s_size * q4; e += 32) {
              const int t = e / q4, u = e - t * q4;
              cp_async16(slab + t * L.kp + 4 * u, kb + (long)t * s_size + 4 * u);
            }
          } else {
            for (int t = 0; t < s_size; ++t)
              for (int u = lane; u < s_size; u += 32)
                cp_async4(slab + t * L.kp + u, kb + (long)t * s_size + u);
          }
          cp_async_wait_all();
          __syncwarp();
          slab_in = true;
        }
        for (int t = lane; t < s_size; t += 32) {
          float sc = -CUDART_INF_F;
          if (ix[t] >= 0) {
            const float* kt = slab + t * L.kp;
            const float gs = tree_dot_s<P>(kt, cf, s_size);
            sc = __fadd_rn(__fsub_rn(q_, __fmul_rn(__fmul_rn(2.f, sign_of(cf[t])), gs)), kt[t]);
          }
          if (sc < best) {
            best = sc;
            arg = t;
          }
        }
      } else {
        for (int t = lane; t < s_size; t += 32)
          if (fabsf(cf[t]) < best) {
            best = fabsf(cf[t]);
            arg = t;
          }
      }
      const int slot = first_min(best, arg);
      const bool fresh = it[slot] < 0;
      __syncwarp();  // every read of the state before its writes
      if constexpr (FAR) {  // the slot's row and column become kv, its diagonal k(x_j, x_j)
        const float* rj = rows0 + j * L.rp;
        for (int t = lane; t < s_size; t += 32) {
          const float v = t == slot ? kdj : rj[t];
          slab[slot * L.kp + t] = v;
          slab[t * L.kp + slot] = v;
        }
      }
      const float om = __fsub_rn(1.f, s);
      for (int t = lane; t < s_size; t += 32) {
        float c = __fmul_rn(cf[t], om);
        if (t == slot) {
          c = __fmul_rn(s, yj);
          ix[t] = base + ij;
          it[t] = ij;
        }
        cf[t] = c;
      }
      if (fresh) {
        if (lane == 0) lst[nin] = slot;
        ++nin;
      }
      const float a1 = __fmul_rn(__fmul_rn(om, om), q_);
      const float a2 = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, s), om), yj), gj);
      const float a3 = __fmul_rn(__fmul_rn(s, s), kdj);
      q_ = __fadd_rn(__fadd_rn(a1, a2), a3);
      if (!seed) r_ = __fadd_rn(r_, __fmul_rn(0.5f, __fsub_rn(dj, r_)));
      xi2_ = __fadd_rn(__fmul_rn(xi2_, __fmul_rn(om, om)), __fmul_rn(__fmul_rn(s, s), gn));
      m_ += 1;
      if (lane > j && in) row[slot] = kj;  // later rows read the slot from K_tt
      __syncwarp();
      rest &= j == 31 ? 0u : ~0u << (j + 1);
    }
    // Release the buffer: the CTA's last warp to do so starts the copy of
    // block blk + NBUF into it, once every generic access to it is ordered
    // before the copy's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = (atomicAdd(released + blk % NBUF, 1) + 1) % nm == 0;
      __threadfence_block();
    }
    if (__shfl_sync(FULL, last, 0) && blk + NBUF < nblk) stage(blk + NBUF);
  }

  for (int t = lane; t < s_size; t += 32) {
    coef[(long)bi * s_size + t] = cf[t];
    idx[(long)bi * s_size + t] = ix[t];
  }
  if (lane == 0) {
    q[bi] = q_;
    r[bi] = r_;
    xi2[bi] = xi2_;
    m[bi] = m_;
  }
  if constexpr (FAR) {
    if (slab_in) {
      __syncwarp();
      for (int t = 0; t < s_size; ++t)
        for (int u = lane; u < s_size; u += 32) kb[(long)t * s_size + u] = slab[t * L.kp + u];
    }
  }
}

template <int P, bool FAR>
int launch_staged(ROWS_PARAMS, int vec, int kvec, cudaStream_t stream) {
  const Staged L(s_size, FAR);
  const int dyn = (int)(4 * L.words);
  const void* fn = (const void*)rows_staged_kernel<P, FAR>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  rows_staged_kernel<P, FAR><<<(b + MPC - 1) / MPC, 32 * MPC, dyn, stream>>>(ROWS_ARGS, vec, kvec);
  return (int)cudaGetLastError();
}

template <bool FAR>
int dispatch_staged(ROWS_PARAMS, int vec, int kvec, cudaStream_t st) {
  switch (sp) {
    case 1: return launch_staged<1, FAR>(ROWS_ARGS, vec, kvec, st);
    case 2: return launch_staged<2, FAR>(ROWS_ARGS, vec, kvec, st);
    case 4: return launch_staged<4, FAR>(ROWS_ARGS, vec, kvec, st);
    case 8: return launch_staged<8, FAR>(ROWS_ARGS, vec, kvec, st);
    case 16: return launch_staged<16, FAR>(ROWS_ARGS, vec, kvec, st);
    case 32: return launch_staged<32, FAR>(ROWS_ARGS, vec, kvec, st);
    case 64: return launch_staged<64, FAR>(ROWS_ARGS, vec, kvec, st);
    case 128: return launch_staged<128, FAR>(ROWS_ARGS, vec, kvec, st);
    case 256: return launch_staged<256, FAR>(ROWS_ARGS, vec, kvec, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Dynamic shared memory of the staged layout (its only shared memory) for S
// slots, with the Kbb slabs if farthest; -1 where S pads past 256 slots.
long kernel_bank_rows_staged_bytes(int s_size, int farthest) {
  if (s_size < 1 || padded(s_size) > STAGED_MAX_SP) return -1;
  return 4 * Staged(s_size, farthest != 0).words;
}

// kernel_bank_rows in the staged layout (the arguments of kernel_bank_rows,
// with no scratch). Returns the CUDA error code of the launch.
int kernel_bank_rows_staged(const float* kcs, const float* ktt, const float* y,
                            const float* c_inv, const float* gain, int* idx, float* coef,
                            float* q, float* r, float* xi2, int* m, float* kbb, int b,
                            int s_size, int bn, int n_valid, int base, cudaStream_t stream) {
  if (kernel_bank_rows_staged_bytes(s_size, kbb != nullptr) < 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || n_valid <= 0) return 0;
  const int sp = padded(s_size);
  const int vec = s_size % 4 == 0 && ((uintptr_t)kcs & 15) == 0;
  const int kvec = s_size % 4 == 0 && ((uintptr_t)kbb & 15) == 0;
  return kbb ? dispatch_staged<true>(ROWS_ARGS, vec, kvec, stream)
             : dispatch_staged<false>(ROWS_ARGS, vec, kvec, stream);
}

}  // extern "C"
