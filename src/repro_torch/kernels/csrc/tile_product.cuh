// The register-tiled f32 product body shared by B2 and B6 serve
// (predict.cu) and B5 (gram.cu): blocks of C[q, b] = <a_q, b_b> for a tile of
// A's rows against 64-row chunks of B, both (rows, d) row-major.
//
// A CTA of 128 threads computes BM x 64 blocks; each thread keeps a TM x TN
// register block, rows ty + TY i and columns tx + TX j. Per chunk, the A tile
// and the B chunk pass through a 3-stage shared-memory buffer of BK-column
// steps, staged row-major (a row's k-chunk contiguous) by cp.async: two steps
// are in flight while one computes, with one barrier per step. The inner loop
// reads four columns of a row as one float4, so a thread makes TM + TN
// 16-byte shared loads per 4 TM TN FMAs. Two tile shapes share one
// shared-memory arena, so a byte model does not depend on which a launch
// takes:
//   small  BM = 32,  4 x 4 per thread, BK = 32: many CTAs for few rows;
//   large  BM = 128, 8 x 8 per thread, BK = 16: a quarter fewer loads per
//          FMA, where the launch has rows enough to fill the card.
// Rows are copied 16 bytes at a time where D and the pointers allow (D a
// multiple of 4 in f32, of 8 in bf16), else element by element (4-byte
// cp.async in f32; plain loads for bf16, the one synchronous case). bf16 A
// is upcast on load (exact). The arena is 46,080 B: three large stages.
//
// Order of the sums. Each element is one f32 fmaf chain over d = 0 .. D - 1
// in ascending order from 0.f, whatever the tile, the thread or the kernel:
// the ragged last step runs a scalar loop over its valid columns only, so no
// zero column is ever added (fmaf(0, 0, -0.f) would turn a -0 into +0). No
// TF32, no tensor cores (f32 wgmma does not exist; 3xTF32 changes the bits),
// no split over k. An element's value therefore does not depend on the launch
// it is in, and equal operands give equal bits in every kernel that walks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BN = 64;  // B rows (bank lanes, Gram columns) per chunk
constexpr int SMALL_BM = 32, LARGE_BM = 128;
constexpr int ARENA_FLOATS = 3 * (LARGE_BM + BN) * (16 + 4);  // 46,080 B: 3 large stages

template <int BM_, int TM_, int TN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static constexpr int STAGE = (BM + BN) * (BK + 4);  // floats per stage
  static_assert(TY * TX == THREADS, "one register block per thread");
  static_assert(STAGES >= 2 && STAGES * STAGE <= ARENA_FLOATS, "stages fit the arena");
  static_assert(BK % 8 == 0, "copies");
};
using Small = Tile<SMALL_BM, 4, 4, 32, 3>;
using Large = Tile<LARGE_BM, 8, 8, 16, 3>;

// The A operand: its shared-memory row padding (rows stay 16-byte aligned
// and an odd number of 16-byte units apart in f32), the elements in one
// 16-byte copy, and four (or one) columns read as f32.
template <typename T> struct Op;
template <> struct Op<float> {
  static constexpr int PAD = 4, VEC = 4;
  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float ld1(const float* p) { return *p; }
};
template <> struct Op<__nv_bfloat16> {
  static constexpr int PAD = 8, VEC = 8;
  static __device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes, or zeros where !ok.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_elem(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_elem(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of one step: A rows q0 .. q0 + BM and B rows b0 .. b0 + 64,
// columns k0 .. k0 + BK; rows past qn / bp and columns past d are
// zero-filled.
template <class Tl, typename T>
__device__ __forceinline__ void stage_load(T* As, float* Bs, const T* Q, const float* W,
                                           int qn, int bp, int d, long q0, int b0, int k0,
                                           bool vec) {
  constexpr int SA = Tl::BK + Op<T>::PAD, SB = Tl::BK + 4;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int VA = Op<T>::VEC, CA = Tl::BK / VA, CB = Tl::BK / 4;
    for (int e = tid; e < Tl::BM * CA; e += THREADS) {
      const int r = e / CA, c = e % CA * VA;
      const bool ok = q0 + r < qn && k0 + c < d;
      cp16(As + r * SA + c, ok ? Q + (q0 + r) * d + k0 + c : Q, ok);
    }
    for (int e = tid; e < BN * CB; e += THREADS) {
      const int r = e / CB, c = e % CB * 4;
      const bool ok = b0 + r < bp && k0 + c < d;
      cp16(Bs + r * SB + c, ok ? W + (long)(b0 + r) * d + k0 + c : W, ok);
    }
  } else {
    for (int e = tid; e < Tl::BM * Tl::BK; e += THREADS) {
      const int r = e / Tl::BK, c = e % Tl::BK;
      const bool ok = q0 + r < qn && k0 + c < d;
      cp_elem(As + r * SA + c, ok ? Q + (q0 + r) * d + k0 + c : Q, ok);
    }
    for (int e = tid; e < BN * Tl::BK; e += THREADS) {
      const int r = e / Tl::BK, c = e % Tl::BK;
      const bool ok = b0 + r < bp && k0 + c < d;
      cp_elem(Bs + r * SB + c, ok ? W + (long)(b0 + r) * d + k0 + c : W, ok);
    }
  }
}

// One step's FMAs over its kv valid columns, each accumulator in ascending k.
template <class Tl, typename T>
__device__ __forceinline__ void stage_compute(const T* As, const float* Bs, int kv,
                                              float (&acc)[Tl::TM][Tl::TN]) {
  constexpr int SA = Tl::BK + Op<T>::PAD, SB = Tl::BK + 4;
  const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
  const T* a0 = As + ty * SA;
  const float* b0 = Bs + tx * SB;
  if (kv == Tl::BK) {
#pragma unroll
    for (int k = 0; k < Tl::BK; k += 4) {
      float4 a[Tl::TM];
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i) a[i] = Op<T>::ld4(a0 + i * Tl::TY * SA + k);
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(b0 + j * Tl::TX * SB + k);
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
    return;
  }
  for (int k = 0; k < kv; ++k) {  // the last step of a ragged D
    float a[Tl::TM];
#pragma unroll
    for (int i = 0; i < Tl::TM; ++i) a[i] = Op<T>::ld1(a0 + i * Tl::TY * SA + k);
#pragma unroll
    for (int j = 0; j < Tl::TN; ++j) {
      const float b = b0[j * Tl::TX * SB + k];
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// The shared product body: blocks of A rows q0 .. q0 + BM against B chunks
// c_lo .. c_hi (64 rows each), with epi(b0, acc) called on each chunk's
// block in chunk order, once every copy has landed and the arena is free for
// the epilogue. Every thread of the CTA calls it.
template <class Tl, typename T, class Epi>
__device__ __forceinline__ void walk(const T* Q, const float* W, int qn, int bp, int d,
                                     long q0, int c_lo, int c_hi, bool vec, float* arena,
                                     Epi&& epi) {
  constexpr int S = Tl::STAGES;
  const int nk = (d + Tl::BK - 1) / Tl::BK;
  auto load = [&](int t, int b0) {  // step t of the chunk at row b0, one copy group
    if (t < nk) {
      float* st = arena + t % S * Tl::STAGE;
      stage_load<Tl>(reinterpret_cast<T*>(st), st + Tl::BM * (Tl::BK + 4), Q, W, qn, bp, d, q0,
                     b0, t * Tl::BK, vec);
    }
    cp_commit();
  };
  float acc[Tl::TM][Tl::TN];
  for (int c = c_lo; c < c_hi; ++c) {
#pragma unroll
    for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j) acc[i][j] = 0.f;
    for (int t = 0; t < S - 1; ++t) load(t, c * BN);
    for (int s = 0; s < nk; ++s) {
      cp_wait<S - 2>();  // step s has landed
      __syncthreads();   // ... for every thread, and step s - 1's stage is free
      load(s + S - 1, c * BN);
      const float* st = arena + s % S * Tl::STAGE;
      stage_compute<Tl>(reinterpret_cast<const T*>(st), st + Tl::BM * (Tl::BK + 4),
                        min(Tl::BK, d - s * Tl::BK), acc);
    }
    __syncthreads();  // the epilogue may reuse the arena
    epi(c * BN, acc);
  }
}

// The large tile where a launch of `ctas` large-tile CTAs gives at least two
// per SM (ptxas gives it 220-255 registers: two CTAs fit an SM), else the
// small one.
bool fills_card(long ctas) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return ctas >= 2L * sms;
}

// 16-byte copies where D and both operands' pointers allow them.
template <typename T>
bool vectorized(const void* Q, const void* W, int d) {
  return d % Op<T>::VEC == 0 && d % 4 == 0 && (size_t)Q % 16 == 0 && (size_t)W % 16 == 0;
}

}  // namespace
