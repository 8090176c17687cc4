// M1 on Hopper: one pass of the paper's Sec 4.3 multi-ball recursion (L
// ball slots, one model) over a stream of rows, with a plain C interface
// (bound with ctypes).
//
// Replaces the per-row lax.scan of src/repro/core/multiball.py::fit_multiball
// (`step`, :88-131, with meb.merge_balls, src/repro/core/meb.py:92-113); no
// pl.pallas_call there. For each row x (signed: y x) against the slots:
//   d_j = sqrt(max(|w_j - x|^2 + xi2_j + 1/C, 1e-12)), inactive slots out;
//   enclosed when some d_j <= r_j: the row changes nothing;
//   else the point ball (x, 0, slack0, 1) opens the first free slot, or,
//   with every slot active, the cheapest of: B_j, merge the point into ball
//   j; C_(i,j) (i < j in triu order), merge balls i and j and open slot j
//   for the point. Cost: the merged radius; argmin takes the first minimum,
//   and C wins only when strictly cheaper than the best B.
//
// Layout. The recursion is sequential in the rows and the reference fits
// one model, so one CTA of 256 threads walks the whole stream in blocks of
// BN = 32 rows. A row that is enclosed changes nothing, so the rows between
// two updates are independent: a block's 32 rows x L slots are evaluated
// at once against the state at its start (S_ij = |w_j - y_i x_i|^2 in a
// shared table), then every warp takes the same ballot over "row t (lane t)
// is not enclosed" and the lowest such row past the last update acts next.
// An update changes one slot (a fill or B) or two (C), so only those
// columns of S, and the entries of the L x L table P of pair distances
// |w_i - w_j|^2 that touch them, are computed again: each entry is a
// function of its two vectors alone, so the table holds the bits a full
// recomputation gives. Where it fits the budget, the stream is staged in
// shared memory a block ahead (one bulk copy of the tensor memory
// accelerator a row, onto the buffer's mbarrier; element loads where rows
// are not 16-byte aligned), and the tables with the slot scalars live in
// shared memory; each falls back to device memory on its own
// (multiball_dyn_bytes gives the bytes of each choice). The L centers stay
// in device memory, read through L1: on an H100 at D = 784 that ran faster
// than centers in shared memory in every layout tried, where they leave
// the SM's L1 no room beside the staged blocks.
//
// Bits. Every sum over D has one order, in every layout and in the plain
// version (kernels/multiball.py::sq_dist): columns padded with zeros to a
// multiple of 32; lane k (0..7) of an 8-lane group takes the columns
// 32 u + 4 k + e for u ascending, e = 0..3, in one chain acc = acc +
// (a - b) * (a - b), each operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no contraction into fma); the 8
// chains combine by the xor tree ((p0 + p4) + (p2 + p6)) + ((p1 + p5) +
// (p3 + p7)). Every scalar step is written with explicit round-to-nearest
// intrinsics, sqrt and division IEEE, so the kernel gives the plain
// version's bits in every leaf.
//
// Bound. The stream is read once (N D 4 bytes) and each row needs L
// distances over D (~3 L D flops), so the card is bound by its memory
// rate. One CTA on one SM evaluates every row against every slot, so this
// kernel runs far from that bound; spreading the evaluation over the card
// is left for a later redesign.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BN = 32;        // rows per block
constexpr int THREADS = 512;  // one CTA
constexpr int WARPS = THREADS / 32;
constexpr int QUAD = 4;       // slots a lane group takes in one pass of the block's rows
// Two mbarriers, the argmin scratch (a cost and an index for B and for C a
// warp), and the block's signs.
constexpr int HEAD = 16 + 16 * WARPS + 4 * BN;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int pitch(int d) { return (d + 31) / 32 * 32; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
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
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four columns c..c+3 of a row: from a padded row (lim < 0: read as is,
// 16-byte aligned) or from a stream row of lim valid columns in device
// memory (zero past lim; one 16-byte load where vec, else four).
__device__ __forceinline__ float4 load4(const float* row, int c, int lim, bool vec) {
  if (lim < 0) return *reinterpret_cast<const float4*>(row + c);
  if (vec) return c < lim ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0, 0, 0, 0);
  float4 v;
  v.x = c < lim ? __ldg(row + c) : 0.f;
  v.y = c + 1 < lim ? __ldg(row + c + 1) : 0.f;
  v.z = c + 2 < lim ? __ldg(row + c + 2) : 0.f;
  v.w = c + 3 < lim ? __ldg(row + c + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float4 scale4(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z), __fmul_rn(s, v.w));
}

// One chain's four steps: acc + (a - b)^2, e = 0..3 in order.
__device__ __forceinline__ float chain4(float acc, float4 a, float4 b) {
  float t = __fsub_rn(a.x, b.x);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.y, b.y);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.z, b.z);
  acc = __fadd_rn(acc, __fmul_rn(t, t));
  t = __fsub_rn(a.w, b.w);
  return __fadd_rn(acc, __fmul_rn(t, t));
}

// The 8 chains of a lane group combined by the xor tree (all 32 lanes call).
__device__ __forceinline__ float tree8(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
  return __fadd_rn(v, __shfl_xor_sync(FULL, v, 1));
}

// |a - s b|^2 over wp columns for lane k of an 8-lane group: a a padded
// center, b a padded row (lim < 0) or a stream row (lim = d), s its sign.
__device__ __forceinline__ float sq_dist(const float* a, const float* b, float s, int k, int wp,
                                         int lim, bool vec) {
  float acc = 0.f;
#pragma unroll 2
  for (int c = 4 * k; c < wp; c += 32)
    acc = chain4(acc, *reinterpret_cast<const float4*>(a + c), scale4(s, load4(b, c, lim, vec)));
  return tree8(acc);
}

// (cost, index) a better than b: smaller cost, ties to the lower index.
__device__ __forceinline__ bool better(float ca, int ia, float cb, int ib) {
  return ca < cb || (ca == cb && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& c, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (better(oc, oi, c, i)) c = oc, i = oi;
  }
}

// The merge of ball 1 (w1, r1, x1) with ball 2 (r2, x2) at squared center
// distance d2w + x1 + x2 (meb.merge_balls): radius, interpolation t and
// slack, and the two containment flags.
struct Merge {
  float r, t, xi2;
  bool one_in_two, two_in_one;
};
__device__ __forceinline__ Merge merge(float d2w, float r1, float x1, float r2, float x2) {
  Merge g;
  const float dist = __fsqrt_rn(fmaxf(__fadd_rn(__fadd_rn(d2w, x1), x2), 0.f));
  g.one_in_two = __fadd_rn(dist, r1) <= r2;
  g.two_in_one = __fadd_rn(dist, r2) <= r1;
  const float rj = __fmul_rn(0.5f, __fadd_rn(__fadd_rn(r1, r2), dist));
  float t = __fdiv_rn(__fsub_rn(rj, r1), fmaxf(dist, 1e-12f));
  g.t = fminf(fmaxf(t, 0.f), 1.f);
  const float om = __fsub_rn(1.f, g.t);
  const float xj = __fadd_rn(__fmul_rn(__fmul_rn(om, om), x1), __fmul_rn(__fmul_rn(g.t, g.t), x2));
  g.r = g.one_in_two ? r2 : (g.two_in_one ? r1 : rj);
  g.xi2 = g.one_in_two ? x2 : (g.two_in_one ? x1 : xj);
  return g;
}

// Dynamic shared memory of multiball_kernel (its only shared memory):
// the head (two mbarriers, the argmin scratch, the block's signs), then,
// each where chosen, two staged blocks of BN rows and the tables (S: BN x
// L, P: L x L) with the slot scalars r, xi2, m, active (4 words a slot).
size_t dyn_bytes(int d, int l, int xs, int ts) {
  const size_t wp = pitch(d);
  return HEAD + sizeof(float) * ((xs ? 2 * BN * wp : 0) +
                                 (ts ? (size_t)BN * l + (size_t)l * l + 4 * (size_t)l : 0));
}

// X (n, d) stream rows, Y (n,) signs; W (L, wp) the centers (zero past d),
// R, XI2 (L,), M, ACT (L,) int32: the state, advanced in place. scratch:
// S and P in device memory when !ts.
template <bool XS>
__global__ void __launch_bounds__(THREADS)
multiball_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* W, float* R,
                 float* XI2, int* M, int* ACT, float* scratch, int n, int d, int L, float cinv,
                 float slack0, int ts, int vec16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);  // [2]
  float* red_c = reinterpret_cast<float*>(smem_raw + 16);  // [WARPS][2] costs (B, C)
  int* red_i = reinterpret_cast<int*>(red_c + 2 * WARPS);  // [WARPS][2] indices
  float* ys = reinterpret_cast<float*>(red_i + 2 * WARPS);  // [BN] the block's signs
  float* dyn = reinterpret_cast<float*>(smem_raw + HEAD);
  const int wp = pitch(d);
  float* xb = dyn;                                // XS: [2][BN][wp]
  float* tab = dyn + (XS ? 2 * BN * wp : 0);      // ts: the tables and scalars
  float* w = W;
  float* S = ts ? tab : scratch;                  // [BN][L]
  float* P = S + BN * L;                          // [L][L]
  float* r = ts ? P + L * L : R;
  float* xi2 = ts ? r + L : XI2;
  int* m = ts ? reinterpret_cast<int*>(xi2 + L) : M;
  int* act = ts ? m + L : ACT;
  const int tid = threadIdx.x, t = tid & 31, wq = tid >> 5;
  const int k = t & 7;  // lane within an 8-lane group
  const int nblocks = (n + BN - 1) / BN;

  // Stage block blk into buffer buf: lanes 0..31 of warp 0 a row each, one
  // bulk copy onto the buffer's mbarrier (BN arrivals), rows past n zeroed;
  // else element loads by every thread, complete at the next barrier.
  auto stage = [&](int blk, int buf) {
    float* dst = xb + (size_t)buf * BN * wp;
    const long row0 = (long)blk * BN;
    if (vec16) {
      if (tid >= BN) return;
      float* row = dst + (size_t)tid * wp;
      if (row0 + tid < n) {
        mbar_expect_tx(bar + buf, 4u * d);
        bulk_copy(row, X + (row0 + tid) * d, 4u * d, bar + buf);
      } else {
        for (int c = 0; c < d; ++c) row[c] = 0.f;
        mbar_arrive(bar + buf);
      }
    } else {
      for (int e = tid; e < BN * wp; e += THREADS) {
        const int j = e / wp, c = e % wp;
        dst[e] = row0 + j < n && c < d ? X[(row0 + j) * d + c] : 0.f;
      }
    }
  };

  if (tid == 0 && XS && vec16) {
    mbar_init(bar, BN);
    mbar_init(bar + 1, BN);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ts)
    for (int s = tid; s < L; s += THREADS) r[s] = R[s], xi2[s] = XI2[s], m[s] = M[s], act[s] = ACT[s];
  if (XS && vec16)  // the columns past d, which the copies never write
    for (int e = tid; e < 2 * BN * (wp - d); e += THREADS)
      xb[(e / (wp - d)) * wp + d + e % (wp - d)] = 0.f;
  __syncthreads();
  // P for every pair of slots, 32 pairs a pass (8 lanes each).
  for (int base = 0; base < L * L; base += THREADS / 8) {
    const int q = base + (tid >> 3);
    const int i = q / L, j = q % L;
    const bool mine = q < L * L && i < j;
    const float v = sq_dist(w + (size_t)(mine ? i : 0) * wp, w + (size_t)(mine ? j : 0) * wp, 1.f,
                            k, wp, -1, true);
    if (mine && k == 0) P[i * L + j] = v, P[j * L + i] = v;
  }
  if (XS && nblocks > 0) stage(0, 0);

  unsigned fill = 0;  // bit b: the parity of buffer b's next fill
  float ycur = (tid >> 3) % BN < n ? __ldg(Y + (tid >> 3) % BN) : 0.f;  // this lane's row's sign
  for (int blk = 0; blk < nblocks; ++blk) {
    const int buf = blk & 1;
    const long row0 = (long)blk * BN;
    if (XS && vec16) {
      mbar_wait(bar + buf, (fill >> buf) & 1u);
      fill ^= 1u << buf;
    }
    __syncthreads();  // every thread is past block blk - 1 (and its buffer)
    if (XS && blk + 1 < nblocks) stage(blk + 1, buf ^ 1);
    const float* xblk = XS ? xb + (size_t)buf * BN * wp : nullptr;
    // The row's stream data: its staged row, or its row in device memory.
    auto xrow = [&](int j) -> const float* { return XS ? xblk + (size_t)j * wp : X + (row0 + j) * d; };
    const int lim = XS ? -1 : d;
    const bool xvec = XS || vec16;

    // S for the block's rows and every slot: lane group g (8 lanes) takes
    // row g % BN and the slots of quads g / BN, + THREADS / 8 / BN, ...; the
    // row's x is read once a quad. Its sign was loaded a block ahead.
    {
      const int g = tid >> 3, j = g % BN;
      const float yj = ycur;
      if (g < BN && k == 0) ys[j] = yj;
      const float* xr = XS || row0 + j < n ? xrow(j) : X;
      const int jl = XS || row0 + j < n ? lim : 0;  // a row past n reads as zeros
      for (int s0 = QUAD * (g / BN); s0 < L; s0 += QUAD * (THREADS / 8 / BN)) {
        float acc[QUAD];
#pragma unroll
        for (int q = 0; q < QUAD; ++q) acc[q] = 0.f;
#pragma unroll 2
        for (int c = 4 * k; c < wp; c += 32) {
          const float4 x4 = scale4(yj, load4(xr, c, jl, xvec));
#pragma unroll
          for (int q = 0; q < QUAD; ++q)
            if (s0 + q < L)
              acc[q] = chain4(acc[q], *reinterpret_cast<const float4*>(w + (size_t)(s0 + q) * wp + c), x4);
        }
#pragma unroll
        for (int q = 0; q < QUAD; ++q) {
          const float v = tree8(acc[q]);
          if (k == 0 && s0 + q < L) S[j * L + s0 + q] = v;
        }
      }
      // The next block's sign for this lane group's row, a block ahead.
      ycur = row0 + BN + j < n ? __ldg(Y + row0 + BN + j) : 0.f;
    }
    __syncthreads();

    for (int j0 = 0;;) {
      // Lane t: is row t, past the last update, outside every active ball?
      bool out = false;
      if (t >= j0 && row0 + t < n) {
        out = true;
        for (int s = 0; s < L; ++s)
          if (act[s]) {
            const float d2 = __fadd_rn(__fadd_rn(S[t * L + s], xi2[s]), cinv);
            if (__fsqrt_rn(fmaxf(d2, 1e-12f)) <= r[s]) {
              out = false;
              break;
            }
          }
      }
      const unsigned viol = __ballot_sync(FULL, out);  // the same in every warp
      if (viol == 0u) break;
      const int j = __ffs(viol) - 1;
      const float yj = ys[j];
      const float* xj = xrow(j);
      int free_slot = -1;
      for (int s = 0; s < L; ++s)
        if (!act[s]) {
          free_slot = s;
          break;
        }
      // The slots the update writes (ch1 for C's point ball) and their new
      // scalars, the same in every thread.
      int ch0, ch1 = -1;
      float nr0 = 0.f, nx0 = slack0;
      int nm0 = 1;
      if (free_slot >= 0) {
        ch0 = free_slot;
        for (int c = tid; c < wp; c += THREADS)
          w[(size_t)ch0 * wp + c] = c < d ? __fmul_rn(yj, xj[c]) : 0.f;
      } else {
        // Every option's cost: B_s (p < L), C_(i,j) (p = L + i L + j, i < j).
        float cb = CUDART_INF_F, cc = CUDART_INF_F;
        int ib = 0x7fffffff, ic = 0x7fffffff;
        for (int p = tid; p < L + L * L; p += THREADS) {
          if (p < L) {
            const Merge g = merge(S[j * L + p], r[p], xi2[p], 0.f, slack0);
            if (better(g.r, p, cb, ib)) cb = g.r, ib = p;
          } else {
            const int q = p - L, a = q / L, b = q % L;
            if (a < b) {
              const Merge g = merge(P[q], r[a], xi2[a], r[b], xi2[b]);
              if (better(g.r, q, cc, ic)) cc = g.r, ic = q;
            }
          }
        }
        warp_argmin(cb, ib);
        warp_argmin(cc, ic);
        if (t == 0) red_c[2 * wq] = cb, red_i[2 * wq] = ib, red_c[2 * wq + 1] = cc, red_i[2 * wq + 1] = ic;
        __syncthreads();
        cb = CUDART_INF_F, cc = CUDART_INF_F, ib = ic = 0x7fffffff;
        for (int v = 0; v < WARPS; ++v) {
          if (better(red_c[2 * v], red_i[2 * v], cb, ib)) cb = red_c[2 * v], ib = red_i[2 * v];
          if (better(red_c[2 * v + 1], red_i[2 * v + 1], cc, ic))
            cc = red_c[2 * v + 1], ic = red_i[2 * v + 1];
        }
        if (cc < cb) {  // C: balls a and b merge into a; the point opens b
          const int a = ic / L, b = ic % L;
          const Merge g = merge(P[ic], r[a], xi2[a], r[b], xi2[b]);
          ch0 = a, ch1 = b;
          nr0 = g.r, nx0 = g.xi2, nm0 = m[a] + m[b];
          float* wa = w + (size_t)a * wp;
          float* wb = w + (size_t)b * wp;
          for (int c = tid; c < wp; c += THREADS) {
            const float va = wa[c], vb = wb[c];
            wa[c] = g.one_in_two ? vb
                    : g.two_in_one ? va
                                   : __fadd_rn(va, __fmul_rn(g.t, __fsub_rn(vb, va)));
            wb[c] = c < d ? __fmul_rn(yj, xj[c]) : 0.f;
          }
        } else {  // B: the point merges into ball ib
          const Merge g = merge(S[j * L + ib], r[ib], xi2[ib], 0.f, slack0);
          ch0 = ib;
          nr0 = g.r, nx0 = g.xi2, nm0 = m[ib] + 1;
          float* wa = w + (size_t)ib * wp;
          for (int c = tid; c < wp; c += THREADS) {
            const float va = wa[c], vb = c < d ? __fmul_rn(yj, xj[c]) : 0.f;
            wa[c] = g.one_in_two ? vb
                    : g.two_in_one ? va
                                   : __fadd_rn(va, __fmul_rn(g.t, __fsub_rn(vb, va)));
          }
        }
      }
      __syncthreads();  // every thread has read the old state
      if (tid == 0) {
        r[ch0] = nr0, xi2[ch0] = nx0, m[ch0] = nm0, act[ch0] = 1;
        if (ch1 >= 0) r[ch1] = 0.f, xi2[ch1] = slack0, m[ch1] = 1, act[ch1] = 1;
      }
      // The table entries that touch a changed slot: P (ch, *) and S of the
      // rows past j, 32 entries a pass (8 lanes each).
      const int nch = ch1 >= 0 ? 2 : 1;
      const int per = L + BN;  // per changed slot: L pair entries, BN rows
      for (int base = 0; base < nch * per; base += THREADS / 8) {
        const int q = base + (tid >> 3);
        const int ch = q / per < 1 ? ch0 : ch1, e = q % per;
        const bool pair = e < L, mine = q < nch * per && (pair ? e != ch : e - L > j);
        // Every lane computes a chain (the tree's shuffles take all 32): a
        // lane without an entry takes a pair of slot 0 with itself.
        const int row = pair ? 0 : e - L;
        const float* b = !mine ? w : pair ? w + (size_t)e * wp : xrow(row);
        const bool on_row = mine && !pair;
        const float v = sq_dist(w + (size_t)(mine ? ch : 0) * wp, b, on_row ? ys[row] : 1.f, k,
                                wp, on_row ? (row0 + row < n ? lim : 0) : -1, on_row ? xvec : true);
        if (mine && k == 0) {
          if (pair)
            P[ch * L + e] = v, P[e * L + ch] = v;
          else
            S[row * L + ch] = v;
        }
      }
      __syncthreads();
      j0 = j + 1;
    }
  }
  __syncthreads();
  if (ts)
    for (int s = tid; s < L; s += THREADS) R[s] = r[s], XI2[s] = xi2[s], M[s] = m[s], ACT[s] = act[s];
}

template <bool XS>
int launch(const void* X, const void* Y, void* W, void* R, void* XI2, void* M, void* ACT,
           void* scratch, int n, int d, int l, float cinv, float slack0, int ts, int vec16,
           cudaStream_t s) {
  const size_t dyn = dyn_bytes(d, l, XS, ts);
  cudaError_t err = cudaFuncSetAttribute((const void*)multiball_kernel<XS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  multiball_kernel<XS><<<1, THREADS, dyn, s>>>(
      (const float*)X, (const float*)Y, (float*)W, (float*)R, (float*)XI2, (int*)M, (int*)ACT,
      (float*)scratch, n, d, l, cinv, slack0, ts, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a block.
int multiball_block_rows() { return BN; }

// Dynamic shared memory the kernel requests (its only shared memory) with
// the stream staged (xs) and the tables (ts) in shared memory.
long multiball_dyn_bytes(int d, int l, int xs, int ts) { return (long)dyn_bytes(d, l, xs, ts); }

// Bytes of the device scratch the tables take where they are not in
// shared memory (S and P).
long multiball_scratch_bytes(int l) { return (long)sizeof(float) * ((long)BN * l + (long)l * l); }

// X (n, d) f32 rows, Y (n,) f32 signs; W (l, pitch(d)) f32 centers, zero
// past d; R, XI2 (l,) f32, M, ACT (l,) int32: the state, advanced in
// place over the n rows. scratch: multiball_scratch_bytes(l) bytes when
// ts == 0 (else unused). vec16: X 16-byte aligned with d a multiple of 4
// (rows then staged by bulk copies). Returns the CUDA error of the launch.
int multiball_scan(const void* X, const void* Y, void* W, void* R, void* XI2, void* M, void* ACT,
                   void* scratch, int n, int d, int l, float cinv, float slack0, int xs, int ts,
                   int vec16, void* stream) {
  if (n < 0 || d <= 0 || l <= 0 || (vec16 && d % 4 != 0) || (!ts && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return xs ? launch<true>(X, Y, W, R, XI2, M, ACT, scratch, n, d, l, cinv, slack0, ts, vec16, s)
            : launch<false>(X, Y, W, R, XI2, M, ACT, scratch, n, d, l, cinv, slack0, ts, vec16, s);
}

}  // extern "C"
