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
// rate. One CTA on one SM (multiball_kernel) evaluates every row against
// every slot, so it runs far from that bound.
//
// The grid layout (multiball_grid_kernel) spreads the rows over the card:
// one CTA an SM, launched cooperatively (all CTAs resident, or the launch
// is refused). The CTAs hold a window of the stream between them in shared
// memory, `rows` consecutive rows each (bulk copies onto an mbarrier, each
// row scaled by its sign in place), and every CTA holds a replica of the
// whole state (centers, scalars, P). Per window, each CTA computes S for
// its rows; then each update is one round: every CTA finds its first row
// past the last update that no active ball encloses (a warp a row), writes
// that row's S entries to its slot of a device scratch, and posts the row
// in the grid's exchange (grid_max: a post a CTA on a line of its own,
// tagged with the round, every CTA polling all posts, so the exchange is
// the round's only grid barrier and every CTA reads the winner from it).
// Every CTA then loads the winner's S entries and y_j x_j at once, applies
// the same update to its replica with the same intrinsics in the same
// order, so the replicas hold the same bits, and computes again the P
// entries and its own rows' S entries of the changed slots. A round whose
// exchange finds no row ends the window. Values written in the kernel are
// read with acquire loads or ld.global.cg (L2), never through the
// non-coherent path. Cost: one exchange per update and per window (1.2 us
// on an H100 at 132 CTAs), beside each update's ~6 us of dependent steps
// (loads from L2, the decision, the recomputed entries, the search) and
// each window's load and S.
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


// ---------------------------------------------------------------------------
// The grid layout: one CTA an SM, launched cooperatively.
// ---------------------------------------------------------------------------

// Fixed shared memory of multiball_grid_kernel: the mbarrier (16 B), the
// argmin scratch (a cost and an index for B and for C a warp) and a word a
// warp for the search and the exchange.
constexpr int GHEAD = 16 + 16 * WARPS + 4 * WARPS;

// Dynamic shared memory of multiball_grid_kernel (its only shared memory):
// the head, the state replica (centers L x wp, P L x L, r, xi2, m, active
// and the acting row's S entries: 5 words a slot), the acting row (wp),
// and `rows` signed rows with their S entries.
size_t grid_dyn_bytes(int d, int l, int rows) {
  const size_t wp = pitch(d);
  return GHEAD + sizeof(float) * ((size_t)l * wp + wp + (size_t)l * l + 5 * (size_t)l +
                                  (size_t)rows * (wp + l));
}

// The device scratch at g CTAs: two sets of g posts (by round parity), a
// post on a 128-byte line of its own, zeroed before the launch; then two
// [g][L] tables of the candidates' S rows.
constexpr int POST_STRIDE = 16;  // words of 8 bytes between two posts
__host__ __device__ inline size_t grid_posts_bytes(int g) {
  return 2 * sizeof(unsigned long long) * POST_STRIDE * (size_t)g;
}
size_t grid_scratch_bytes(int l, int g) { return grid_posts_bytes(g) + sizeof(float) * 2 * (size_t)g * l; }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid's exchange of round `round`: CTA `cta` posts `val` in its slot
// of the round's set (tagged with round + 1 in the high word), then every
// thread returns the largest val over all G CTAs, once all have posted: a
// grid barrier that also reduces. The CTA's writes before it (shared or
// device memory, by any thread) are visible to every CTA after it: the
// post is a release after the CTA's barrier, each poll an acquire before
// it. A set is written again two rounds on, after every CTA has read it.
// A wait past 10 s traps: a fault, not a hang. red: a word a warp.
__device__ __forceinline__ unsigned grid_max(unsigned long long* posts, int G, int cta,
                                             unsigned round, unsigned val, unsigned* red) {
  unsigned long long* set = posts + (size_t)(round & 1) * G * POST_STRIDE;
  const unsigned long long tag = (unsigned long long)(round + 1) << 32;
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(set + (size_t)cta * POST_STRIDE),
                 "l"(tag | val)
                 : "memory");
  unsigned best = 0;
  for (int c = threadIdx.x; c < G; c += THREADS) {
    unsigned long long v;
    const unsigned long long t0 = global_ns();
    for (int spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(set + (size_t)c * POST_STRIDE) : "memory");
      if ((v & 0xffffffff00000000ull) == tag) break;
      if ((spin & 255) == 255 && global_ns() - t0 > 10000000000ull) __trap();
    }
    best = max(best, (unsigned)v);
  }
  best = __reduce_max_sync(FULL, best);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  const int t = threadIdx.x & 31;
  return __reduce_max_sync(FULL, t < WARPS ? red[t] : 0u);
}

// |a - b|^2 over wp columns for lane k of an 8-lane group, both padded
// rows in shared memory (the same chains and tree as sq_dist). Every lane
// of the warp calls it (the tree's shuffles take all 32); a group without
// work passes on = false and reads nothing.
__device__ __forceinline__ float sq_dist_rows(const float* a, const float* b, int k, int wp, bool on) {
  float acc = 0.f;
  const int lim = on ? wp : 0;
#pragma unroll 2
  for (int c = 4 * k; c < lim; c += 32)
    acc = chain4(acc, *reinterpret_cast<const float4*>(a + c), *reinterpret_cast<const float4*>(b + c));
  return tree8(acc);
}

// X (n, d) stream rows, Y (n,) signs; W (L, wp) the centers (zero past d),
// R, XI2 (L,), M, ACT (L,) int32: the state, read by every CTA at the start
// and written back by CTA 0 at the end. scratch: grid_scratch_bytes(L,
// gridDim.x) bytes, its posts zeroed. Each window of
// gridDim.x * rows rows gives CTA c its rows c * rows .. c * rows + rows - 1.
__global__ void __launch_bounds__(THREADS, 1)
multiball_grid_kernel(const float* __restrict__ X, const float* __restrict__ Y, float* W, float* R,
                      float* XI2, int* M, int* ACT, unsigned char* scratch, int n, int d, int L,
                      float cinv, float slack0, int rows, int vec16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  float* red_c = reinterpret_cast<float*>(smem_raw + 16);  // [WARPS][2] costs (B, C)
  int* red_i = reinterpret_cast<int*>(red_c + 2 * WARPS);  // [WARPS][2] indices
  int* first = red_i + 2 * WARPS;                          // [WARPS] the search's rows
  const int wp = pitch(d);
  float* w = reinterpret_cast<float*>(smem_raw + GHEAD);  // [L][wp] the centers
  float* xj = w + (size_t)L * wp;                         // [wp] the acting row, signed
  float* xs = xj + wp;                                    // [rows][wp] signed rows
  float* S = xs + (size_t)rows * wp;                      // [rows][L]
  float* P = S + (size_t)rows * L;                        // [L][L]
  float* r = P + (size_t)L * L;
  float* xi2 = r + L;
  int* m = reinterpret_cast<int*>(xi2 + L);
  int* act = m + L;
  float* sj = reinterpret_cast<float*>(act + L);  // [L] the acting row's S entries
  const int G = gridDim.x, cta = blockIdx.x;
  unsigned long long* posts = reinterpret_cast<unsigned long long*>(scratch);  // [2][G] posts
  float* srow = reinterpret_cast<float*>(scratch + grid_posts_bytes(G));       // [2][G][L]
  const int tid = threadIdx.x, t = tid & 31, wq = tid >> 5;
  const int k = t & 7, g = tid >> 3;  // lane in an 8-lane group; the group
  constexpr int GROUPS = THREADS / 8;

  if (tid == 0 && vec16) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int s = tid; s < L; s += THREADS) r[s] = R[s], xi2[s] = XI2[s], m[s] = M[s], act[s] = ACT[s];
  for (int e = tid; e < L * wp / 4; e += THREADS)
    reinterpret_cast<float4*>(w)[e] = reinterpret_cast<const float4*>(W)[e];
  if (vec16 && wp > d)  // the columns past d, which the copies never write
    for (int e = tid; e < rows * (wp - d); e += THREADS) xs[(e / (wp - d)) * wp + d + e % (wp - d)] = 0.f;
  __syncthreads();
  // P for every pair of slots, GROUPS pairs a pass.
  for (int base = 0; base < L * L; base += GROUPS) {
    const int q = base + g;
    const int i = q / L, j = q % L;
    const bool mine = q < L * L && i < j;
    const float v = sq_dist_rows(w + (size_t)i * wp * mine, w + (size_t)j * wp * mine, k, wp, mine);
    if (mine && k == 0) P[i * L + j] = v, P[j * L + i] = v;
  }

  unsigned round = 0, phase = 0;
  const long span = (long)G * rows;
  for (long w0 = 0; w0 < n; w0 += span) {
    const long base = w0 + (long)cta * rows;  // this CTA's first row
    const int nv = (int)max(0L, min((long)rows, (long)n - base));
    // Stage the CTA's rows: one bulk copy a row onto the mbarrier, then
    // each row scaled by its sign in place; else element loads, scaled.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the last window's rows are no longer read
    if (vec16 && nv > 0) {
      if (tid == 0) mbar_expect_tx(bar, 4u * d * nv);
      __syncthreads();
      for (int j = tid; j < nv; j += THREADS) bulk_copy(xs + (size_t)j * wp, X + (base + j) * d, 4u * d, bar);
      mbar_wait(bar, phase);
      phase ^= 1u;
      for (int j = wq; j < nv; j += WARPS) {
        const float yj = __ldg(Y + base + j);
        for (int c = t; c < d; c += 32) xs[(size_t)j * wp + c] = __fmul_rn(yj, xs[(size_t)j * wp + c]);
      }
    } else if (nv > 0) {
      for (int j = wq; j < nv; j += WARPS) {
        const float yj = __ldg(Y + base + j);
        for (int c = t; c < wp; c += 32)
          xs[(size_t)j * wp + c] = c < d ? __fmul_rn(yj, __ldg(X + (base + j) * d + c)) : 0.f;
      }
    }
    __syncthreads();
    // S for the rows and every slot: a task is a row and a quad of slots
    // (rows fastest); GROUPS tasks a pass, every lane in every pass (the
    // tree's shuffles take all 32).
    {
      const int nq = (L + QUAD - 1) / QUAD, tasks = nv * nq;
      for (int b0 = 0; b0 < tasks; b0 += GROUPS) {
        const int q = b0 + g;
        const bool mine = q < tasks;
        const int j = mine ? q % nv : 0, s0 = mine ? QUAD * (q / nv) : 0;
        const float* xr = xs + (size_t)j * wp;
        float acc[QUAD];
#pragma unroll
        for (int e = 0; e < QUAD; ++e) acc[e] = 0.f;
        const int lim = mine ? wp : 0;
#pragma unroll 2
        for (int c = 4 * k; c < lim; c += 32) {
          const float4 x4 = *reinterpret_cast<const float4*>(xr + c);
#pragma unroll
          for (int e = 0; e < QUAD; ++e)
            if (s0 + e < L)
              acc[e] = chain4(acc[e], *reinterpret_cast<const float4*>(w + (size_t)(s0 + e) * wp + c), x4);
        }
#pragma unroll
        for (int e = 0; e < QUAD; ++e) {
          const float v = tree8(acc[e]);
          if (mine && k == 0 && s0 + e < L) S[j * L + s0 + e] = v;
        }
      }
    }
    __syncthreads();

    for (long j0 = w0;;) {
      // This CTA's first row at or past j0 outside every active ball: a
      // warp takes 32 / lp rows at once, lp lanes a row over its slots (lp:
      // L rounded up to a power of two, at most 32), one ballot for them.
      int mine = 0x7fffffff;
      {
        const int lp = L >= 32 ? 32 : 1 << (32 - __clz(L - 1)), rpp = 32 / lp;
        const int sub = t / lp, lane = t % lp;
        const unsigned group = lp == 32 ? FULL : (1u << lp) - 1u;
        for (int r0 = (int)max(0L, j0 - base) + wq * rpp; r0 < nv; r0 += WARPS * rpp) {
          const int jl = r0 + sub;
          bool in = jl >= nv;  // past the rows: never out
          for (int s = lane; s < L && !in; s += lp)
            if (act[s]) {
              const float d2 = __fadd_rn(__fadd_rn(S[jl * L + s], xi2[s]), cinv);
              in = __fsqrt_rn(fmaxf(d2, 1e-12f)) <= r[s];
            }
          const unsigned ins = __ballot_sync(FULL, in);
          int hit = -1;
          for (int q = 0; q < rpp && hit < 0; ++q)
            if (((ins >> (q * lp)) & group) == 0u) hit = q;
          if (hit >= 0) {
            mine = r0 + hit;
            break;
          }
        }
      }
      if (t == 0) first[wq] = mine;
      __syncthreads();
      const int best = __reduce_min_sync(FULL, t < WARPS ? first[t] : 0x7fffffff);
      // Post the complement of the row (0: none), so the largest post is the
      // round's first row, with its S entries in the CTA's slot.
      const int par = round & 1;
      if (best != 0x7fffffff)
        for (int s = tid; s < L; s += THREADS) srow[((size_t)par * G + cta) * L + s] = S[best * L + s];
      const unsigned key = grid_max(posts, G, cta, round, best != 0x7fffffff ? 0xffffffffu - (unsigned)(base + best) : 0u,
                                    reinterpret_cast<unsigned*>(first));
      ++round;
      if (key == 0u) break;  // no row acts: the window is done
      // The acting row j: its S entries from the winner's slot of the
      // scratch, and y_j x_j from the stream, all loads in flight at once.
      const long j = (long)(0xffffffffu - key);
      const int wc = (int)((j - w0) / rows);
      for (int s = tid; s < L; s += THREADS) sj[s] = __ldcg(srow + ((size_t)par * G + wc) * L + s);
      {
        const float yj = __ldg(Y + j);
        for (int c = tid; c < wp; c += THREADS) xj[c] = c < d ? __fmul_rn(yj, __ldg(X + j * d + c)) : 0.f;
      }
      int free_slot = -1;
      for (int s = 0; s < L; ++s)
        if (!act[s]) {
          free_slot = s;
          break;
        }
      __syncthreads();  // sj, xj
      // The slots the update writes (ch1 for C's point ball) and their new
      // scalars, the same in every thread of every CTA.
      int ch0, ch1 = -1;
      float nr0 = 0.f, nx0 = slack0;
      int nm0 = 1;
      if (free_slot >= 0) {
        ch0 = free_slot;
        for (int c = tid; c < wp; c += THREADS) w[(size_t)ch0 * wp + c] = xj[c];
      } else {
        // Every option's cost: B_s (p < L), C_(i,j) (p = L + i L + j, i < j).
        float cb = CUDART_INF_F, cc = CUDART_INF_F;
        int ib = 0x7fffffff, ic = 0x7fffffff;
        for (int p = tid; p < L + L * L; p += THREADS) {
          if (p < L) {
            const Merge mg = merge(sj[p], r[p], xi2[p], 0.f, slack0);
            if (better(mg.r, p, cb, ib)) cb = mg.r, ib = p;
          } else {
            const int q = p - L, a = q / L, b = q % L;
            if (a < b) {
              const Merge mg = merge(P[q], r[a], xi2[a], r[b], xi2[b]);
              if (better(mg.r, q, cc, ic)) cc = mg.r, ic = q;
            }
          }
        }
        warp_argmin(cb, ib);
        warp_argmin(cc, ic);
        if (t == 0) red_c[2 * wq] = cb, red_i[2 * wq] = ib, red_c[2 * wq + 1] = cc, red_i[2 * wq + 1] = ic;
        __syncthreads();
        // The warps' minima, a lane each, reduced again (any order gives
        // the first minimum: `better` orders (cost, index) totally).
        cb = t < WARPS ? red_c[2 * t] : CUDART_INF_F, ib = t < WARPS ? red_i[2 * t] : 0x7fffffff;
        cc = t < WARPS ? red_c[2 * t + 1] : CUDART_INF_F, ic = t < WARPS ? red_i[2 * t + 1] : 0x7fffffff;
        warp_argmin(cb, ib);
        warp_argmin(cc, ic);
        if (cc < cb) {  // C: balls a and b merge into a; the point opens b
          const int a = ic / L, b = ic % L;
          const Merge mg = merge(P[ic], r[a], xi2[a], r[b], xi2[b]);
          ch0 = a, ch1 = b;
          nr0 = mg.r, nx0 = mg.xi2, nm0 = m[a] + m[b];
          float* wa = w + (size_t)a * wp;
          float* wb = w + (size_t)b * wp;
          for (int c = tid; c < wp; c += THREADS) {
            const float va = wa[c], vb = wb[c];
            wa[c] = mg.one_in_two ? vb
                    : mg.two_in_one ? va
                                    : __fadd_rn(va, __fmul_rn(mg.t, __fsub_rn(vb, va)));
            wb[c] = xj[c];
          }
        } else {  // B: the point merges into ball ib
          const Merge mg = merge(sj[ib], r[ib], xi2[ib], 0.f, slack0);
          ch0 = ib;
          nr0 = mg.r, nx0 = mg.xi2, nm0 = m[ib] + 1;
          float* wa = w + (size_t)ib * wp;
          for (int c = tid; c < wp; c += THREADS) {
            const float va = wa[c], vb = xj[c];
            wa[c] = mg.one_in_two ? vb
                    : mg.two_in_one ? va
                                    : __fadd_rn(va, __fmul_rn(mg.t, __fsub_rn(vb, va)));
          }
        }
      }
      __syncthreads();  // every thread has read the old state
      if (tid == 0) {
        r[ch0] = nr0, xi2[ch0] = nx0, m[ch0] = nm0, act[ch0] = 1;
        if (ch1 >= 0) r[ch1] = 0.f, xi2[ch1] = slack0, m[ch1] = 1, act[ch1] = 1;
      }
      // The entries that touch a changed slot, GROUPS tasks a pass: S of
      // this CTA's rows past j (a task a row, its x read once for both
      // changed slots), then P (ch, e), a task a pair.
      const int lo = (int)max(0L, min((long)nv, j + 1 - base)), nrow = nv - lo;
      const int nch = ch1 >= 0 ? 2 : 1, tasks = nrow + nch * L;
      for (int b0 = 0; b0 < tasks; b0 += GROUPS) {
        const int q = b0 + g, p = q - nrow;
        const bool row = q < nrow, ch_b = !row && p >= L;
        const int e = row ? 0 : p % L, ch = ch_b ? ch1 : ch0;
        const bool on = row || (q < tasks && e != ch), two = row && nch > 1;
        const float* a0 = w + (size_t)(on ? ch : 0) * wp;
        const float* a1 = w + (size_t)(two ? ch1 : 0) * wp;
        const float* b = row ? xs + (size_t)(lo + q) * wp : w + (size_t)(on ? e : 0) * wp;
        float v0 = 0.f, v1 = 0.f;
        const int lim = on ? wp : 0;
#pragma unroll 2
        for (int c = 4 * k; c < lim; c += 32) {
          const float4 b4 = *reinterpret_cast<const float4*>(b + c);
          v0 = chain4(v0, *reinterpret_cast<const float4*>(a0 + c), b4);
          if (two) v1 = chain4(v1, *reinterpret_cast<const float4*>(a1 + c), b4);
        }
        v0 = tree8(v0);
        v1 = tree8(v1);
        if (on && k == 0) {
          if (row) {
            S[(lo + q) * L + ch0] = v0;
            if (two) S[(lo + q) * L + ch1] = v1;
          } else {
            P[ch * L + e] = v0, P[e * L + ch] = v0;
          }
        }
      }
      __syncthreads();
      j0 = j + 1;
    }
  }
  if (cta == 0) {
    for (int e = tid; e < L * wp / 4; e += THREADS)
      reinterpret_cast<float4*>(W)[e] = reinterpret_cast<const float4*>(w)[e];
    for (int s = tid; s < L; s += THREADS) R[s] = r[s], XI2[s] = xi2[s], M[s] = m[s], ACT[s] = act[s];
  }
}

// k rounds of the grid's exchange and nothing else: the cost of one, timed
// by tools/multiball_layouts.py at the grid layout's CTAs and shared memory.
__global__ void __launch_bounds__(THREADS, 1) grid_barrier_kernel(unsigned long long* posts, int k) {
  __shared__ unsigned red[WARPS];
  for (int i = 0; i < k; ++i) grid_max(posts, gridDim.x, blockIdx.x, (unsigned)i, blockIdx.x, red);
}

// Launch `kernel` cooperatively on g CTAs with dyn bytes of dynamic shared
// memory, or refuse (cudaErrorCooperativeLaunchTooLarge) where the card
// cannot hold all g at once.
int cooperative(const void* kernel, int g, size_t dyn, void** args, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, dyn)) != cudaSuccess)
    return (int)err;
  if (g < 1 || (long)per_sm * sms < g) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(g), dim3(THREADS), args, dyn, s);
  if (err != cudaSuccess) return (int)err;
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

// Dynamic shared memory of the grid layout at `rows` rows a CTA (its only
// shared memory).
long multiball_grid_dyn_bytes(int d, int l, int rows) { return (long)grid_dyn_bytes(d, l, rows); }

// Bytes of the grid layout's device scratch at g CTAs.
long multiball_grid_scratch_bytes(int l, int g) { return (long)grid_scratch_bytes(l, g); }

// The grid layout: g CTAs (one an SM), `rows` rows a CTA a window, launched
// cooperatively; arguments as multiball_scan's, scratch
// multiball_grid_scratch_bytes(l, g) bytes (zeroed here where needed).
// Returns the CUDA error of the launch: cudaErrorCooperativeLaunchTooLarge
// where the card cannot hold the g CTAs at once (nothing runs).
int multiball_grid_scan(const void* X, const void* Y, void* W, void* R, void* XI2, void* M,
                        void* ACT, void* scratch, int n, int d, int l, float cinv, float slack0,
                        int rows, int g, int vec16, void* stream) {
  if (n < 0 || d <= 0 || l <= 0 || rows <= 0 || (vec16 && d % 4 != 0) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, grid_posts_bytes(g), s);
  if (err != cudaSuccess) return (int)err;
  const float* x = (const float*)X;
  const float* y = (const float*)Y;
  float *w = (float*)W, *r = (float*)R, *xi2 = (float*)XI2;
  int *m = (int*)M, *act = (int*)ACT;
  unsigned char* sc = (unsigned char*)scratch;
  void* args[] = {&x, &y, &w, &r, &xi2, &m, &act, &sc, &n, &d, &l, &cinv, &slack0, &rows, &vec16};
  return cooperative((const void*)multiball_grid_kernel, g, grid_dyn_bytes(d, l, rows), args, s);
}

// k rounds of the grid's exchange on g CTAs of THREADS threads with dyn
// bytes of dynamic shared memory (posts: multiball_grid_scratch_bytes(0,
// g) bytes of device memory, zeroed here).
int multiball_grid_barriers(void* posts, int g, int k, long dyn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(posts, 0, grid_posts_bytes(g), s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* c = (unsigned long long*)posts;
  void* args[] = {&c, &k};
  return cooperative((const void*)grid_barrier_kernel, g, (size_t)dyn, args, s);
}

}  // extern "C"
