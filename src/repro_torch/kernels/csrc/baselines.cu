// P2 on Hopper: one sweep of Pegasos (the primal sub-gradient SVM of
// Shalev-Shwartz et al.) over a stream, in steps of k rows, with a plain C
// interface (bound with ctypes). Two layouts live here, beside the walk
// (csrc/streamsvm_single.cu, pegasos_single, blocks of at most 32 rows):
// the step form (pegasos_kernel) and the walk over blocks of several steps
// (pegasos_blocks_kernel). kernels.baselines.pegasos_plan picks one by k.
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
// The step form. The steps are sequential, so one CTA of 256 threads walks
// them. "staged" (STAGED): w in shared memory, and the stream in a ring of
// two slots of one step's k rows (and their signs), each filled by cp.async
// (16-byte copies where rows are 16-byte aligned, else 4-byte ones) one
// step ahead of its use: a step waits on its reductions and barriers, not
// on its copy, so a deeper ring buys nothing. "in place": w in device memory
// and the rows read where they lie, for a w or a step that does not fit.
// Per step: the k margins on the warps (a warp a row, lane-strided columns,
// one fmaf chain a lane and a fixed xor tree), a barrier, the masked
// update and |w|^2's partial sums (a thread a column, every 256th), a warp
// tree and a barrier, the projection. Three barriers a step.
//
// The walk over blocks ("blocks", for k above the walk's reach, on wide
// rows 16-byte aligned). A block holds rb = k floor(R / k) rows (whole
// steps, S = rb / k <= 32 of them; R of ~96-224, picked by timing), its
// rows padded to rp = 32 ceil(rb / 32). A pre-pass across the card
// (csrc/signed_gram.cuh) writes every block's Gram of the signed rows,
// G_jt = <y_j x_j, y_t x_t> (it does not depend on w). A cluster of CLUSTER
// CTAs walks the blocks, each CTA owning a slice of the columns. Per block:
// cp.async brings the block's Gram into shared memory (rp^2 floats) behind
// the g pass, which takes every row's margin against the block's starting
// w, g_t = y_t <w, x_t>: each CTA over its slice (the rows from device
// memory, so CLUSTER SMs read the block at once), the partials exchanged
// through distributed shared memory (one cluster barrier a block) and
// summed in the same order in every CTA. Then ONE warp walks the steps, a
// lane a step, as the 32-row walk does with a lane a row: p_s, the product
// of the factors of the steps since the last round (a product scan over the
// steps' lanes), a row t of step s violates when p_s g_t < 1, and the
// lowest step with a violation, or whose projection would bind by the
// walk's own |w|^2, takes a round: with c = f_s p_s and V its violating
// rows, g_t <- c g_t + a_s sum_V G_rt (each lane rp / 32 rows),
// |w|^2 <- c^2 |w|^2 + 2 c a_s sum_V g_r + a_s^2 sum_V sum_V G_rr'
// (double), and the projection's scale on g and |w|^2. One warp round a
// step with a violation; no CTA barrier and no D-wide pass a step. At the
// block's end the deferred replay, all threads a column each, runs the
// block's steps in order with the reference's f32 operations, each rounded
// on its own (f w, coef times the sum over the step's violating rows, their
// sum, the scale), reading only the violating rows, several at once; then
// |w|^2 from the new w (once a block). Three CTA barriers a block. Every
// CTA runs the same rounds on the same values (the same decisions) and
// replays its own columns. Narrow rows, and rows not 16-byte aligned, keep
// the step form: there the rounds set the pace, and they cost about a step
// form's step.
//
// Bound. The stream is read once (n d 4 bytes) and each step does ~4 k d
// flops, so the card is bound by its memory rate. One CTA (or one cluster)
// walks the steps, so every layout runs far from that bound: the step form
// pays a dependent chain of reductions and barriers a step; the walk over
// blocks pays a warp round a step with a violation, each a chain of
// dependent shuffles and shared-memory reads, and, a block, the g pass
// (bound by its loads' latency on one SM, hence the cluster), the replay
// and three barriers (tools/pegasos_layouts.py times each layout).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "signed_gram.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The walk over blocks of several steps
// ---------------------------------------------------------------------------

constexpr int MAX_STEPS = 32;  // steps a block (a lane each)
constexpr int MAX_SLOTS = 8;   // rows a lane (rp <= 256)
constexpr int RB_LOADS = 8;    // violating rows the replay loads at once
constexpr int CLUSTER = 8;     // the CTAs of the cluster, a column slice each
constexpr int SPW = 8;         // rows a warp takes at once in the g pass

// Dynamic shared memory of pegasos_blocks_kernel (each CTA's), in bytes:
// the warps' |w|^2 sums (WARPS doubles), the block's Gram (rp^2), w (its
// pitch), each row's margin, sign and -(viol y), the violating rows' list
// and their steps (rp each), each step's factor, coefficient and scale
// (MAX_STEPS each), the list's length (MAX_STEPS + 1 words), the mask of
// the steps that projected, and the CTAs' |w|^2 and margin partials, two
// sets (CLUSTER doubles and CLUSTER rp floats each).
size_t blocks_dyn_bytes(int d, int rp) {
  const size_t words = (size_t)rp * rp + wpitch(d) + 5 * (size_t)rp + 3 * MAX_STEPS + MAX_STEPS +
                       2 + 2 * CLUSTER * (2 + (size_t)rp);
  return sizeof(double) * WARPS + sizeof(float) * words;
}

// X (n, d) f32, 16-byte aligned with d a multiple of 4 (the g pass reads
// float4s; the replay reads the violating rows from device memory), Y (n,)
// f32, n a multiple of k; G the pre-pass's Grams; W (d,) f32 the start,
// updated in place; F (n,) uint8 each row's violation, or null. rb: rows a
// block (k floor(R / k), rb / k <= MAX_STEPS); rp: rb padded to 32 (<= 32
// MAX_SLOTS). A cluster of CLUSTER CTAs, each owning a slice of the
// columns: each takes the block's margins over its slice (a warp SPW rows),
// writes them into every CTA's shared memory with its slice's |w|^2, and
// after one cluster barrier each sums them in the same order, runs the same
// rounds on the same values (the same decisions in every CTA), and replays
// its own columns.
__global__ void __launch_bounds__(THREADS)
pegasos_blocks_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                      const float* __restrict__ G, float* __restrict__ W,
                      unsigned char* __restrict__ F, int n, int d, float lam, int k, int rb,
                      int rp) {
  extern __shared__ __align__(16) float smem[];
  double* wq = reinterpret_cast<double*>(smem);         // [WARPS]
  float* gs = smem + 2 * WARPS;                         // [rp][rp]
  float* w = gs + (long)rp * rp;                        // [wpitch(d)]
  float* hs = w + wpitch(d);                            // [rp]: g_t = y_t <w, x_t>
  float* ys = hs + rp;                                  // [rp]
  float* nv = ys + rp;                                  // [rp]: -(viol y)
  int* vl = reinterpret_cast<int*>(nv + rp);            // [rp]: the violating rows, ascending
  int* vs = vl + rp;                                    // [rp]: their steps
  float* fst = reinterpret_cast<float*>(vs + rp);       // [MAX_STEPS]: factor
  float* cst = fst + MAX_STEPS;                         // [MAX_STEPS]: coef = -eta / k
  float* sst = cst + MAX_STEPS;                         // [MAX_STEPS]: the projection's scale
  int* vst = reinterpret_cast<int*>(sst + MAX_STEPS);   // [MAX_STEPS + 1]: [0] the list's length
  unsigned* smk = reinterpret_cast<unsigned*>(vst + MAX_STEPS + 1);  // the steps that projected
  // the CTAs' |w|^2 partials [2][CLUSTER] (8-byte aligned: an even word,
  // every term before it a whole number of pairs of words) and margin
  // partials [2][CLUSTER][rp], a set a block's parity
  double* wqx = reinterpret_cast<double*>(smk + 1);
  float* part = reinterpret_cast<float*>(wqx + 2 * CLUSTER);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.block_rank();
  const int dc = (d + 4 * CLUSTER - 1) / (4 * CLUSTER) * 4;
  const int c0 = min(d, cl * dc), c1 = min(d, c0 + dc);  // this CTA's columns
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wp = tid >> 5;
  const int ns = rp / 32;
  const int nblocks = (n + rb - 1) / rb;
  const float radius = __fdiv_rn(1.0f, __fsqrt_rn(lam));

  // The block's Gram into shared memory, by cp.async (one group).
  auto load_gram = [&](int blk) {
    const float* src = G + (long)blk * rp * rp;
    for (int e = tid; e < rp * rp / 4; e += THREADS) cp_async16(gs + 4 * e, src + 4 * e);
    cp_async_commit();
  };
  load_gram(0);
  for (int c = tid; c < wpitch(d); c += THREADS) w[c] = c < d ? W[c] : 0.f;
  __syncthreads();
  {
    double sq = 0.0;  // over this CTA's columns
    for (int c = c0 + tid; c < c1; c += THREADS) sq = fma((double)w[c], (double)w[c], sq);
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
    if (lane == 0) wq[wp] = sq;
  }
  cp_async_wait_all();  // block 0's Gram
  __syncthreads();

  for (int blk = 0; blk < nblocks; ++blk) {
    const long row0 = (long)blk * rb;
    const int rows = (int)min((long)rb, (long)n - row0);  // whole steps
    const int S = rows / k;
    // The g pass over this CTA's columns, a warp SPW rows at once,
    // lane-strided float4 columns (their loads in flight together: one
    // SM's loads wait on their latency, not on their bytes).
    {
      const int par = blk & 1;
      const float yt = tid < rows ? Y[row0 + tid] : 0.f;  // rp <= THREADS: a row a thread
      if (tid < CLUSTER) {  // this CTA's |w|^2 (its warps' sums in order) to CTA tid
        double sq = 0.0;
        for (int i = 0; i < WARPS; ++i) sq += wq[i];
        *cluster.map_shared_rank(wqx + par * CLUSTER + cl, tid) = sq;
      }
      // the margins, to every CTA (lane j writes CTA j's copy)
      const float4* w4 = reinterpret_cast<const float4*>(w + c0);
      const int n4 = (c1 - c0) / 4;
      for (int r = SPW * wp; r < rows; r += SPW * WARPS) {
        const float4* x4 = reinterpret_cast<const float4*>(X + (row0 + r) * d + c0);
        const int d4 = d / 4;
        float h[SPW];
#pragma unroll
        for (int j = 0; j < SPW; ++j) h[j] = 0.f;
        for (int c = lane; c < n4; c += 32) {
          const float4 wv = w4[c];
          float4 v[SPW];
#pragma unroll
          for (int j = 0; j < SPW; ++j)
            v[j] = r + j < rows ? __ldg(x4 + (long)j * d4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < SPW; ++j) {
            h[j] = fmaf(wv.x, v[j].x, h[j]);
            h[j] = fmaf(wv.y, v[j].y, h[j]);
            h[j] = fmaf(wv.z, v[j].z, h[j]);
            h[j] = fmaf(wv.w, v[j].w, h[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < SPW; ++j) h[j] = warp_sum(h[j]);
        if (lane < CLUSTER) {
          float* dst = cluster.map_shared_rank(part + (par * CLUSTER + cl) * rp, lane);
#pragma unroll
          for (int j = 0; j < SPW; ++j)
            if (r + j < rows) dst[r + j] = h[j];
        }
      }
      cluster.sync();  // every CTA's partials have landed
      if (tid < rp) {
        float h = 0.f;
        if (tid < rows)
          for (int c = 0; c < CLUSTER; ++c) h += part[(par * CLUSTER + c) * rp + tid];
        ys[tid] = yt;
        hs[tid] = yt * h;
      }
      if (tid < WARPS) {  // |w|^2: the CTAs' partials in order, in wq[0]
        double sq = 0.0;
        if (tid == 0)
          for (int c = 0; c < CLUSTER; ++c) sq += wqx[par * CLUSTER + c];
        wq[tid] = sq;
      }
    }
    __syncthreads();  // (1) margins and signs

    if (wp == 0) {
      // The rounds, on one warp. Lane s holds step s's scalars as the
      // reference rounds them and tests its k rows' margins p_s g_t (g in
      // shared memory, hs); row t = 32 i + lane of slot i takes the rounds'
      // updates of g.
      double pw2 = 0.0;
      for (int i = 0; i < WARPS; ++i) pw2 += wq[i];
#pragma unroll
      for (int i = 0; i < MAX_SLOTS; ++i)
        if (i < ns) nv[32 * i + lane] = 0.f;
      float fct = 1.0f, ak = 0.0f;
      if (lane < S) {
        const float tf = (float)(row0 / k + lane);
        const float eta = __fdiv_rn(1.0f, __fmul_rn(lam, __fadd_rn(tf, 1.0f)));
        fct = __fsub_rn(1.0f, __fmul_rn(eta, lam));
        ak = __fdiv_rn(eta, (float)k);
      }
      const float* hrow = hs + lane * k;  // lane s's rows
      float step_scale = 1.0f;
      for (int s0 = 0;;) {
        // P_s: the factors of the steps s0 .. s - 1 (an exclusive product
        // scan over the steps' lanes; lanes before s0 carry 1).
        float q = lane >= s0 && lane < S ? fct : 1.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(FULL, q, off);
          if (lane >= off) q *= o;
        }
        float P = __shfl_up_sync(FULL, q, 1);
        if (lane == 0) P = 1.0f;
        const float c = fct * P;
        // Lane s: whether a row of its step violates (p_s g_t < 1), or its
        // projection would bind without one (|c| sqrt(|w|^2) past the
        // radius, squares compared in double).
        bool hit = false;
        if (lane >= s0 && lane < S) {
#pragma unroll 4
          for (int j = 0; j < k; ++j) hit |= P * hrow[j] < 1.0f;
          hit |= (double)c * c * pw2 > (double)radius * radius;
        }
        const unsigned hits = __ballot_sync(FULL, hit);
        if (hits == 0u) break;  // the block's last steps only decay w
        const int st = __ffs(hits) - 1;  // the round's step
        const int lo = st * k;
        const float ps = __shfl_sync(FULL, P, st);
        const float cs = __shfl_sync(FULL, c, st);
        const float a_s = __shfl_sync(FULL, ak, st);
        // V: its violating rows, a word of the step's rows at a time, lane j
        // row lo + 32 w + j; u_t = sum over V (ascending) of G_rt, and the
        // sum over V of g_r.
        float u[MAX_SLOTS];
#pragma unroll
        for (int i = 0; i < MAX_SLOTS; ++i) u[i] = 0.f;
        float sgl = 0.f;
        for (int w0 = 0; w0 < k; w0 += 32) {
          const int r = lo + w0 + lane;
          const bool in = w0 + lane < k && ps * hs[r] < 1.0f;
          if (in) {
            sgl += hs[r];
            nv[r] = -ys[r];
          }
          for (unsigned v = __ballot_sync(FULL, in); v != 0u; v &= v - 1u) {
            const float* grow = gs + (long)(lo + w0 + __ffs(v) - 1) * rp + lane;
#pragma unroll
            for (int i = 0; i < MAX_SLOTS; ++i)
              if (i < ns) u[i] += grow[32 * i];
          }
        }
        __syncwarp();
        float sul = 0.f;  // the sum over V of u_r: V's rows are those nv marks in [lo, lo + k)
#pragma unroll
        for (int i = 0; i < MAX_SLOTS; ++i) {
          const int t = 32 * i + lane;
          if (i < ns && t >= lo && t < lo + k && nv[t] != 0.f) sul += u[i];
        }
        const float sg = warp_sum(sgl), su = warp_sum(sul);
        pw2 = (double)cs * cs * pw2 + 2.0 * cs * a_s * sg + (double)a_s * a_s * su;
        const float scale = fminf(1.0f, radius / fmaxf(sqrtf((float)pw2), 1e-12f));
#pragma unroll
        for (int i = 0; i < MAX_SLOTS; ++i) {
          const int t = 32 * i + lane;
          if (i < ns) hs[t] = scale * (cs * hs[t] + a_s * u[i]);
        }
        __syncwarp();
        pw2 *= (double)scale * scale;
        if (lane == st) step_scale = scale;
        s0 = st + 1;
      }
      // The records of the deferred replay: each step's scalars, the
      // violating rows in order with their steps, and the list's step
      // starts.
      const unsigned proj = __ballot_sync(FULL, lane < S && step_scale != 1.0f);
      if (lane < S) {
        fst[lane] = fct;
        cst[lane] = -ak;
        sst[lane] = step_scale;
      }
      int base = 0;
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < MAX_SLOTS; ++i) {
        if (i < ns) {
          const int t = 32 * i + lane;
          const bool viol = nv[t] != 0.f;
          const unsigned m = __ballot_sync(FULL, viol);
          if (viol) {
            vl[base + __popc(m & below)] = t;
            vs[base + __popc(m & below)] = t / k;
          }
          if (F != nullptr && t < rows && cl == 0) F[row0 + t] = viol;
          base += __popc(m);
        }
      }
      if (lane == 0) {
        vst[0] = base;  // the count of violating rows
        smk[0] = proj;
      }
    }
    __syncthreads();  // (2) the records
    if (blk + 1 < nblocks) load_gram(blk + 1);  // the Gram is read by the rounds only

    // The deferred replay of columns tid + 256 u, through the block's steps
    // in order with the reference's f32 operations, each rounded on its own:
    // w <- (f w + coef sum_r -(viol_r y_r) x_r) scale. A step without a
    // violation is f w; a scale of 1 changes nothing. Only the violating
    // rows are read, RB_LOADS of them at once (their loads in flight
    // together, then applied in order). Then |w|^2 for the next block.
    const unsigned proj = smk[0];
    const int nviol = vst[0];
    double wsum = 0.0;
    for (int cb = c0; cb < c1; cb += 4 * THREADS) {  // this CTA's columns
      float v[4], sa[4];
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + tid + THREADS * u;
        in[u] = c < c1;
        v[u] = in[u] ? w[c] : 0.f;
        sa[u] = 0.f;
      }
      int s = 0;       // the next step to close
      bool has = false;  // step s has a violating row in sa
      // Close the steps before `upto`: f w, plus coef sa where step s
      // violated, then the scale where it projected.
      auto close = [&](int upto) {
        for (; s < upto; ++s) {
          const float f = fst[s];
          if (has) {
            const float co = cst[s];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              v[u] = __fadd_rn(__fmul_rn(f, v[u]), __fmul_rn(co, sa[u]));
              sa[u] = 0.f;
            }
            has = false;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(f, v[u]);
          }
          if ((proj >> s) & 1u) {
            const float sc = sst[s];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(v[u], sc);
          }
        }
      };
      for (int a0 = 0; a0 < nviol; a0 += RB_LOADS) {
        float xv[RB_LOADS][4], nvj[RB_LOADS];
        int sj[RB_LOADS];
#pragma unroll
        for (int j = 0; j < RB_LOADS; ++j) {
          const bool ok = a0 + j < nviol;
          const int r = ok ? vl[a0 + j] : 0;
          sj[j] = ok ? vs[a0 + j] : 0;
          nvj[j] = nv[r];
          const float* xr = X + (row0 + r) * d + cb + tid;
#pragma unroll
          for (int u = 0; u < 4; ++u) xv[j][u] = ok && in[u] ? __ldg(xr + THREADS * u) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RB_LOADS; ++j) {
          if (a0 + j < nviol) {
            close(sj[j]);
#pragma unroll
            for (int u = 0; u < 4; ++u) sa[u] = __fadd_rn(sa[u], __fmul_rn(nvj[j], xv[j][u]));
            has = true;
          }
        }
      }
      close(S);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (in[u]) {
          w[cb + tid + THREADS * u] = v[u];
          wsum = fma((double)v[u], (double)v[u], wsum);
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(FULL, wsum, off);
    if (lane == 0) wq[wp] = wsum;
    cp_async_wait_all();  // the next block's Gram
    __syncthreads();      // (3) w, its |w|^2 sums and the next block's Gram
  }
  for (int c = c0 + tid; c < c1; c += THREADS) W[c] = w[c];
  cluster.sync();  // no CTA leaves while another may write to it
}

int launch_blocks(const void* X, const void* Y, void* G, void* W, void* F, int n, int d,
                  float lam, int k, int rb, int rp, cudaStream_t s) {
  const size_t dyn = blocks_dyn_bytes(d, rp);
  cudaError_t err = cudaFuncSetAttribute((const void*)pegasos_blocks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  err = signed_gram::launch((const float*)X, (const float*)Y, (float*)G, n, d, rb, rp, s);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pegasos_blocks_kernel, (const float*)X,
                           (const float*)Y, (const float*)G, (float*)W, (unsigned char*)F, n, d,
                           lam, k, rb, rp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The walk over blocks: rows a block at k rows a step and R rows asked
// for (k floor(R / k)), 0 where that layout does not take k (no whole
// step, more than MAX_STEPS steps, or beyond 32 MAX_SLOTS rows).
int pegasos_blocks_rows(int k, int r) {
  if (k < 1 || r < k) return 0;
  const int rb = r / k * k;
  return rb / k <= MAX_STEPS && rb <= 32 * MAX_SLOTS ? rb : 0;
}

// Its dynamic shared memory (its only shared memory; each CTA's) at rb
// rows a block.
long pegasos_blocks_dyn_bytes(int d, int rb) {
  return (long)blocks_dyn_bytes(d, (rb + 31) / 32 * 32);
}

// The CTAs of its cluster.
int pegasos_blocks_cluster() { return CLUSTER; }

// P2 by the walk over blocks: one sweep over n / k steps of k rows of X
// (n, d) with signs Y (n,), lam > 0, rb rows a block (pegasos_blocks_rows).
// G: scratch of ceil(n / rb) rp^2 floats, rp = rb rounded up to 32. W (d,)
// f32 the start, updated in place; F (n,) uint8 each row's violation, or
// null; vec16: X 16-byte aligned with d a multiple of 4 (required); the
// dynamic bytes (pegasos_blocks_dyn_bytes) must fit the card. Returns the
// CUDA error of the launches (0 on success).
int pegasos_blocks(const void* X, const void* Y, void* G, void* W, void* F, int n, int d,
                   float lam, int k, int rb, int vec16, void* stream) {
  if (n <= 0 || d <= 0 || k < 1 || n % k != 0 || !(lam > 0.f) || rb % k != 0 ||
      pegasos_blocks_rows(k, rb) != rb || !vec16)
    return (int)cudaErrorInvalidValue;
  return launch_blocks(X, Y, G, W, F, n, d, lam, k, rb, (rb + 31) / 32 * 32,
                       (cudaStream_t)stream);
}

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
