// B4 on Hopper: one pass of Algorithm 1 for ONE model over a stream of
// label-signed rows, with a plain C interface (bound with ctypes).
//
// Replaces src/repro/kernels/streamsvm_scan.py::_kernel (driven there by
// streamsvm_scan_pallas).
//
// Layout. One model has only the stream axis, and its recursion is
// sequential in the rows, so one CTA of 256 threads walks the whole stream
// in internal blocks of BN = 32 rows. What does not depend on the model
// runs beside it: a pre-pass kernel (csrc/signed_gram.cuh) computes every
// block's Gram of the signed rows, G_jk = <y_j x_j, y_k x_k>, over the whole
// card, into global memory. The CTA keeps the model's w row in shared
// memory where it fits (else it works on w in device memory) and stages
// the stream two buffers deep, each staged row one bulk copy of the tensor
// memory accelerator (cp.async.bulk onto the buffer's mbarrier: per-thread
// 16-byte cp.async from one lone SM stalls the very threads that issue
// it), the block's Gram by cp.async from its first step: where two whole
// blocks fit (D up to ~870, Fig 3's 784 among them), each buffer holds a
// whole 32-row block, copied a block ahead and read by both passes; else
// (BN, SDC) chunks, each copied one step ahead. Per block: the g pass over
// the chunks on all 8 warps (4 rows a warp; the 8 lanes of a row take
// interleaved 4-column pieces, each lane one fmaf chain, combined by a
// fixed xor tree at the block's end); then the rows, as in the TPU kernel:
// d^2 = |w|^2 - 2 g_j + G_jj + xi2 + 1/C, the update when d >= r (row
// valid, sign != 0), the rank-1 maintenance of g and the r / xi2 (with the
// slack gain) / |w|^2 / m recursions, with the row's step recorded (alpha,
// decay) instead of applied. A row that does not update changes nothing,
// so one warp ballot over the rows' distances finds the next update: one
// dependent step per update, not one per row. Finally the deferred update
// over the same chunks again, w <- decay * w + sum_k (alpha_k y_k) x_k, one
// fmaf chain over the block's rows per column, a thread taking every 256th
// column. That is the TPU kernel's per-row AXPY w <- (1-s) w + s y_j x_j in
// another order, taken out of the row loop: the rows make no device-memory
// access. Every thread computes the scalar chain identically, lane k of
// each warp holding g_k, so the rows need no barrier: g_j reaches all
// threads by warp shuffle.
//
// All math is f32 on the CUDA cores (no TF32: it would flip d >= r
// decisions). m is an int32 (the TPU kernel carries it as an f32, exact to
// 2^24). Rows at or past n_valid and rows of sign 0 are inert.
//
// Bound. The stream is read once (N D 4 bytes) and the work is ~5 D flops
// per row, so the card is bound by its memory rate. One CTA on one SM walks
// the whole stream, so this kernel runs far from that bound: per block it
// pays a dependent step (a ballot, a sqrt and a divide) per update, the
// passes' chains and each step's barrier, while the bulk copies run a block
// ahead where it fits. That is the nature of a single sequential model; many models at
// once are B1's and B3's work.
//
// P1, the perceptron, is the same walk with the perceptron's rule
// (single_kernel<WS, true>, entry perceptron_single). It replaces no TPU
// kernel: the reference computes it as a lax.scan over the rows
// (src/repro/baselines/perceptron.py:12-20), which an eager loop would pay
// in ~3 launches a row. A mistake is y_j <w, x_j> <= 0 on the w before the
// row, and it adds y_j x_j to w. Between two mistakes the rows are
// independent, so the ballot finds the next one: lane t holds
// g_t = <w, y_t x_t>, a mistake at row j adds G_jt to every later g_t, and
// the row's step is recorded as alpha 1 (decay 1) for the block's deferred
// update. w starts at zero and the kernel counts the mistakes; it keeps no
// ball scalars. Where `flags` is given, it writes each row's decision
// there (1: a mistake), for certifying a parting from the plain version.
//
// P2, Pegasos at k rows a step with k <= 32, is the same walk with Pegasos'
// rule and the step's decay deferred (single_kernel<WS, PEG>, entry
// pegasos_single). It replaces no TPU kernel either: the reference is a
// lax.scan over the steps (src/repro/baselines/pegasos.py:28-42). Step s
// (eta_s = 1 / (lam (s + 1)), f_s = 1 - eta_s lam, a_s = eta_s / k) takes
// w <- f_s w + a_s sum_r viol_r y_r x_r over its rows, viol_r = y_r <w, x_r>
// < 1 against the step's w, then the projection w <- w min(1, (1/sqrt(lam))
// / |w|). A step without a violation only scales w by f_s < 1, and after
// any step |w| <= 1/sqrt(lam), so its projection leaves w alone: the steps
// between two that violate are independent. A block holds whole steps
// (rb = k floor(32 / k) rows; lanes rb.. are inert) and lane t holds
// g_t = <w_r, y_t x_t> against the state after the last round, w_r, and
// p_t, the product of the factors of the steps between that round and
// t's (a warp product scan, redone after each round). Row t violates when
// p_t g_t < 1. The lowest step with a violation, or whose projection would
// bind by the walk's own |w|^2 (a rounding edge), takes a round: with
// c = f_s p_s and V its violating rows, g_t <- c g_t + a_s sum_V G_rt,
// |w|^2 <- c^2 |w|^2 + 2 c a_s sum_V g_r + a_s^2 sum_V sum_V G_rr' (in
// double), then the projection's scale multiplies g and |w|^2. One
// dependent round a step with a violation, not three barriers a step. Each
// row's step factor, coefficient, violation and the step's scale are
// recorded, and the block's deferred pass replays them column by column
// with the reference's f32 operations, each rounded on its own (the plain
// version's roundings: a product of the factors, as B4's decay, rounds far
// less, and over a long sweep the reference's w drifts from that by more
// than the engine tolerance). It recomputes |w|^2 from the new w (one
// reduction a block), so the recursion's drift stays within a block.
#include <cuda_runtime.h>

#include "signed_gram.cuh"

namespace {

constexpr int BN = 32;        // rows per internal block
constexpr int THREADS = 256;  // one CTA
constexpr int WARPS = THREADS / 32;
constexpr int SDC = 256;      // feature columns of a staged chunk where no whole block fits
constexpr unsigned FULL = 0xffffffffu;
// The rule single_kernel walks: Algorithm 1, the perceptron, Pegasos.
enum Rule { ALG1, PERC, PEG };

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor memory accelerator's bulk copy onto an mbarrier: one thread
// starts a whole row's copy, and the copy holds no thread's issue slots.
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

// A w row in shared memory: D rounded up to 8 floats, zero past D.
__host__ __device__ inline int wpitch(int d) { return (d + 7) / 8 * 8; }

// Floats of Pegasos' walk state: the warps' |w|^2 sums (WARPS doubles) and
// each row's step factor, step coefficient and step scale (BN each).
constexpr int PEG_STATE = 2 * WARPS + 3 * BN;

// Dynamic shared memory of single_kernel, in bytes, for staged chunks of
// cw columns (a multiple of 4; at a row pitch of cw + 4): two chunks, the
// block Gram, h and alpha*y (BN each), the two chunks' mbarriers (4 floats'
// room), Pegasos' walk state (peg), then the w row when it lives there.
size_t single_dyn_bytes(int d, int w_smem, int cw, bool peg) {
  return sizeof(float) * ((size_t)2 * BN * (cw + 4) + BN * BN + 2 * BN + 4 +
                          (peg ? PEG_STATE : 0) + (w_smem ? wpitch(d) : 0));
}

// ALG1: S = [r, xi2, 1/C, gain] and M = [m] are read at the start and r,
// xi2, m written back at the end; W (d,) is updated in place, through its
// copy in shared memory when WS. PERC: the perceptron's rule (S unused, M
// counts the mistakes, F (n,) the rows' decisions where not null). PEG:
// Pegasos at k rows a step with regularizer lam, rb rows a block (S and M
// unused, F each row's violation where not null); ALG1 and PERC take BN
// rows a block. cw: the staged chunk's columns (d rounded up to 4: whole
// blocks; else SDC). vec16: X 16-byte aligned with d a multiple of 4 (each
// staged row is then one bulk copy, else element loads).
template <bool WS, Rule RULE>
__global__ void __launch_bounds__(THREADS)
single_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              const float* __restrict__ G, float* __restrict__ W, float* __restrict__ S,
              int* __restrict__ M, unsigned char* __restrict__ F, int n, int n_valid, int d,
              int cw, int vec16, float lam, int k_step, int rb) {
  constexpr bool PERCEPTRON = RULE == PERC;
  constexpr bool PEGASOS = RULE == PEG;
  extern __shared__ __align__(16) float smem[];
  const int SP = cw + 4;          // a staged row's pitch: 8 rows' 16-byte reads in distinct banks
  float* xb = smem;               // [2][BN][SP]
  float* gs = xb + 2 * BN * SP;   // [BN][BN]
  float* hb = gs + BN * BN;       // [BN]: h, and the warps' |w|^2 sums at the start
  float* ay = hb + BN;            // [BN]: alpha * y; PEGASOS: -(viol y)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ay + BN);  // [2]
  // PEGASOS: the warps' |w|^2 sums of a block's end, and each row's step
  // factor, coefficient and scale, for the deferred replay.
  double* wq = reinterpret_cast<double*>(ay + BN + 4);  // [WARPS]
  float* fb = ay + BN + 4 + 2 * WARPS;                  // [BN]
  float* cb = fb + BN;                                  // [BN]
  float* sb = cb + BN;                                  // [BN]
  float* w = WS ? ay + BN + 4 + (PEGASOS ? PEG_STATE : 0) : W;  // [wpitch(d)] when WS
  const int RB = PEGASOS ? rb : BN;  // rows a block
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int wp = tid >> 5;
  const int nc = (d + cw - 1) / cw;
  const bool whole = nc == 1;  // the update reads the g pass's buffer again
  const int nblocks = (n + RB - 1) / RB;
  const int steps = nblocks * 2 * nc;  // per block: the g pass, then the update
  // Start the copy of chunk ch of block blk into buffer buf. vec16: lanes
  // 0..3 of each warp take a row each (row 4 wp + lane): one bulk copy onto
  // the buffer's mbarrier (BN arrivals), whose wait (fill, the parity)
  // completes it; a row past n is zeroed instead (the columns past d, which
  // a 16-byte-aligned chunk never reads, are not). Else element loads, zero
  // past n and d, complete at the next barrier.
  auto stage = [&](int blk, int ch, int buf) {
    float* dst = xb + buf * BN * SP;
    const long row0 = (long)blk * RB;
    const int c0 = ch * cw;
    if (vec16) {
      if (t >= BN / WARPS) return;
      const int j = (BN / WARPS) * wp + t;
      float* row = dst + j * SP;
      if (j < RB && row0 + j < n) {
        const unsigned bytes = 4u * min(cw, d - c0);
        mbar_expect_tx(bar + buf, bytes);
        bulk_copy(row, X + (row0 + j) * d + c0, bytes, bar + buf);
      } else {
        for (int c = 0; c < cw; ++c) row[c] = 0.f;
        mbar_arrive(bar + buf);
      }
    } else if (PEGASOS) {  // an element a thread (a row a thread here would wait on each load)
      for (int e = tid; e < BN * cw; e += THREADS) {
        const int j = e / cw, c = e - j * cw;
        const bool rok = j < RB && row0 + j < n;
        dst[j * SP + c] = rok && c0 + c < d ? X[(row0 + j) * d + c0 + c] : 0.f;
      }
    } else {
      for (int j = 0; j < BN; ++j) {
        const bool rok = j < RB && row0 + j < n;
        for (int c = tid; c < cw; c += THREADS)
          dst[j * SP + c] = rok && c0 + c < d ? X[(row0 + j) * d + c0 + c] : 0.f;
      }
    }
  };
  unsigned fill = 0;  // bit b: the parity of buffer b's next fill to wait for

  if (tid == 0) {
    mbar_init(bar, BN);
    mbar_init(bar + 1, BN);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(0, 0, 0);
  if (WS)
    for (int c = tid; c < wpitch(d); c += THREADS) w[c] = c < d ? W[c] : 0.f;
  // |w|^2: strided partial sums, a warp tree, then the warps' sums in
  // order (every thread ends with the same value).
  __syncthreads();
  float part = 0.f;
  for (int c = tid; c < d; c += THREADS) part = fmaf(w[c], w[c], part);
  part = warp_sum(part);
  if (t == 0) hb[wp] = part;
  __syncthreads();
  float wsq = 0.f;
  for (int i = 0; i < WARPS; ++i) wsq += hb[i];

  float r = RULE == ALG1 ? S[0] : 0.f, xi2 = RULE == ALG1 ? S[1] : 0.f;
  const float cinv = RULE == ALG1 ? S[2] : 0.f, gain = RULE == ALG1 ? S[3] : 0.f;
  int m = PEGASOS ? 0 : M[0];
  const float radius = PEGASOS ? __fdiv_rn(1.0f, __fsqrt_rn(lam)) : 0.f;
  float h = 0.f, yrow = 0.f, decay = 1.f;
  double pw2 = wsq;    // PEGASOS: |w|^2, by recursion within a block
  double wsum = 0.0;   // PEGASOS: this thread's part of |w|^2 after the deferred replay
  // PEGASOS: the block's violating rows, and the last rows of its steps
  // whose projection bound (the same in every thread)
  unsigned vmask = 0u, smask = 0u;
  // The g pass: rows 4 wp + (t >> 3); lane k = t & 7 takes the chunk's
  // columns 4 k + 32 u .. + 3, u ascending.
  const int grow = 4 * wp + (t >> 3), k = t & 7;

  int blk = 0, within = 0, xbuf = 0;  // step s is step `within` of block blk
  for (int s = 0; s < steps; ++s) {
    const bool g_pass = within < nc;
    const bool fresh = g_pass || !whole;  // a chunk the previous step did not read
    const int ch = g_pass ? within : within - nc;
    const long row0 = (long)blk * RB;
    const int nwithin = within + 1 == 2 * nc ? 0 : within + 1;  // step s + 1
    const int nblk = nwithin == 0 ? blk + 1 : blk;
    if (fresh && vec16) {  // the step's chunk is in place
      mbar_wait(bar + xbuf, (fill >> xbuf) & 1u);
      fill ^= 1u << xbuf;
    }
    __syncthreads();  // (the element loads too); every thread is past step s - 1
    if (fresh) {  // the next fresh chunk, into the other buffer
      if (whole) {
        if (blk + 1 < nblocks) stage(blk + 1, 0, xbuf ^ 1);
      } else if (s + 1 < steps) {
        stage(nblk, nwithin < nc ? nwithin : nwithin - nc, xbuf ^ 1);
      }
    }
    if (within == 0) {  // the block's Gram, needed after its g pass
      for (int e = tid; e < BN * BN / 4; e += THREADS)
        cp_async16(gs + 4 * e, G + (long)blk * BN * BN + 4 * e, true);
      cp_async_commit();
      yrow = t < RB && row0 + t < n ? Y[row0 + t] : 0.f;
    }
    const float* xc = xb + xbuf * BN * SP;
    const int c0 = ch * cw;
    if (g_pass) {
      if (ch == 0) h = 0.f;
      const int cols = min(cw, d - c0);
      const float* xr = xc + grow * SP;
#pragma unroll 4
      for (int c = 4 * k; c < cols; c += 32) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr + c);
        float w4[4];
        if (WS) {  // zero past d up to the row's pitch
          const float4 v = *reinterpret_cast<const float4*>(w + c0 + c);
          w4[0] = v.x, w4[1] = v.y, w4[2] = v.z, w4[3] = v.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) w4[i] = c + i < cols ? W[c0 + c + i] : 0.f;
        }
        h = fmaf(w4[0], x4.x, h);
        h = fmaf(w4[1], x4.y, h);
        h = fmaf(w4[2], x4.z, h);
        h = fmaf(w4[3], x4.w, h);
      }
      if (ch == nc - 1) {  // h of the row: the 8 lanes' chains, combined
        h += __shfl_xor_sync(FULL, h, 4);
        h += __shfl_xor_sync(FULL, h, 2);
        h += __shfl_xor_sync(FULL, h, 1);
        if (k == 0) hb[grow] = h;
        cp_async_wait<0>();  // the Gram
        __syncthreads();
        float g = yrow * hb[t];  // g_t = <w, y_t x_t>
        const float gtt = gs[t * BN + t];
        float alpha = 0.f;
        decay = 1.f;
        // A row that does not update changes nothing, so the rows between
        // two updates are independent: lane t takes row t's distance under
        // the state after the last update, and the lowest violating row
        // past it updates next. The same distances and decisions as a walk
        // over the rows in order, in one step per update (plus one).
        for (int j0 = 0; PERCEPTRON;) {  // the perceptron: a mistake is g_t <= 0
          const unsigned viol =
              __ballot_sync(FULL, t >= j0 && g <= 0.0f && row0 + t < n_valid && yrow != 0.0f);
          if (viol == 0u) break;
          const int j = __ffs(viol) - 1;
          g += gs[j * BN + t];  // w += y_j x_j
          if (t == j) alpha = 1.f;
          m += 1;
          j0 = j + 1;
        }
        for (int j0 = 0; RULE == ALG1;) {
          const float d2 = wsq - 2.0f * g + gtt + xi2 + cinv;
          const float dist_t = sqrtf(fmaxf(d2, 1e-12f));
          const unsigned viol = __ballot_sync(
              FULL, t >= j0 && dist_t >= r && row0 + t < n_valid && yrow != 0.0f);
          if (viol == 0u) break;  // the same in every thread: no divergence
          const int j = __ffs(viol) - 1;
          const float gj = __shfl_sync(FULL, g, j);
          const float dist = __shfl_sync(FULL, dist_t, j);
          const float gjj = gs[j * BN + j];
          const float s = 0.5f * (1.0f - r / dist);
          const float one_s = 1.0f - s;
          g = one_s * g + s * gs[j * BN + t];
          alpha = t == j ? s : one_s * alpha;
          decay = decay * one_s;
          wsq = one_s * one_s * wsq + 2.0f * s * one_s * gj + s * s * gjj;
          r = r + 0.5f * (dist - r);
          xi2 = xi2 * one_s * one_s + s * s * gain;
          m += 1;
          j0 = j + 1;
        }
        if (PEGASOS) {
          // Lane t's step (of k rows; a block holds whole steps), its
          // scalars as the reference rounds them (coef = -eta / k = -ak),
          // and whether it is the step's first lane. |w|^2: after block 0,
          // the last deferred replay's, recomputed from w.
          const int first = t / k_step * k_step;
          const bool lead = t == first;
          const bool live = t < RB && row0 + t < n_valid;
          const float tf = (float)((row0 + t) / k_step);
          const float eta = __fdiv_rn(1.0f, __fmul_rn(lam, __fadd_rn(tf, 1.0f)));
          const float fct = __fsub_rn(1.0f, __fmul_rn(eta, lam));
          const float ak = __fdiv_rn(eta, (float)k_step);
          const unsigned stepmask = k_step >= 32 ? FULL : (1u << k_step) - 1u;
          if (blk > 0) {
            pw2 = 0.0;
            for (int i = 0; i < WARPS; ++i) pw2 += wq[i];
          }
          bool viol_row = false;    // row t violated
          float step_scale = 1.0f;  // the projection's scale of t's step
          for (int j0 = 0;;) {
            // p_t: the factors of the steps from j0's up to t's, t's own
            // excluded (an inclusive product scan over the steps' first
            // lanes, read at the lane before t's step).
            float q = live && lead && t >= j0 ? fct : 1.0f;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const float o = __shfl_up_sync(FULL, q, off);
              if (t >= off) q *= o;
            }
            const float pb = __shfl_sync(FULL, q, first > 0 ? first - 1 : 0);
            const float p = first > 0 ? pb : 1.0f;
            const bool open = live && t >= j0;
            const bool viol = open && p * g < 1.0f;
            // A step whose projection would bind without a violation.
            const float c = fct * p;
            const float nrm = (float)sqrt((double)c * c * pw2);
            const bool bind =
                open && lead && fminf(1.0f, radius / fmaxf(nrm, 1e-12f)) < 1.0f;
            const unsigned hit = __ballot_sync(FULL, viol || bind);
            if (hit == 0u) break;  // the block's last steps only decay w
            const int s0 = (__ffs(hit) - 1) / k_step * k_step;  // the round's step
            const unsigned vio = __ballot_sync(FULL, viol) & (stepmask << s0);
            const float cs = __shfl_sync(FULL, c, s0);
            const float a_s = __shfl_sync(FULL, ak, s0);
            float u = 0.f;  // sum over V of G_rt
            for (unsigned v = vio; v != 0u; v &= v - 1u) u += gs[(__ffs(v) - 1) * BN + t];
            const bool in = (vio >> t) & 1u;
            const float sg = warp_sum(in ? g : 0.f);
            const float su = warp_sum(in ? u : 0.f);
            pw2 = (double)cs * cs * pw2 + 2.0 * cs * a_s * sg + (double)a_s * a_s * su;
            const float scale = fminf(1.0f, radius / fmaxf((float)sqrt(pw2), 1e-12f));
            g = scale * (cs * g + a_s * u);
            pw2 *= (double)scale * scale;
            if (t >= s0 && t < s0 + k_step) step_scale = scale;
            viol_row |= in;
            j0 = s0 + k_step;
          }
          vmask = __ballot_sync(FULL, viol_row);
          smask = __ballot_sync(FULL, step_scale != 1.0f && t % k_step == k_step - 1);
          if (wp == 0) {
            ay[t] = viol_row ? -yrow : 0.f;
            fb[t] = fct;
            cb[t] = -ak;
            sb[t] = step_scale;
            if (F != nullptr && t < RB && row0 + t < n) F[row0 + t] = viol_row;
          }
        } else if (wp == 0) {
          ay[t] = alpha * yrow;
          if (PERCEPTRON && F != nullptr && row0 + t < n) F[row0 + t] = alpha != 0.f;
        }
      }
    } else if (PEGASOS) {
      // The deferred replay of columns tid + 256 u (cw <= 4 * 256): each
      // through the block's steps in order with the reference's f32
      // operations, w <- (f w + coef sum_r -(viol_r y_r) x_r) scale, each
      // rounded on its own, so w takes the plain version's roundings (a
      // product of the steps' factors would round each far less, and the
      // plain version's w drifts from that by more than the engine
      // tolerance over a long sweep). Then |w|^2 for the next block.
      const int cols = min(cw, d - c0);
      const int rows = (int)min((long)RB, (long)n - row0);
      const unsigned stepmask = k_step >= 32 ? FULL : (1u << k_step) - 1u;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = tid + THREADS * u;
        v[u] = c < cols ? w[c0 + c] : 0.f;
      }
      // A step without a violation is f w (its coef * 0 adds nothing), and
      // a scale of 1 changes nothing: those operations are skipped. The
      // step's sum runs over its violating rows in order (the others add
      // zeros).
#pragma unroll 4
      for (int s0 = 0; s0 < rows; s0 += k_step) {
        const int last = s0 + k_step - 1;
        const float f = fb[last];
        const unsigned sv = (vmask >> s0) & stepmask;
        if (sv == 0u) {
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(f, v[u]);
        } else {
          float sa[4] = {0.f, 0.f, 0.f, 0.f};
          for (unsigned m = sv; m != 0u; m &= m - 1u) {
            const int j = s0 + __ffs(m) - 1;
            const float nv = ay[j];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              sa[u] = __fadd_rn(sa[u], __fmul_rn(nv, xc[j * SP + tid + THREADS * u]));
          }
          const float co = cb[last];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = __fadd_rn(__fmul_rn(f, v[u]), __fmul_rn(co, sa[u]));
        }
        if ((smask >> last) & 1u) {
          const float sc = sb[last];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(v[u], sc);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = tid + THREADS * u;
        if (c < cols) {
          w[c0 + c] = v[u];
          wsum = fma((double)v[u], (double)v[u], wsum);
        }
      }
      if (ch == nc - 1) {  // |w|^2 of the block's end, for the next block
        for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(FULL, wsum, off);
        if (t == 0) wq[wp] = wsum;
        wsum = 0.0;
      }
    } else {
      // The deferred update of columns tid + 256 u (cw <= 4 * 256): one
      // chain over the rows each, the four interleaved. Past the chunk's
      // columns the reads stay in shared memory and go unused.
      const int cols = min(cw, d - c0);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < BN; ++j) {
        const float a = ay[j];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(a, xc[j * SP + tid + THREADS * u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = tid + THREADS * u;
        if (c < cols) w[c0 + c] = decay * w[c0 + c] + acc[u];
      }
    }
    if (nwithin < nc || !whole) xbuf ^= 1;  // step s + 1 reads a fresh chunk
    blk = nblk;
    within = nwithin;
  }
  if (tid == 0) {
    if (RULE == ALG1) {
      S[0] = r;
      S[1] = xi2;
    }
    if (!PEGASOS) M[0] = m;
  }
  if (WS) {
    __syncthreads();
    for (int c = tid; c < d; c += THREADS) W[c] = w[c];
  }
}

template <bool WS, Rule RULE>
int launch(const void* X, const void* Y, void* G, void* W, void* S, void* M, void* F, int n,
           int n_valid, int d, int cw, int vec16, float lam, int k, int rb, cudaStream_t s) {
  const size_t dyn = single_dyn_bytes(d, WS, cw, RULE == PEG);
  cudaError_t err = cudaFuncSetAttribute((const void*)single_kernel<WS, RULE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  err = signed_gram::launch((const float*)X, (const float*)Y, (float*)G, n, d, rb, BN, s);
  if (err != cudaSuccess) return (int)err;
  single_kernel<WS, RULE><<<1, THREADS, dyn, s>>>(
      (const float*)X, (const float*)Y, (const float*)G, (float*)W, (float*)S, (int*)M,
      (unsigned char*)F, n, n_valid, d, cw, vec16, lam, k, rb);
  return (int)cudaGetLastError();
}

bool bad_layout(int n, int d, int cw) {
  return n <= 0 || d <= 0 || cw <= 0 || cw % 4 != 0 || (cw != SDC && cw < d);
}

}  // namespace

extern "C" {

// Rows per internal block: the Gram scratch holds ceil(n / BN) * BN * BN
// floats.
int streamsvm_single_block_rows() { return BN; }

// Dynamic shared memory the kernel requests (its only shared memory), with
// the w row in shared memory (w_smem != 0) or in device memory, and staged
// chunks of cw columns.
long streamsvm_single_dyn_bytes(int d, int w_smem, int cw) {
  return (long)single_dyn_bytes(d, w_smem, cw, false);
}

// The same for P2 (pegasos_single), which adds the warps' |w|^2 sums.
long pegasos_single_dyn_bytes(int d, int w_smem, int cw) {
  return (long)single_dyn_bytes(d, w_smem, cw, true);
}

// The staged chunk's columns where no whole block fits.
int streamsvm_single_chunk() { return SDC; }

// X (n, d) and Y (n,) f32; W (d,) f32 updated in place; S (4,) f32
// [r, xi2, 1/C, gain] with r and xi2 updated; M (1,) int32 updated.
// G is scratch for the block Grams. w_smem != 0 keeps w in shared memory;
// cw: the staged chunk's columns, d rounded up to 4 (whole blocks) or SDC
// (streamsvm_single_dyn_bytes(d, w_smem, cw) must fit the card); vec16 as
// single_kernel's. Returns the CUDA error of the launches (0 on success).
int streamsvm_single(const void* X, const void* Y, void* G, void* W, void* S, void* M, int n,
                     int n_valid, int d, int w_smem, int cw, int vec16, void* stream) {
  if (bad_layout(n, d, cw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch<true, ALG1>(X, Y, G, W, S, M, nullptr, n, n_valid, d, cw, vec16, 0.f, 1,
                                     BN, s)
                : launch<false, ALG1>(X, Y, G, W, S, M, nullptr, n, n_valid, d, cw, vec16, 0.f, 1,
                                      BN, s);
}

// P1: one pass of the perceptron over X (n, d) and Y (n,) (signs; 0: inert
// row) on the layout of streamsvm_single (G, w_smem, cw, vec16 the same).
// W (d,) is updated in place (zero for a fresh fit); M (1,) int32 counts the
// mistakes on top of its value; F (n,) uint8 gets each row's decision, or
// is null. Returns the CUDA error of the launches (0 on success).
int perceptron_single(const void* X, const void* Y, void* G, void* W, void* M, void* F, int n,
                      int n_valid, int d, int w_smem, int cw, int vec16, void* stream) {
  if (bad_layout(n, d, cw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch<true, PERC>(X, Y, G, W, nullptr, M, F, n, n_valid, d, cw, vec16, 0.f, 1,
                                     BN, s)
                : launch<false, PERC>(X, Y, G, W, nullptr, M, F, n, n_valid, d, cw, vec16, 0.f, 1,
                                      BN, s);
}

// Rows a block of P2's walk at k rows a step (whole steps, k <= BN): the
// Gram scratch holds ceil(n / rows) * BN * BN floats.
int pegasos_single_block_rows(int k) { return k >= 1 && k <= BN ? BN / k * k : 0; }

// P2: one sweep of Pegasos over n / k steps of k rows (1 <= k <= BN, n a
// multiple of k) of X (n, d) with signs Y (n,), lam > 0, on the layout of
// streamsvm_single (G, w_smem, cw, vec16 the same; the dynamic bytes are
// pegasos_single_dyn_bytes). W (d,) f32 is the start (zero for a fresh
// fit), updated in place; F (n,) uint8 gets each row's violation, or is
// null. Returns the CUDA error of the launches (0 on success).
int pegasos_single(const void* X, const void* Y, void* G, void* W, void* F, int n, int d,
                   float lam, int k, int w_smem, int cw, int vec16, void* stream) {
  if (bad_layout(n, d, cw) || k < 1 || k > BN || n % k != 0 || !(lam > 0.f))
    return (int)cudaErrorInvalidValue;
  const int rb = BN / k * k;
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch<true, PEG>(X, Y, G, W, nullptr, nullptr, F, n, n, d, cw, vec16, lam, k,
                                    rb, s)
                : launch<false, PEG>(X, Y, G, W, nullptr, nullptr, F, n, n, d, cw, vec16, lam, k,
                                     rb, s);
}

}  // extern "C"
