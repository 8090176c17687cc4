// B4 on Hopper: one pass of Algorithm 1 for ONE model over a stream of
// label-signed rows, with a plain C interface (bound with ctypes).
//
// Replaces src/repro/kernels/streamsvm_scan.py::_kernel (driven there by
// streamsvm_scan_pallas).
//
// Layout. One model has only the stream axis, and its recursion is
// sequential in the rows, so one CTA of 256 threads walks the whole stream
// in internal blocks of BN = 32 rows. What does not depend on the model
// runs beside it: a pre-pass kernel computes every block's Gram of the
// signed rows, G_jk = <y_j x_j, y_k x_k>, over the whole card, into global
// memory. The CTA keeps the model's w row in shared memory where it fits
// (else it works on w in device memory) and stages the stream two buffers
// deep, each staged row one bulk copy of the tensor memory accelerator
// (cp.async.bulk onto the buffer's mbarrier: per-thread 16-byte cp.async
// from one lone SM stalls the very threads that issue it), the
// block's Gram by cp.async from its first step: where two whole blocks fit
// (D up to ~870, Fig 3's 784 among them), each buffer holds a whole 32-row
// block, copied a block ahead and read by both passes; else (BN, SDC)
// chunks, each copied one step ahead. Per block: the g pass over
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
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;        // rows per internal block
constexpr int THREADS = 256;  // one CTA
constexpr int WARPS = THREADS / 32;
constexpr int DC = 128;       // feature columns staged per chunk (Gram pre-pass)
constexpr int SDC = 256;      // feature columns of a staged chunk where no whole block fits
constexpr unsigned FULL = 0xffffffffu;

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

// Dynamic shared memory of single_kernel, in bytes, for staged chunks of
// cw columns (a multiple of 4; at a row pitch of cw + 4): two chunks, the
// block Gram, h and alpha*y (BN each), the two chunks' mbarriers (4 floats'
// room), then the w row when it lives there.
size_t single_dyn_bytes(int d, int w_smem, int cw) {
  return sizeof(float) *
         ((size_t)2 * BN * (cw + 4) + BN * BN + 2 * BN + 4 + (w_smem ? wpitch(d) : 0));
}

// G[blk][j][k] = <y_j x_j, y_k x_k> for the rows of block blk; rows >= n
// read as zero.
__global__ void __launch_bounds__(THREADS)
signed_gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ G, int n, int d) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float ys[BN];
  const int tid = threadIdx.x;
  const int k = tid & 31;
  const int jb = tid >> 5;
  const long row0 = (long)blockIdx.x * BN;
  if (tid < BN) ys[tid] = row0 + tid < n ? Y[row0 + tid] : 0.f;
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < d; d0 += DC) {
    for (int e = tid; e < BN * DC; e += THREADS) {
      const int j = e / DC, c = e % DC;
      const long row = row0 + j;
      const int col = d0 + c;
      xs[j][c] = (row < n && col < d) ? X[row * d + col] * ys[j] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < DC; ++c) {
      const float xk = xs[k][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[jb + 8 * i][c], xk, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) G[(row0 + jb + 8 * i) * BN + k] = acc[i];
}

// S = [r, xi2, 1/C, gain] and M = [m] are read at the start and r, xi2, m
// written back at the end; W (d,) is updated in place, through its copy in
// shared memory when WS. PERC: the perceptron's rule (S unused, M counts
// the mistakes, F (n,) the rows' decisions where not null). cw: the staged
// chunk's columns (d rounded up to 4: whole blocks; else SDC). vec16: X
// 16-byte aligned with d a multiple of 4 (each staged row is then one bulk
// copy, else element loads).
template <bool WS, bool PERC>
__global__ void __launch_bounds__(THREADS)
single_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              const float* __restrict__ G, float* __restrict__ W, float* __restrict__ S,
              int* __restrict__ M, unsigned char* __restrict__ F, int n, int n_valid, int d,
              int cw, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int SP = cw + 4;          // a staged row's pitch: 8 rows' 16-byte reads in distinct banks
  float* xb = smem;               // [2][BN][SP]
  float* gs = xb + 2 * BN * SP;   // [BN][BN]
  float* hb = gs + BN * BN;       // [BN]: h, and the warps' |w|^2 sums at the start
  float* ay = hb + BN;            // [BN]: alpha * y
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ay + BN);  // [2]
  float* w = WS ? ay + BN + 4 : W;  // [wpitch(d)] when WS
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int wp = tid >> 5;
  const int nc = (d + cw - 1) / cw;
  const bool whole = nc == 1;  // the update reads the g pass's buffer again
  const int nblocks = (n + BN - 1) / BN;
  const int steps = nblocks * 2 * nc;  // per block: the g pass, then the update
  // Start the copy of chunk ch of block blk into buffer buf. vec16: lanes
  // 0..3 of each warp take a row each (row 4 wp + lane): one bulk copy onto
  // the buffer's mbarrier (BN arrivals), whose wait (fill, the parity)
  // completes it; a row past n is zeroed instead (the columns past d, which
  // a 16-byte-aligned chunk never reads, are not). Else element loads, zero
  // past n and d, complete at the next barrier.
  auto stage = [&](int blk, int ch, int buf) {
    float* dst = xb + buf * BN * SP;
    const long row0 = (long)blk * BN;
    const int c0 = ch * cw;
    if (vec16) {
      if (t >= BN / WARPS) return;
      const int j = (BN / WARPS) * wp + t;
      float* row = dst + j * SP;
      if (row0 + j < n) {
        const unsigned bytes = 4u * min(cw, d - c0);
        mbar_expect_tx(bar + buf, bytes);
        bulk_copy(row, X + (row0 + j) * d + c0, bytes, bar + buf);
      } else {
        for (int c = 0; c < cw; ++c) row[c] = 0.f;
        mbar_arrive(bar + buf);
      }
    } else {
      for (int j = 0; j < BN; ++j) {
        const bool rok = row0 + j < n;
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

  float r = PERC ? 0.f : S[0], xi2 = PERC ? 0.f : S[1];
  const float cinv = PERC ? 0.f : S[2], gain = PERC ? 0.f : S[3];
  int m = M[0];
  float h = 0.f, yrow = 0.f, decay = 1.f;
  // The g pass: rows 4 wp + (t >> 3); lane k = t & 7 takes the chunk's
  // columns 4 k + 32 u .. + 3, u ascending.
  const int grow = 4 * wp + (t >> 3), k = t & 7;

  int blk = 0, within = 0, xbuf = 0;  // step s is step `within` of block blk
  for (int s = 0; s < steps; ++s) {
    const bool g_pass = within < nc;
    const bool fresh = g_pass || !whole;  // a chunk the previous step did not read
    const int ch = g_pass ? within : within - nc;
    const long row0 = (long)blk * BN;
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
        cp_async16(gs + 4 * e, G + row0 * BN + 4 * e, true);
      cp_async_commit();
      yrow = row0 + t < n ? Y[row0 + t] : 0.f;
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
        for (int j0 = 0; PERC;) {  // the perceptron: a mistake is g_t <= 0
          const unsigned viol =
              __ballot_sync(FULL, t >= j0 && g <= 0.0f && row0 + t < n_valid && yrow != 0.0f);
          if (viol == 0u) break;
          const int j = __ffs(viol) - 1;
          g += gs[j * BN + t];  // w += y_j x_j
          if (t == j) alpha = 1.f;
          m += 1;
          j0 = j + 1;
        }
        for (int j0 = 0; !PERC;) {
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
        if (wp == 0) ay[t] = alpha * yrow;
        if (PERC && F != nullptr && wp == 0 && row0 + t < n) F[row0 + t] = alpha != 0.f;
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
    if (!PERC) {
      S[0] = r;
      S[1] = xi2;
    }
    M[0] = m;
  }
  if (WS) {
    __syncthreads();
    for (int c = tid; c < d; c += THREADS) W[c] = w[c];
  }
}

template <bool WS, bool PERC>
int launch(const void* X, const void* Y, void* G, void* W, void* S, void* M, void* F, int n,
           int n_valid, int d, int cw, int vec16, cudaStream_t s) {
  const size_t dyn = single_dyn_bytes(d, WS, cw);
  cudaError_t err = cudaFuncSetAttribute((const void*)single_kernel<WS, PERC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + BN - 1) / BN;
  signed_gram_kernel<<<nblocks, THREADS, 0, s>>>((const float*)X, (const float*)Y, (float*)G, n,
                                                 d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  single_kernel<WS, PERC><<<1, THREADS, dyn, s>>>((const float*)X, (const float*)Y,
                                                  (const float*)G, (float*)W, (float*)S, (int*)M,
                                                  (unsigned char*)F, n, n_valid, d, cw, vec16);
  return (int)cudaGetLastError();
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
  return (long)single_dyn_bytes(d, w_smem, cw);
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
  if (n <= 0 || d <= 0 || cw <= 0 || cw % 4 != 0 || (cw != SDC && cw < d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch<true, false>(X, Y, G, W, S, M, nullptr, n, n_valid, d, cw, vec16, s)
                : launch<false, false>(X, Y, G, W, S, M, nullptr, n, n_valid, d, cw, vec16, s);
}

// P1: one pass of the perceptron over X (n, d) and Y (n,) (signs; 0: inert
// row) on the layout of streamsvm_single (G, w_smem, cw, vec16 the same).
// W (d,) is updated in place (zero for a fresh fit); M (1,) int32 counts the
// mistakes on top of its value; F (n,) uint8 gets each row's decision, or
// is null. Returns the CUDA error of the launches (0 on success).
int perceptron_single(const void* X, const void* Y, void* G, void* W, void* M, void* F, int n,
                      int n_valid, int d, int w_smem, int cw, int vec16, void* stream) {
  if (n <= 0 || d <= 0 || cw <= 0 || cw % 4 != 0 || (cw != SDC && cw < d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch<true, true>(X, Y, G, W, nullptr, M, F, n, n_valid, d, cw, vec16, s)
                : launch<false, true>(X, Y, G, W, nullptr, M, F, n, n_valid, d, cw, vec16, s);
}

}  // extern "C"
