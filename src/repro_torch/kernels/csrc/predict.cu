// B2 on Hopper: score a tile of queries against a bank with a fused
// epilogue, with a plain C interface (bound from Python with ctypes).
//
// Replaces src/repro/kernels/predict.py::_kernel (predict_bank_pallas) in
// its VMEM layout, with _first_argmax.
//
// Layout. One CTA per QT = 32 query rows and one column of bank lanes: a
// column is SCORES_TILE lanes for "scores", one bank tile of whole groups
// for "ovr" (so a group never crosses a CTA) and the whole bank for "topk"
// (whose running list spans the bank). The CTA loops over its lanes in
// chunks of BT = 32, and over D in staged chunks of DC columns. Each margin
// S[q, b] = <q, w_b> is one f32 dot product over the full D, summed in
// ascending order with FMAs on the CUDA cores (no TF32, no library GEMM).
// The epilogue then runs in the CTA:
//   scores  raw S, no bias;
//   ovr     S + bias, then per group of nc_pad lanes the first argmax and
//           its margin (a running max that a strictly greater value
//           replaces, reset at each group's first lane);
//   topk    S + bias, kept in a running sorted list of k (score, id) per
//           query in shared memory, across the whole bank: a candidate
//           goes in after every entry it does not beat, so ties go to the
//           lowest lane and the list is in descending order.
// bf16 query tiles are upcast on load; the bank, bias and epilogue state
// are f32.
//
// Bound. 2 Q B D flops against Q D + B D input bytes: at the served shapes
// the card is bound by its f32 rate. This simple kernel is held back by
// shared-memory operand traffic (five loads per four FMAs) and, per server
// step, by launch overhead.
//
// B6 serve (predict_ring_kernel below), bank_resident="hbm": replaces the
// same _kernel with hbm=True (src/repro/kernels/predict.py:94-134), where
// W stays in ANY space and (b_tile, D) slices pass through a read-only
// 2-slot VMEM ring. Here one CTA per QT query rows walks every bank lane in
// order, the query tile outer as in the TPU grid. Its steps are (BT-lane
// chunk, RDC-column chunk) pairs; the W chunk of step t + 1 is copied into
// the other of two shared-memory slots by cp.async before the compute on
// step t starts. Each margin is the same ascending f32 chain over D as in
// B2, and the epilogues run in lane order as in B2's column (a group's
// running argmax resets at its first lane; topk's list spans the bank), so
// the ring equals B2 bit for bit. Bound: B2's work; the ring's chunks are
// half as wide (its slots and query tile fit in less shared memory than
// B2's tiles) and it keeps no second grid axis over the bank.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 32;   // query rows per CTA
constexpr int BT = 32;   // bank lanes per chunk
constexpr int DC = 128;  // feature columns staged per chunk
constexpr int THREADS = 256;
constexpr int SCORES_TILE = 64;  // bank lanes per CTA column for "scores"
constexpr float NEG_MASK = -3.0e38f;
enum { SCORES = 0, OVR = 1, TOPK = 2 };

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
predict_kernel(const T* __restrict__ Q, const float* __restrict__ W,
               const float* __restrict__ bias, int qn, int bp, int d,
               int epilogue, int nc_pad, int k, int tile,
               float* __restrict__ out_f, int* __restrict__ out_i) {
  __shared__ float qs[QT][DC + 1];
  __shared__ float wsm[BT][DC + 1];
  __shared__ float ss[QT][BT + 1];
  extern __shared__ float topk_state[];  // QT*k values, then QT*k ids
  const int tid = threadIdx.x;
  const int bl = tid & 31;  // bank lane within the chunk
  const int qb = tid >> 5;  // first query row of this thread (+8 i)
  const long q0 = (long)blockIdx.x * QT;
  const long my_q = q0 + tid;  // epilogue row of threads tid < QT
  const bool owner = tid < QT && my_q < qn;

  float* tv = topk_state + tid * k;
  int* ti = (int*)(topk_state + QT * k) + tid * k;
  if (epilogue == TOPK && owner) {
    for (int i = 0; i < k; ++i) {
      tv[i] = NEG_MASK;
      ti[i] = 0;
    }
  }
  float best = 0.f;
  int arg = 0;
  const int gp = epilogue == OVR ? bp / nc_pad : 0;

  const int lo = blockIdx.y * tile;
  const int hi = lo + tile < bp ? lo + tile : bp;
  for (int b0 = lo; b0 < hi; b0 += BT) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < QT * DC; e += THREADS) {
        const int j = e / DC, c = e % DC;
        const int col = d0 + c;
        qs[j][c] = (q0 + j < qn && col < d) ? ld(Q, (q0 + j) * d + col) : 0.f;
      }
      for (int e = tid; e < BT * DC; e += THREADS) {
        const int j = e / DC, c = e % DC;
        const int col = d0 + c;
        wsm[j][c] = (b0 + j < hi && col < d) ? W[(long)(b0 + j) * d + col] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < DC; ++c) {
        const float wv = wsm[bl][c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(qs[qb + 8 * i][c], wv, acc[i]);
      }
      __syncthreads();
    }
    const int b = b0 + bl;
    if (epilogue == SCORES) {
      if (b < hi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long q = q0 + qb + 8 * i;
          if (q < qn) out_f[q * bp + b] = acc[i];
        }
      }
      continue;
    }
    const float bb = b < hi ? bias[b] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss[qb + 8 * i][bl] = acc[i] + bb;
    __syncthreads();
    if (owner) {
      const int lim = hi - b0 < BT ? hi - b0 : BT;
      for (int c = 0; c < lim; ++c) {
        const float v = ss[tid][c];
        const int lane = b0 + c;
        if (epilogue == OVR) {
          const int cls = lane % nc_pad;
          if (cls == 0 || v > best) {
            best = v;
            arg = cls;
          }
          if (cls == nc_pad - 1) {
            out_i[my_q * gp + lane / nc_pad] = arg;
            out_f[my_q * gp + lane / nc_pad] = best;
          }
        } else if (v > tv[k - 1]) {
          int p = k - 1;
          while (p > 0 && v > tv[p - 1]) {
            tv[p] = tv[p - 1];
            ti[p] = ti[p - 1];
            --p;
          }
          tv[p] = v;
          ti[p] = lane;
        }
      }
    }
    __syncthreads();  // ss is rewritten by the next chunk
  }
  if (epilogue == TOPK && owner) {
    for (int i = 0; i < k; ++i) {
      out_f[my_q * k + i] = tv[i];
      out_i[my_q * k + i] = ti[i];
    }
  }
}

template <typename T>
int launch(const void* Q, const void* W, const void* bias, int qn, int bp,
           int d, int epilogue, int nc_pad, int k, int tile, void* out_f,
           void* out_i, cudaStream_t s) {
  const size_t dyn = epilogue == TOPK ? (size_t)QT * k * (sizeof(float) + sizeof(int)) : 0;
  if (dyn > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)predict_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((qn + QT - 1) / QT, (bp + tile - 1) / tile);
  predict_kernel<T><<<grid, THREADS, dyn, s>>>(
      (const T*)Q, (const float*)W, (const float*)bias, qn, bp, d, epilogue,
      nc_pad, k, tile, (float*)out_f, (int*)out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6 serve: the ring
// ---------------------------------------------------------------------------

constexpr int RDC = 64;                      // ring columns per chunk
constexpr int RING_FLOATS = 2 * BT * (RDC + 1);  // the two W slots

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Start the copy of the W chunk of step `step` (lane chunk step / nd, column
// chunk step % nd) into slot, as one cp.async group of every thread; lanes
// past bp and columns past d are zero-filled.
__device__ __forceinline__ void ring_load(float (*slot)[RDC + 1], const float* W,
                                          int step, int nd, int bp, int d, int tid) {
  const int b0 = step / nd * BT, d0 = step % nd * RDC;
  for (int e = tid; e < BT * RDC; e += THREADS) {
    const int j = e / RDC, c = e % RDC;
    const bool ok = b0 + j < bp && d0 + c < d;
    cp_async4(&slot[j][c], ok ? W + (long)(b0 + j) * d + d0 + c : W, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
predict_ring_kernel(const T* __restrict__ Q, const float* __restrict__ W,
                    const float* __restrict__ bias, int qn, int bp, int d,
                    int epilogue, int nc_pad, int k, float* __restrict__ out_f,
                    int* __restrict__ out_i) {
  __shared__ float qs[QT][RDC + 1];
  __shared__ float ss[QT][BT + 1];
  extern __shared__ float dyn[];  // the two W slots, then QT*k values, QT*k ids
  float (*ring)[BT][RDC + 1] = (float (*)[BT][RDC + 1])dyn;
  float* topk_state = dyn + RING_FLOATS;
  const int tid = threadIdx.x;
  const int bl = tid & 31;  // bank lane within the chunk
  const int qb = tid >> 5;  // first query row of this thread (+8 i)
  const long q0 = (long)blockIdx.x * QT;
  const long my_q = q0 + tid;  // epilogue row of threads tid < QT
  const bool owner = tid < QT && my_q < qn;

  float* tv = topk_state + tid * k;
  int* ti = (int*)(topk_state + QT * k) + tid * k;
  if (epilogue == TOPK && owner) {
    for (int i = 0; i < k; ++i) {
      tv[i] = NEG_MASK;
      ti[i] = 0;
    }
  }
  float best = 0.f;
  int arg = 0;
  const int gp = epilogue == OVR ? bp / nc_pad : 0;

  const int nd = (d + RDC - 1) / RDC;
  const int steps = (bp + BT - 1) / BT * nd;
  ring_load(ring[0], W, 0, nd, bp, d, tid);
  int step = 0;
  for (int b0 = 0; b0 < bp; b0 += BT) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < d; d0 += RDC, ++step) {
      if (step + 1 < steps) {  // prefetch step + 1 before computing step
        ring_load(ring[(step + 1) & 1], W, step + 1, nd, bp, d, tid);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      for (int e = tid; e < QT * RDC; e += THREADS) {
        const int j = e / RDC, c = e % RDC;
        const int col = d0 + c;
        qs[j][c] = (q0 + j < qn && col < d) ? ld(Q, (q0 + j) * d + col) : 0.f;
      }
      __syncthreads();
      const float (*wsm)[RDC + 1] = ring[step & 1];
      for (int c = 0; c < RDC; ++c) {
        const float wv = wsm[bl][c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(qs[qb + 8 * i][c], wv, acc[i]);
      }
      __syncthreads();  // the slot and qs may be refilled
    }
    const int b = b0 + bl;
    if (epilogue == SCORES) {
      if (b < bp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long q = q0 + qb + 8 * i;
          if (q < qn) out_f[q * bp + b] = acc[i];
        }
      }
      continue;
    }
    const float bb = b < bp ? bias[b] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss[qb + 8 * i][bl] = acc[i] + bb;
    __syncthreads();
    if (owner) {
      const int lim = bp - b0 < BT ? bp - b0 : BT;
      for (int c = 0; c < lim; ++c) {
        const float v = ss[tid][c];
        const int lane = b0 + c;
        if (epilogue == OVR) {
          const int cls = lane % nc_pad;
          if (cls == 0 || v > best) {
            best = v;
            arg = cls;
          }
          if (cls == nc_pad - 1) {
            out_i[my_q * gp + lane / nc_pad] = arg;
            out_f[my_q * gp + lane / nc_pad] = best;
          }
        } else if (v > tv[k - 1]) {
          int p = k - 1;
          while (p > 0 && v > tv[p - 1]) {
            tv[p] = tv[p - 1];
            ti[p] = ti[p - 1];
            --p;
          }
          tv[p] = v;
          ti[p] = lane;
        }
      }
    }
    __syncthreads();  // ss is rewritten by the next chunk
  }
  if (epilogue == TOPK && owner) {
    for (int i = 0; i < k; ++i) {
      out_f[my_q * k + i] = tv[i];
      out_i[my_q * k + i] = ti[i];
    }
  }
}

size_t ring_dyn_bytes(int epilogue, int k) {
  return sizeof(float) * RING_FLOATS +
         (epilogue == TOPK ? (size_t)QT * k * (sizeof(float) + sizeof(int)) : 0);
}

template <typename T>
int launch_ring(const void* Q, const void* W, const void* bias, int qn, int bp, int d,
                int epilogue, int nc_pad, int k, void* out_f, void* out_i,
                cudaStream_t s) {
  const size_t dyn = ring_dyn_bytes(epilogue, k);
  cudaError_t err = cudaFuncSetAttribute((const void*)predict_ring_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  predict_ring_kernel<T><<<(qn + QT - 1) / QT, THREADS, dyn, s>>>(
      (const T*)Q, (const float*)W, (const float*)bias, qn, bp, d, epilogue, nc_pad, k,
      (float*)out_f, (int*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k the topk epilogue's shared-memory state can hold.
int predict_bank_max_k() { return (232448 - 40 * 1024) / (QT * 8); }

// Q (qn, d) in f32 (bf16 when bf16 != 0); W (bp, d) and bias (bp,) f32.
// epilogue 0 scores -> out_f (qn, bp); 1 ovr -> out_i, out_f (qn, bp/nc_pad);
// 2 topk -> out_f, out_i (qn, k). b_tile is the ovr bank tile (whole
// groups of nc_pad lanes); the other epilogues ignore it. Returns the CUDA
// error of the launch.
int predict_bank(const void* Q, const void* W, const void* bias, int qn,
                 int bp, int d, int epilogue, int nc_pad, int k, int b_tile,
                 void* out_f, void* out_i, int bf16, void* stream) {
  if (qn <= 0 || bp <= 0 || d <= 0 || epilogue < SCORES || epilogue > TOPK)
    return (int)cudaErrorInvalidValue;
  if (epilogue == OVR && (nc_pad <= 0 || b_tile <= 0 || b_tile % nc_pad != 0 || bp % b_tile != 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == TOPK && (k < 1 || k > predict_bank_max_k())) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tile = epilogue == SCORES ? SCORES_TILE : epilogue == OVR ? b_tile : bp;
  if (bf16) return launch<__nv_bfloat16>(Q, W, bias, qn, bp, d, epilogue, nc_pad, k, tile, out_f, out_i, s);
  return launch<float>(Q, W, bias, qn, bp, d, epilogue, nc_pad, k, tile, out_f, out_i, s);
}

// B6 serve: as predict_bank with the bank walked by one CTA per query tile
// through the ring (every lane in order, so b_tile is not needed here).
int predict_bank_ring(const void* Q, const void* W, const void* bias, int qn, int bp,
                      int d, int epilogue, int nc_pad, int k, void* out_f, void* out_i,
                      int bf16, void* stream) {
  if (qn <= 0 || bp <= 0 || d <= 0 || epilogue < SCORES || epilogue > TOPK)
    return (int)cudaErrorInvalidValue;
  if (epilogue == OVR && (nc_pad <= 0 || bp % nc_pad != 0)) return (int)cudaErrorInvalidValue;
  if (epilogue == TOPK && (k < 1 || k > predict_bank_max_k())) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch_ring<__nv_bfloat16>(Q, W, bias, qn, bp, d, epilogue, nc_pad, k, out_f, out_i, s);
  return launch_ring<float>(Q, W, bias, qn, bp, d, epilogue, nc_pad, k, out_f, out_i, s);
}

// Dynamic shared memory the serving ring requests.
long predict_bank_ring_dyn_bytes(int epilogue, int k) { return (long)ring_dyn_bytes(epilogue, k); }

}  // extern "C"
