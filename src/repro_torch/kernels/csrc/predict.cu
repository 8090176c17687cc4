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

}  // extern "C"
