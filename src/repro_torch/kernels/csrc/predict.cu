// B2 and B6 serve on Hopper: score a tile of queries against a bank with a
// fused epilogue, with a plain C interface (bound from Python with ctypes).
//
// Replaces src/repro/kernels/predict.py::_kernel (predict_bank_pallas) with
// _first_argmax: B2 (predict_kernel) in its VMEM layout, B6 serve
// (predict_ring_kernel) with hbm=True (predict.py:94-134), where W stays in
// ANY space and (b_tile, D) slices pass through a 2-slot VMEM ring.
//
// The product is tile_product.cuh's walk, one body for both kernels (and
// for B5's Gram): a CTA of 128 threads computes 128 x 64 (large tile) or
// 32 x 64 (small tile) blocks of margins S[q, b] = <q, w_b>, one query tile
// against a run of consecutive 64-lane bank chunks, through a 3-stage
// cp.async arena of 46,080 B. A launch takes the large tile when that gives
// at least two CTAs per SM (a 256-query server step takes the small one: 8
// query tiles x 10 bank tiles in B2). Each margin is one f32 fmaf chain over
// d ascending from 0.f, whatever the tile, the thread or the kernel: B2 and
// the ring give the same bits, and a query's margins do not depend on the
// launch or step it is in. The epilogue reuses the drained stages.
//
// Epilogues, each query row's lanes met in lane order:
//   scores  raw S, no bias, stored from registers;
//   ovr     S + bias, staged through shared memory 32 lanes at a time; one
//           owner thread per query row walks them keeping the first argmax of
//           each group of nc_pad lanes (a running max that only a strictly
//           greater value replaces, reset at the group's first lane) and
//           writes every group that begins and ends in its CTA's lanes. A
//           group that crosses a CTA's edge leaves a partial (best, lane)
//           there, and the partials of a query tile's CTAs are merged in lane
//           order by the same rule (merge_row): ties go to the lowest lane and
//           the result is the one sequential walk's, deterministically. This
//           is the route taken instead of 64-bit atomicMax keys: no float
//           ordering trick, no -0.0 folding, and one merge for both kernels.
//           B2 (one CTA per 64-lane tile, so groups of any nc_pad straddle
//           tiles) keeps the partials in device memory, and the last CTA of
//           a query tile to finish merges them (an arrival counter per query
//           tile, cleared by cudaMemsetAsync at the launch; __threadfence
//           before arriving and before reading). The ring keeps them in
//           shared memory and merges across its cluster (below);
//   topk    S + bias into a running sorted list of k (score, lane) per query:
//           a candidate goes in after every entry it does not beat, so ties
//           go to the lowest lane. One CTA walks the whole bank per query
//           tile (small tile), in both kernels. The lists live in dynamic
//           shared memory up to k = MAX_K (727: 32 queries x k x 8 B beside
//           B2's static bytes); past it, in device memory: each query's list
//           is its own row of the (Q, k) outputs, filled in place by the same
//           insertion, so any 1 <= k <= B runs and gives the same ids.
//
// B6 serve (predict_ring_kernel). The query tile is outer and the bank is
// walked in lane order, chunk after chunk through the shared body's cp.async
// stages. The walk of each query tile is split along the bank across a
// thread-block cluster of up to 8 CTAs (the portable size): each CTA walks a
// contiguous run of whole 64-lane chunks, and rank 0 merges the ovr partials
// of every rank through distributed shared memory (map_shared_rank) between
// two cluster barriers. The cluster size is the one whose launch should end
// first given how many clusters the card holds at once (ring_cluster): a
// 256-query step at B = 600 runs 8 query tiles x 8 = 64 CTAs.
//
// Bound. 2 Q B D operations against Q D + B D input bytes: at the served
// shapes the card is bound by its f32 rate (67 TFLOP/s without tensor
// cores). A 256-query step is 0.24 GFLOP, 3.6 us at that rate: there the
// launch, the memset and the per-step latency of 25 k-steps dominate.
#include <cooperative_groups.h>

#include "tile_product.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EP = 32;  // lanes per epilogue piece staged in shared memory
constexpr int MAX_SMEM = 232448;  // the H100's shared memory per block
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
// The largest k whose topk lists (SMALL_BM queries x k (value, id) pairs)
// fit in shared memory beside B2's static bytes (the arena and the merge
// flag); a larger k keeps the lists in the outputs themselves.
constexpr int MAX_K = (MAX_SMEM - (int)sizeof(float) * ARENA_FLOATS - 16) / (SMALL_BM * 8);
constexpr float NEG_MASK = -3.0e38f;
enum { SCORES = 0, OVR = 1, TOPK = 2 };

template <class Tl>
struct Pieces {  // the ovr pieces and partials reuse the drained arena
  static_assert(Tl::BM * (EP + 1) <= ARENA_FLOATS && 4 * Tl::BM <= ARENA_FLOATS, "pieces, partials");
  static_assert(EP % Tl::TX == 0, "pieces");
  static constexpr bool ok = true;
};
static_assert(Pieces<Small>::ok && Pieces<Large>::ok, "epilogue layout");

struct Best {
  float v;
  int arg;
};

// The epilogue of one CTA over its lanes [L, H): owner thread tid < BM holds
// query row q0 + tid.
template <class Tl>
struct Epilogue {
  const float* bias;
  float* ss;         // one piece of margins, BM x (EP + 1)
  float* tv;         // topk values of this owner, then ids (ti): in shared
  int* ti;           // memory, or (k > MAX_K) the owner's rows of the outputs
  float* out_f;
  int* out_i;
  int qn, bp, epilogue, nc_pad, gp, k, L, H;
  long q0;
  Best best{0.f, 0}, edge0{0.f, 0}, edge1{0.f, 0};

  __device__ __forceinline__ void visit(long q, int b, float v) {
    if (epilogue == TOPK) {
      if (v > tv[k - 1]) {
        int p = k - 1;
        while (p > 0 && v > tv[p - 1]) {
          tv[p] = tv[p - 1];
          ti[p] = ti[p - 1];
          --p;
        }
        tv[p] = v;
        ti[p] = b;
      }
      return;
    }
    const int cls = b % nc_pad;
    if (cls == 0 || b == L || v > best.v) best = {v, cls};
    if (cls == nc_pad - 1 || b == H - 1) {  // the group's run in this CTA ends
      const int g = b / nc_pad;
      const bool began = g * nc_pad >= L;
      if (began && cls == nc_pad - 1) {
        out_i[q * gp + g] = best.arg;
        out_f[q * gp + g] = best.v;
      } else if (!began) {
        edge0 = best;  // entered mid-group at L
      } else {
        edge1 = best;  // left mid-group at H
      }
    }
  }

  __device__ __forceinline__ void chunk(int b0, const float (&acc)[Tl::TM][Tl::TN]) {
    const int tid = threadIdx.x, tx = tid % Tl::TX, ty = tid / Tl::TX;
    if (epilogue == SCORES) {
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i) {
        const long q = q0 + ty + i * Tl::TY;
#pragma unroll
        for (int j = 0; j < Tl::TN; ++j) {
          const int b = b0 + tx + j * Tl::TX;
          if (q < qn && b < bp) out_f[q * bp + b] = acc[i][j];
        }
      }
      return;
    }
    for (int p = 0; p < BN / EP && b0 + p * EP < H; ++p) {
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j) {
        if (j * Tl::TX / EP != p) continue;
        const int c = tx + j * Tl::TX, b = b0 + c;
        const float bb = b < bp ? bias[b] : 0.f;
#pragma unroll
        for (int i = 0; i < Tl::TM; ++i)
          ss[(ty + i * Tl::TY) * (EP + 1) + c - p * EP] = acc[i][j] + bb;
      }
      __syncthreads();
      const long q = q0 + tid;
      if (tid < Tl::BM && q < qn) {
        const int lo = b0 + p * EP, lim = min(EP, H - lo);
        for (int c = 0; c < lim; ++c) visit(q, lo + c, ss[tid * (EP + 1) + c]);
      }
      __syncthreads();  // ss is rewritten by the next piece
    }
  }

  __device__ __forceinline__ void start() {
    if (epilogue == TOPK && threadIdx.x < Tl::BM && q0 + threadIdx.x < qn)
      for (int i = 0; i < k; ++i) {
        tv[i] = NEG_MASK;
        ti[i] = 0;
      }
  }

  __device__ __forceinline__ void finish() {
    const long q = q0 + threadIdx.x;
    if (epilogue == TOPK && k <= MAX_K && threadIdx.x < Tl::BM && q < qn)
      for (int i = 0; i < k; ++i) {
        out_f[q * k + i] = tv[i];
        out_i[q * k + i] = ti[i];
      }
  }
};

// Merge the ovr partials of the R CTAs of one query tile for row q, in lane
// order: bounds(r) gives CTA r's lanes [L, H), slot(r, 0) its partial of the
// group it entered mid-way, slot(r, 1) of the group it left mid-way. A later
// partial replaces the running best only if strictly greater.
template <class Bounds, class Slot>
__device__ __forceinline__ void merge_row(int R, int nc_pad, int gp, long q, Bounds bounds,
                                          Slot slot, float* out_f, int* out_i) {
  Best cur{0.f, 0};
  for (int r = 0; r < R; ++r) {
    const int2 lh = bounds(r);
    if (lh.x % nc_pad != 0) {
      const Best p = slot(r, 0);
      if (p.v > cur.v) cur = p;
      const int g = lh.x / nc_pad;
      if ((g + 1) * nc_pad <= lh.y) {
        out_i[q * gp + g] = cur.arg;
        out_f[q * gp + g] = cur.v;
      }
    }
    if (lh.y % nc_pad != 0 && (lh.y - 1) / nc_pad * nc_pad >= lh.x) cur = slot(r, 1);
  }
}

template <class Tl>
__device__ __forceinline__ Epilogue<Tl> make_epilogue(const float* bias, float* arena,
                                                      float* lists, float* out_f, int* out_i,
                                                      int qn, int bp, int epilogue, int nc_pad,
                                                      int k, long q0, int L, int H) {
  Epilogue<Tl> ep;
  ep.bias = bias;
  ep.ss = arena;  // the stages are drained while an epilogue runs
  if (k <= MAX_K) {
    ep.tv = lists + threadIdx.x * k;
    ep.ti = reinterpret_cast<int*>(lists + Tl::BM * k) + threadIdx.x * k;
  } else {  // read only by owners of rows q < qn
    ep.tv = out_f + (q0 + threadIdx.x) * k;
    ep.ti = out_i + (q0 + threadIdx.x) * k;
  }
  ep.out_f = out_f;
  ep.out_i = out_i;
  ep.qn = qn;
  ep.bp = bp;
  ep.epilogue = epilogue;
  ep.nc_pad = nc_pad;
  ep.gp = epilogue == OVR ? bp / nc_pad : 0;
  ep.k = k;
  ep.L = L;
  ep.H = H;
  ep.q0 = q0;
  return ep;
}

// B2: grid (bank tiles of 64 lanes, query tiles); topk has one bank column
// that walks the whole bank. edges (qn, R, 2) and counters (query tiles)
// hold the ovr partials and the arrivals for the merge.
template <class Tl, typename T>
__global__ void __launch_bounds__(THREADS)
predict_kernel(const T* __restrict__ Q, const float* __restrict__ W,
               const float* __restrict__ bias, int qn, int bp, int d, int epilogue,
               int nc_pad, int k, int vec, float* __restrict__ out_f, int* __restrict__ out_i,
               int2* __restrict__ edges, int* __restrict__ counters) {
  __shared__ __align__(16) float arena[ARENA_FLOATS];
  __shared__ int last;  // this CTA arrived last for its query tile
  extern __shared__ float lists[];  // topk, k <= MAX_K: BM*k values, then BM*k ids
  const int nch = (bp + BN - 1) / BN, R = gridDim.x;
  const int c_lo = epilogue == TOPK ? 0 : blockIdx.x;
  const int c_hi = epilogue == TOPK ? nch : c_lo + 1;
  const long q0 = (long)blockIdx.y * Tl::BM;
  auto ep = make_epilogue<Tl>(bias, arena, lists, out_f, out_i, qn, bp, epilogue, nc_pad, k,
                              q0, c_lo * BN, min(c_hi * BN, bp));
  ep.start();
  walk<Tl>(Q, W, qn, bp, d, q0, c_lo, c_hi, vec != 0, arena,
           [&](int b0, const float (&acc)[Tl::TM][Tl::TN]) { ep.chunk(b0, acc); });
  ep.finish();
  if (epilogue != OVR || R == 1) return;
  const int tid = threadIdx.x;
  const long q = q0 + tid;
  const bool owner = tid < Tl::BM && q < qn;
  if (owner) {
    int2* e = edges + (q * R + blockIdx.x) * 2;
    e[0] = make_int2(__float_as_int(ep.edge0.v), ep.edge0.arg);
    e[1] = make_int2(__float_as_int(ep.edge1.v), ep.edge1.arg);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.y, 1) == R - 1;
  __syncthreads();
  if (!last || !owner) return;
  __threadfence();
  merge_row(
      R, nc_pad, bp / nc_pad, q,
      [&](int r) { return make_int2(r * BN, min((r + 1) * BN, bp)); },
      [&](int r, int s) {
        const int2 u = __ldcg(edges + (q * R + r) * 2 + s);
        return Best{__int_as_float(u.x), u.y};
      },
      out_f, out_i);
}

// B6 serve: grid (cluster size, query tiles) in clusters along the bank;
// rank r walks chunks [lo(r), lo(r + 1)).
template <class Tl, typename T>
__global__ void __launch_bounds__(THREADS)
predict_ring_kernel(const T* __restrict__ Q, const float* __restrict__ W,
                    const float* __restrict__ bias, int qn, int bp, int d, int epilogue,
                    int nc_pad, int k, int vec, float* __restrict__ out_f,
                    int* __restrict__ out_i) {
  __shared__ __align__(16) float arena[ARENA_FLOATS];
  extern __shared__ float lists[];  // topk, k <= MAX_K: BM*k values, then BM*k ids
  cg::cluster_group cluster = cg::this_cluster();
  const int nch = (bp + BN - 1) / BN, cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  auto lo = [&](int r) { return r * (nch / cs) + min(r, nch % cs); };
  const long q0 = (long)blockIdx.y * Tl::BM;
  auto ep = make_epilogue<Tl>(bias, arena, lists, out_f, out_i, qn, bp, epilogue, nc_pad, k,
                              q0, lo(rank) * BN, min(lo(rank + 1) * BN, bp));
  ep.start();
  walk<Tl>(Q, W, qn, bp, d, q0, lo(rank), lo(rank + 1), vec != 0, arena,
           [&](int b0, const float (&acc)[Tl::TM][Tl::TN]) { ep.chunk(b0, acc); });
  ep.finish();
  if (epilogue != OVR || cs == 1) return;
  const int tid = threadIdx.x;
  // The partials overlay the arena, free once the walk has ended.
  Best* slots = reinterpret_cast<Best*>(arena);
  if (tid < Tl::BM) {
    slots[2 * tid] = ep.edge0;
    slots[2 * tid + 1] = ep.edge1;
  }
  cluster.sync();
  const long q = q0 + tid;
  if (rank == 0 && tid < Tl::BM && q < qn)
    merge_row(
        cs, nc_pad, bp / nc_pad, q,
        [&](int r) { return make_int2(lo(r) * BN, min(lo(r + 1) * BN, bp)); },
        [&](int r, int s) { return cluster.map_shared_rank(slots, r)[2 * tid + s]; },
        out_f, out_i);
  cluster.sync();  // no CTA leaves while rank 0 reads its partials
}

size_t lists_bytes(int epilogue, int k) {
  return epilogue == TOPK && k <= MAX_K ? (size_t)SMALL_BM * k * (sizeof(float) + sizeof(int))
                                        : 0;
}

// The large tile where it gives at least two CTAs per SM, else the small.
bool large_tile(int epilogue, int qn, int along) {
  return epilogue != TOPK && fills_card((long)((qn + LARGE_BM - 1) / LARGE_BM) * along);
}

// Scratch of the B2 ovr merge: one counter per small query tile, then the
// (qn, bank tiles, 2) partials.
size_t counter_bytes(int qn) { return ((size_t)(qn + SMALL_BM - 1) / SMALL_BM * 4 + 15) / 16 * 16; }
size_t scratch_bytes(int qn, int bp, int epilogue) {
  const int R = (bp + BN - 1) / BN;
  if (epilogue != OVR || R == 1) return 0;
  return counter_bytes(qn) + (size_t)qn * R * 2 * sizeof(int2);
}

template <class Tl, typename T>
int launch(const void* Q, const void* W, const void* bias, int qn, int bp, int d, int epilogue,
           int nc_pad, int k, void* out_f, void* out_i, void* scratch, cudaStream_t s) {
  const size_t dyn = lists_bytes(epilogue, k);
  cudaError_t err = cudaFuncSetAttribute((const void*)predict_kernel<Tl, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(epilogue == TOPK ? 1 : (bp + BN - 1) / BN, (qn + Tl::BM - 1) / Tl::BM);
  int* counters = (int*)scratch;
  int2* edges = scratch ? (int2*)((char*)scratch + counter_bytes(qn)) : nullptr;
  if (scratch_bytes(qn, bp, epilogue) > 0) {
    err = cudaMemsetAsync(counters, 0, grid.y * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  predict_kernel<Tl, T><<<grid, THREADS, dyn, s>>>(
      (const T*)Q, (const float*)W, (const float*)bias, qn, bp, d, epilogue, nc_pad, k,
      (int)vectorized<T>(Q, W, d), (float*)out_f, (int*)out_i, edges, counters);
  return (int)cudaGetLastError();
}

// The ring's launch: grid (cluster size, query tiles), clusters along x.
template <class Tl>
cudaLaunchConfig_t ring_config(int qn, int cs, size_t dyn, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (qn + Tl::BM - 1) / Tl::BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The ring's cluster size: the one of 1 .. 8 (at most the bank's chunks)
// whose launch should finish first, counting waves of the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters: a cluster must fit one GPC)
// times the chunks each CTA walks; ties to the larger cluster. topk walks
// the bank in one CTA.
template <class Tl, typename T>
int ring_cluster(int epilogue, int qn, int bp, size_t dyn, cudaStream_t s, int* cs) {
  const int nch = (bp + BN - 1) / BN, qt = (qn + Tl::BM - 1) / Tl::BM;
  *cs = 1;
  if (epilogue == TOPK) return 0;
  static int cached_dev = -1;               // the card the counts below are for
  static int active[MAX_CLUSTER + 1] = {};  // clusters of each size it holds at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev) {
    for (int c = 1; c <= MAX_CLUSTER; ++c) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = ring_config<Tl>(qn, c, dyn, s, &attr);
      err = cudaOccupancyMaxActiveClusters(&active[c], predict_ring_kernel<Tl, T>, &cfg);
      if (err != cudaSuccess) return (int)err;
    }
    cached_dev = dev;
  }
  long best = -1;
  for (int c = 1; c <= MAX_CLUSTER && c <= nch; ++c) {
    if (active[c] < 1) continue;
    const long cost = (long)((qt + active[c] - 1) / active[c]) * ((nch + c - 1) / c);
    if (best < 0 || cost <= best) {
      best = cost;
      *cs = c;
    }
  }
  return 0;
}

template <class Tl, typename T>
int launch_ring(const void* Q, const void* W, const void* bias, int qn, int bp, int d,
                int epilogue, int nc_pad, int k, void* out_f, void* out_i, cudaStream_t s) {
  const size_t dyn = lists_bytes(epilogue, k);
  cudaError_t err = cudaFuncSetAttribute((const void*)predict_ring_kernel<Tl, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  int cs = 1;
  if (int e = ring_cluster<Tl, T>(epilogue, qn, bp, dyn, s, &cs)) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ring_config<Tl>(qn, cs, dyn, s, &attr);
  err = cudaLaunchKernelEx(&cfg, predict_ring_kernel<Tl, T>, (const T*)Q, (const float*)W,
                           (const float*)bias, qn, bp, d, epilogue, nc_pad, k,
                           (int)vectorized<T>(Q, W, d), (float*)out_f, (int*)out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k whose topk lists the launch keeps in shared memory beside B2's
// static bytes (the arena and its merge flag); past it they live in the
// outputs, in device memory.
int predict_bank_max_k() { return MAX_K; }

// Device-memory scratch B2 needs for a launch (0 unless an ovr launch spans
// more than one bank tile).
long predict_bank_scratch_bytes(int qn, int bp, int epilogue) {
  return (long)scratch_bytes(qn, bp, epilogue);
}

// Q (qn, d) in f32 (bf16 when bf16 != 0); W (bp, d) and bias (bp,) f32.
// epilogue 0 scores -> out_f (qn, bp); 1 ovr -> out_i, out_f (qn, bp/nc_pad);
// 2 topk -> out_f, out_i (qn, k), any k >= 1. b_tile is the ovr bank tile of the
// caller's padding (whole groups of nc_pad lanes, checked); the kernel's own
// lane tiles cross groups. scratch holds predict_bank_scratch_bytes. Returns
// the CUDA error of the launch.
int predict_bank(const void* Q, const void* W, const void* bias, int qn, int bp, int d,
                 int epilogue, int nc_pad, int k, int b_tile, void* out_f, void* out_i,
                 void* scratch, int bf16, void* stream) {
  if (qn <= 0 || bp <= 0 || d <= 0 || epilogue < SCORES || epilogue > TOPK)
    return (int)cudaErrorInvalidValue;
  if (epilogue == OVR && (nc_pad <= 0 || b_tile <= 0 || b_tile % nc_pad != 0 || bp % b_tile != 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == TOPK && k < 1) return (int)cudaErrorInvalidValue;
  if (scratch_bytes(qn, bp, epilogue) > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool large = large_tile(epilogue, qn, (bp + BN - 1) / BN);
#define B2_ARGS Q, W, bias, qn, bp, d, epilogue, nc_pad, k, out_f, out_i, scratch, s
  if (bf16)
    return large ? launch<Large, __nv_bfloat16>(B2_ARGS) : launch<Small, __nv_bfloat16>(B2_ARGS);
  return large ? launch<Large, float>(B2_ARGS) : launch<Small, float>(B2_ARGS);
#undef B2_ARGS
}

// B6 serve: as predict_bank, each query tile's walk of the bank split over a
// cluster of up to 8 CTAs (one CTA for topk); b_tile is not needed here.
int predict_bank_ring(const void* Q, const void* W, const void* bias, int qn, int bp, int d,
                      int epilogue, int nc_pad, int k, void* out_f, void* out_i, int bf16,
                      void* stream) {
  if (qn <= 0 || bp <= 0 || d <= 0 || epilogue < SCORES || epilogue > TOPK)
    return (int)cudaErrorInvalidValue;
  if (epilogue == OVR && (nc_pad <= 0 || bp % nc_pad != 0)) return (int)cudaErrorInvalidValue;
  if (epilogue == TOPK && k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (bp + BN - 1) / BN;
  const bool large = large_tile(epilogue, qn, nch < MAX_CLUSTER ? nch : MAX_CLUSTER);
#define RING_ARGS Q, W, bias, qn, bp, d, epilogue, nc_pad, k, out_f, out_i, s
  if (bf16)
    return large ? launch_ring<Large, __nv_bfloat16>(RING_ARGS)
                 : launch_ring<Small, __nv_bfloat16>(RING_ARGS);
  return large ? launch_ring<Large, float>(RING_ARGS) : launch_ring<Small, float>(RING_ARGS);
#undef RING_ARGS
}

// Dynamic shared memory the serving ring requests (the topk lists).
long predict_bank_ring_dyn_bytes(int epilogue, int k) { return (long)lists_bytes(epilogue, k); }

}  // extern "C"
