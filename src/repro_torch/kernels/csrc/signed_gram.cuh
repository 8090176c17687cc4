// The Gram of a block's signed rows, G_jt = <y_j x_j, y_t x_t>, shared by
// the walks of csrc/streamsvm_single.cu (B4, P1 and P2's walk: 32-row
// blocks, one tile each) and csrc/baselines.cu (P2's walk over blocks: up to
// 256 rows a block). It does not depend on w, so a pre-pass across the card
// computes every block's Gram before the walk starts.
//
// Block blk holds rows blk rb + j, j < rb (rows >= n, and j >= rb up to the
// padding rp = 32 nt, read as zero); its Gram is rp x rp floats, row-major,
// at G + blk rp^2. CTA (blk, tile) computes the 32 x 32 tile (a, b), a <= b
// (the upper triangle of tiles, row-major), and writes it and, off the
// diagonal, its transpose. The tile's signed rows pass through shared
// memory in DC-column chunks (one buffer on the diagonal, two off it); each
// of the 256 threads keeps 4 sums, each one fmaf chain over the columns in
// ascending order from 0.f, so an element's bits do not depend on rp or on
// the tile that holds it.
#pragma once

#include <cuda_runtime.h>

namespace {
namespace signed_gram {

constexpr int THREADS = 256;
constexpr int TILE = 32;  // rows of a tile
constexpr int DC = 128;   // feature columns staged a chunk

__global__ void __launch_bounds__(THREADS)
signed_gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                   float* __restrict__ G, int n, int d, int rb, int rp) {
  extern __shared__ float rows[];  // [a == b ? 1 : 2][TILE][DC + 1]
  __shared__ float sa[TILE], sb[TILE];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int jb = tid >> 5;
  const int nt = rp / TILE;
  int a = 0, tile = blockIdx.y;  // the tile-th (a, b) with a <= b, row-major
  while (tile >= nt - a) tile -= nt - a++;
  const int b = a + tile;
  float* xa = rows;
  float* xb = a == b ? rows : rows + TILE * (DC + 1);
  const long row0 = (long)blockIdx.x * rb;
  if (tid < TILE) {
    const int ja = TILE * a + tid, jt = TILE * b + tid;
    sa[tid] = ja < rb && row0 + ja < n ? Y[row0 + ja] : 0.f;
    sb[tid] = jt < rb && row0 + jt < n ? Y[row0 + jt] : 0.f;
  }
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < d; d0 += DC) {
    for (int e = tid; e < TILE * DC; e += THREADS) {
      const int j = e / DC, c = e % DC, col = d0 + c;
      const int ja = TILE * a + j, jt = TILE * b + j;
      xa[j * (DC + 1) + c] =
          ja < rb && row0 + ja < n && col < d ? X[(row0 + ja) * d + col] * sa[j] : 0.f;
      if (a != b)
        xb[j * (DC + 1) + c] =
            jt < rb && row0 + jt < n && col < d ? X[(row0 + jt) * d + col] * sb[j] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < DC; ++c) {
      const float xt = xb[lane * (DC + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xa[(jb + 8 * i) * (DC + 1) + c], xt, acc[i]);
    }
    __syncthreads();
  }
  float* g = G + (long)blockIdx.x * rp * rp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = TILE * a + jb + 8 * i, t = TILE * b + lane;
    g[(long)j * rp + t] = acc[i];
    if (a != b) g[(long)t * rp + j] = acc[i];
  }
}

// Every block's Gram at rb rows a block, padded to rp (a multiple of TILE):
// ceil(n / rb) rp^2 floats at G. Returns the launch's CUDA error.
inline cudaError_t launch(const float* X, const float* Y, float* G, int n, int d, int rb, int rp,
                          cudaStream_t s) {
  const int nblocks = (n + rb - 1) / rb;
  const int nt = rp / TILE;
  const size_t dyn = sizeof(float) * (nt > 1 ? 2 : 1) * TILE * (DC + 1);
  signed_gram_kernel<<<dim3(nblocks, nt * (nt + 1) / 2), THREADS, dyn, s>>>(X, Y, G, n, d, rb, rp);
  return cudaGetLastError();
}

}  // namespace signed_gram
}  // namespace
