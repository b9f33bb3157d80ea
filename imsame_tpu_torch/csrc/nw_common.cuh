// nw_common.cuh: what the two NW kernels, nw_stats.cu (function S) and
// nw_forward.cu (function F), share: constants, the length buckets, the
// strip bounds, the row shift of the wavefront, the query-row load and
// the launch geometry.  Both put K rows on a lane and strips of 32*K rows
// on a warp; nw_stats.cu walks a pair's strips on one warp (a per-warp
// boundary in global memory), nw_forward.cu runs them on the warps of one
// block past L = 256.  traceback.cu takes the buckets.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nw {

constexpr int kPoint = 4;
constexpr int kNeg = -(1 << 28);
constexpr int kNoBest = -2147483647;  // -(2^31) + 1, below any packed cell
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // warp-per-pair blocks: the batch tile

// (L, K, NS) of every length bucket: K rows per lane, NS strips of 32*K
#define NW_BUCKETS(F) \
  F(128, 4, 1) F(256, 8, 1) F(512, 8, 2) F(1024, 8, 4) F(2048, 8, 8) \
  F(3072, 8, 12)

// One past the last diagonal on which strip rows r0 .. r0+H-1 hold a valid
// cell, at least r0 (a strip of an empty read has none).  A pair sweeps at
// most the bucket's nd = 2L-1 diagonals, even when its lengths exceed L: a
// batch's padding pairs repeat read 0, which may be longer than the
// chunk's bucket, and the plain version stops there too.
__device__ __forceinline__ int strip_end(int r0, int H, int xl, int yl,
                                         int nd) {
  return max(r0, min(min(r0 + H, xl) - 1 + yl, nd));
}

// Moves the wavefront one row down: a lane's row k takes row k-1, its
// first row the previous lane's last, and lane 0's first row takes `top`.
template <int K>
__device__ __forceinline__ void shift_down(int (&v)[K], int lane, int top) {
  const int up = __shfl_up_sync(kFull, v[K - 1], 1);
#pragma unroll
  for (int k = K - 1; k > 0; --k) v[k] = v[k - 1];
  v[0] = lane ? up : top;
}

// Copies a pair's query row into the warp's shared row.
__device__ __forceinline__ void load_row(uint8_t* ys, const uint8_t* yrow,
                                         int lane, int L) {
  __syncwarp();  // the previous pair is done with ys
  for (int c = lane; c < L; c += 32) ys[c] = yrow[c];
  __syncwarp();
}

// Warp slots of `kernel` resident on the whole card at once.
template <typename Kernel>
int resident_slots(Kernel kernel) {
  int dev = 0, sms = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                32 * kWarpsPerBlock, 0);
  return blocks * sms * kWarpsPerBlock;
}

// A launch over B pairs needs a positive multiple of kWarpsPerBlock slots.
inline bool bad_launch(int B, int n_slots) {
  return B <= 0 || n_slots <= 0 || n_slots % kWarpsPerBlock;
}

}  // namespace nw
