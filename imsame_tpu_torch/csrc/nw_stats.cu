// nw_stats: stats-only gapped aligner (function S) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of imsame_tpu/ops/nw_pallas.py on the
// compare path's accept wave: nw_stats_batch_pallas_pipe4 (:1953, kernel
// body _make_nw_stats_pipe4_kernel :1696) and nw_stats_batch_pallas_pipe3
// (:1104, body :798).  Per pair it returns the best cell (score, i, j) of
// the reference's quirky semi-global DP (src/alignmentFunctions.c:389-489)
// and the length and identities of that cell's traceback path, bit-equal to
// the plain torch version, imsame_tpu_torch/ops/nw.py nw_stats_batch, whose
// docstring derives the recurrence, the path-stat propagation and the
// (score, i, j) tie-break.
//
// What bounds it on the H100: the DP's dependency chain.  A pair moves 2L
// bytes of codes in and 20 bytes out, but every anti-diagonal depends on
// the two before it, so a pair is 2L-1 serial steps of ~50 integer
// operations per row.  The kernel is latency-bound, not memory-bound.
//
// What the design does about it: one warp per pair, stepping the
// anti-diagonals d = 0 .. xlen+ylen-2 (later diagonals hold no valid cell).
// Lane t owns the contiguous rows i = t*K .. t*K+K-1 (K = L/32, 8 rows at
// L = 256), so the wavefront's row shift is a register move inside a lane
// plus one __shfl_up_sync of the lane's last row.  The three score
// diagonals, the packed path stats (len + (id << 16)), the mf/mc gap
// trackers and the query chars along the diagonal all stay in registers;
// only the query row sits in shared memory.  Independent pairs fill the
// SM: many warps in flight hide each warp's dependency latency.  The best
// cell folds per diagonal as a warp max of (score << 13 | i), the
// lex-max the reference's row-major ">=" scan picks (nw.py _best_fold).
// Everything is int32 with NEG = -(2^28).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoint = 4;
constexpr int kNeg = -(1 << 28);
constexpr int kNoBest = -2147483647;  // -(2^31) + 1, below any packed cell
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // pairs per block: the batch tile

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
nw_stats_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                const int* __restrict__ xlen, const int* __restrict__ ylen,
                int B, int igap, int egap, int* __restrict__ out_score,
                int* __restrict__ out_i, int* __restrict__ out_j,
                int* __restrict__ out_len, int* __restrict__ out_id) {
  constexpr int L = 32 * K;
  __shared__ uint8_t ys_all[kWarpsPerBlock][L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // the whole warp leaves together
  uint8_t* ys = ys_all[warp];
  const uint8_t* xrow = X + (size_t)b * L;
  const uint8_t* yrow = Y + (size_t)b * L;
  for (int c = lane; c < L; c += 32) ys[c] = yrow[c];
  __syncwarp();
  const int xl = xlen[b];
  const int yl = ylen[b];
  const int y0 = ys[0];
  const int row0 = lane * K;

  int xc[K], yd[K];
  int s1[K], s2[K], s3[K], w1[K], w2[K], w3[K];
  int mf_s[K], mf_x[K], mf_y[K], mf_w[K], mc_s[K], mc_x[K], mc_w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xc[k] = xrow[row0 + k];
    yd[k] = 0;
    s1[k] = s2[k] = s3[k] = kNeg;
    w1[k] = w2[k] = w3[k] = 0;
    mf_s[k] = kNeg;
    mf_x[k] = mf_y[k] = mf_w[k] = 0;
    mc_s[k] = kNeg;
    mc_x[k] = mc_w[k] = 0;
  }
  int bs = kNoBest, bi = 0, bj = 0, bw = 0;

  // empty reads (a padding pair's read 0 may be one) have no diagonal
  const int dend = max(0, min(2 * L - 1, xl + yl - 1));
  for (int d = 0; d < dend; ++d) {
    // query chars along the diagonal: yd[row i] = Y[d - i] (index clamps
    // at L-1 like the plain version; such chars reach only invalid cells)
    {
      const int up = __shfl_up_sync(kFull, yd[K - 1], 1);
#pragma unroll
      for (int k = K - 1; k > 0; --k) yd[k] = yd[k - 1];
      yd[0] = lane ? up : ys[min(d, L - 1)];
    }
    // rows just above this lane's block, from the previous lane
    const int s2_up = __shfl_up_sync(kFull, s2[K - 1], 1);
    const int s3_up1 = __shfl_up_sync(kFull, s3[K - 1], 1);
    const int s3_up2 = __shfl_up_sync(kFull, s3[K - 2], 1);
    const int w2_up = __shfl_up_sync(kFull, w2[K - 1], 1);
    const int w3_up1 = __shfl_up_sync(kFull, w3[K - 1], 1);
    const int w3_up2 = __shfl_up_sync(kFull, w3[K - 2], 1);

    int s0[K], w0[K];
    int best_packed = kNoBest;
    bool has_elig = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = row0 + k;
      const int j = d - i;
      const bool valid = j >= 0 && i < xl && j < yl;
      const bool inner = valid && i >= 1 && j >= 1;
      const bool eq = xc[k] == yd[k];
      const int s_pm = eq ? kPoint : -kPoint;
      const int diag_add = eq ? (1 << 16) + 1 : 1;

      // T[i-1][j-1], T[i-1][j-2], T[i-2][j-1] and their path stats
      const int t_im1_jm1 = k >= 1 ? s2[k > 0 ? k - 1 : 0] : (lane ? s2_up : kNeg);
      const int t_im1_jm2 = k >= 1 ? s3[k > 0 ? k - 1 : 0] : (lane ? s3_up1 : kNeg);
      const int t_im2_jm1 = k >= 2 ? s3[k > 1 ? k - 2 : 0]
                            : k == 1 ? (lane ? s3_up1 : kNeg)
                                     : (lane ? s3_up2 : kNeg);
      const int w_im1_jm1 = k >= 1 ? w2[k > 0 ? k - 1 : 0] : (lane ? w2_up : 0);
      const int w_im1_jm2 = k >= 1 ? w3[k > 0 ? k - 1 : 0] : (lane ? w3_up1 : 0);
      const int w_im2_jm1 = k >= 2 ? w3[k > 1 ? k - 2 : 0]
                            : k == 1 ? (lane ? w3_up1 : 0)
                                     : (lane ? w3_up2 : 0);

      // mf update (before the cell), rows with j > 1
      if (valid && i >= 1 && j >= 2 && mf_s[k] <= s2[k]) {
        mf_s[k] = t_im1_jm2;
        mf_x[k] = i - 1;
        mf_y[k] = j - 2;
        mf_w[k] = w_im1_jm2;
      }

      const int score_diag = t_im1_jm1 + s_pm;
      const int score_left =
          j >= 2 ? mf_s[k] + igap + (j - (mf_y[k] + 1)) * egap + s_pm : kNeg;
      const int score_right =
          i >= 2 ? mc_s[k] + igap + (i - (mc_x[k] + 1)) * egap + s_pm : kNeg;
      const bool pick_diag =
          score_diag >= score_left && score_diag >= score_right;
      const bool pick_right = !pick_diag && score_right > score_left;
      int cell = pick_diag ? score_diag
                           : (pick_right ? score_right : score_left);
      const int w_new =
          pick_diag ? w_im1_jm1 + diag_add
          : pick_right ? mc_w[k] + max(i - mc_x[k], 1)
                       : mf_w[k] + max(i - mf_x[k], j - mf_y[k]);

      if (valid && (i == 0 || j == 0)) cell = s_pm;  // border cell
      s0[k] = valid ? cell : kNeg;
      w0[k] = inner ? w_new : 0;

      // mc update (after the cell), strict >, from two rows up
      if (inner && i >= 2 && j >= 2 && t_im2_jm1 > mc_s[k]) {
        mc_s[k] = t_im2_jm1;
        mc_x[k] = i - 2;
        mc_w[k] = w_im2_jm1;
      }
      // mf re-init from this diagonal's column-0 cell (d, 0)
      if (i == d && xl > d) {
        mf_s[k] = xc[k] == y0 ? kPoint : -kPoint;
        mf_x[k] = d;
        mf_y[k] = 0;
        mf_w[k] = 0;
      }
      // best-cell candidates: last row or last column
      if (inner && (i == xl - 1 || j == yl - 1)) {
        has_elig = true;
        best_packed = max(best_packed, s0[k] * 8192 + i);
      }
    }

    // advance mc to diagonal d+1: shift down, push column d at row 0
    {
      const int new_col = (d < L && yl > d) ? s0[0] : kNeg;
      const int up_s = __shfl_up_sync(kFull, mc_s[K - 1], 1);
      const int up_x = __shfl_up_sync(kFull, mc_x[K - 1], 1);
      const int up_w = __shfl_up_sync(kFull, mc_w[K - 1], 1);
#pragma unroll
      for (int k = K - 1; k > 0; --k) {
        mc_s[k] = mc_s[k - 1];
        mc_x[k] = mc_x[k - 1];
        mc_w[k] = mc_w[k - 1];
      }
      mc_s[0] = lane ? up_s : new_col;
      mc_x[0] = lane ? up_x : 0;
      mc_w[0] = lane ? up_w : 0;
    }

    // fold this diagonal's best into the running best (warp-uniform)
    if (__any_sync(kFull, has_elig)) {
      const int dbest = __reduce_max_sync(kFull, best_packed);
      const int ds = dbest >> 13;  // floor(dbest / 8192)
      const int di = dbest & 8191;
      if (ds > bs || (ds == bs && di >= bi)) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (row0 + k == di) v = w0[k];
        bw = __shfl_sync(kFull, v, di / K);
        bs = ds;
        bi = di;
        bj = d - di;
      }
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
      s3[k] = s2[k];
      s2[k] = s1[k];
      s1[k] = s0[k];
      w3[k] = w2[k];
      w2[k] = w1[k];
      w1[k] = w0[k];
    }
  }

  if (lane == 0) {
    out_score[b] = bs;
    out_i[b] = bi;
    out_j[b] = bj;
    out_len[b] = bw & 0xFFFF;
    out_id[b] = bw >> 16;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: X, Y [B, L] uint8 row-major; xlen, ylen
// and the five outputs [B] int32.  L must be 128 or 256.
extern "C" int nw_stats_launch(const uint8_t* X, const uint8_t* Y,
                               const int* xlen, const int* ylen, int B,
                               int L, int igap, int egap, int* out_score,
                               int* out_i, int* out_j, int* out_len,
                               int* out_id, cudaStream_t stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  switch (L) {
    case 128:
      nw_stats_kernel<4><<<grid, block, 0, stream>>>(
          X, Y, xlen, ylen, B, igap, egap, out_score, out_i, out_j, out_len,
          out_id);
      break;
    case 256:
      nw_stats_kernel<8><<<grid, block, 0, stream>>>(
          X, Y, xlen, ylen, B, igap, egap, out_score, out_i, out_j, out_len,
          out_id);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
