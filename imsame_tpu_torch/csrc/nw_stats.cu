// nw_stats: stats-only gapped aligner (function S) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of imsame_tpu/ops/nw_pallas.py that compute
// function S: nw_stats_batch_pallas_pipe4 (:1953, kernel body
// _make_nw_stats_pipe4_kernel :1696) and nw_stats_batch_pallas_pipe3
// (:1104, body :798) on the compare path's accept wave, at every length
// bucket 128 .. 3072, and their layout variants nw_stats_batch_pallas_pipe2
// (:1449), nw_stats_batch_pallas_pipe (:1528) and nw_stats_batch_pallas
// (:1619), which differ from them only in how pairs sit in TPU lanes.  Per
// pair it returns the best cell (score, i, j) of the reference's quirky
// semi-global DP (src/alignmentFunctions.c:389-489) and the length and
// identities of that cell's traceback path, bit-equal to the plain torch
// version, imsame_tpu_torch/ops/nw.py nw_stats_batch, whose docstring
// derives the recurrence, the path-stat propagation and the (score, i, j)
// tie-break.
//
// What bounds it on the H100: the DP's dependency chain.  A pair moves 2L
// bytes of codes in and 20 bytes out, but every anti-diagonal depends on
// the two before it, so a pair is a chain of serial steps of ~50 integer
// operations per row.  The kernel is latency-bound, not memory-bound.
//
// What the design does about it: one warp per pair, stepping the
// anti-diagonals.  Lane t owns K contiguous rows of a strip of H = 32*K
// rows, so the wavefront's row shift is a register move inside a lane plus
// one __shfl_up_sync of the lane's last row.  The three score diagonals,
// the packed path stats (len + (id << 16)), the mf/mc gap trackers and the
// query chars along the diagonal all stay in registers; the query row sits
// in shared memory.  Independent pairs fill the SM: many warps in flight
// hide each warp's dependency latency.
//
// Buckets past 256 rows keep the register budget of the 256 bucket (K = 8)
// by strip-mining: the warp walks the rows in NS = L/256 strips, top to
// bottom, and each strip sweeps only the diagonals on which it has a valid
// row (rows >= xlen are never visited).  A strip's top row needs, per
// column c, the scores and path stats of the two rows above it and the
// column gap tracker (mc) as it leaves the strip above; the strip above
// writes those 7 ints per column into a per-warp boundary in global memory
// (L2), and lane 0 reads them one diagonal ahead of use.  The row tracker
// mf and its column-0 re-init stay inside the strip: a row's mf state only
// starts on the row's first diagonal.  Reads and writes of one strip never
// touch the same column at once: on diagonal d the strip reads column
// d - r0 and writes columns <= d - r0 - H + 2.
//
// Like the plain version, a pair sweeps at most the bucket's 2L-1
// diagonals, even when its lengths exceed L: a batch's padding pairs
// repeat read 0, which may be longer than the chunk's bucket.  The
// boundary has 2L columns, one per diagonal, so such pairs stay in bounds
// and still equal the plain version.  The strip machinery (boundary loads
// and hand-off, row shift, best fold, buckets) is nw_common.cuh, shared
// with nw_forward.cu.
//
// The best cell is the lex-max of (score, i, j) over the last row and
// column, which is order-free, so it folds per diagonal as a warp max of
// (score << 13 | i) across strips as within one (nw.py _best_fold).  The
// packings hold at L = 3072: score*8192 + i needs i < 4096 and |score| <=
// 4*3001 (the diagonal path bounds a cell from below), len + (id << 16)
// needs len <= 2*3072 < 2^16.  Everything is int32 with NEG = -(2^28).
// Here the boundary's per-cell state is the path stats w, and the column
// tracker is {mc_s, mc_x, mc_w, -}.

#include "nw_common.cuh"

namespace {

using namespace nw;

template <int K, int NS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
nw_stats_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                const int* __restrict__ xlen, const int* __restrict__ ylen,
                int B, int igap, int egap, int4* __restrict__ scratch,
                int* __restrict__ out_score, int* __restrict__ out_i,
                int* __restrict__ out_j, int* __restrict__ out_len,
                int* __restrict__ out_id) {
  constexpr int H = 32 * K;  // rows per strip
  constexpr int L = H * NS;
  constexpr int ND = 2 * L - 1;  // diagonals of the bucket
  __shared__ uint8_t ys_all[kWarpsPerBlock][L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarpsPerBlock + warp;
  const int n_slots = gridDim.x * kWarpsPerBlock;
  uint8_t* ys = ys_all[warp];
  int4* sw = NS > 1 ? scratch + (size_t)slot * 4 * L : nullptr;
  int4* mcb = NS > 1 ? sw + 2 * L : nullptr;

  // each warp slot takes pairs slot, slot + n_slots, ... (the whole warp
  // leaves together)
  for (int b = slot; b < B; b += n_slots) {
    const uint8_t* xrow = X + (size_t)b * L;
    const uint8_t* yrow = Y + (size_t)b * L;
    load_row(ys, yrow, lane, L);
    const int xl = xlen[b];
    const int yl = ylen[b];
    const int y0 = ys[0];
    int bs = kNoBest, bi = 0, bj = 0, bw = 0;

    for (int s = 0; s < NS; ++s) {
      const int r0 = s * H;
      if (r0 >= xl) break;
      const bool top = NS > 1 && s > 0;  // rows above come from sw / mcb
      // a strip below reads ours
      const bool out = NS > 1 && s + 1 < NS && r0 + H < xl;
      const int row0 = r0 + lane * K;
      // diagonals with a valid row of this strip (none when yl == 0;
      // empty reads may be read 0 of a sample, and read 0 pads batches)
      const int dend = strip_end(r0, H, xl, yl, ND);

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
      // boundary columns for the next diagonal: sw of column d - r0 - 1,
      // mc of column d - r0; (pA, pW) is row r0-1 at column d - r0 - 2
      int4 sw_next = make_int4(kNeg, 0, kNeg, 0);
      int4 mc_next = top ? load_mc(mcb, 0, yl) : make_int4(kNeg, 0, 0, 0);
      int pA = kNeg, pW = 0;

      for (int d = r0; d < dend; ++d) {
        const int4 bsw = sw_next;
        const int4 bmc = mc_next;
        if (top) {
          sw_next = load_sw(sw, d - r0, yl);
          mc_next = load_mc(mcb, d - r0 + 1, yl);
        }
        // query chars along the diagonal: yd[row i] = Y[d - i] (index
        // clamps at L-1 like the plain version; such chars reach only
        // invalid cells)
        shift_down(yd, lane, ys[min(d - r0, L - 1)]);
        // the two rows just above this lane's block: the previous lane's,
        // or for lane 0 the strip boundary (NEG / 0 above row 0)
        const int s2_up = __shfl_up_sync(kFull, s2[K - 1], 1);
        const int s3_up1 = __shfl_up_sync(kFull, s3[K - 1], 1);
        const int s3_up2 = __shfl_up_sync(kFull, s3[K - 2], 1);
        const int w2_up = __shfl_up_sync(kFull, w2[K - 1], 1);
        const int w3_up1 = __shfl_up_sync(kFull, w3[K - 1], 1);
        const int w3_up2 = __shfl_up_sync(kFull, w3[K - 2], 1);
        const int a_im1_jm1 = lane ? s2_up : bsw.x;
        const int a_im1_jm2 = lane ? s3_up1 : pA;
        const int a_im2_jm1 = lane ? s3_up2 : bsw.z;
        const int v_im1_jm1 = lane ? w2_up : bsw.y;
        const int v_im1_jm2 = lane ? w3_up1 : pW;
        const int v_im2_jm1 = lane ? w3_up2 : bsw.w;
        pA = bsw.x;
        pW = bsw.y;

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
          const int t_im1_jm1 = k >= 1 ? s2[k > 0 ? k - 1 : 0] : a_im1_jm1;
          const int t_im1_jm2 = k >= 1 ? s3[k > 0 ? k - 1 : 0] : a_im1_jm2;
          const int t_im2_jm1 = k >= 2 ? s3[k > 1 ? k - 2 : 0]
                                : k == 1 ? a_im1_jm2 : a_im2_jm1;
          const int w_im1_jm1 = k >= 1 ? w2[k > 0 ? k - 1 : 0] : v_im1_jm1;
          const int w_im1_jm2 = k >= 1 ? w3[k > 0 ? k - 1 : 0] : v_im1_jm2;
          const int w_im2_jm1 = k >= 2 ? w3[k > 1 ? k - 2 : 0]
                                : k == 1 ? v_im1_jm2 : v_im2_jm1;

          // mf update (before the cell), rows with j > 1
          if (valid && i >= 1 && j >= 2 && mf_s[k] <= s2[k]) {
            mf_s[k] = t_im1_jm2;
            mf_x[k] = i - 1;
            mf_y[k] = j - 2;
            mf_w[k] = w_im1_jm2;
          }

          const int score_diag = t_im1_jm1 + s_pm;
          const int score_left =
              j >= 2 ? mf_s[k] + igap + (j - (mf_y[k] + 1)) * egap + s_pm
                     : kNeg;
          const int score_right =
              i >= 2 ? mc_s[k] + igap + (i - (mc_x[k] + 1)) * egap + s_pm
                     : kNeg;
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

        // hand the strip below its boundary: the last two rows' cells of
        // this diagonal, and the column tracker leaving the last row
        if (out && lane == 31)
          hand_off(sw, mcb, d, r0 + H - 1, yl, make_int2(s0[K - 1], w0[K - 1]),
                   make_int2(s0[K - 2], w0[K - 2]),
                   make_int4(mc_s[K - 1], mc_x[K - 1], mc_w[K - 1], 0));

        // advance mc to diagonal d+1: shift down; the top row takes column
        // d - r0: a new column from row 0 in strip 0, else the boundary's
        shift_down(mc_s, lane,
                   top ? bmc.x : (d < L && yl > d) ? s0[0] : kNeg);
        shift_down(mc_x, lane, top ? bmc.y : 0);
        shift_down(mc_w, lane, top ? bmc.z : 0);

        // fold this diagonal's best into the running best, with its path
        // stats from the lane that holds the best row
        if (fold_best(has_elig, best_packed, d, bs, bi, bj)) {
          int v = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (row0 + k == bi) v = w0[k];
          bw = __shfl_sync(kFull, v, (bi - r0) / K);
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
      __syncwarp();  // the boundary written by lane 31 is seen by lane 0
    }

    if (lane == 0) {
      out_score[b] = bs;
      out_i[b] = bi;
      out_j[b] = bj;
      out_len[b] = bw & 0xFFFF;
      out_id[b] = bw >> 16;
    }
  }
}

template <int K, int NS>
int launch(const uint8_t* X, const uint8_t* Y, const int* xlen,
           const int* ylen, int B, int igap, int egap, int4* scratch,
           int n_slots, int* out_score, int* out_i, int* out_j, int* out_len,
           int* out_id, cudaStream_t stream) {
  nw_stats_kernel<K, NS><<<n_slots / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
                           stream>>>(X, Y, xlen, ylen, B, igap, egap, scratch,
                                     out_score, out_i, out_j, out_len, out_id);
  return (int)cudaGetLastError();
}

}  // namespace

// Warp slots resident on the whole card for bucket L (a multiple of 4), or
// -1 for another L.  A batch larger than this loops its warps over pairs.
extern "C" int nw_stats_slots(int L) {
  switch (L) {
#define NW_CASE(l, k, ns) \
  case l:                 \
    return resident_slots(nw_stats_kernel<k, ns>);
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return -1;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: X, Y [B, L] uint8 row-major; xlen, ylen
// and the five outputs [B] int32.  The grid holds n_slots warps (a positive
// multiple of 4); each takes pairs slot, slot + n_slots, ...  For L > 256
// scratch is [n_slots, 2, 2L] int4 (the strip boundaries, no init
// needed); for L <= 256 it is unused.  L must be a length bucket.
extern "C" int nw_stats_launch(const uint8_t* X, const uint8_t* Y,
                               const int* xlen, const int* ylen, int B,
                               int L, int igap, int egap, int4* scratch,
                               int n_slots, int* out_score, int* out_i,
                               int* out_j, int* out_len, int* out_id,
                               cudaStream_t stream) {
  if (bad_launch(B, n_slots)) return (int)cudaErrorInvalidValue;
  switch (L) {
#define NW_CASE(l, k, ns)                                                    \
  case l:                                                                    \
    return launch<k, ns>(X, Y, xlen, ylen, B, igap, egap, scratch, n_slots, \
                         out_score, out_i, out_j, out_len, out_id, stream);
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
