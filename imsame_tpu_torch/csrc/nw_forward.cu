// nw_forward: forward gapped aligner with backpointers (function F) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of imsame_tpu/ops/nw_pallas.py that compute
// function F on the compare path's render wave, at every length bucket
// 128 .. 3072: nw_forward_batch_pallas_pipe5 (:2307, kernel body
// _make_nw_fwd_pipe5_kernel :2053), taken for batches that are multiples of
// 256 pairs, and nw_forward_batch_pallas (:248, body _make_nw_kernel :51),
// taken for the others (the long buckets' render chunks of 64, 24 and 8
// pairs).  Per cell it writes the packed from-cell word of the reference's
// DP (src/alignmentFunctions.c:389-489): xfrom*4096 + yfrom in bits 0-23
// (< 2^24 since coordinates are < 3072), the diagonal-run length ending at
// the cell in bits 24-27 and the matches within that run in bits 28-31
// (capped at RUN_CAP = 15; words go negative at >= 8 matches), -1 outside
// the valid region; and per pair the best cell (score, i, j).  Output
// layout is the per-pair diagonal layout bp[b, d, i] (cell (i, d-i)) of the
// plain torch version, imsame_tpu_torch/ops/nw.py nw_forward_batch, to
// which every output is bit-equal.
//
// What bounds it on the H100: stores.  Each pair writes (2L-1)*L*4 bytes
// of backpointers against ~50 integer operations per valid cell.
//
// What the design does about it: the same warp-per-pair wavefront as
// nw_stats.cu (lane t owns K contiguous rows of a strip of 32*K rows, row
// shifts are register moves plus one __shfl_up_sync, all DP state in
// registers), so each diagonal's slice of the strip's rows leaves as one
// coalesced warp store of 16-byte vectors.  The run length and run matches
// ride one register per row (run | matches << 4), which shifted left by 24
// is the word's top byte.  Past L = 256 the rows are strip-mined as in
// nw_stats.cu: a strip sweeps only its valid diagonals and takes its top
// boundary (scores of the two rows above, run state of the row above, the
// column tracker {mc_s, mc_x, -, -}) from a per-warp boundary in global
// memory, which lane 0 reads one diagonal ahead and lane 31 writes, and a
// pair sweeps at most the bucket's 2L-1 diagonals whatever its lengths
// (see nw_stats.cu).  Every word is written exactly once: a strip fills
// the diagonals before and after its sweep with -1, and a strip with no
// valid
// row (rows >= xlen) fills all of them, so the tensor needs no
// initialisation.

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kPack = 4096;
constexpr int kRunCap = 15;

// Strip boundary of one warp slot, [2, 2L] int4 in global memory:
//   sw[c] = {T, v} of the strip's last row and {T, v} of the row above it
//           at column c (v: the run state, run | matches << 4),
//   mc[c] = the column gap tracker of column c as it leaves the last row.
// Columns past the query read hold NEG / 0.
__device__ __forceinline__ int4 load_sw(const int4* sw, int c, int yl) {
  return c < yl ? __ldcg(sw + c) : make_int4(kNeg, 0, kNeg, 0);
}
__device__ __forceinline__ int4 load_mc(const int4* mc, int c, int yl) {
  return c <= yl - 2 ? __ldcg(mc + c) : make_int4(kNeg, 0, 0, 0);
}

// Lane 31 hands the strip below its boundary on diagonal d of the strip
// whose last row is r_last: `last` is that row's cell (column d - r_last),
// `above` the row above's (column d - r_last + 1), `mc` the column tracker
// leaving the last row (column d - r_last - 1).  The strip reads its own
// top boundary from the same buffer at columns d - r0 and d - r0 + 1, at
// least H - 2 columns ahead of these writes, so no column is overwritten
// before it is read.
__device__ __forceinline__ void hand_off(int4* sw, int4* mc, int d,
                                         int r_last, int yl, int2 last,
                                         int2 above, int4 mc_out) {
  const int c1 = d - r_last;
  if (c1 >= 0 && c1 < yl) __stcg(reinterpret_cast<int2*>(sw + c1), last);
  if (c1 + 1 >= 0 && c1 + 1 < yl)
    __stcg(reinterpret_cast<int2*>(sw + c1 + 1) + 1, above);
  if (c1 - 1 >= 0 && c1 - 1 <= yl - 2) __stcg(mc + c1 - 1, mc_out);
}

// Folds diagonal d's best last-row / last-column candidate (score << 13 |
// i, a lex-max) into the running best (bs, bi, bj).  Warp-uniform; true
// when the diagonal's best became the running best.  Order-free, so it
// folds across strips as within one (ops/nw.py _best_fold).
__device__ __forceinline__ bool fold_best(bool has_elig, int best_packed,
                                          int d, int& bs, int& bi, int& bj) {
  if (!__any_sync(kFull, has_elig)) return false;
  const int dbest = __reduce_max_sync(kFull, best_packed);
  const int ds = dbest >> 13;  // floor(dbest / 8192)
  const int di = dbest & 8191;
  if (ds < bs || (ds == bs && di < bi)) return false;
  bs = ds;
  bi = di;
  bj = d - di;
  return true;
}

template <int K>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[K]) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    d4[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int K>
__device__ __forceinline__ void fill_rows(int* bp_lane, int L, int d0,
                                          int d1) {
  int none[K];
#pragma unroll
  for (int k = 0; k < K; ++k) none[k] = -1;
  for (int d = d0; d < d1; ++d) store_row<K>(bp_lane + (size_t)d * L, none);
}

template <int K, int NS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
nw_forward_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                  const int* __restrict__ xlen, const int* __restrict__ ylen,
                  int B, int igap, int egap, int4* __restrict__ scratch,
                  int* __restrict__ bp, int* __restrict__ out_score,
                  int* __restrict__ out_i, int* __restrict__ out_j) {
  constexpr int H = 32 * K;  // rows per strip
  constexpr int L = H * NS;
  constexpr int ND = 2 * L - 1;
  __shared__ uint8_t ys_all[kWarpsPerBlock][L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarpsPerBlock + warp;
  const int n_slots = gridDim.x * kWarpsPerBlock;
  uint8_t* ys = ys_all[warp];
  int4* sw = NS > 1 ? scratch + (size_t)slot * 4 * L : nullptr;
  int4* mcb = NS > 1 ? sw + 2 * L : nullptr;

  for (int b = slot; b < B; b += n_slots) {
    const uint8_t* xrow = X + (size_t)b * L;
    const uint8_t* yrow = Y + (size_t)b * L;
    load_row(ys, yrow, lane, L);
    const int xl = xlen[b];
    const int yl = ylen[b];
    const int y0 = ys[0];
    int bs = kNoBest, bi = 0, bj = 0;

    for (int s = 0; s < NS; ++s) {
      const int r0 = s * H;
      const int row0 = r0 + lane * K;
      int* bp_lane = bp + (size_t)b * ND * L + row0;
      if (r0 >= xl) {  // no valid row: every diagonal of the strip is -1
        fill_rows<K>(bp_lane, L, 0, ND);
        continue;
      }
      const bool top = NS > 1 && s > 0;
      const bool out = NS > 1 && s + 1 < NS && r0 + H < xl;
      // empty reads (a padding pair's read 0 may be one) have no diagonal
      const int dend = strip_end(r0, H, xl, yl, ND);
      fill_rows<K>(bp_lane, L, 0, r0);

      int xc[K], yd[K];
      int s1[K], s2[K], s3[K], rm1[K], rm2[K];
      int mf_s[K], mf_x[K], mf_y[K], mc_s[K], mc_x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xc[k] = xrow[row0 + k];
        yd[k] = 0;
        s1[k] = s2[k] = s3[k] = kNeg;
        rm1[k] = rm2[k] = 0;
        mf_s[k] = kNeg;
        mf_x[k] = mf_y[k] = 0;
        mc_s[k] = kNeg;
        mc_x[k] = 0;
      }
      // boundary columns for the next diagonal: sw of column d - r0 - 1,
      // mc of column d - r0; pA is row r0-1 at column d - r0 - 2
      int4 sw_next = make_int4(kNeg, 0, kNeg, 0);
      int4 mc_next = top ? load_mc(mcb, 0, yl) : make_int4(kNeg, 0, 0, 0);
      int pA = kNeg;

      for (int d = r0; d < dend; ++d) {
        const int4 bsw = sw_next;
        const int4 bmc = mc_next;
        if (top) {
          sw_next = load_sw(sw, d - r0, yl);
          mc_next = load_mc(mcb, d - r0 + 1, yl);
        }
        shift_down(yd, lane, ys[min(d - r0, L - 1)]);
        const int s2_up = __shfl_up_sync(kFull, s2[K - 1], 1);
        const int s3_up1 = __shfl_up_sync(kFull, s3[K - 1], 1);
        const int s3_up2 = __shfl_up_sync(kFull, s3[K - 2], 1);
        const int rm2_up = __shfl_up_sync(kFull, rm2[K - 1], 1);
        const int a_im1_jm1 = lane ? s2_up : bsw.x;
        const int a_im1_jm2 = lane ? s3_up1 : pA;
        const int a_im2_jm1 = lane ? s3_up2 : bsw.z;
        const int r_im1_jm1 = lane ? rm2_up : bsw.y;
        pA = bsw.x;

        int s0[K], rm0[K], word[K];
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

          const int t_im1_jm1 = k >= 1 ? s2[k > 0 ? k - 1 : 0] : a_im1_jm1;
          const int t_im1_jm2 = k >= 1 ? s3[k > 0 ? k - 1 : 0] : a_im1_jm2;
          const int t_im2_jm1 = k >= 2 ? s3[k > 1 ? k - 2 : 0]
                                : k == 1 ? a_im1_jm2 : a_im2_jm1;
          // run state of cell (i-1, j-1), diagonal d-2
          const int rm_prev = k >= 1 ? rm2[k > 0 ? k - 1 : 0] : r_im1_jm1;

          if (valid && i >= 1 && j >= 2 && mf_s[k] <= s2[k]) {
            mf_s[k] = t_im1_jm2;
            mf_x[k] = i - 1;
            mf_y[k] = j - 2;
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
          const int xfrom =
              pick_diag ? i - 1 : (pick_right ? mc_x[k] : mf_x[k]);
          const int yfrom = (pick_diag || pick_right) ? j - 1 : mf_y[k];

          // diagonal-run fields: run | matches << 4
          int rm = 0;
          if (pick_diag && inner) {
            const int m = eq ? 1 : 0;
            rm = (rm_prev & 15) == kRunCap ? 1 | (m << 4)
                                           : rm_prev + 1 + (m << 4);
          }
          rm0[k] = rm;

          if (valid && (i == 0 || j == 0)) cell = s_pm;  // border cell
          s0[k] = valid ? cell : kNeg;

          if (inner && i >= 2 && j >= 2 && t_im2_jm1 > mc_s[k]) {
            mc_s[k] = t_im2_jm1;
            mc_x[k] = i - 2;
          }
          if (i == d && xl > d) {
            mf_s[k] = xc[k] == y0 ? kPoint : -kPoint;
            mf_x[k] = d;
            mf_y[k] = 0;
          }
          if (inner && (i == xl - 1 || j == yl - 1)) {
            has_elig = true;
            best_packed = max(best_packed, s0[k] * 8192 + i);
          }
          word[k] = inner ? (int)((unsigned)(xfrom * kPack + yfrom) |
                                  ((unsigned)rm << 24))
                          : -1;
        }
        store_row<K>(bp_lane + (size_t)d * L, word);

        // hand the strip below its boundary (see nw_stats.cu)
        if (out && lane == 31)
          hand_off(sw, mcb, d, r0 + H - 1, yl,
                   make_int2(s0[K - 1], rm0[K - 1]), make_int2(s0[K - 2], 0),
                   make_int4(mc_s[K - 1], mc_x[K - 1], 0, 0));

        shift_down(mc_s, lane,
                   top ? bmc.x : (d < L && yl > d) ? s0[0] : kNeg);
        shift_down(mc_x, lane, top ? bmc.y : 0);

        fold_best(has_elig, best_packed, d, bs, bi, bj);

#pragma unroll
        for (int k = 0; k < K; ++k) {
          s3[k] = s2[k];
          s2[k] = s1[k];
          s1[k] = s0[k];
          rm2[k] = rm1[k];
          rm1[k] = rm0[k];
        }
      }
      fill_rows<K>(bp_lane, L, dend, ND);
      __syncwarp();  // the boundary written by lane 31 is seen by lane 0
    }

    if (lane == 0) {
      out_score[b] = bs;
      out_i[b] = bi;
      out_j[b] = bj;
    }
  }
}

template <int K, int NS>
int launch(const uint8_t* X, const uint8_t* Y, const int* xlen,
           const int* ylen, int B, int igap, int egap, int4* scratch,
           int n_slots, int* bp, int* out_score, int* out_i, int* out_j,
           cudaStream_t stream) {
  nw_forward_kernel<K, NS><<<n_slots / kWarpsPerBlock, 32 * kWarpsPerBlock,
                             0, stream>>>(X, Y, xlen, ylen, B, igap, egap,
                                          scratch, bp, out_score, out_i,
                                          out_j);
  return (int)cudaGetLastError();
}

}  // namespace

// Warp slots resident on the whole card for bucket L (a multiple of 4), or
// -1 for another L.
extern "C" int nw_forward_slots(int L) {
  switch (L) {
#define NW_CASE(l, k, ns) \
  case l:                 \
    return resident_slots(nw_forward_kernel<k, ns>);
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return -1;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: X, Y [B, L] uint8 row-major; xlen, ylen
// and the three best-cell outputs [B] int32; bp [B, 2L-1, L] int32,
// 16-byte aligned, fully written by the kernel.  The grid holds n_slots
// warps (a positive multiple of 4); each takes pairs slot, slot + n_slots,
// ...  For L > 256 scratch is [n_slots, 2, 2L] int4 (the strip boundaries,
// no init needed); for L <= 256 it is unused.  L must be a length bucket.
extern "C" int nw_forward_launch(const uint8_t* X, const uint8_t* Y,
                                 const int* xlen, const int* ylen, int B,
                                 int L, int igap, int egap, int4* scratch,
                                 int n_slots, int* bp, int* out_score,
                                 int* out_i, int* out_j,
                                 cudaStream_t stream) {
  if (bad_launch(B, n_slots)) return (int)cudaErrorInvalidValue;
  switch (L) {
#define NW_CASE(l, k, ns)                                                    \
  case l:                                                                    \
    return launch<k, ns>(X, Y, xlen, ylen, B, igap, egap, scratch, n_slots, \
                         bp, out_score, out_i, out_j, stream);
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
