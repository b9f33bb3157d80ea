// nw_forward: forward gapped aligner with backpointers (function F) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of imsame_tpu/ops/nw_pallas.py on the compare
// path's render wave: nw_forward_batch_pallas_pipe5 (:2307, kernel body
// _make_nw_fwd_pipe5_kernel :2053).  Per cell it writes the packed
// from-cell word of the reference's DP (src/alignmentFunctions.c:389-489):
// xfrom*4096 + yfrom in bits 0-23, the diagonal-run length ending at the
// cell in bits 24-27 and the matches within that run in bits 28-31 (capped
// at RUN_CAP = 15; words go negative at >= 8 matches), -1 outside the
// valid region; and per pair the best cell (score, i, j).  Output layout is
// the per-pair diagonal layout bp[b, d, i] (cell (i, d-i)) of the plain
// torch version, imsame_tpu_torch/ops/nw.py nw_forward_batch, to which
// every output is bit-equal.
//
// What bounds it on the H100: stores.  Each pair writes (2L-1)*L*4 bytes
// of backpointers, about 0.5 MB at L = 256, against ~50 integer operations
// per cell; a 2048-pair render chunk writes 1 GB.
//
// What the design does about it: the same warp-per-pair wavefront as
// nw_stats.cu (lane t owns rows t*K .. t*K+K-1, row shifts are register
// moves plus one __shfl_up_sync, all DP state in registers), so each
// diagonal's row of L words leaves as one coalesced warp store of 16-byte
// vectors, and nothing but the bp words touches device memory.  The run
// length and run matches ride one register per row (run | matches << 4),
// which shifted left by 24 is the word's top byte.  Diagonals past
// xlen+ylen-2 hold no valid cell and are filled with -1 without the DP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoint = 4;
constexpr int kNeg = -(1 << 28);
constexpr int kNoBest = -2147483647;  // -(2^31) + 1, below any packed cell
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // pairs per block: the batch tile
constexpr int kPack = 4096;
constexpr int kRunCap = 15;

template <int K>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[K]) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    d4[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
nw_forward_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                  const int* __restrict__ xlen, const int* __restrict__ ylen,
                  int B, int igap, int egap, int* __restrict__ bp,
                  int* __restrict__ out_score, int* __restrict__ out_i,
                  int* __restrict__ out_j) {
  constexpr int L = 32 * K;
  constexpr int ND = 2 * L - 1;
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
  int* bp_lane = bp + (size_t)b * ND * L + row0;

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
  int bs = kNoBest, bi = 0, bj = 0;

  // empty reads (a padding pair's read 0 may be one) have no diagonal
  const int dend = max(0, min(ND, xl + yl - 1));
  for (int d = 0; d < dend; ++d) {
    {
      const int up = __shfl_up_sync(kFull, yd[K - 1], 1);
#pragma unroll
      for (int k = K - 1; k > 0; --k) yd[k] = yd[k - 1];
      yd[0] = lane ? up : ys[min(d, L - 1)];
    }
    const int s2_up = __shfl_up_sync(kFull, s2[K - 1], 1);
    const int s3_up1 = __shfl_up_sync(kFull, s3[K - 1], 1);
    const int s3_up2 = __shfl_up_sync(kFull, s3[K - 2], 1);
    const int rm2_up = __shfl_up_sync(kFull, rm2[K - 1], 1);

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

      const int t_im1_jm1 = k >= 1 ? s2[k > 0 ? k - 1 : 0] : (lane ? s2_up : kNeg);
      const int t_im1_jm2 = k >= 1 ? s3[k > 0 ? k - 1 : 0] : (lane ? s3_up1 : kNeg);
      const int t_im2_jm1 = k >= 2 ? s3[k > 1 ? k - 2 : 0]
                            : k == 1 ? (lane ? s3_up1 : kNeg)
                                     : (lane ? s3_up2 : kNeg);
      // run state of cell (i-1, j-1), diagonal d-2
      const int rm_prev = k >= 1 ? rm2[k > 0 ? k - 1 : 0] : (lane ? rm2_up : 0);

      if (valid && i >= 1 && j >= 2 && mf_s[k] <= s2[k]) {
        mf_s[k] = t_im1_jm2;
        mf_x[k] = i - 1;
        mf_y[k] = j - 2;
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
      const int xfrom = pick_diag ? i - 1 : (pick_right ? mc_x[k] : mf_x[k]);
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

    {
      const int new_col = (d < L && yl > d) ? s0[0] : kNeg;
      const int up_s = __shfl_up_sync(kFull, mc_s[K - 1], 1);
      const int up_x = __shfl_up_sync(kFull, mc_x[K - 1], 1);
#pragma unroll
      for (int k = K - 1; k > 0; --k) {
        mc_s[k] = mc_s[k - 1];
        mc_x[k] = mc_x[k - 1];
      }
      mc_s[0] = lane ? up_s : new_col;
      mc_x[0] = lane ? up_x : 0;
    }

    if (__any_sync(kFull, has_elig)) {
      const int dbest = __reduce_max_sync(kFull, best_packed);
      const int ds = dbest >> 13;  // floor(dbest / 8192)
      const int di = dbest & 8191;
      if (ds > bs || (ds == bs && di >= bi)) {
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
      rm2[k] = rm1[k];
      rm1[k] = rm0[k];
    }
  }

  int none[K];
#pragma unroll
  for (int k = 0; k < K; ++k) none[k] = -1;
  for (int d = dend; d < ND; ++d) store_row<K>(bp_lane + (size_t)d * L, none);

  if (lane == 0) {
    out_score[b] = bs;
    out_i[b] = bi;
    out_j[b] = bj;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: X, Y [B, L] uint8 row-major; xlen, ylen
// and the three best-cell outputs [B] int32; bp [B, 2L-1, L] int32,
// 16-byte aligned.  L must be 128 or 256.
extern "C" int nw_forward_launch(const uint8_t* X, const uint8_t* Y,
                                 const int* xlen, const int* ylen, int B,
                                 int L, int igap, int egap, int* bp,
                                 int* out_score, int* out_i, int* out_j,
                                 cudaStream_t stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  switch (L) {
    case 128:
      nw_forward_kernel<4><<<grid, block, 0, stream>>>(
          X, Y, xlen, ylen, B, igap, egap, bp, out_score, out_i, out_j);
      break;
    case 256:
      nw_forward_kernel<8><<<grid, block, 0, stream>>>(
          X, Y, xlen, ylen, B, igap, egap, bp, out_score, out_i, out_j);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
