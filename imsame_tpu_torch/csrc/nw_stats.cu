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
// What bounds it on the H100: integer issue.  A pair moves 2L bytes of
// codes in and 20 bytes out, but each cell of the DP costs ~25 integer
// operations (three candidates, the max with its tie-break, the path
// stats, the row and column gap trackers).  The card's 132 SMs x 64 INT32
// lanes x 1.98 GHz give ~16.7 T ops/s, ~0.67 T cells/s.  Every
// anti-diagonal depends on the two before it, so a pair is a serial chain
// and only many pairs in flight fill the SMs.
//
// What the design does about it: one warp per pair, stepping the
// anti-diagonals.  Lane t owns K contiguous rows of a strip of H = 32*K
// rows, so the wavefront's row shift is a register move inside a lane plus
// one __shfl_up_sync of the lane's last row.  Scores, packed path stats
// (len + (id << 16)) and trackers stay in registers; the query row sits in
// shared memory and the lane's 8 db and query chars in two packed words
// each (one __vcmpeq4 compares four cells).  Per cell:
//
//  - no predicates.  Cells outside the pair (j < 0, j >= ylen, i >= xlen)
//    are computed too: no valid cell reads them.  The row tracker needs no
//    column-0 re-init (its first update, at j = 2, always fires from a
//    near-NEG state), column 0's tracker carries a +2^30 score so that it
//    never updates, and rows 0 and 1 see -2^30 above them.  Only the
//    border cell (j = 0) of the first H diagonals of a strip is a select:
//    the loop runs a head (rows entering) and a body.
//  - no multiplies.  The trackers are stored less their coordinate's gap
//    cost: the row tracker as mf_s - mf_y*egap (and its path stats less
//    mf_y), the column tracker as mc_s - (mc_x + column)*egap (stats less
//    mc_x + column), so a gap candidate is one add of a per-diagonal
//    value; mf_x (always i-1 or i) is gone.  The raw mf_s / mc_s stay for
//    the trackers' own compares.
//  - the max of the three candidates with its pick is two __vibmax_s32.
//  - the diagonal loop is unrolled by 3 so the three score (and stats)
//    diagonals swap roles instead of being copied.
//  - each lane keeps its own best (score << 13 | i, j, stats): a row lives
//    in one lane, so within a lane a later diagonal wins ties on (score, i)
//    as nw.py _best_fold orders them; one warp fold per pair.
//  - __launch_bounds__(128, 3): 12 resident warps per SM.
//
// Buckets past 256 rows strip-mine (K = 8): the warp walks the rows in
// NS = L/256 strips, top to bottom, and each strip sweeps only the
// diagonals on which it has a valid row.  A strip's top row needs, per
// column c, the scores and path stats of the two rows above it and the
// column tracker as it leaves the strip above.  The strip above writes
// those 7 ints per column into a per-warp boundary in global memory (L2):
// lane 31 stores them into a 64-column ring in shared memory and the warp
// flushes each 32 columns as coalesced stores.  The strip below streams
// them back with cp.async, 32 columns (one per lane) at a time into a
// second ring, double-buffered, and lane 0 reads its column from shared
// memory.  A warp finishes strip s before it reads strip s's boundary,
// and within a strip reads run >= 200 columns ahead of the flushed writes.
//
// Like the plain version, a pair sweeps at most the bucket's 2L-1
// diagonals, even when its lengths exceed L: a batch's padding pairs
// repeat read 0, which may be longer than the chunk's bucket.  The
// boundary has 2L columns, one per diagonal, so such pairs stay in bounds
// and still equal the plain version.  The packings hold at L = 3072:
// score*8192 + i needs i < 4096 and |score| <= 4*3001, len + (id << 16)
// needs len <= 2*3072 < 2^16.  Everything is int32 with NEG = -(2^28).

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kBlocksPerSM = 3;     // resident blocks: 12 warps per SM
constexpr int kFar = -(1 << 30);    // "row above" of rows 0 and 1
constexpr int kNoUpdate = 1 << 30;  // column 0's tracker score
constexpr int kRing = 64;           // boundary ring columns (2 x 32)

// Boundary ring slot: the strip above's {T, v, T', v'} of its last two
// rows at column c-1 (read ring) or c (write ring), and the column tracker
// {mc_s, mc_q, mc_wq, -} leaving it at column c.
struct Slot {
  int4 sw;
  int4 mc;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Lane's share of read-ring block `blk`: slot c = 32*blk + lane holds
// sw[c-1] and mc[c] of the boundary in global memory (defaults past the
// query read or the 2L columns).
__device__ __forceinline__ void fetch_block(Slot* ring, const int4* sw,
                                            const int4* mc, int blk,
                                            int lane, int yl, int ncol) {
  const int c = 32 * blk + lane;
  Slot* s = ring + (c & (kRing - 1));
  if (c >= 1 && c - 1 < yl && c - 1 < ncol)
    cp_async16(&s->sw, sw + c - 1);
  else
    s->sw = make_int4(kNeg, 0, kNeg, 0);
  if (c <= yl - 2 && c < ncol)
    cp_async16(&s->mc, mc + c);
  else
    s->mc = make_int4(kNeg, kNeg, 0, 0);
}

// Lane's share of write-ring block `blk`: column 32*blk + lane to global.
__device__ __forceinline__ void flush_block(const Slot* ring, int4* sw,
                                            int4* mc, int blk, int lane,
                                            int yl, int ncol) {
  const int c = 32 * blk + lane;
  const Slot& s = ring[c & (kRing - 1)];
  if (c < yl && c < ncol) __stcg(sw + c, s.sw);
  if (c <= yl - 2 && c < ncol) __stcg(mc + c, s.mc);
}

// Register state of one strip of one pair: the lane's K rows.
template <int K>
struct Rows {
  unsigned xc[K / 4], yd[K / 4];  // db / query chars, byte k = row k
  int mfs[K], mfm[K], mfw[K];     // row tracker: mf_s, normalised, stats
  int mcs[K], mcq[K], mcw[K];     // column tracker, aligned to row k
};

// Per-pair, per-strip constants and the lane's running best.
struct Ctx {
  int lane, r0, xl, yl, L, igap, egap;
  bool top, out;
  bool row0_lane;  // the lane holds rows 0 and 1 (strip 0, lane 0)
  bool has_lr;     // the strip holds the last row
  int bp, bj, bw;
  Slot* ring;  // read ring (top), then the write ring (out)
  int4* sw;    // boundary: sw [2L], then mc [2L]
};

// Before the triple of diagonals that reads read-ring slots lo-1 .. lo+2:
// wait for the block its last slot enters, and once its first slot has
// left block b-1, refill that half with block b+1.
__device__ __forceinline__ void ring_advance(Ctx& c, int lo) {
  if (!c.top) return;
  const int hi = lo + 2;
  if ((hi >> 5) != ((hi - 3) >> 5)) {
    cp_async_wait_all();
    __syncwarp();
  }
  if (lo - 1 >= 32 && ((lo - 1) >> 5) != ((lo - 4) >> 5)) {
    __syncwarp();  // lane 0 is done with block b-1
    fetch_block(c.ring, c.sw, c.sw + 2 * c.L, ((lo - 1) >> 5) + 1, c.lane,
                c.yl, 2 * c.L);
    cp_async_commit();
  }
}

// Offers cell (i, j) of row k of lane `src` (warp-uniform k) to that
// lane's best.
template <int K>
__device__ __forceinline__ void offer(Ctx& c, const int (&s)[K],
                                      const int (&w)[K], int k, int src,
                                      int i, int j) {
  int v = 0, x = 0;
  switch (k) {
#define NW_PICK(n)                  \
  case n:                           \
    v = s[n < K ? n : 0];           \
    x = w[n < K ? n : 0];           \
    break;
    NW_PICK(0) NW_PICK(1) NW_PICK(2) NW_PICK(3)
    NW_PICK(4) NW_PICK(5) NW_PICK(6) NW_PICK(7)
#undef NW_PICK
  }
  const int p = v * 8192 + i;
  if (c.lane == src && p >= c.bp) {
    c.bp = p;
    c.bj = j;
    c.bw = x;
  }
}

// One anti-diagonal d.  s2/w2 hold diagonal d-2, s3/w3 diagonal d-3 and
// receive diagonal d (cells run k = K-1 .. 0, so s3[k] is free once cell k
// is done).  HEAD: some row of the strip may sit at column 0.
template <bool HEAD, int K>
__device__ __forceinline__ void step(Ctx& c, Rows<K>& r, const uint8_t* ys,
                                     int (&s2)[K], int (&s3)[K],
                                     int (&w2)[K], int (&w3)[K], int d) {
  const int j0 = d - c.r0 - c.lane * K;  // column of the lane's row 0
  // query char entering the lane's row 0 (clamped like the plain version;
  // other chars reach only cells no valid cell reads)
  const unsigned ch = ys[min(max(j0, 0), c.L - 1)];
#pragma unroll
  for (int q = K / 4 - 1; q > 0; --q)
    r.yd[q] = __funnelshift_l(r.yd[q - 1], r.yd[q], 8);
  r.yd[0] = (r.yd[0] << 8) | ch;

  // rows above the lane's block: the previous lane's, or for lane 0 the
  // strip boundary (strip 0: kFar)
  const int up_s2 = __shfl_up_sync(kFull, s2[K - 1], 1);
  const int up_s3a = __shfl_up_sync(kFull, s3[K - 1], 1);
  const int up_s3b = __shfl_up_sync(kFull, s3[K - 2], 1);
  const int up_w2 = __shfl_up_sync(kFull, w2[K - 1], 1);
  const int up_w3a = __shfl_up_sync(kFull, w3[K - 1], 1);
  const int up_w3b = __shfl_up_sync(kFull, w3[K - 2], 1);
  // boundary (strip > 0): sw of column d-r0-1 and mc of column d-r0, and
  // the previous slot's row r0-1 at column d-r0-2 (NEG on the first)
  int4 bsw = make_int4(kFar, 0, kFar, 0), bmc = make_int4(0, 0, 0, 0);
  int pA = kFar, pW = 0;
  if (c.top) {
    const int col = d - c.r0;
    const Slot& sl = c.ring[col & (kRing - 1)];
    bsw = sl.sw;
    bmc = sl.mc;
    const int2 prev =
        *reinterpret_cast<const int2*>(&c.ring[(col - 1) & (kRing - 1)].sw);
    pA = col ? prev.x : kNeg;
    pW = col ? prev.y : 0;
  }
  const bool l0 = c.lane == 0;
  const int a11 = l0 ? bsw.x : up_s2;  // T[i-1][j-1] of row 0
  const int a12 = l0 ? pA : up_s3a;  // T[i-1][j-2]
  const int a21 = l0 ? bsw.z : up_s3b; // T[i-2][j-1]
  const int v11 = l0 ? bsw.y : up_w2;
  const int v12 = l0 ? pW : up_w3a;
  const int v21 = l0 ? bsw.w : up_w3b;

  // per-diagonal terms of the normalised candidates
  const int J = j0 * c.egap;              // j*egap of row 0 (row k: - k*egap)
  const int Af = c.igap + c.egap - J;     // mf_m of an update: t + Af
  const int Gf = 2 - j0;                  // mf_w of an update: w + Gf
  const int Er = (d - 1) * c.egap;        // right candidate: mc_q + Er
  const int Bc = c.igap - c.egap - (d - 3) * c.egap;  // mc_q of an update
  const int Hc = 3 - d;                   // mc_w of an update: w + Hc
  const int dm1 = d - 1;

  unsigned m8[K / 4], m1[K / 4];
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const unsigned m = __vcmpeq4(r.xc[q], r.yd[q]);
    m8[q] = m & 0x08080808u;
    m1[q] = m & 0x01010101u;
  }

#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const int D = k >= 1 ? s2[k >= 1 ? k - 1 : 0] : a11;
    const int Wd = k >= 1 ? w2[k >= 1 ? k - 1 : 0] : v11;
    const int t12 = k >= 1 ? s3[k >= 1 ? k - 1 : 0] : a12;
    const int w12 = k >= 1 ? w3[k >= 1 ? k - 1 : 0] : v12;
    const int t21 = k >= 2 ? s3[k >= 2 ? k - 2 : 0] : k == 1 ? a12 : a21;
    const int w21 = k >= 2 ? w3[k >= 2 ? k - 2 : 0] : k == 1 ? v12 : v21;
    const int p = k & 3;
    // 8 or 0, and 0x10000 or 0: this cell's match
    const int e8 = (int)__byte_perm(m8[k / 4], 0, 0x4440 | p);
    const int e16 = (int)__byte_perm(m1[k / 4], 0, 0x4044 | (p << 8));

    // row tracker update (before the cell), from T[i][j-2] <= ...
    if (r.mfs[k] <= s2[k]) {
      r.mfs[k] = t12;
      r.mfm[k] = t12 + Af;
      r.mfw[k] = w12 + Gf;
    }
    const int lf = r.mfm[k] + J;
    const int rt =
        r.mcq[k] + Er + (k == 1 && c.row0_lane ? kFar : 0);  // row 1
    bool pl, pd;
    const int mlr = __vibmax_s32(lf, rt, &pl);  // pl: left >= right
    const int mx = __vibmax_s32(D, mlr, &pd);   // pd: diagonal wins ties
    int cell = mx + e8 - 4;
    int w = pd ? Wd + e16 + 1 : pl ? r.mfw[k] + j0 : r.mcw[k] + dm1;
    bool border = k == 0 && c.row0_lane;  // row 0
    if (HEAD) border = border || j0 == k;  // column 0
    if (border) {
      cell = e8 - 4;
      w = 0;
    }
    // column tracker update (after the cell), strict >, from two rows up
    if (t21 > r.mcs[k]) {
      r.mcs[k] = t21;
      r.mcq[k] = t21 + Bc;
      r.mcw[k] = w21 + Hc;
    }
    s3[k] = cell;
    w3[k] = w;
  }

  // hand the strip below its boundary through the write ring: the last
  // two rows' cells of this diagonal and the column tracker leaving them
  if (c.out) {
    const int c1 = d - (c.r0 + 32 * K - 1);
    if (c.lane == 31) {
      Slot* o = c.ring + kRing;
      *reinterpret_cast<int2*>(&o[c1 & (kRing - 1)].sw.x) =
          make_int2(s3[K - 1], w3[K - 1]);
      *reinterpret_cast<int2*>(&o[(c1 + 1) & (kRing - 1)].sw.z) =
          make_int2(s3[K - 2], w3[K - 2]);
      o[(c1 - 1) & (kRing - 1)].mc =
          make_int4(r.mcs[K - 1], r.mcq[K - 1], r.mcw[K - 1], 0);
    }
    // column c1 - 1 completes a block of 32: flush it
    if (c1 >= 32 && ((c1 - 1) & 31) == 31) {
      __syncwarp();
      flush_block(c.ring + kRing, c.sw, c.sw + 2 * c.L, (c1 - 1) >> 5,
                  c.lane, c.yl, 2 * c.L);
    }
  }

  // best-cell candidates: the last row and the last column
  if (c.has_lr) {
    const int jr = d - (c.xl - 1);
    const int il = c.xl - 1 - c.r0;
    if (jr >= 1 && jr < c.yl)
      offer(c, s3, w3, il & (K - 1), il / K, c.xl - 1, jr);
  }
  const int ic = d - c.yl + 1;
  if (ic >= max(c.r0, 1) && ic < min(c.r0 + 32 * K, c.xl) && c.yl >= 2)
    offer(c, s3, w3, (ic - c.r0) & (K - 1), (ic - c.r0) / K, ic, c.yl - 1);

  // advance the column tracker to diagonal d+1: shift down; the top row
  // takes column d - r0: a new column from row 0 in strip 0, else the
  // boundary's
  int ns = bmc.x, nq = bmc.y, nw = bmc.z;
  if (!c.top) {
    const int v = (d < c.L && c.yl > d) ? s3[0] : kNeg;
    ns = d == 0 ? kNoUpdate : v;
    nq = v - d * c.egap + c.igap - c.egap;
    nw = -d;
  }
  shift_down(r.mcs, c.lane, ns);
  shift_down(r.mcq, c.lane, nq);
  shift_down(r.mcw, c.lane, nw);
}

template <int K, int NS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kBlocksPerSM)
nw_stats_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                const int* __restrict__ xlen, const int* __restrict__ ylen,
                int B, int igap, int egap, int4* __restrict__ scratch,
                int* __restrict__ out_score, int* __restrict__ out_i,
                int* __restrict__ out_j, int* __restrict__ out_len,
                int* __restrict__ out_id) {
  constexpr int H = 32 * K;  // rows per strip
  constexpr int L = H * NS;
  constexpr int ND = 2 * L - 1;  // diagonals of the bucket
  constexpr int kHead = (H + 2) / 3 * 3;  // head diagonals, a multiple of 3
  constexpr int RS = NS > 1 ? kRing : 1;
  __shared__ uint8_t ys_all[kWarpsPerBlock][L];
  __shared__ Slot rings[kWarpsPerBlock][2 * RS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarpsPerBlock + warp;
  const int n_slots = gridDim.x * kWarpsPerBlock;
  uint8_t* ys = ys_all[warp];

  Ctx c;
  c.lane = lane;
  c.L = L;
  c.igap = igap;
  c.egap = egap;
  c.ring = rings[warp];
  c.sw = NS > 1 ? scratch + (size_t)slot * 4 * L : nullptr;

  // each warp slot takes pairs slot, slot + n_slots, ... (the whole warp
  // leaves together)
  for (int b = slot; b < B; b += n_slots) {
    const uint8_t* xrow = X + (size_t)b * L;
    load_row(ys, Y + (size_t)b * L, lane, L);
    c.xl = xlen[b];
    c.yl = ylen[b];
    c.bp = kNoBest;
    c.bj = 0;
    c.bw = 0;

    for (int s = 0; s < NS; ++s) {
      const int r0 = s * H;
      if (r0 >= c.xl) break;
      c.r0 = r0;
      c.top = NS > 1 && s > 0;  // rows above come from the boundary
      // a strip below reads ours
      c.out = NS > 1 && s + 1 < NS && r0 + H < c.xl;
      c.row0_lane = s == 0 && lane == 0;
      c.has_lr = c.xl - 1 >= max(r0, 1) && c.xl - 1 < r0 + H;
      // diagonals with a valid row of this strip (none when yl == 0;
      // empty reads may be read 0 of a sample, and read 0 pads batches)
      const int dend = strip_end(r0, H, c.xl, c.yl, ND);

      Rows<K> r;
      int sa[K], sb[K], sc[K], wa[K], wb[K], wc[K];
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        r.xc[q] = reinterpret_cast<const unsigned*>(xrow + r0 + lane * K)[q];
        r.yd[q] = 0;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sa[k] = sb[k] = sc[k] = kNeg;
        wa[k] = wb[k] = wc[k] = 0;
        r.mfs[k] = r.mfm[k] = kNeg;
        r.mfw[k] = 0;
        r.mcs[k] = r.mcq[k] = kNeg;
        r.mcw[k] = 0;
      }
      if (c.top) {  // the read ring's first two blocks
        fetch_block(c.ring, c.sw, c.sw + 2 * L, 0, lane, c.yl, 2 * L);
        fetch_block(c.ring, c.sw, c.sw + 2 * L, 1, lane, c.yl, 2 * L);
        cp_async_commit();
      }

      // sa/sb/sc (and wa/wb/wc) rotate: on diagonal d of a triple they
      // hold d-1, d-2, d-3 in turn
      int d = r0;
      const int dh = min(r0 + kHead, dend);
      for (; d < dh; d += 3) {
        ring_advance(c, d - r0);
        step<true>(c, r, ys, sb, sc, wb, wc, d);
        if (d + 1 < dh) step<true>(c, r, ys, sa, sb, wa, wb, d + 1);
        if (d + 2 < dh) step<true>(c, r, ys, sc, sa, wc, wa, d + 2);
      }
      for (; d < dend; d += 3) {
        ring_advance(c, d - r0);
        step<false>(c, r, ys, sb, sc, wb, wc, d);
        if (d + 1 < dend) step<false>(c, r, ys, sa, sb, wa, wb, d + 1);
        if (d + 2 < dend) step<false>(c, r, ys, sc, sa, wc, wa, d + 2);
      }
      if (c.top) cp_async_wait_all();
      if (c.out) {
        // the write ring's last blocks: columns < nc have their tracker,
        // blocks below nc / 32 are flushed
        __syncwarp();
        const int nc = max(dend - (r0 + H - 1) - 1, 0);
        for (int blk = nc >> 5; blk <= (nc >> 5) + 1; ++blk)
          flush_block(c.ring + kRing, c.sw, c.sw + 2 * L, blk, lane, c.yl,
                      2 * L);
      }
      __syncwarp();  // the boundary written by all lanes is seen by all
    }

    // one fold of the lanes' bests: the lex-max of (score, i) picks one
    // lane (a row lives in one lane), which holds j and the path stats
    const int best = __reduce_max_sync(kFull, c.bp);
    const int src = __ffs(__ballot_sync(kFull, c.bp == best)) - 1;
    const int bj = __shfl_sync(kFull, c.bj, src);
    const int bw = __shfl_sync(kFull, c.bw, src);
    if (lane == 0) {
      const bool none = best == kNoBest;
      out_score[b] = none ? kNoBest : best >> 13;  // floor(best / 8192)
      out_i[b] = none ? 0 : best & 8191;
      out_j[b] = none ? 0 : bj;
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
