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
// What bounds it on the H100: stores, once the card is full.  Each pair
// writes (2L-1)*L*4 bytes of backpointers against ~50 integer operations
// per valid cell.  The render sends few long pairs at a time (24 at 3072,
// 64 at 2048), so what bounds a launch there is one pair's chain of
// anti-diagonals, each depending on the two before it.
//
// What the design does about it:
//
//  - Past L = 256 a pair is one block of NS = L/256 warps, and warp w owns
//    strip w (rows 256w .. 256w+255).  The strips run at once, each a few
//    dozen diagonals behind the one above, so a pair's chain is ~xlen+ylen
//    diagonals instead of NS strip sweeps in a row.  Up to L = 256 a warp
//    owns a pair (4 pairs a block).
//  - Within a strip, lane t owns K = 8 contiguous rows (the wavefront's row
//    shift is a register move plus one __shfl_up_sync), all DP state is in
//    registers, and each diagonal's words of the strip leave as one
//    coalesced warp store of 16-byte vectors.
//  - The strip boundary (the scores of the strip's last two rows, the run
//    word of its last row, the column tracker leaving it) goes to the warp
//    below through a 128-column ring in shared memory: lane 31 writes it,
//    lane 0 of the warp below reads it.  Flow control runs both ways at a
//    cadence of 32 columns: the producer publishes the columns it has
//    completed (`ready`), the consumer the column it has reached
//    (`freed`); each spins on the other's counter with __nanosleep.  The
//    warps of a block are co-resident, so the spins always end.
//  - The cells carry the recurrence of nw_stats.cu (header there): no
//    validity or border predicates (cells outside the pair are computed
//    and never read), no multiplies (trackers stored less their gap cost,
//    so a gap candidate is one add), two __vibmax_s32 for the max with its
//    pick, the diagonal loop unrolled by 3, a best cell per lane.  The
//    trackers carry their from-word (mf_x*4096 + mf_y, mc_x*4096 +
//    column), and a diagonal move's is a per-diagonal value plus
//    k*4095, so the word needs no multiply either.  The run word is kept
//    shifted left by 24, as it sits in the word.
//  - A word is -1 outside the valid region by one byte flag: bit 7 of a
//    row's db char (row >= xlen) or of the query char entering the lane
//    (column < 0 or >= ylen), which rides the char shift; prmt's
//    sign-replicate mode turns a cell's flag into the -1 mask.  Border
//    cells (row 0, column 0) are selected as in nw_stats.cu and take -1.
//  - Every word is written exactly once: a strip fills the diagonals
//    before and after its sweep with -1, and a strip with no valid row
//    (rows >= xlen) fills all of them, so the tensor needs no
//    initialisation.  A pair sweeps at most the bucket's 2L-1 diagonals,
//    even when its lengths exceed L (padding pairs repeat read 0).
//
// Char codes are < 128 (2-bit codes unpacked, 0..3).

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kFar = -(1 << 30);    // "row above" of rows 0 and 1
constexpr int kNoUpdate = 1 << 30;  // column 0's tracker score
constexpr int kRing = 128;          // boundary ring columns
constexpr int kBlk = 32;            // flow-control cadence, columns
constexpr int kDone = 0x7fffffff;   // counter of a strip that has ended
constexpr int kPack = 4096;
constexpr int kRunOne = 1 << 24;     // run length 1, in the word's place
constexpr int kRunCap = 0x0F000000;  // run length RUN_CAP = 15

// Warps and pairs of a block, and resident blocks per SM asked of ptxas
// (12 warps per SM: at most 168 registers a thread).
template <int NS>
struct Geo {
  static constexpr int warps = NS > 1 ? NS : kWarpsPerBlock;
  static constexpr int pairs = NS > 1 ? 1 : kWarpsPerBlock;
  static constexpr int min_blocks = 12 / warps > 1 ? 12 / warps : 1;
};

// Boundary ring slot of column c: the strip above's {T, R, T', -} (its
// last row's score and run word at c, the row above's score at c) and
// {mc_s, mc_q, mc_p, -} (column c's tracker leaving its last row).
struct Slot {
  int4 sw;
  int4 mc;
};

template <int K, int NS>
struct Shared {
  static constexpr int L = 32 * K * NS;
  uint8_t ys[Geo<NS>::pairs][L];                         // query rows
  Slot ring[NS > 1 ? NS - 1 : 1][NS > 1 ? kRing : 1];    // strip w -> w+1
  int ready[NS];  // columns strip w has completed for the strip below
  int freed[NS];  // the column strip w has reached in the ring above
  int best[NS], best_j[NS];
};

// 0xffffffff if byte p of v has bit 7 set, else 0 (prmt sign replicate)
__device__ __forceinline__ int byte_sign(unsigned v, int p) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(v), "r"(0u), "r"(0x8888 | (p * 0x1111)));
  return r;
}

// Waits for a neighbour strip's counter.  A wait of seconds can only be a
// fault: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void spin_until(const volatile int* n, int need) {
  for (unsigned tries = 0; *n < need; ++tries) {
    if (tries == (1u << 26)) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

// Register state of one strip of one pair: the lane's K rows.
template <int K>
struct Rows {
  unsigned xc[K / 4], yd[K / 4];  // db / query chars, byte k = row k
  int mfs[K], mfm[K], mfp[K];     // row tracker: mf_s, normalised, word
  int mcs[K], mcq[K], mcp[K];     // column tracker, aligned to row k
};

// Per-pair, per-strip constants, the lane's running best and the ring
// ends.
struct Ctx {
  int lane, r0, row0, xl, yl, igap, egap;
  bool top, out;
  bool row0_lane;  // the lane holds rows 0 and 1 (strip 0, lane 0)
  bool has_lr;     // the strip holds the last row
  int bp, bj;
  int* bpd;  // bp of the lane's first row on diagonal 0
  const Slot* in;
  Slot* ring_out;
  const volatile int* up_ready;
  volatile int* my_freed;
  volatile int* my_ready;
  const volatile int* down_freed;
};

template <int K>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[K]) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    __stcs(d4 + q,
           make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
}

template <int K>
__device__ __forceinline__ void fill_rows(int* bp_lane, int L, int d0,
                                          int d1) {
  int none[K];
#pragma unroll
  for (int k = 0; k < K; ++k) none[k] = -1;
  for (int d = d0; d < d1; ++d) store_row<K>(bp_lane + (size_t)d * L, none);
}

// Offers cell (i, j) of row k of lane `src` (warp-uniform k) to that
// lane's best.
template <int K>
__device__ __forceinline__ void offer(Ctx& c, const int (&s)[K], int k,
                                      int src, int i, int j) {
  int v = 0;
  switch (k) {
#define NW_PICK(n)        \
  case n:                 \
    v = s[n < K ? n : 0]; \
    break;
    NW_PICK(0) NW_PICK(1) NW_PICK(2) NW_PICK(3)
    NW_PICK(4) NW_PICK(5) NW_PICK(6) NW_PICK(7)
#undef NW_PICK
  }
  const int p = v * 8192 + i;
  if (c.lane == src && p >= c.bp) {
    c.bp = p;
    c.bj = j;
  }
}

// One anti-diagonal d.  s2/u2 hold the scores / run words of diagonal d-2,
// s3/u3 those of d-3 and receive diagonal d (cells run k = K-1 .. 0, so
// s3[k] is free once cell k is done).  HEAD: some row of the strip may sit
// at column 0.
template <bool HEAD, int K, int L>
__device__ __forceinline__ void step(Ctx& c, Rows<K>& r, const uint8_t* ys,
                                     int (&s2)[K], int (&s3)[K],
                                     int (&u2)[K], int (&u3)[K], int d) {
  const int j0 = d - c.row0;  // column of the lane's row 0
  // query char entering the lane's row 0 (clamped like the plain
  // version), flagged outside the query read
  const unsigned ch = ys[min(max(j0, 0), L - 1)] |
                      ((unsigned)j0 >= (unsigned)c.yl ? 0x80u : 0u);
#pragma unroll
  for (int q = K / 4 - 1; q > 0; --q)
    r.yd[q] = __funnelshift_l(r.yd[q - 1], r.yd[q], 8);
  r.yd[0] = (r.yd[0] << 8) | ch;

  // rows above the lane's block: the previous lane's, or for lane 0 the
  // strip boundary (strip 0: kFar)
  const int up_s2 = __shfl_up_sync(kFull, s2[K - 1], 1);
  const int up_s3a = __shfl_up_sync(kFull, s3[K - 1], 1);
  const int up_s3b = __shfl_up_sync(kFull, s3[K - 2], 1);
  const int up_u2 = __shfl_up_sync(kFull, u2[K - 1], 1);
  const bool l0 = c.lane == 0;
  // boundary (strip > 0): sw of column d-r0-1, mc of column d-r0, and row
  // r0-1 at column d-r0-2
  int4 bsw = make_int4(kFar, 0, kFar, 0), bmc = make_int4(0, 0, 0, 0);
  int pA = kFar;
  if (c.top) {
    const int col = d - c.r0;
    if ((col & (kBlk - 1)) == 0) {  // a new block of 32 columns
      if (l0) {
        __threadfence_block();  // done reading the columns before col
        *c.my_freed = col;
        spin_until(c.up_ready, col + kBlk);
      }
      __syncwarp();
    }
    if (l0) {
      bsw = col >= 1 ? c.in[(col - 1) & (kRing - 1)].sw
                     : make_int4(kNeg, 0, kNeg, 0);
      pA = col >= 2 ? c.in[(col - 2) & (kRing - 1)].sw.x : kNeg;
      bmc = c.in[col & (kRing - 1)].mc;
    }
  }
  const int a11 = l0 ? bsw.x : up_s2;   // T[i-1][j-1] of row 0
  const int a12 = l0 ? pA : up_s3a;     // T[i-1][j-2]
  const int a21 = l0 ? bsw.z : up_s3b;  // T[i-2][j-1]
  const int v11 = l0 ? bsw.y : up_u2;   // run word of (i-1, j-1)

  // per-diagonal terms of the normalised candidates and words
  const int J = j0 * c.egap;           // j*egap of row 0 (row k: - k*egap)
  const int Af = c.igap + c.egap - J;  // mf_m of an update: t + Af
  const int Er = (d - 1) * c.egap;     // right candidate: mc_q + Er
  const int Bc = c.igap - c.egap - (d - 3) * c.egap;  // mc_q of an update
  // word of row 0's diagonal move, (i-1)*4096 + (j-1); row k: + k*4095
  const int Pd0 = c.row0 * (kPack - 1) + d - kPack - 1;

  unsigned m8[K / 4], m16[K / 4], bad[K / 4];
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const unsigned m = __vcmpeq4(r.xc[q], r.yd[q]);
    m8[q] = m & 0x08080808u;
    m16[q] = m & 0x10101010u;
    bad[q] = r.xc[q] | r.yd[q];
  }

  int word[K];
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const int D = k >= 1 ? s2[k >= 1 ? k - 1 : 0] : a11;
    const int Ud = k >= 1 ? u2[k >= 1 ? k - 1 : 0] : v11;
    const int t12 = k >= 1 ? s3[k >= 1 ? k - 1 : 0] : a12;
    const int t21 = k >= 2 ? s3[k >= 2 ? k - 2 : 0] : k == 1 ? a12 : a21;
    const int p = k & 3;
    // 8 or 0, and 1 << 28 or 0: this cell's match
    const int e8 = (int)__byte_perm(m8[k / 4], 0, 0x4440 | p);
    const int e28 = (int)__byte_perm(m16[k / 4], 0, 0x0444 | (p << 12));
    const int Pd = Pd0 + k * (kPack - 1);

    // row tracker update (before the cell), from T[i][j-2] <= ...
    if (r.mfs[k] <= s2[k]) {
      r.mfs[k] = t12;
      r.mfm[k] = t12 + Af;
      r.mfp[k] = Pd - 1;  // (i-1)*4096 + j-2
    }
    const int lf = r.mfm[k] + J;
    const int rt =
        r.mcq[k] + Er + (k == 1 && c.row0_lane ? kFar : 0);  // row 1
    bool pl, pd;
    const int mlr = __vibmax_s32(lf, rt, &pl);  // pl: left >= right
    const int mx = __vibmax_s32(D, mlr, &pd);   // pd: diagonal wins ties
    int cell = mx + e8 - 4;
    int run = pd ? ((Ud & kRunCap) == kRunCap ? 0 : Ud) + kRunOne + e28 : 0;
    int from = pd ? Pd : pl ? r.mfp[k] : r.mcp[k];
    bool border = k == 0 && c.row0_lane;   // row 0
    if (HEAD) border = border || j0 == k;  // column 0
    if (border) {
      cell = e8 - 4;
      run = 0;
      from = -1;
    }
    // column tracker update (after the cell), strict >, from two rows up
    if (t21 > r.mcs[k]) {
      r.mcs[k] = t21;
      r.mcq[k] = t21 + Bc;
      r.mcp[k] = Pd - kPack;  // (i-2)*4096 + j-1
    }
    s3[k] = cell;
    u3[k] = run;
    word[k] = from | run | byte_sign(bad[k / 4], p);
  }
  store_row<K>(c.bpd + (size_t)d * L, word);

  // hand the strip below its boundary through the ring: the last two
  // rows' cells of this diagonal and the column tracker leaving them
  if (c.out && c.lane == 31) {
    const int c1 = d - (c.r0 + 32 * K - 1);  // the last row's column
    if (c1 >= -1) {
      // the next 32 diagonals write slots c1-1 .. c1+32
      if ((c1 & (kBlk - 1)) == 0) spin_until(c.down_freed, c1 + 35 - kRing);
      Slot* o = c.ring_out;
      if (c1 >= 0)
        *reinterpret_cast<int2*>(&o[c1 & (kRing - 1)].sw.x) =
            make_int2(s3[K - 1], u3[K - 1]);
      o[(c1 + 1) & (kRing - 1)].sw.z = s3[K - 2];
      if (c1 >= 1)
        o[(c1 - 1) & (kRing - 1)].mc =
            make_int4(r.mcs[K - 1], r.mcq[K - 1], r.mcp[K - 1], 0);
      if (c1 >= kBlk && (c1 & (kBlk - 1)) == 0) {  // columns < c1 complete
        __threadfence_block();
        *c.my_ready = c1;
      }
    }
  }

  // best-cell candidates: the last row and the last column
  if (c.has_lr) {
    const int jr = d - (c.xl - 1);
    const int il = c.xl - 1 - c.r0;
    if (jr >= 1 && jr < c.yl) offer(c, s3, il & (K - 1), il / K, c.xl - 1, jr);
  }
  const int ic = d - c.yl + 1;
  if (ic >= max(c.r0, 1) && ic < min(c.r0 + 32 * K, c.xl) && c.yl >= 2)
    offer(c, s3, (ic - c.r0) & (K - 1), (ic - c.r0) / K, ic, c.yl - 1);

  // advance the column tracker to diagonal d+1: shift down; the top row
  // takes column d - r0: a new column from row 0 in strip 0, else the
  // boundary's
  int ns = bmc.x, nq = bmc.y, np = bmc.z;
  if (!c.top) {
    const int v = (d < L && c.yl > d) ? s3[0] : kNeg;
    ns = d == 0 ? kNoUpdate : v;
    nq = v - d * c.egap + c.igap - c.egap;
    np = d;  // row 0, column d
  }
  shift_down(r.mcs, c.lane, ns);
  shift_down(r.mcq, c.lane, nq);
  shift_down(r.mcp, c.lane, np);
}

// Sweeps strip c.r0 of a pair over diagonals r0 .. dend-1.
template <int K, int L>
__device__ __forceinline__ void sweep(Ctx& c, const uint8_t* xrow,
                                      const uint8_t* ys, int dend) {
  constexpr int H = 32 * K;
  constexpr int kHead = (H + 2) / 3 * 3;  // head diagonals, a multiple of 3
  Rows<K> r;
  int sa[K], sb[K], sc[K], ua[K], ub[K], uc[K];
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    unsigned x = reinterpret_cast<const unsigned*>(xrow + c.row0)[q];
#pragma unroll
    for (int n = 0; n < 4; ++n)  // rows past the db read: no cell
      if (c.row0 + 4 * q + n >= c.xl) x |= 0x80u << (8 * n);
    r.xc[q] = x;
    r.yd[q] = 0x80808080u;  // no column entered yet
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sa[k] = sb[k] = sc[k] = kNeg;
    ua[k] = ub[k] = uc[k] = 0;
    r.mfs[k] = r.mfm[k] = kNeg;
    r.mfp[k] = 0;
    r.mcs[k] = r.mcq[k] = kNeg;
    r.mcp[k] = 0;
  }
  // sa/sb/sc (and ua/ub/uc) rotate: on diagonal d of a triple they hold
  // d-1, d-2, d-3 in turn
  int d = c.r0;
  const int dh = min(c.r0 + kHead, dend);
  for (; d < dh; d += 3) {
    step<true, K, L>(c, r, ys, sb, sc, ub, uc, d);
    if (d + 1 < dh) step<true, K, L>(c, r, ys, sa, sb, ua, ub, d + 1);
    if (d + 2 < dh) step<true, K, L>(c, r, ys, sc, sa, uc, ua, d + 2);
  }
  for (; d < dend; d += 3) {
    step<false, K, L>(c, r, ys, sb, sc, ub, uc, d);
    if (d + 1 < dend) step<false, K, L>(c, r, ys, sa, sb, ua, ub, d + 1);
    if (d + 2 < dend) step<false, K, L>(c, r, ys, sc, sa, uc, ua, d + 2);
  }
}

template <int K, int NS>
__global__ void __launch_bounds__(32 * Geo<NS>::warps, Geo<NS>::min_blocks)
nw_forward_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                  const int* __restrict__ xlen, const int* __restrict__ ylen,
                  int igap, int egap, int* __restrict__ bp,
                  int* __restrict__ out_score, int* __restrict__ out_i,
                  int* __restrict__ out_j) {
  constexpr int H = 32 * K;  // rows per strip
  constexpr int L = H * NS;
  constexpr int ND = 2 * L - 1;  // diagonals of the bucket
  __shared__ Shared<K, NS> sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // past L = 256 a block is one pair and warp w its strip w; else each
  // warp is a pair
  const int b = NS > 1 ? blockIdx.x : blockIdx.x * kWarpsPerBlock + warp;
  const int s = NS > 1 ? warp : 0;
  const uint8_t* ys = sh.ys[NS > 1 ? 0 : warp];
  if (NS > 1) {
    const uint4* y4 = reinterpret_cast<const uint4*>(Y + (size_t)b * L);
    for (int n = threadIdx.x; n < L / 16; n += blockDim.x)
      reinterpret_cast<uint4*>(sh.ys[0])[n] = y4[n];
    for (int n = threadIdx.x; n < (NS - 1) * kRing; n += blockDim.x) {
      Slot& o = sh.ring[n / kRing][n % kRing];
      o.sw = make_int4(kNeg, 0, kNeg, 0);
      o.mc = make_int4(kNeg, kNeg, 0, 0);
    }
    if (threadIdx.x < NS) sh.ready[threadIdx.x] = sh.freed[threadIdx.x] = 0;
    __syncthreads();
  } else {
    load_row(sh.ys[warp], Y + (size_t)b * L, lane, L);
  }

  Ctx c;
  c.lane = lane;
  c.igap = igap;
  c.egap = egap;
  c.xl = xlen[b];
  c.yl = ylen[b];
  c.r0 = s * H;
  c.row0 = c.r0 + lane * K;
  c.bp = kNoBest;
  c.bj = 0;
  c.bpd = bp + (size_t)b * ND * L + c.row0;
  if (c.r0 >= c.xl) {  // no valid row: every diagonal of the strip is -1
    fill_rows<K>(c.bpd, L, 0, ND);
  } else {
    c.top = s > 0;  // rows above come from the ring
    c.out = s + 1 < NS && c.r0 + H < c.xl;  // a strip below reads ours
    c.row0_lane = s == 0 && lane == 0;
    c.has_lr = c.xl - 1 >= max(c.r0, 1) && c.xl - 1 < c.r0 + H;
    if (NS > 1) {
      c.in = sh.ring[s > 0 ? s - 1 : 0];
      c.ring_out = sh.ring[s < NS - 1 ? s : 0];
      c.up_ready = &sh.ready[s > 0 ? s - 1 : 0];
      c.my_freed = &sh.freed[s];
      c.my_ready = &sh.ready[s];
      c.down_freed = &sh.freed[s < NS - 1 ? s + 1 : 0];
    }
    // diagonals with a valid row of this strip (none when yl == 0: empty
    // reads may be read 0 of a sample, and read 0 pads batches)
    const int dend = strip_end(c.r0, H, c.xl, c.yl, ND);
    fill_rows<K>(c.bpd, L, 0, c.r0);
    sweep<K, L>(c, X + (size_t)b * L, ys, dend);
    if (NS > 1) {  // neither neighbour waits on this strip any more
      __threadfence_block();
      if (lane == 0) sh.freed[s] = kDone;
      if (lane == 31) sh.ready[s] = kDone;
    }
    fill_rows<K>(c.bpd, L, dend, ND);
  }
  if (NS > 1 && c.r0 >= c.xl && lane == 0) sh.freed[s] = sh.ready[s] = kDone;

  // one fold of the lanes' bests: the lex-max of (score, i) picks one
  // lane (a row lives in one lane), which holds j; past L = 256 then one
  // fold of the strips' bests (rows of two strips never tie on i)
  int best = __reduce_max_sync(kFull, c.bp);
  const int src = __ffs(__ballot_sync(kFull, c.bp == best)) - 1;
  int bj = __shfl_sync(kFull, c.bj, src);
  if (NS > 1) {
    if (lane == 0) {
      sh.best[s] = best;
      sh.best_j[s] = bj;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    for (int w = 0; w < NS; ++w) {
      if (sh.best[w] > best) {
        best = sh.best[w];
        bj = sh.best_j[w];
      }
    }
  } else if (lane != 0) {
    return;
  }
  const bool none = best == kNoBest;
  out_score[b] = none ? kNoBest : best >> 13;  // floor(best / 8192)
  out_i[b] = none ? 0 : best & 8191;
  out_j[b] = none ? 0 : bj;
}

template <int K, int NS>
int resident_pairs() {
  int dev = 0, sms = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nw_forward_kernel<K, NS>, 32 * Geo<NS>::warps, 0);
  return blocks * sms * Geo<NS>::pairs;
}

template <int K, int NS>
int launch(const uint8_t* X, const uint8_t* Y, const int* xlen,
           const int* ylen, int B, int igap, int egap, int* bp,
           int* out_score, int* out_i, int* out_j, cudaStream_t stream) {
  nw_forward_kernel<K, NS><<<B / Geo<NS>::pairs, 32 * Geo<NS>::warps, 0,
                             stream>>>(X, Y, xlen, ylen, igap, egap, bp,
                                       out_score, out_i, out_j);
  return (int)cudaGetLastError();
}

}  // namespace

// Pairs in flight on the whole card at once for bucket L (blocks of one
// pair past L = 256, warps of one pair up to it), or -1 for another L.
extern "C" int nw_forward_resident(int L) {
  switch (L) {
#define NW_CASE(l, k, ns) \
  case l:                 \
    return resident_pairs<k, ns>();
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return -1;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: X, Y [B, L] uint8 row-major (16-byte
// aligned rows); xlen, ylen and the three best-cell outputs [B] int32; bp
// [B, 2L-1, L] int32, 16-byte aligned, fully written by the kernel.  B
// must be a positive multiple of 4 and L a length bucket.
extern "C" int nw_forward_launch(const uint8_t* X, const uint8_t* Y,
                                 const int* xlen, const int* ylen, int B,
                                 int L, int igap, int egap, int* bp,
                                 int* out_score, int* out_i, int* out_j,
                                 cudaStream_t stream) {
  if (B <= 0 || B % kWarpsPerBlock) return (int)cudaErrorInvalidValue;
  switch (L) {
#define NW_CASE(l, k, ns)                                                 \
  case l:                                                                 \
    return launch<k, ns>(X, Y, xlen, ylen, B, igap, egap, bp, out_score, \
                         out_i, out_j, stream);
    NW_BUCKETS(NW_CASE)
#undef NW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
