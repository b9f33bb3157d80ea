// gate: the ungapped extension gate over packed read rows, for Hopper
// (sm_90a): candidate -> pass bit and exactness bit, packed 32 to a word.
//
// Replaces imsame_tpu/ops/extend_packed.py extend_packed (:123), reached
// through imsame_tpu/ops/candidates.py gate_core (:29), flat_gate_packed
// (:58), flat_gate_seg (:95) and flat_gate (:175): jitted jnp functions,
// not Pallas kernels.  It computes exactly what the plain torch versions,
// imsame_tpu_torch/ops/candidates.py gate_core + pack_bits over
// ops/extend_packed.py extend_packed, compute, for every candidate format:
//
//   seg          one word a candidate, new-segment flag << 31 | qoff delta
//                << 25 | index row, plus the segments' read ids (rtab) and
//                qoff bases (rbase): rix = inclusive count of flags - 1,
//                clamped to the segments, r = rtab[rix], qoff = rbase[rix]
//                + inclusive sum of the deltas (mod 2^32);
//   two words    [hit, r << 12 | qoff];
//   three words  [hit, r, qoff];
//
// and both index payloads: the packed word (s = bits 12-31, doff = bits
// 0-11) or the wide triple (s = sid[hit], doff = pos[hit] - db_start[s]),
// the index row clamped into the table.  Base b of a packed row lies at
// bits 2*(b & 15) of word b >> 4 (uint32 words on int32 storage); a base
// outside the row reads the row's word clamp(b >> 4, 0, wp - 1), as the
// plain version's clamped window gather does.  The forward walk starts at
// SEED_SCORE = 48 and moves +-4 a base over (qoff + o, doff + o); it stops
// after the first o with S <= 0, past flim = min(dlen-1-doff, qlen-1-qoff),
// or at W.  It keeps the watermark M (-2^30 when nothing was walked) and
// the last o that reaches it.  The backward walk, seeded with max(M, 48),
// walks (qoff-13-o, doff-13-o) within blim = min(doff, qoff) - 13.  Then
// raw = (2 * idents - t_len) * 4, pass = raw >= thr[r], and exact = (flim
// < W or the forward walk died) and (blim < W or the backward one died).
// int32 arithmetic wraps as torch's does.  A read id or db read id past its
// table (the plain version raises there) is clamped, so no load leaves a
// table.
//
// What bounds it on the H100: not bytes (its byte bound is a few percent
// of its time), but the work of each candidate's thread, in two parts.
// The walk: base by base it costs some 8-10 instructions a base, and a
// warp waits on the longest walk of its 32 lanes -- read-major stream
// order puts one query read's long true-diagonal walks beside random hits
// that die within a few tens of bases.  The set-up: dependent scattered
// gathers (candidate -> index entry -> db read -> row words), each warp
// load touching up to 32 lines.
//
// What the design does about it: one thread walks one candidate, straight
// from the packed rows, 16 bases a load pair (a funnel shift aligns them),
// and stops as soon as its score dies: the work follows the walk and not
// W, and no [chunk, window] temporary exists.  The 16 match bits of a load
// pair are compacted to one bit a base, and the walk takes them eight at a
// time: a 256-entry step table, indexed by the 8-bit match mask, gives the
// group's net step, its highest prefix and the last base reaching it, and
// its lowest prefix.  A group that lies within the walk's limit and whose
// lowest prefix cannot take the score to 0 is one step (identities by
// popcount, the watermark from the highest prefix); only the group where
// the score can die, or where the limit falls, runs the per-base loop.  A
// score of 36 or more cannot die within 8 bases, so a walk runs on the
// table from its seed until it nears death, and the serial chain of a
// lane's steps is an eighth of the per-base one.  On chunks of short walks
// the set-up's gathers are left in front (PERF.md, section 6).  Lane k of
// warp w is candidate 32w + k, so the two output words are two ballots.  W
// is a runtime argument (any positive multiple of 16).  The seg format's
// two prefix sums are a block scan with a carry from a scan of the blocks'
// totals: three launches a chunk (totals, their scan, the gate); the other
// formats one.  Offsets into rows and chunks are 64-bit.
//
// The step table lives in shared memory (1 KB, built by the block's 256
// threads, one entry each, before anything else): lanes index it
// divergently, which constant memory would serialise.  Entry g (bit t of
// g = base t of the group matched; step +1 on a match, -1 otherwise,
// prefix P_t after base t) packs four bytes, the first three signed and
// scaled by the walk's 4 points a base: byte 0 = 4 * P_7, byte 1 = 4 *
// max_t P_t, byte 2 = 4 * min_t P_t, byte 3 = the last t with P_t equal
// to the maximum (the walk's watermark keeps the last o that reaches it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // candidates a block, one a thread
constexpr int kScanBlock = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kK = 12;  // FIXED_K
constexpr int kPoint = 4;
constexpr int kSeed = kK * kPoint;  // SEED_SCORE
constexpr int kNegI = -(1 << 30);   // the watermark when nothing was walked
constexpr int kGroup = 8;           // bases a table step
static_assert(kBlock == 1 << kGroup, "a block builds the step table");

enum Format { kSeg = 1, kTwoWords = 2, kThreeWords = 3 };

struct Tables {
  const unsigned* qp;  // [n_q, wp_q] packed query rows
  const unsigned* dp;  // [n_db, wp_d] packed db rows
  const int* qlen;     // [n_q]
  const int* dlen;     // [n_db]
  const int* thr;      // [n_q] per-read raw-score threshold
  const int* idx;      // [n_idx] packed index words, or the wide pos
  const int* sid;      // [n_idx] the wide sid (wide payload only)
  const int* db_start; // [n_db] (wide payload only)
  long long n_idx;
  int n_q, wp_q, n_db, wp_d;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ uint2 add2(uint2 a, uint2 b) {
  return make_uint2(a.x + b.x, a.y + b.y);
}

// Bases p .. p+15 of a packed row, base p + t at bits 2t; p may lie
// outside the row (each word index is clamped, as the plain gather's).
__device__ __forceinline__ unsigned bases16(const unsigned* row, int wp,
                                            int p) {
  const int wi = p >> 4;  // arithmetic: floor
  const unsigned lo = __ldg(row + min(max(wi, 0), wp - 1));
  const unsigned hi = __ldg(row + min(max(wi + 1, 0), wp - 1));
  return __funnelshift_r(lo, hi, 2 * (p & 15));
}

// Bit t set where base t of two 16-base groups is equal.
__device__ __forceinline__ unsigned match_bits(unsigned q, unsigned d) {
  unsigned m = ~(q ^ d);
  m &= (m >> 1) & 0x55555555u;  // bit 2t
  m = (m | (m >> 1)) & 0x33333333u;
  m = (m | (m >> 2)) & 0x0F0F0F0Fu;
  m = (m | (m >> 4)) & 0x00FF00FFu;
  return (m | (m >> 8)) & 0xFFFFu;
}

// Entry g of the step table (see the note at the top), built by thread g.
__device__ __forceinline__ unsigned step_entry(unsigned g) {
  int P = 0, hi = -kGroup, lo = kGroup, last = 0;
  for (int t = 0; t < kGroup; ++t) {
    P += (g >> t) & 1 ? 1 : -1;
    if (P >= hi) {
      hi = P;
      last = t;
    }
    lo = min(lo, P);
  }
  return ((unsigned)(kPoint * P) & 0xFFu) |
         ((unsigned)(kPoint * hi) & 0xFFu) << 8 |
         ((unsigned)(kPoint * lo) & 0xFFu) << 16 | (unsigned)last << 24;
}

struct Walk {
  int M;       // watermark, kNegI when nothing was walked
  int best;    // the last o that reached it
  int idents;  // matches walked
  bool died;   // the score reached <= 0 at o <= lim
};

// One walk over o = 0 .. lim (lim = min(bound, W - 1)) from score S, a
// positive multiple of 4: the forward walk compares (q + o, d + o), the
// backward one (q - o, d - o).  It stops after the first o with S <= 0.
// `steps` is the block's step table.
template <bool kBackward>
__device__ __forceinline__ Walk walk(const unsigned* steps,
                                     const unsigned* qrow, int wpq,
                                     const unsigned* drow, int wpd, int q,
                                     int d, int lim, int S) {
  Walk w{kNegI, -1, 0, false};
  for (int o0 = 0; o0 <= lim; o0 += 16) {
    unsigned m;
    if constexpr (kBackward) {
      // bases q - o0 - 15 .. q - o0; reversed, o = o0 + k at bit k
      m = match_bits(bases16(qrow, wpq, q - o0 - 15),
                     bases16(drow, wpd, d - o0 - 15));
      m = __brev(m) >> 16;
    } else {
      m = match_bits(bases16(qrow, wpq, q + o0), bases16(drow, wpd, d + o0));
    }
#pragma unroll
    for (int h = 0; h < 16; h += kGroup) {
      const int g0 = o0 + h;
      if (g0 > lim) return w;
      const unsigned g = (m >> h) & 0xFFu;
      const unsigned e = steps[g];
      const int lo = (int)(signed char)(e >> 16);
      if (g0 + kGroup - 1 <= lim && S + lo > 0) {  // no death in the group
        const int top = S + (int)(signed char)(e >> 8);
        w.idents += __popc(g);
        if (top >= w.M) {  // >=: the last o that reaches the watermark
          w.M = top;
          w.best = g0 + (int)(e >> 24);
        }
        S += (int)(signed char)e;
        continue;
      }
      // the group where the score can die or the limit falls: base by base
      const int n = min(kGroup, lim - g0 + 1);
      for (int t = 0; t < n; ++t) {
        const int hit = (g >> t) & 1;
        S += hit ? kPoint : -kPoint;
        w.idents += hit;
        if (S >= w.M) {
          w.M = S;
          w.best = g0 + t;
        }
        if (S <= 0) {
          w.died = true;
          return w;
        }
      }
    }
  }
  return w;
}

// Inclusive scan of v over a block of kWarps warps; `sums` is shared, one
// entry a warp.  Every thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ uint2 block_scan(uint2 v, uint2* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint2 u = make_uint2(__shfl_up_sync(kFull, v.x, d),
                               __shfl_up_sync(kFull, v.y, d));
    if (lane >= d) v = add2(v, u);
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint2 s = lane < kWarps ? sums[lane] : make_uint2(0, 0);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint2 u = make_uint2(__shfl_up_sync(kFull, s.x, d),
                                 __shfl_up_sync(kFull, s.y, d));
      if (lane >= d) s = add2(s, u);
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  return warp ? add2(v, sums[warp - 1]) : v;
}

// The seg word's two scanned fields: (new-segment flag, qoff delta).
__device__ __forceinline__ uint2 seg_fields(const int* cand, long long N,
                                            long long i) {
  const unsigned w = i < N ? (unsigned)cand[i] : 0u;
  return make_uint2(w >> 31, (w >> 25) & 63u);
}

// Seg format, launch 1: each block's sums of the two fields.
__global__ void __launch_bounds__(kBlock)
    seg_totals_kernel(const int* __restrict__ cand, long long N,
                      uint2* __restrict__ tot) {
  __shared__ uint2 sums[kBlock / 32];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const uint2 v = block_scan<kBlock / 32>(seg_fields(cand, N, i), sums);
  if (threadIdx.x == kBlock - 1) tot[blockIdx.x] = v;
}

// Seg format, launch 2 (one block): the blocks' totals become exclusive
// prefixes, in place.
__global__ void __launch_bounds__(kScanBlock)
    seg_scan_kernel(uint2* __restrict__ tot, int nb) {
  __shared__ uint2 sums[kScanBlock / 32];
  uint2 carry = make_uint2(0, 0);
  for (int base = 0; base < nb; base += kScanBlock) {
    const int i = base + threadIdx.x;
    const uint2 v = i < nb ? tot[i] : make_uint2(0, 0);
    const uint2 inc = block_scan<kScanBlock / 32>(v, sums);
    if (i < nb)
      tot[i] = make_uint2(carry.x + inc.x - v.x, carry.y + inc.y - v.y);
    carry = add2(carry, sums[kScanBlock / 32 - 1]);
    __syncthreads();  // sums is rewritten by the next tile
  }
}

// The gate: one thread a candidate.  `carry` (seg only) holds each block's
// exclusive prefix of the seg fields.
template <int kFormat, bool kWide>
__global__ void __launch_bounds__(kBlock)
    gate_kernel(Tables t, const int* __restrict__ cand, long long N,
                const int* __restrict__ rtab, const int* __restrict__ rbase,
                int n_seg, const uint2* __restrict__ carry, int W,
                int* __restrict__ out) {
  __shared__ unsigned steps[1 << kGroup];  // one entry a thread
  steps[threadIdx.x] = step_entry(threadIdx.x);
  __syncthreads();  // before any thread of the block returns
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  int r, hit, qoff;
  if constexpr (kFormat == kSeg) {
    __shared__ uint2 sums[kBlock / 32];
    const uint2 v = add2(
        block_scan<kBlock / 32>(seg_fields(cand, N, i), sums),
        carry[blockIdx.x]);
    if (i >= N) return;  // whole warps: N is a multiple of 32
    const int rix = min(max((int)v.x - 1, 0), n_seg - 1);
    r = __ldg(rtab + rix);
    qoff = wadd(__ldg(rbase + rix), (int)v.y);
    hit = cand[i] & 0x1FFFFFF;
  } else {
    if (i >= N) return;
    hit = cand[i];
    if constexpr (kFormat == kTwoWords) {
      const unsigned rq = (unsigned)cand[N + i];
      r = (int)(rq >> 12);
      qoff = (int)(rq & 0xFFFu);
    } else {
      r = cand[N + i];
      qoff = cand[2 * N + i];
    }
  }
  r = min(max(r, 0), t.n_q - 1);
  const long long h = min(max((long long)hit, 0LL), t.n_idx - 1);
  int s, doff;
  if constexpr (kWide) {
    s = min(max(__ldg(t.sid + h), 0), t.n_db - 1);
    doff = wsub(__ldg(t.idx + h), __ldg(t.db_start + s));
  } else {
    const unsigned w = (unsigned)__ldg(t.idx + h);
    s = min((int)(w >> 12), t.n_db - 1);
    doff = (int)(w & 0xFFFu);
  }
  const int ql = __ldg(t.qlen + r), dl = __ldg(t.dlen + s);
  const unsigned* qrow = t.qp + (long long)r * t.wp_q;
  const unsigned* drow = t.dp + (long long)s * t.wp_d;

  const int flim = min(wsub(wsub(dl, 1), doff), wsub(wsub(ql, 1), qoff));
  const Walk f = walk<false>(steps, qrow, t.wp_q, drow, t.wp_d, qoff, doff,
                             min(flim, W - 1), kSeed);
  const int end_row = f.M >= kSeed ? wadd(doff, f.best) : wsub(doff, 1);
  const int blim = wsub(min(doff, qoff), kK + 1);
  const Walk b = walk<true>(steps, qrow, t.wp_q, drow, t.wp_d,
                            wsub(qoff, kK + 1), wsub(doff, kK + 1),
                            min(blim, W - 1), max(f.M, kSeed));
  const int start_row =
      b.M >= kSeed ? wsub(wsub(doff, kK + 1), b.best) : wsub(doff, kK);
  const unsigned idents = (unsigned)(kK + f.idents + b.idents);
  const int raw =
      (int)((2u * idents - (unsigned)wsub(end_row, start_row)) * kPoint);
  const bool pass = raw >= __ldg(t.thr + r);
  const bool exact = (flim < W || f.died) && (blim < W || b.died);

  const unsigned pw = __ballot_sync(kFull, pass);
  const unsigned ew = __ballot_sync(kFull, exact);
  if ((threadIdx.x & 31) == 0) {
    out[i >> 5] = (int)pw;
    out[(N >> 5) + (i >> 5)] = (int)ew;
  }
}

template <int kFormat>
cudaError_t launch_format(const Tables& t, bool wide, const int* cand,
                          long long N, const int* rtab, const int* rbase,
                          int n_seg, const uint2* carry, int W, int* out,
                          unsigned blocks, cudaStream_t stream) {
  if (wide)
    gate_kernel<kFormat, true><<<blocks, kBlock, 0, stream>>>(
        t, cand, N, rtab, rbase, n_seg, carry, W, out);
  else
    gate_kernel<kFormat, false><<<blocks, kBlock, 0, stream>>>(
        t, cand, N, rtab, rbase, n_seg, carry, W, out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launches (0 = ok).
// All arrays are int32 device pointers: qp [n_q, wp_q], dp [n_db, wp_d],
// qlen and thr [n_q], dlen [n_db]; the index payload idx [n_idx] (packed
// words; sid and db_start null) or the wide pos, sid [n_idx] and db_start
// [n_db]; cand [N] (format 1, seg, with rtab and rbase [n_seg] and a
// scratch of ceil(N / 256) * 8 bytes), [2, N] (format 2) or [3, N]
// (format 3); out [2, N / 32], every word written.  N must be a positive
// multiple of 32 and W a positive multiple of 16.
extern "C" int gate_launch(const int* qp, int n_q, int wp_q, const int* dp,
                           int n_db, int wp_d, const int* qlen,
                           const int* dlen, const int* thr, const int* idx,
                           const int* sid, const int* db_start,
                           long long n_idx, const int* cand, int format,
                           long long N, const int* rtab, const int* rbase,
                           int n_seg, void* scratch, int W, int* out,
                           cudaStream_t stream) {
  const long long nb = (N + kBlock - 1) / kBlock;
  const bool wide = sid != nullptr;
  if (N <= 0 || N % 32 || W <= 0 || W % 16 || n_idx <= 0 || n_q <= 0 ||
      n_db <= 0 || wp_q <= 0 || wp_d <= 0 || nb > 0x7fffffffLL ||
      (wide && db_start == nullptr) ||
      (format == kSeg && (n_seg <= 0 || !rtab || !rbase || !scratch)) ||
      format < kSeg || format > kThreeWords)
    return (int)cudaErrorInvalidValue;
  const Tables t{(const unsigned*)qp, (const unsigned*)dp, qlen, dlen, thr,
                 idx, sid, db_start, n_idx, n_q, wp_q, n_db, wp_d};
  const unsigned blocks = (unsigned)nb;
  uint2* tot = (uint2*)scratch;
  switch (format) {
    case kSeg: {
      seg_totals_kernel<<<blocks, kBlock, 0, stream>>>(cand, N, tot);
      cudaError_t err = cudaGetLastError();
      if (err) return (int)err;
      seg_scan_kernel<<<1, kScanBlock, 0, stream>>>(tot, (int)nb);
      err = cudaGetLastError();
      if (err) return (int)err;
      return (int)launch_format<kSeg>(t, wide, cand, N, rtab, rbase, n_seg,
                                      tot, W, out, blocks, stream);
    }
    case kTwoWords:
      return (int)launch_format<kTwoWords>(t, wide, cand, N, nullptr,
                                           nullptr, 0, nullptr, W, out,
                                           blocks, stream);
    default:
      return (int)launch_format<kThreeWords>(t, wide, cand, N, nullptr,
                                             nullptr, 0, nullptr, W, out,
                                             blocks, stream);
  }
}
