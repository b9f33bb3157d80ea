// traceback: the render's walk back from each pair's best cell over the
// backpointer words that nw_forward.cu writes, for Hopper (sm_90a).
//
// Replaces imsame_tpu/ops/traceback.py traceback_batch (:136), a jitted
// jnp function (one lax.while_loop over the batch), not a Pallas kernel.
// It computes exactly what the plain torch version,
// imsame_tpu_torch/ops/traceback.py traceback_batch, computes on the
// per-pair layout bp[b, d, i] (cell (i, d-i)): from the best cell read the
// word at (px + py) * L + px, clamped to the pair's (2L-1) * L words;
// bits 0-23 are the from-cell xfrom * 4096 + yfrom, bits 24-27 the
// diagonal-run length ending at the cell and bits 28-31 the matches
// within that run (read unsigned: bit 31 is set at >= 8 matches).  A run
// (length > 0) is jumped whole and its chain entry carries RUN_FLAG; else
// the move is a gap, in x when dx > dy (the reference's rule,
// src/alignmentFunctions.c:493-560).  It sums length, identities, gap
// opens and gap extensions, and writes the chain: chain[0] = best_i * 4096
// + best_j, one entry a move, -1 after the last; n_steps is the number of
// chain entries that are not -1, less one.  A pair walks while px > 0, py
// > 0 and it has made fewer than 2L - 1 moves: the plain version's
// batch-wide loop stops at the same step for every pair, since a pair
// that has stopped never moves again.
//
// What bounds it on the H100: latency.  A pair's moves are a chain of
// dependent reads from a bp tensor far larger than L2 (one 3072 pair is
// 75.5 MB); read one word a move from device memory, a 250-move walk is
// 250 round trips of ~0.43 us, while its bytes would take microseconds.
//
// What the design does about it: the cells a walk visits next lie close
// to its diagonal (a run moves along it by at most 15, RUN_CAP; F's gaps
// leave it by their length).  On antidiagonal d the cells whose offset i -
// j lies within G of the offset c0 are at most G + 1 contiguous words of
// row d.  So a round copies a band into the warp's shared memory: from
// the walk's cell (px, py), with s0 = px + py and c0 = px - py, the 2W
// rows d = s0 .. s0 - 2W + 1, in each the words of i in [ceil((d + c0 -
// G) / 2), floor((d + c0 + G) / 2)], cut to the cells a walk can reach (1
// <= i <= min(L - 1, d - 1)), as the aligned 16-byte segments that hold
// them (cp.async, two lanes a row, all of a round's copies in flight
// together).  The walk then reads its words from shared memory while its
// cell lies in the band, and a cell outside it starts the next round
// there.  A cell no band holds (px >= L, or px + py > 2L - 2: words F
// never writes) is read by one load of the clamped address, as the plain
// version gathers it.  So a launch takes its longest walk's rounds
// (chip_smoke.tile_rounds counts them: 6-7 for a 3,000 bp copy at 3072)
// and its moves from shared memory, each a dependent shared read issued
// before the test of whether the walk stays in the band, so that the
// test is off the chain.  A round costs more by the rows it copies (one
// line request each) than by its one round trip, so the walk's span in
// rows sets the copies' cost and W trades little.  At 128 and 256 the
// render's 2,048-pair chunks make the band's bytes (a sector or two a row
// of a walk that reads one row in 30) cost more than the round trips
// they save: there W = 0, no band, and each move reads its word from
// device memory.  W and G are per bucket, from ops/nw_cuda.py
// TRACEBACK_BAND.
//
// One warp a pair, one pair a block: a round's copies from pairs on other
// SMs do not queue behind each other in one SM's load units (1.15-1.32x
// faster at 2048-3072 than four pairs a block).  Every lane walks the
// same cells (the shared reads broadcast), so the warp needs no shuffle
// and no branch of the walk diverges; lane 0 writes the stats and the
// chain entries, and the lanes fill the -1 tail with coalesced stores, so
// each output word is written once and the outputs need no
// initialisation.  There is no host round trip: a render chunk is F, then
// this launch.  A pair's base offset is 64-bit (a 3072 / 272 batch is 5.1
// G words).

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kPack = 4096;
constexpr unsigned kBpMask = (1u << 24) - 1;  // the from-cell's bits
constexpr int kRunFlag = 1 << 26;             // chain entry of a run

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// A warp's band in shared memory: 2W rows of 8 words (two 16-byte
// segments), row k holding antidiagonal s0 - k from the aligned word at or
// below its first cell within G of the anchor's offset c0.
template <int L, int W, int G>
struct Band {
  static_assert(W == 0 || (W >= 16 && (W & (W - 1)) == 0),
                "W: 0 (no band) or a power of two");
  static_assert(G >= 1 && G <= 4, "G + 1 cells fit two segments");
  static constexpr int kRows = 2 * W;
  static constexpr int kStride = 8;  // two segments a row
  static constexpr int kWords = kRows * kStride;  // a warp's: a power of 2

  int* rows;            // the warp's
  int s0 = -1, c0 = 0;  // the anchor; none yet

  // Row d's first word in the band: ceil((d + c0 - G) / 2) rounded down
  // to a multiple of 4 (a few words before the row at most: still in the
  // pair, since d >= 2).
  __device__ __forceinline__ int base(int d) const {
    return ((d + c0 - G + 1) >> 1) & ~3;
  }
  // Whether the band holds cell (x, y) of a walk (x, y >= 1): its row lies
  // in the band, x < L, and its offset is within G of c0.
  __device__ __forceinline__ bool holds(int x, int y) const {
    return (unsigned)(s0 - x - y) < (unsigned)kRows && x < L &&
           (unsigned)(x - y - c0 + G) <= (unsigned)(2 * G);
  }
  // The band's word at cell (x, y), for any cell: the slot is wrapped into
  // the warp's rows, so the read is safe before holds() is known (an asm
  // statement, which the compiler issues where it stands).
  __device__ __forceinline__ unsigned peek(int x, int y) const {
    const int d = x + y;
    const int slot = ((s0 - d) * kStride + x - base(d)) & (kWords - 1);
    unsigned w;
    asm volatile("ld.shared.u32 %0, [%1];\n"
                 : "=r"(w)
                 : "r"((unsigned)__cvta_generic_to_shared(rows + slot)));
    return w;
  }
  // Copies the band anchored at (x, y), x + y <= 2L - 2 and x < L: rows
  // d = s0 .. s0 - 2W + 1, in each the aligned 16-byte segments that hold
  // its cells 1 <= i <= min(L - 1, d - 1) within G of c0 (none for d <
  // 2).  Two lanes a row, one segment each, so that a copy instruction
  // asks for 16 rows' lines; all of a round's copies are in flight
  // together (cp.async).
  __device__ __forceinline__ void load(const int* pbp, int x, int y,
                                       int lane) {
    s0 = x + y;
    c0 = x - y;
    __syncwarp();  // every lane is done reading the last band
    const int seg = 4 * (lane & 1);
    const int k0 = lane >> 1;
    // this lane's segment of row k0; row k0 + 16r lies 16rL words below
    const int* src = pbp + (long long)(s0 - k0) * L + seg;
#pragma unroll
    for (int r = 0; r < kRows / 16; ++r) {
      const int k = k0 + 16 * r;
      const int d = s0 - k;
      const int lo = max((d + c0 - G + 1) >> 1, 1);
      const int hi = min(min((d + c0 + G) >> 1, L - 1), d - 1);
      const int a = base(d);
      if (lo <= hi && a + seg <= hi)
        cp_async16(rows + k * kStride + seg, src + (a - 16 * r * L));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();  // every lane's copies are visible to the warp
  }
};

// A walk's sums and its moves.
struct Path {
  int len = 0, id = 0, ig = 0, eg = 0, t = 0, valid = 0;

  // One move from cell (x, y) by its word w, with no branch: a run
  // (length > 0) is jumped whole, else the move is a gap to the stored
  // from-cell, in x when dx > dy.  Moves (x, y) to the from-cell and
  // returns the chain entry.
  __device__ __forceinline__ int move(unsigned w, int& x, int& y) {
    const int run = (w >> 24) & 15;
    const unsigned frm = w & kBpMask;
    const int fx = run > 0 ? x - run : (int)(frm / kPack);
    const int fy = run > 0 ? y - run : (int)(frm % kPack);
    const int gap = max(x - fx, y - fy);
    len += run > 0 ? run : gap;
    id += run > 0 ? (int)(w >> 28) : 0;
    ig += run > 0 ? 0 : 1;
    eg += run > 0 ? 0 : gap - 1;
    x = fx;
    y = fy;
    const int entry =
        run > 0 ? (fx * kPack + fy) | kRunFlag : fx * kPack + fy;
    ++t;
    valid += entry != -1;
    return entry;
  }
};

template <int L, int W, int G>
__global__ void __launch_bounds__(32)
    traceback_kernel(const int* __restrict__ bp,
                     const int* __restrict__ best_i,
                     const int* __restrict__ best_j,
                     int* __restrict__ length, int* __restrict__ identities,
                     int* __restrict__ igaps, int* __restrict__ egaps,
                     int* __restrict__ n_steps, int* __restrict__ chain) {
  using Bd = Band<L, W, G>;
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;  // one pair a block of one warp
  constexpr int CH = 2 * L;
  constexpr long long words = (long long)(2 * L - 1) * L;  // one pair's bp
  Bd band;
  band.rows = smem;
  const int* pbp = bp + (long long)b * words;
  int* pch = chain + (long long)b * CH;
  int px = best_i[b], py = best_j[b];
  Path path;
  int entry = px * kPack + py;
  if (lane == 0) pch[0] = entry;
  path.valid = entry != -1;
  while (px > 0 && py > 0 && path.t < CH - 1) {
    if (!band.holds(px, py)) {
      if (W == 0 || px + py > 2 * L - 2 || px >= L) {
        // no band at this bucket, or a word F never writes: the clamped
        // address, read directly
        const unsigned w = (unsigned)__ldg(
            pbp + min((long long)(px + py) * L + px, words - 1));
        entry = path.move(w, px, py);
        if (lane == 0) pch[path.t] = entry;
        continue;
      }
      band.load(pbp, px, py, lane);  // the next round, anchored here
    }
    // the walk in the band: one shared read a move, issued before the
    // test of whether the walk goes on in the band, so that the test does
    // not lengthen the chain of dependent reads
    unsigned w = band.peek(px, py);
    for (;;) {
      entry = path.move(w, px, py);
      if (lane == 0) pch[path.t] = entry;
      w = band.peek(px, py);
      if (!(px > 0 && py > 0 && path.t < CH - 1 && band.holds(px, py)))
        break;
    }
  }
  if (lane == 0) {
    length[b] = path.len;
    identities[b] = path.id;
    igaps[b] = path.ig;
    egaps[b] = path.eg;
    n_steps[b] = path.valid - 1;
  }
  for (int c = path.t + 1 + lane; c < CH; c += 32) pch[c] = -1;
}

template <int L, int W, int G>
int launch(const int* bp, const int* best_i, const int* best_j, int B,
           int* length, int* identities, int* igaps, int* egaps,
           int* n_steps, int* chain, cudaStream_t stream) {
  constexpr int smem = Band<L, W, G>::kWords * 4;
  static_assert(smem <= 48 * 1024, "a larger band needs the opt-in "
                "cudaFuncAttributeMaxDynamicSharedMemorySize");
  traceback_kernel<L, W, G><<<B, 32, smem, stream>>>(
      bp, best_i, best_j, length, identities, igaps, egaps, n_steps, chain);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: bp [B, 2L-1, L] int32 as nw_forward
// writes it, 16-byte aligned; best_i, best_j and the five per-pair
// outputs (length, identities, igaps, egaps, n_steps) [B] int32; chain
// [B, 2L] int32.  The kernel writes every output word.  B must be
// positive and L a length bucket.
extern "C" int traceback_launch(const int* bp, const int* best_i,
                                const int* best_j, int B, int L, int* length,
                                int* identities, int* igaps, int* egaps,
                                int* n_steps, int* chain,
                                cudaStream_t stream) {
  if (B <= 0 || (uintptr_t)bp % 16) return (int)cudaErrorInvalidValue;
#define NW_CASE(l, k, ns)                                                  \
  if (L == l)                                                              \
    return launch<l, TB_W##l, TB_G##l>(bp, best_i, best_j, B, length,     \
                                       identities, igaps, egaps, n_steps, \
                                       chain, stream);
  NW_BUCKETS(NW_CASE)
#undef NW_CASE
  return (int)cudaErrorInvalidValue;
}
