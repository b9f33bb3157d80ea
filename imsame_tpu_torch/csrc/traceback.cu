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
// dependent loads, each from a bp tensor far larger than L2 (one 3072 pair
// is 75.5 MB), so a launch takes about max(n_steps) device-memory round
// trips; its bytes (a 32-byte sector a move, the chain and the stats)
// would take a few microseconds.
//
// What the design does about it: one warp per pair, four pairs a block.
// Lane 0 walks and writes the pair's stats and chain entries; the other
// lanes then fill the -1 tail of the chain with coalesced stores, so each
// output word is written once and the outputs need no initialisation.
// There is no host round trip: the walk's loop condition is evaluated on
// the card, so a render chunk is F, then this launch.  A pair's base
// offset is 64-bit (a 3072 / 272 batch is 5.1 G words).

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kPack = 4096;
constexpr unsigned kBpMask = (1u << 24) - 1;  // the from-cell's bits
constexpr int kRunFlag = 1 << 26;             // chain entry of a run

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    traceback_kernel(const int* __restrict__ bp,
                     const int* __restrict__ best_i,
                     const int* __restrict__ best_j, int B, int L,
                     int* __restrict__ length, int* __restrict__ identities,
                     int* __restrict__ igaps, int* __restrict__ egaps,
                     int* __restrict__ n_steps, int* __restrict__ chain) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: one pair a warp
  const int CH = 2 * L;
  const long long words = (long long)(2 * L - 1) * L;  // one pair's bp
  const int* pbp = bp + (long long)b * words;
  int* pch = chain + (long long)b * CH;
  int t = 0;  // moves made
  if (lane == 0) {
    int px = best_i[b], py = best_j[b];
    int len = 0, id = 0, ig = 0, eg = 0;
    int entry = px * kPack + py;
    pch[0] = entry;
    int valid = entry != -1;
    while (px > 0 && py > 0 && t < CH - 1) {
      const long long at = (long long)(px + py) * L + px;
      const unsigned w = (unsigned)__ldg(pbp + min(at, words - 1));
      const int run = (w >> 24) & 15;
      int fx, fy;
      if (run > 0) {  // a diagonal run ending here, jumped whole
        fx = px - run;
        fy = py - run;
        len += run;
        id += w >> 28;
        entry = (fx * kPack + fy) | kRunFlag;
      } else {  // a gap move to the stored from-cell
        const int frm = w & kBpMask;
        fx = frm / kPack;
        fy = frm - fx * kPack;
        const int dx = px - fx, dy = py - fy;
        const int gap = dx > dy ? dx : dy;  // in x when dx > dy
        len += gap;
        eg += gap - 1;
        ig += 1;
        entry = fx * kPack + fy;
      }
      pch[++t] = entry;
      valid += entry != -1;
      px = fx;
      py = fy;
    }
    length[b] = len;
    identities[b] = id;
    igaps[b] = ig;
    egaps[b] = eg;
    n_steps[b] = valid - 1;
  }
  t = __shfl_sync(kFull, t, 0);
  for (int c = t + 1 + lane; c < CH; c += 32) pch[c] = -1;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// All arrays are device pointers: bp [B, 2L-1, L] int32 as nw_forward
// writes it; best_i, best_j and the five per-pair outputs (length,
// identities, igaps, egaps, n_steps) [B] int32; chain [B, 2L] int32.  The
// kernel writes every output word.  B must be positive and L a length
// bucket.
extern "C" int traceback_launch(const int* bp, const int* best_i,
                                const int* best_j, int B, int L, int* length,
                                int* identities, int* igaps, int* egaps,
                                int* n_steps, int* chain,
                                cudaStream_t stream) {
  bool bucket = false;
#define NW_CASE(l, k, ns) bucket |= L == l;
  NW_BUCKETS(NW_CASE)
#undef NW_CASE
  if (!bucket || B <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  traceback_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      bp, best_i, best_j, B, L, length, identities, igaps, egaps, n_steps,
      chain);
  return (int)cudaGetLastError();
}
