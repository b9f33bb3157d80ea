/* Native host runtime for imsame_tpu.
 *
 * The TPU does the alignment math; these routines are the host side of the
 * pipeline -- index construction and candidate-stream expansion -- where the
 * reference spends its single-threaded C time (dict build src/IMSAME.c:232-281,
 * per-thread k-mer scan src/alignmentFunctions.c:91-121).  They replace the
 * multi-pass numpy formulations with C passes: a partitioned counting sort
 * instead of argsort, and fused rolling-key + bucket-lookup + prefix-sum
 * loops.
 *
 * Semantics are bit-compatible with the numpy paths (tests/test_native.py
 * checks exact equality); layout contracts:
 *   codes  uint8[total_len]   2-bit base codes (A=0 C=1 G=2 T=3)
 *   fresh  uint8[total_len]   1 where the k-mer window restarts (read start
 *                             or preceded by a dropped non-newline char,
 *                             reference src/IMSAME.c:229-231)
 *   bucket_start int32[4^k+1] exclusive prefix table; bucket of key b is
 *                             rows [bucket_start[b], bucket_start[b+1])
 *   index rows sorted by (key asc, pos desc) -- descending pos reproduces
 *   the reference's prepend-on-insert "newest first" hit order
 *   (src/IMSAME.c:263-276, SURVEY.md quirk 6.1).
 *
 * Build: gcc -O3 -shared -fPIC (see native/__init__.py); no dependencies.
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

static inline uint32_t key_mask(int32_t k) {
    return (k >= 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
}

/* ------------------------------------------------------------------ *
 * Parallel index build: a two-level partitioned counting sort.
 *
 * Replaces the reference's single-threaded insert loop
 * (src/IMSAME.c:232-281).  A key of 2k bits splits into its top S bits,
 * the partition, and its low F = 2k - S bits, the fine key; F is at most
 * IDX_FINE_BITS, so one partition's counters (2^F) stay in a core's
 * cache, and the threads' partition tables hold T x 2^S counters.  No
 * table of the 4^k key space is allocated: every temporary grows with
 * the entries, and the only full-width write is bucket_start itself.
 * Four passes:
 *
 *   count    threads take contiguous window-end ranges and count their
 *            valid k-mers per partition;
 *   prefix   one serial prefix over (partition, thread) gives every
 *            thread its write cursor in each partition's region, threads
 *            in ascending order, so a region holds its entries in
 *            ascending position;
 *   scatter  threads rescan their ranges and append each entry's fine
 *            key (uint16) and payload to its partition's region: the
 *            payload into the output arrays, whose partition regions
 *            are the ones the sorted index gives each partition;
 *   place    threads take contiguous partition ranges, balanced by
 *            entries.  A partition's fine keys are histogrammed, its
 *            slice of bucket_start written, its payload copied to a
 *            scratch buffer and placed back from each bucket's end
 *            downward: entries arrive in ascending position, so every
 *            bucket comes out in descending position, the reference's
 *            prepend-on-insert "newest first" (src/IMSAME.c:263-276,
 *            quirk 6.1).
 *
 * A k-mer ending at p is valid iff its k bases were appended with no
 * window reset: no fresh flag in (p-k+1, p].  Threads warm up their
 * rolling key/run state from p_lo-k+1, so the split is seam-free.
 * Threads: the caller's count, capped at 32 and at one thread per
 * IDX_MIN_ENTRIES_PER_THREAD window ends (each window end is at most one
 * entry), so small builds run on one thread.
 *
 * Output modes (keys/pos/sid are derived lazily in Python):
 *   mode 1 (packable: n_seqs < 2^20 and read lens < 4096):
 *       out_packed[o] = (sid << 12) | (pos - start[sid])
 *   mode 0: out_pos[o] = one-past-kmer-end (src/IMSAME.c:247),
 *           out_sid[o] = read id.
 * Returns the total entry count, or -1 on allocation failure (caller
 * falls back to numpy).
 * ------------------------------------------------------------------ */

/* fine key bits: a partition's histogram of 2^12 int64 counters, 32 KB
   (on an H100's 8-core host, F = 12 built a wide db of 1,081,344 250 bp
   reads fastest, and came within 12 ms of F = 14-16 at 20k and 100k) */
#define IDX_FINE_BITS 12
/* partition bits at most, so a fine key fits a uint16 up to k = 16 */
#define IDX_MAX_PART_BITS 16
/* window ends a thread takes at least */
#define IDX_MIN_ENTRIES_PER_THREAD (1 << 17)

typedef struct {
    const uint8_t *codes, *fresh;
    const int64_t *start;
    int64_t n_seqs;
    int32_t k, F;         /* k-mer length, fine key bits */
    int64_t p_lo, p_hi;   /* window-end range [p_lo, p_hi) */
    int64_t *cur;         /* [max(2^S, 2^F)]: a partition's counts, then
                             write cursors; in the place pass a fine
                             key's counts, then end cursors */
    uint16_t *fine;       /* [entries]: fine keys, partition-ordered */
    uint32_t *out_packed; /* NULL in the wide mode */
    int32_t *out_pos, *out_sid;
    /* place pass */
    int64_t part_lo, part_hi;
    const int64_t *part_start; /* [2^S + 1] */
    int32_t *bucket_start;
    int32_t *scratch;     /* [1 or 2 x the largest partition of the range] */
} IdxTask;

/* The window ends [p_lo, p_hi) whose k-mer is valid, in ascending order:
 * the rolling key and run warm up from p_lo-k+1, and EACH runs for each
 * valid window end `p` with its k-mer in `key`. */
#define IDX_SCAN(t, EACH)                                                   \
    do {                                                                    \
        const uint8_t *restrict codes_ = (t)->codes, *restrict fresh_ =    \
            (t)->fresh;                                                     \
        const uint32_t mask_ = key_mask((t)->k);                            \
        const int64_t k_ = (t)->k, p_hi_ = (t)->p_hi;                       \
        int64_t p_ = (t)->p_lo - (k_ - 1), first_ = (t)->p_lo;              \
        if (p_ < 0) p_ = 0;                                                 \
        if (first_ < k_ - 1) first_ = k_ - 1;                               \
        if (first_ > p_hi_) first_ = p_hi_;                                 \
        uint32_t key = 0;                                                   \
        int64_t run_ = 0;                                                   \
        for (; p_ < first_; p_++) {                                         \
            key = ((key << 2) | codes_[p_]) & mask_;                        \
            run_ = fresh_[p_] ? 1 : run_ + 1;                               \
        }                                                                   \
        for (int64_t p = p_; p < p_hi_; p++) {                              \
            key = ((key << 2) | codes_[p]) & mask_;                         \
            run_ = fresh_[p] ? 1 : run_ + 1;                                \
            if (run_ >= k_) { EACH; }                                       \
        }                                                                   \
    } while (0)

static void *idx_count_pass(void *arg) {
    const IdxTask *t = (const IdxTask *)arg;
    const int F = t->F;
    int64_t *restrict cnt = t->cur;
    IDX_SCAN(t, cnt[key >> F]++);
    return NULL;
}

static void *idx_scatter_pass(void *arg) {
    const IdxTask *t = (const IdxTask *)arg;
    const int F = t->F;
    const uint32_t fmask = (1u << F) - 1u;
    const int64_t *restrict start = t->start;
    const int64_t n_seqs = t->n_seqs, k = t->k;
    int64_t *restrict cur = t->cur;
    uint16_t *restrict fine = t->fine;
    uint32_t *restrict out_packed = t->out_packed;
    int32_t *restrict out_pos = t->out_pos, *restrict out_sid = t->out_sid;
    /* read id of the first window start via binary search, then linear */
    int64_t r = 0;
    {
        int64_t ps0 = t->p_lo - (k - 1);
        if (ps0 < 0) ps0 = 0;
        int64_t a = 0, b = n_seqs;
        while (a < b) { /* upper_bound(start, ps0) - 1 */
            int64_t mid = a + (b - a) / 2;
            if (start[mid] <= ps0) a = mid + 1; else b = mid;
        }
        r = a > 0 ? a - 1 : 0;
    }
    int64_t base = n_seqs ? start[r] : 0;
    int64_t next = r + 1 < n_seqs ? start[r + 1] : INT64_MAX;
    if (out_packed)
        IDX_SCAN(t, {
            while (p - k + 1 >= next) {
                base = next;
                next = ++r + 1 < n_seqs ? start[r + 1] : INT64_MAX;
            }
            int64_t o = cur[key >> F]++;
            fine[o] = (uint16_t)(key & fmask);
            out_packed[o] = ((uint32_t)r << 12) | (uint32_t)(p + 1 - base);
        });
    else
        IDX_SCAN(t, {
            while (p - k + 1 >= next)
                next = ++r + 1 < n_seqs ? start[r + 1] : INT64_MAX;
            int64_t o = cur[key >> F]++;
            fine[o] = (uint16_t)(key & fmask);
            out_pos[o] = (int32_t)(p + 1);
            out_sid[o] = (int32_t)r;
        });
    return NULL;
}

static void *idx_place_pass(void *arg) {
    IdxTask *t = (IdxTask *)arg;
    const int F = t->F;
    const int64_t nf = (int64_t)1 << F;
    int64_t *hist = t->cur;  /* [2^F]: counts, then end cursors */
    const int packed = t->out_packed != NULL;
    for (int64_t q = t->part_lo; q < t->part_hi; q++) {
        const int64_t lo = t->part_start[q], hi = t->part_start[q + 1];
        const int64_t m = hi - lo;
        int32_t *bs = t->bucket_start + (q << F);
        if (m == 0) {
            for (int64_t f = 0; f < nf; f++) bs[f] = (int32_t)lo;
            continue;
        }
        const uint16_t *fk = t->fine + lo;
        memset(hist, 0, (size_t)nf * sizeof(int64_t));
        for (int64_t i = 0; i < m; i++) hist[fk[i]]++;
        int64_t acc = lo;
        for (int64_t f = 0; f < nf; f++) {
            bs[f] = (int32_t)acc;
            acc += hist[f];
            hist[f] = acc;
        }
        if (packed) {
            uint32_t *out = t->out_packed, *tmp = (uint32_t *)t->scratch;
            memcpy(tmp, out + lo, (size_t)m * 4);
            for (int64_t i = 0; i < m; i++) out[--hist[fk[i]]] = tmp[i];
        } else {
            int32_t *tp = t->scratch, *ts = t->scratch + m;
            memcpy(tp, t->out_pos + lo, (size_t)m * 4);
            memcpy(ts, t->out_sid + lo, (size_t)m * 4);
            for (int64_t i = 0; i < m; i++) {
                int64_t o = --hist[fk[i]];
                t->out_pos[o] = tp[i];
                t->out_sid[o] = ts[i];
            }
        }
    }
    return NULL;
}

/* Generic task runner: tasks is an array of T task structs of size
 * ``stride`` bytes (passing the typed pointer directly would index with
 * the wrong element size for any struct but the one it was declared
 * for). */
static void run_tasks_s(void *tasks, size_t stride, int T,
                        void *(*fn)(void *)) {
    pthread_t tids[64];
    int spawned = 0;
    char *base = (char *)tasks;
    for (int j = 0; j + 1 < T; j++)
        if (pthread_create(&tids[j], NULL, fn, base + (size_t)j * stride) == 0)
            spawned++;
        else { fn(base + (size_t)j * stride); }  /* degrade: run inline */
    fn(base + (size_t)(T - 1) * stride);
    for (int j = 0; j < spawned; j++) pthread_join(tids[j], NULL);
}

#define run_tasks(tasks, T, fn) \
    run_tasks_s((tasks), sizeof((tasks)[0]), (T), (fn))

EXPORT int64_t imsame_index_build(
    const uint8_t *codes, const uint8_t *fresh,
    const int64_t *start, int64_t n_seqs,
    int64_t n, int32_t k, int64_t n_buckets, int32_t n_threads,
    int32_t *bucket_start /* [n_buckets+1] out: exclusive prefix table */,
    uint32_t *out_packed /* [cap] or dummy */, int32_t mode_packed,
    int32_t *out_pos, int32_t *out_sid /* [cap] each, or dummy */) {
    int T = n_threads < 1 ? 1 : (n_threads > 32 ? 32 : n_threads);
    const int64_t t_max = n / IDX_MIN_ENTRIES_PER_THREAD;
    if (T > t_max) T = t_max > 1 ? (int)t_max : 1;
    if (n < k) {
        memset(bucket_start, 0, (size_t)(n_buckets + 1) * 4);
        return 0;
    }
    /* F fine bits, S = 2k - F partition bits, S <= IDX_MAX_PART_BITS, so
       F <= 16 for every k <= 16 and a fine key fits a uint16 */
    int F = 2 * k < IDX_FINE_BITS ? 2 * k : IDX_FINE_BITS;
    if (2 * k - F > IDX_MAX_PART_BITS) F = 2 * k - IDX_MAX_PART_BITS;
    const int64_t P = (int64_t)1 << (2 * k - F);
    const int64_t cur_len = P > ((int64_t)1 << F) ? P : ((int64_t)1 << F);

    IdxTask tasks[32];
    int64_t *part_start = (int64_t *)malloc((size_t)(P + 1) * 8);
    int64_t *cur = (int64_t *)calloc((size_t)(T * cur_len), 8);
    uint16_t *fine = NULL;
    int32_t *scratch = NULL;
    int64_t total = -1;
    if (!part_start || !cur) goto done;
    for (int j = 0; j < T; j++) {
        IdxTask *t = &tasks[j];
        t->codes = codes; t->fresh = fresh; t->start = start;
        t->n_seqs = n_seqs; t->k = k; t->F = F;
        t->p_lo = n * j / T;
        t->p_hi = n * (j + 1) / T;
        t->cur = cur + (int64_t)j * cur_len;
        t->out_packed = mode_packed ? out_packed : NULL;
        t->out_pos = out_pos; t->out_sid = out_sid;
        t->part_start = part_start; t->bucket_start = bucket_start;
    }
    run_tasks(tasks, T, idx_count_pass);
    /* counts -> cursors over (partition, thread), threads ascending */
    total = 0;
    for (int64_t q = 0; q < P; q++) {
        part_start[q] = total;
        for (int j = 0; j < T; j++) {
            int64_t c = tasks[j].cur[q];
            tasks[j].cur[q] = total;
            total += c;
        }
    }
    part_start[P] = total;
    fine = (uint16_t *)malloc((size_t)(total > 0 ? total : 1) * 2);
    if (!fine) { total = -1; goto done; }
    for (int j = 0; j < T; j++) tasks[j].fine = fine;
    run_tasks(tasks, T, idx_scatter_pass);
    /* partition ranges balanced by weight, a partition weighing its
       entries and a quarter of its 2^F counters; each range's scratch
       holds its largest partition's payload */
    {
        const int64_t w_part = ((int64_t)1 << F) / 4 + 1;
        const int64_t w_all = total + P * w_part;
        const int words = mode_packed ? 1 : 2;
        int64_t q = 0, w = 0, scratch_len = 0, off[32];
        for (int j = 0; j < T; j++) {
            int64_t big = 0;
            tasks[j].part_lo = q;
            while (q < P && (j == T - 1 || w < w_all * (j + 1) / T)) {
                int64_t m = part_start[q + 1] - part_start[q];
                if (m > big) big = m;
                w += m + w_part;
                q++;
            }
            tasks[j].part_hi = q;
            off[j] = scratch_len;
            scratch_len += big * words;
        }
        scratch = (int32_t *)malloc(
            (size_t)(scratch_len > 0 ? scratch_len : 1) * 4);
        if (!scratch) { total = -1; goto done; }
        for (int j = 0; j < T; j++) tasks[j].scratch = scratch + off[j];
    }
    run_tasks(tasks, T, idx_place_pass);
    bucket_start[n_buckets] = (int32_t)total;
done:
    free(scratch);
    free(fine);
    free(cur);
    free(part_start);
    return total;
}

/* ------------------------------------------------------------------ *
 * Report renderer: the whole -out report of a batch of accepted pairs in
 * one pass.  Per pair, the record header (src/alignmentFunctions.c:
 * 167-168), then the two right-aligned alignment buffers rebuilt from
 * the device traceback chain and emitted as 60-column triplet blocks (db
 * line, query line, '*' match line), counting identities during
 * emission -- the reference counts them at render time too
 * (src/alignmentFunctions.c:230-271; emission order
 * src/alignmentFunctions.c:493-560).  Bases are read as 2-bit codes and
 * mapped to ASCII where they are read, so no sample is copied to
 * characters.
 *
 * Chain encoding (ops/traceback.py): chain[0] = best cell as
 * px*4096+py; subsequent entries are visited cells, bit 26 flagging a
 * diagonal-run jump whose chars expand one by one.
 * ------------------------------------------------------------------ */

#define ALIGN_COLS 60

static const uint8_t BASE_CHAR[4] = {'A', 'C', 'G', 'T'};

static int64_t render_one(
    const int32_t *chain, int32_t n_steps, int32_t xl, int32_t yl,
    const uint8_t *xc, const uint8_t *yc, /* 2-bit codes of the two reads */
    uint8_t *rec_x, uint8_t *rec_y, /* scratch, >= 4*max(xl,yl)+2 */
    uint8_t *out, int32_t *identities_out) {
    const int32_t PACKB = 4096;
    const int32_t RUN_FLAG = 1 << 26;
#define XC(k) BASE_CHAR[xc[k] & 3]
#define YC(k) BASE_CHAR[yc[k] & 3]
    int32_t maximum_len = 2 * (xl > yl ? xl : yl);
    int32_t buf_len = 2 * maximum_len + 2;
    memset(rec_x, ' ', (size_t)buf_len);
    memset(rec_y, ' ', (size_t)buf_len);
    int32_t head_x = maximum_len, head_y = maximum_len;
    int32_t bc_x = chain[0] / PACKB, bc_y = chain[0] % PACKB;
    int32_t prev_x = bc_x, prev_y = bc_y;
    for (int32_t k = xl - 1; k > bc_x; k--) rec_x[head_x--] = '-';
    for (int32_t k = yl - 1; k > bc_y; k--) rec_y[head_y--] = '-';
    int32_t curr_x = bc_x, curr_y = bc_y;
    for (int32_t st = 1; st <= n_steps; st++) {
        int32_t e = chain[st];
        int is_run = (e & RUN_FLAG) != 0;
        e &= RUN_FLAG - 1;
        curr_x = e / PACKB;
        curr_y = e % PACKB;
        if (is_run) {
            for (int32_t k = 0; k < prev_x - curr_x; k++) {
                rec_x[head_x--] = XC(prev_x - k);
                rec_y[head_y--] = YC(prev_y - k);
            }
        } else if (curr_x == prev_x - 1 && curr_y == prev_y - 1) {
            rec_x[head_x--] = XC(prev_x);
            rec_y[head_y--] = YC(prev_y);
        } else if ((prev_x - curr_x) > (prev_y - curr_y)) {
            for (int32_t k = prev_x; k > curr_x; k--) {
                rec_y[head_y--] = '-';
                rec_x[head_x--] = XC(k);
            }
        } else {
            for (int32_t k = prev_y; k > curr_y; k--) {
                rec_x[head_x--] = '-';
                rec_y[head_y--] = YC(k);
            }
        }
        prev_x = curr_x;
        prev_y = curr_y;
    }
#undef XC
#undef YC
    int32_t hx = 0, hy = 0; /* leading gap runs; shorter side space-padded */
    for (int32_t k = curr_x - 1; k >= 0; k--) { rec_x[head_x--] = '-'; hx++; }
    for (int32_t k = curr_y - 1; k >= 0; k--) { rec_y[head_y--] = '-'; hy++; }
    if (hx >= hy)
        while (hx-- > 0) rec_y[head_y--] = ' ';
    else
        while (hy-- > 0) rec_x[head_x--] = ' ';

    int32_t identities = 0;
    int64_t o = 0;
    int32_t i = head_x + 1, j = head_y + 1;
    while (i <= maximum_len && j <= maximum_len) {
        int32_t off = 0, before_i = i, before_j = j;
        while (off < ALIGN_COLS && i <= maximum_len) {
            out[o++] = rec_x[i++];
            off++;
        }
        out[o++] = '\n';
        off = 0;
        while (off < ALIGN_COLS && j <= maximum_len) {
            out[o++] = rec_y[j++];
            off++;
        }
        out[o++] = '\n';
        while (before_i < i) {
            uint8_t cx = rec_x[before_i], cy = rec_y[before_j];
            if (cx != '-' && cy != '-' && cx == cy) {
                out[o++] = '*';
                identities++;
            } else
                out[o++] = ' ';
            before_j++;
            before_i++;
        }
        out[o++] = '\n';
    }
    out[o++] = '\n';
    *identities_out = identities;
    return o;
}

/* Decimal digits of v at o; returns the count (Python's str(int)). */
static int put_int(uint8_t *o, int64_t v) {
    uint8_t tmp[24];
    int n = 0, s = 0;
    uint64_t u = (uint64_t)v;
    if (v < 0) {
        o[s++] = '-';
        u = 0 - u;
    }
    do {
        tmp[n++] = (uint8_t)('0' + u % 10);
        u /= 10;
    } while (u);
    for (int k = 0; k < n; k++) o[s + k] = tmp[n - 1 - k];
    return s + n;
}

/* "(<qread>, <dbread>) : <id>% <cov>% <ylen>\n $$$$$$$ \n" with the
 * percentages MIN(100, .) of uint64 floor divisions (io/report.py
 * format_record).  At most 80 bytes. */
static int64_t put_header(uint8_t *o, int64_t qread, int64_t dbread,
                          int32_t identities, int32_t length, int32_t ylen) {
    uint64_t id_pct = (uint64_t)100 * (uint64_t)identities / (uint64_t)length;
    uint64_t cov_pct = (uint64_t)100 * (uint64_t)length / (uint64_t)ylen;
    int64_t n = 0;
    o[n++] = '(';
    n += put_int(o + n, qread);
    o[n++] = ',';
    o[n++] = ' ';
    n += put_int(o + n, dbread);
    memcpy(o + n, ") : ", 4);
    n += 4;
    n += put_int(o + n, (int64_t)(id_pct < 100 ? id_pct : 100));
    o[n++] = '%';
    o[n++] = ' ';
    n += put_int(o + n, (int64_t)(cov_pct < 100 ? cov_pct : 100));
    o[n++] = '%';
    o[n++] = ' ';
    n += put_int(o + n, ylen);
    memcpy(o + n, "\n $$$$$$$ \n", 11);
    return n + 11;
}

typedef struct {
    const uint8_t *xcodes, *ycodes;
    const int64_t *qread, *dbread, *xoff, *yoff;
    const int32_t *xlen, *ylen, *length, *identities, *rec_ylen, *n_steps;
    const int32_t *chains;
    const int64_t *chain_off, *out_off;
    int64_t r0, r1;       /* record range [r0, r1) */
    int32_t maxl;         /* longest read of the batch */
    uint8_t *out;
    int32_t *emitted;
    int64_t written;      /* bytes from out + out_off[r0] */
    int32_t status;       /* 0, or -1: no scratch, -2: a record refused */
} RrTask;

/* One thread's records, back to back from the start of its range's
 * capped slots.  A record the renderer cannot take (a zero length, a
 * chain shorter than its steps, an output past its cap) stops the range
 * with status -2, so the caller falls back to the Python path, which
 * defines the answer for it. */
static void *rr_pass(void *arg) {
    RrTask *t = (RrTask *)arg;
    t->written = 0;
    t->status = 0;
    uint8_t *rec_x = (uint8_t *)malloc((size_t)(4 * t->maxl + 2) * 2);
    if (!rec_x) {
        t->status = -1;
        return NULL;
    }
    uint8_t *rec_y = rec_x + (4 * t->maxl + 2);
    uint8_t *o = t->out + t->out_off[t->r0];
    for (int64_t p = t->r0; p < t->r1; p++) {
        int32_t ns = t->n_steps[p];
        if (t->length[p] <= 0 || t->rec_ylen[p] <= 0 || t->identities[p] < 0
            || ns < 0 || ns + 1 > t->chain_off[p + 1] - t->chain_off[p]) {
            t->status = -2;
            break;
        }
        int64_t n = put_header(o, t->qread[p], t->dbread[p], t->identities[p],
                               t->length[p], t->rec_ylen[p]);
        n += render_one(t->chains + t->chain_off[p], ns, t->xlen[p],
                        t->ylen[p], t->xcodes + t->xoff[p],
                        t->ycodes + t->yoff[p], rec_x, rec_y, o + n,
                        &t->emitted[p]);
        o += n;
        t->written += n;
        if (o - t->out > t->out_off[p + 1]) {
            t->status = -2; /* past the record's cap: the caps are wrong */
            break;
        }
    }
    free(rec_x);
    return NULL;
}

/* The report of P records into out: each record's slot [out_off[p],
 * out_off[p+1]) (out_off[0] = 0) holds its header's 80 bytes and its
 * blocks' bound, 3 * span + 3 * (span / 60 + 2) + 8 with span =
 * 2 * max(xlen, ylen) (native/__init__.py render_report).  Up to n_threads threads render contiguous
 * record ranges, balanced by slot bytes, each from the start of its
 * range's slots; the ranges are then moved down, in order, so that the
 * report lies at out[0, returned length).  One thread below 4,096
 * records.  emitted[p] is the identity count the render of record p
 * emitted.  Returns the report's length, -1 when scratch memory runs
 * out or -2 for a record the renderer refuses (rr_pass). */
EXPORT int64_t imsame_render_report(
    const uint8_t *xcodes, const uint8_t *ycodes,
    const int64_t *qread, const int64_t *dbread,
    const int64_t *xoff, const int64_t *yoff,
    const int32_t *xlen, const int32_t *ylen,
    const int32_t *length, const int32_t *identities,
    const int32_t *rec_ylen, const int32_t *n_steps,
    const int32_t *chains, const int64_t *chain_off,
    int64_t P, const int64_t *out_off, uint8_t *out, int32_t *emitted,
    int32_t n_threads) {
    if (P <= 0) return 0;
    int32_t maxl = 0;
    for (int64_t p = 0; p < P; p++) {
        if (xlen[p] > maxl) maxl = xlen[p];
        if (ylen[p] > maxl) maxl = ylen[p];
    }
    int T = n_threads < 1 ? 1 : (n_threads > 32 ? 32 : n_threads);
    int64_t most = P < 4096 ? 1 : P / 2048; /* thread setup dwarfs less */
    if (T > most) T = (int)most;
    RrTask tasks[32];
    int64_t r = 0;
    for (int j = 0; j < T; j++) {
        RrTask *t = &tasks[j];
        t->xcodes = xcodes; t->ycodes = ycodes;
        t->qread = qread; t->dbread = dbread; t->xoff = xoff; t->yoff = yoff;
        t->xlen = xlen; t->ylen = ylen; t->length = length;
        t->identities = identities; t->rec_ylen = rec_ylen;
        t->n_steps = n_steps; t->chains = chains; t->chain_off = chain_off;
        t->out_off = out_off; t->maxl = maxl; t->out = out;
        t->emitted = emitted;
        t->r0 = r;
        int64_t goal = out_off[P] * (j + 1) / T;
        while (r < P && out_off[r] < goal) r++;
        t->r1 = (j == T - 1) ? P : r;
    }
    run_tasks(tasks, T, rr_pass);
    int64_t n = 0;
    for (int j = 0; j < T; j++) {
        if (tasks[j].status != 0) return tasks[j].status;
        uint8_t *src = out + tasks[j].out_off[tasks[j].r0];
        if (src != out + n) memmove(out + n, src, (size_t)tasks[j].written);
        n += tasks[j].written;
    }
    return n;
}

/* ------------------------------------------------------------------ *
 * FASTA ingest: one pass replicating io/fasta.py parse semantics
 * (reference ingest, src/IMSAME.c:196-289): header lines ('>' at line
 * start) delimit reads; every other byte after the first header maps
 * through ``lut`` (A/C/G/T upper+lower -> 0..3, else 255); 255 bytes are
 * dropped and set a window-reset flag on the next kept base (reference
 * src/IMSAME.c:229-231); newlines neither reset nor emit.
 *
 * Outputs (caller-allocated): codes/fresh sized >= n; start sized >= the
 * number of '>' bytes in the input (upper bound on reads); hdr_se holds
 * (text_start, text_end) byte offsets per header.  start[r] is -1 for
 * reads with no kept bases (caller back-fills with the next read's
 * start, matching the numpy searchsorted semantics).  Returns the kept
 * base count; read count via n_reads_out.
 * ------------------------------------------------------------------ */
EXPORT int64_t imsame_parse_fasta(
    const uint8_t *raw, int64_t n, const uint8_t *lut,
    uint8_t *codes, uint8_t *fresh,
    int64_t *start, int64_t *hdr_se, int64_t *n_reads_out) {
    int64_t m = 0;
    int64_t r = -1;
    int in_header = 0;
    int at_line_start = 1;
    int pending_fresh = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = raw[i];
        if (c == '\n') {
            if (in_header) {
                hdr_se[2 * r + 1] = i;
                in_header = 0;
            }
            at_line_start = 1;
            continue;
        }
        if (at_line_start) {
            at_line_start = 0;
            if (c == '>') {
                r++;
                start[r] = -1;
                hdr_se[2 * r] = i + 1;
                hdr_se[2 * r + 1] = n; /* header at EOF without newline */
                in_header = 1;
                pending_fresh = 0;
                continue;
            }
        }
        if (in_header || r < 0) continue;
        uint8_t code = lut[c];
        if (code == 255) {
            pending_fresh = 1;
            continue;
        }
        if (start[r] < 0) {
            start[r] = m;
            fresh[m] = 1; /* first base of a read always restarts */
        } else {
            fresh[m] = (uint8_t)pending_fresh;
        }
        pending_fresh = 0;
        codes[m] = code;
        m++;
    }
    *n_reads_out = r + 1;
    return m;
}

/* Query candidate-stream tables: fused rolling key + bucket lookup + prefix
 * sum (the numpy path needs five multi-megabyte temporaries and two random
 * gathers into the 67 MB prefix table).
 *
 * Per read rd, emits n_kmers[rd] consecutive slots starting at stream
 * position qlo[rd] (the caller bakes the reference's boundary-base quirk,
 * SURVEY.md 6.5, into qlo/n_kmers).  For global slot i:
 *   kp[i]   k-mer start position in the concatenated query array
 *   lo[i]   first index row of the k-mer's bucket
 *   cnt[i]  bucket size
 *   Ccum[i] exclusive prefix sum of cnt (Ccum[0]=0, length total+1)
 */
typedef struct {
    const uint8_t *codes;
    const int64_t *qlo, *n_kmers, *slot_off;
    int64_t r0, r1;
    int32_t k;
    const int32_t *bucket_start;
    int64_t *kp;
    int32_t *lo, *cnt;
    int64_t *Ccum;
    int64_t range_total; /* out of scan pass / base for fixup pass */
} KsTask;

/* Per-thread scan of a contiguous read range: reads are independent (each
 * read's slots land at slot_off[rd]), so only the Ccum prefix is global --
 * the scan writes thread-LOCAL cumulatives and a fixup pass adds the
 * cross-range base.  The scan is cache-miss bound on the two adjacent
 * bucket_start words per slot (67 MB table); threads overlap the misses. */
static void *ks_scan(void *arg) {
    KsTask *t = (KsTask *)arg;
    const uint32_t mask = key_mask(t->k);
    int64_t c = 0;
    for (int64_t rd = t->r0; rd < t->r1; rd++) {
        int64_t s = t->qlo[rd], m = t->n_kmers[rd];
        int64_t i = t->slot_off[rd];
        if (m <= 0) continue;
        uint32_t key = 0;
        for (int32_t j = 0; j < t->k - 1; j++)
            key = (key << 2) | t->codes[s + j];
        for (int64_t j = 0; j < m; j++) {
            key = ((key << 2) | t->codes[s + j + t->k - 1]) & mask;
            t->kp[i] = s + j;
            int32_t l = t->bucket_start[key];
            int32_t h = t->bucket_start[key + 1];
            t->lo[i] = l;
            t->cnt[i] = h - l;
            c += h - l;
            t->Ccum[i + 1] = c;
            i++;
        }
    }
    t->range_total = c;
    return NULL;
}

static void *ks_fixup(void *arg) {
    KsTask *t = (KsTask *)arg;
    int64_t base = t->range_total; /* repurposed: prefix of earlier ranges */
    if (base == 0) return NULL;
    int64_t i0 = t->slot_off[t->r0] + 1, i1 = t->slot_off[t->r1] + 1;
    for (int64_t i = i0; i < i1; i++) t->Ccum[i] += base;
    return NULL;
}

EXPORT void imsame_kmer_stream(
    const uint8_t *codes,
    const int64_t *qlo, const int64_t *n_kmers, int64_t n_seqs, int32_t k,
    const int32_t *bucket_start,
    int64_t *kp, int32_t *lo, int32_t *cnt, int64_t *Ccum,
    int32_t n_threads) {
    Ccum[0] = 0;
    int64_t *slot_off = (int64_t *)malloc((size_t)(n_seqs + 1) * 8);
    if (!slot_off) { /* degrade: the original single-threaded scan */
        const uint32_t mask = key_mask(k);
        int64_t i = 0, c = 0;
        for (int64_t rd = 0; rd < n_seqs; rd++) {
            int64_t s = qlo[rd], m = n_kmers[rd];
            if (m <= 0) continue;
            uint32_t key = 0;
            for (int32_t j = 0; j < k - 1; j++) key = (key << 2) | codes[s + j];
            for (int64_t j = 0; j < m; j++) {
                key = ((key << 2) | codes[s + j + k - 1]) & mask;
                kp[i] = s + j;
                int32_t l = bucket_start[key];
                int32_t h = bucket_start[key + 1];
                lo[i] = l;
                cnt[i] = h - l;
                c += h - l;
                Ccum[i + 1] = c;
                i++;
            }
        }
        return;
    }
    int64_t total = 0;
    for (int64_t rd = 0; rd < n_seqs; rd++) {
        slot_off[rd] = total;
        if (n_kmers[rd] > 0) total += n_kmers[rd];
    }
    slot_off[n_seqs] = total;
    int T = n_threads < 1 ? 1 : (n_threads > 32 ? 32 : n_threads);
    if (total < (1 << 18)) T = 1;
    KsTask tasks[32];
    /* split read ranges by slot count for balance */
    int64_t r = 0;
    for (int j = 0; j < T; j++) {
        KsTask *t = &tasks[j];
        t->codes = codes; t->qlo = qlo; t->n_kmers = n_kmers;
        t->slot_off = slot_off; t->k = k; t->bucket_start = bucket_start;
        t->kp = kp; t->lo = lo; t->cnt = cnt; t->Ccum = Ccum;
        t->r0 = r;
        int64_t goal = total * (j + 1) / T;
        while (r < n_seqs && slot_off[r] < goal) r++;
        t->r1 = (j == T - 1) ? n_seqs : r;
        t->range_total = 0;
    }
    run_tasks(tasks, T, ks_scan);
    int64_t acc = 0;
    for (int j = 0; j < T; j++) {
        int64_t rt = tasks[j].range_total;
        tasks[j].range_total = acc; /* repurpose as fixup base */
        acc += rt;
    }
    run_tasks(tasks, T, ks_fixup);
    free(slot_off);
}

/* Expand candidate-rank windows [from_rank[e], to_rank[e]) of the selected
 * reads into flat per-candidate arrays, in stream order (k-mer slots in scan
 * order x bucket hits newest-first -- the order the reference worker walks,
 * src/alignmentFunctions.c:107-186):
 *   out_rids[o]  query read id
 *   out_hits[o]  index row of the hit (lo[slot] + offset, so sid/pos are
 *                direct gathers for the caller)
 *   out_qoffs[o] one past the k-mer's last base, in read-row coordinates
 * Returns the number of candidates emitted; the caller sizes the outputs as
 * sum(max(0, min(to, N_r) - from)).  A binary search per read finds the
 * first slot of the window, so resuming a read mid-stream (the two-stage
 * gate) costs O(log slots), not a rescan. */
EXPORT int64_t imsame_build_flat(
    const int64_t *read_ids, const int64_t *from_rank, const int64_t *to_rank,
    int64_t m,
    const int64_t *K_off, const int64_t *C_off,
    const int64_t *kp, const int32_t *lo, const int32_t *cnt,
    const int64_t *Ccum,
    const int64_t *q_start, int32_t k,
    int32_t *out_rids, int32_t *out_hits, int32_t *out_qoffs) {
    int64_t o = 0;
    for (int64_t e = 0; e < m; e++) {
        int64_t r = read_ids[e];
        int64_t t0 = K_off[r], t1 = K_off[r + 1];
        int64_t base = Ccum[t0];
        int64_t f = from_rank[e], t = to_rank[e];
        int64_t nr = C_off[r + 1] - C_off[r];
        if (t > nr) t = nr;
        if (f >= t) continue;
        /* first slot whose candidate range extends past rank f */
        int64_t a = t0, b = t1;
        while (a < b) {
            int64_t mid = a + (b - a) / 2;
            if (Ccum[mid + 1] - base > f) b = mid;
            else a = mid + 1;
        }
        int64_t rank = Ccum[a] - base;
        int32_t rid32 = (int32_t)r;
        for (int64_t slot = a; slot < t1 && rank < t; slot++) {
            int64_t nh = cnt[slot];
            int32_t qoff = (int32_t)(kp[slot] + k - q_start[r]);
            int32_t l = lo[slot];
            for (int64_t h = 0; h < nh && rank < t; h++, rank++) {
                if (rank >= f) {
                    out_rids[o] = rid32;
                    out_hits[o] = l + (int32_t)h;
                    out_qoffs[o] = qoff;
                    o++;
                }
            }
        }
    }
    return o;
}

/* Segment-encode one candidate chunk for the 4-byte gate format
 * (ops/candidates.py flat_gate_seg): one int32 word per candidate --
 * bit 31 a new-segment flag, bits 25..30 the qoff delta (0..63), bits
 * 0..24 the index-hit row -- plus per-segment (read id, qoff decode
 * base) tables.  Segments break on read change, negative/overflowing
 * qoff delta, or chunk start; rbase[seg] = qoff - inclusive_cumsum(qd)
 * at the segment's first candidate so the device reconstructs
 * qoff = rbase[rix] + cumsum(qd).  Returns the segment count, or -1
 * when it would exceed seg_cap (caller falls back to the 8-byte
 * format).  Single pass; replaces an ~8-pass numpy encoding that cost
 * ~170 ms per 2M-candidate chunk. */
EXPORT int64_t imsame_seg_encode(
    const int32_t *rids, const int32_t *qoffs, const int32_t *hits,
    int64_t n, int64_t seg_cap,
    int32_t *cand, int32_t *rtab, int32_t *rbase) {
    int64_t nseg = 0;
    int64_t cs = 0;
    int32_t prev_r = -1;
    int32_t prev_q = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t r = rids[i];
        int32_t qo = qoffs[i];
        int64_t dq = (int64_t)qo - (int64_t)prev_q;
        uint32_t w;
        if (i == 0 || r != prev_r || dq < 0 || dq > 63) {
            if (nseg >= seg_cap) return -1;
            rtab[nseg] = r;
            rbase[nseg] = (int32_t)((int64_t)qo - cs);
            nseg++;
            w = 0x80000000u | (uint32_t)hits[i];
        } else {
            cs += dq;
            w = ((uint32_t)dq << 25) | (uint32_t)hits[i];
        }
        cand[i] = (int32_t)w;
        prev_r = r;
        prev_q = qo;
    }
    return nseg;
}
