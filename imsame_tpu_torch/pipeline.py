"""Batched engine: seed scan -> extension gate -> NW resolve, on one
device or on a mesh of devices (Config.mesh_shape; parallel/).

Replaces the reference's per-thread sequential scan
(src/alignmentFunctions.c:43-208) with batched device stages while keeping
its acceptance semantics bit-exact:

  * Each query read has a totally ordered candidate stream: k-mer start
    positions in scan order (including the boundary-base quirk, SURVEY.md
    6.5) x bucket hits in descending database position (6.1).
  * The reference walks that stream sequentially, runs the gapped aligner
    on every e-value-passing hit, and the first *accepting* pair wins the
    read ("NWaligned", 6.8).  The winner only depends on the (query read,
    db read) pair -- the aligner sees full reads -- so acceptance can be
    evaluated out of order and the winner recovered as the first candidate
    whose pair accepts.  We therefore:
      1. gate each read's first few candidates on the device
         (ops/candidates.py flat gate over packed rows: the csrc/gate.cu
         kernel on the card, ops/extend_packed.py on the CPU) -- most
         reads accept their first candidate, mirroring the reference's
         early exit -- then gate every remaining
         candidate of the unresolved tail in one flat pass (random reads
         have no passing candidate anywhere, so the reference walks their
         whole stream too);
      2. gapped-align every unique passing (read, db read) pair in one
         wave with the stats-only aligner (ops/resolve.py nw_stats_rows,
         the nw_stats CUDA kernel -- no backpointer tensor), then
      3. replay each read's candidate stream on the host: the first
         candidate whose pair accepted wins the read (_judge_and_replay).
         Traceback chains are produced at render time by running the
         backpointer kernel (nw_forward) and the traceback on accepted
         pairs only.

This yields identical accepted pairs and, with the shared renderer, a
byte-identical report to the reference binary at n_threads=1.

Device work is queued asynchronously on the current CUDA stream; each
stage reads its results back with one ``.cpu()``, which is where the host
waits.  Reads up to the reference's MAX_READ_SIZE = 3000 bp run, padded
to the length buckets of Config.length_buckets (128 .. 3072); a longer
read aborts with the reference's ValueError once it reaches the gapped
aligner, as in the JAX engine.  Samples of any read count run, in the
JAX engine's formats: a database of < 2^20 reads keeps its index on the
device as one (sid << 12) | doff word per entry, a larger one as the wide
(pos, sid, db_start) triple; a query of < 2^20 reads ships its candidates
segment-encoded or as two words each (read id and k-mer offset sharing
one), a larger one in the wide three-word format (ops/candidates.py).

Row-coordinate bound reduction (used by the packed extension): the
reference clamps the extension walk with four checks -- array end, and the
per-read bounds rxs/rxe/rys/rye from _read_bounds_ext (last read's end
bound is total_len, src/alignmentFunctions.c:280-294).  Because reads are
concatenated contiguously, all four reduce in row coordinates to
``o <= read_len - 1 - offset`` (forward) and ``o <= offset - K - 1``
(backward) for *both* the last-read and interior cases, so the walk never
leaves the owning read and per-read packed rows are sufficient.

On a mesh (parallel/mesh.py) the tables replicate over the positions, the
index payload splits by row range over "dict", and the gate chunks and
NW batches split over "data" (NW batches over both axes): each stage
calls the sharded step of parallel/sharded.py in place of the
single-device op, with the same bits by construction.  A packed-format
gate with n_dict > 1 routes each candidate to the position that holds
its index row (_gate_chunks_routed).  The stages do not see the mesh:
they place data and launch steps through the engine's placement methods
(_put, the one upload of a host array, then _rep, _put_rows, _put_cols,
_nw_stats, _nw_render and _gate_launch), which alone ask for it.
"""

from __future__ import annotations

import dataclasses
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import native
from .config import Config
from .constants import FIXED_K, MAX_READ_SIZE
from .index.kmer import KmerIndex, build_index, rolling_keys
from .io.fasta import CODE_TO_CHAR, SeqInfo
from .io.reconstruct import backtrack_from_chain
from .io.report import format_record, render_alignment
from .ops.candidates import (
    encode_seg_chunk, flat_gate, flat_gate_packed, flat_gate_seg,
)
from .ops.enum_gate import build_enum_tables, enum_gate_chunk, enum_select_prefix
from .ops.extend import raw_score_threshold
from .ops import nw_cuda
from .ops.extend_packed import pack_stream, rows_from_stream
from .ops.resolve import nw_stats_rows, nw_traceback_rows
from .parallel import sharded
from .parallel.mesh import make_mesh, visible_devices
from .utils.timing import PhaseTimer

# Up to this extension window, gate stages above SMALL_TIER_MIN_CANDIDATES
# candidates run GATE_WINDOW_SMALL first (below it the escalation's extra
# device round trip cannot repay the narrower window) and stage 1 gates at
# the full window.  Past it every stage gates at the small window first
# and re-gates only the inexact escapees at the full window, as the JAX
# engine does for window > 256.
SHORT_WINDOW = 256
# The small window (bases): random candidates' walks die within a few
# mismatches, provably inside it (the gate flags exactness).
GATE_WINDOW_SMALL = 64
SMALL_TIER_MIN_CANDIDATES = 2_000_000
# Candidates x window of one gate chunk past SHORT_WINDOW: bounds the
# plain gate's [chunk, window] int32 temporaries (the CPU path's; the
# card's kernel has none) to this many elements each (87,360 candidates at
# the 3072 window; up to SHORT_WINDOW the chunks are Config.gate_chunks as
# they are).  The verdict bits do not depend on chunking.
GATE_MAX_ELEMENTS = 1 << 28
# Segment-encoded gate words hold the index row in 25 bits.
SEG_MAX_INDEX_ROWS = 1 << 25
# Packed formats hold a read id in 20 bits: a database of fewer reads
# keeps one word per index entry, a query of fewer reads shares one word
# between read id and k-mer offset; larger samples take the wide formats.
PACKED_MAX_READS = 1 << 20
# Device enumeration (Config.gate_enum) ranks a compare's candidates with
# int32 prefix sums (ops/enum_gate.py); a compare with this many
# candidates or more takes the host gate, as in the JAX engine.
ENUM_MAX_CANDIDATES = 1 << 31
# ... and so does a query of more padded rows (enum_padded_rows) than
# this, the JAX engine's gate_enum_max_rows: the [rows, row_len - 10]
# int32 slot tables then reach gigabytes at the 3072 window.
ENUM_MAX_ROWS = 1 << 17


def gate_chunk_sizes(chunks, window: int, gran: int = 32) -> list:
    """Gate chunk sizes at an extension window, largest first: the
    configured sizes, capped past SHORT_WINDOW at GATE_MAX_ELEMENTS //
    window candidates (a multiple of ``gran``: 32, times the mesh
    positions a chunk splits over)."""
    if window > SHORT_WINDOW:
        cap = max(gran, GATE_MAX_ELEMENTS // window // gran * gran)
        chunks = {min(z, cap) for z in chunks}
    return sorted(set(chunks), reverse=True)


def first_window_at(cfg: Config, load: float) -> int:
    """Candidates per read of gate stage 1 at an index's mean bucket load
    (n_entries / 4^K): Config.first_window, widened with the load
    (Config.first_window_auto; the cap bounds only the auto-widening -- an
    explicitly larger first_window is honored)."""
    F = cfg.first_window
    if cfg.first_window_auto and load:
        F = max(F, min(64, F * max(1, int(np.ceil(2.0 * load)))))
    return F


# The rung: k-mer slots of a read's second gate window.  One substitution
# kills at most K consecutive k-mers, so a copy with one substitution near
# its start has a clean seed among its first K + 1.
RUNG_KMERS = FIXED_K + 1


def rung_engages(first_window: int, load: float) -> bool:
    """Whether the gate's ladder takes the rung, a second window of ranks
    [F, W_r) (rung_window) before the whole tail of the reads stage 1
    leaves open: where stage 1's F candidates reach fewer than K + 1
    k-mers at the index's mean bucket load."""
    return first_window < RUNG_KMERS * load


def rung_window(stream, read_ids) -> np.ndarray:
    """W_r of each of ``read_ids``: the candidates of the read's first
    K + 1 k-mer slots (a rank, so at most its N_r).  ``stream`` is the
    tuple of TorchEngine._kmer_stream."""
    _, K_off, _, _, Ccum, C_off = stream
    end = np.minimum(K_off[read_ids] + RUNG_KMERS, K_off[read_ids + 1])
    return Ccum[end] - C_off[read_ids]


def enum_padded_rows(n: int) -> int:
    """The row count that ENUM_MAX_ROWS bounds: n query reads
    padded to a power of two of at least 256, as the JAX engine pads its
    query rows."""
    return max(256, 1 << (max(n, 1) - 1).bit_length())


def build_flat(stream, q_start, read_ids, from_rank, to_rank):
    """Flat (rids, hits, qoffs) int32 arrays for candidate ranks [from, to)
    per read, read-major, stream order.  ``stream`` is the tuple of
    TorchEngine._kmer_stream; hits are index rows, qoffs k-mer end offsets
    in read-row coordinates."""
    kp, K_off, lo, cnt, Ccum, C_off = stream
    N_r = C_off[1:] - C_off[:-1]
    out_size = int(
        np.maximum(0, np.minimum(to_rank, N_r[read_ids]) - from_rank).sum()
    )
    arrs = native.build_flat_arrays(
        read_ids, from_rank, to_rank, K_off, C_off,
        kp, lo, cnt, Ccum, q_start, FIXED_K, out_size,
    )
    if arrs is not None:
        return arrs
    # numpy fallback: the whole selection of the rank windows (read_ids
    # ascending, as every caller's flatnonzero gives them)
    frm = np.zeros(len(N_r), np.int64)
    to = np.zeros(len(N_r), np.int64)
    frm[read_ids] = from_rank
    to[read_ids] = to_rank
    return map_selected(stream, q_start, np.arange(out_size), frm, to)


def map_selected(stream, q_start, sel_idx, frm, to):
    """(rids, hits, qoffs) int32 of the candidates at positions ``sel_idx``
    of a stage's selection (ranks [frm[r], to[r]) of every read r, in
    stream order), from the host stream tables: the inverse of the device
    enumeration's addressing (ops/enum_gate.py enum_candidates)."""
    kp, K_off, lo, cnt, Ccum, C_off = stream
    N_r = C_off[1:] - C_off[:-1]
    lo_r = np.minimum(frm, N_r)
    sel_r = np.maximum(np.minimum(to, N_r) - lo_r, 0)
    selcum = np.zeros(len(N_r) + 1, np.int64)
    np.cumsum(sel_r, out=selcum[1:])
    r = np.searchsorted(selcum, sel_idx, side="right") - 1
    gc = C_off[r] + lo_r[r] + (sel_idx - selcum[r])
    slot = np.searchsorted(Ccum, gc, side="right") - 1
    hits = (lo[slot] + (gc - Ccum[slot])).astype(np.int32)
    qoffs = (kp[slot] + FIXED_K - q_start[r]).astype(np.int32)
    return r.astype(np.int32), hits, qoffs


@dataclasses.dataclass(slots=True)
class AcceptedRead:
    qread: int
    dbread: int
    length: int
    identities: int
    ylen: int
    # Traceback data: the accept path runs the stats-only aligner (no
    # backpointer tensor); the chain is produced by running the bp kernel
    # on accepted pairs only, at render time (render_report).
    n_steps: int = -1
    chain: Optional[np.ndarray] = None


@dataclasses.dataclass
class PipelineResult:
    accepted: int
    n_query: int
    n_db: int
    pairs: List[Tuple[int, int]]
    records: List[AcceptedRead]
    timings: Dict[str, float]
    nw_cells: int  # DP cells computed (for GCUPS accounting)
    n_candidates: int  # extension candidates evaluated

    @property
    def jaccard(self) -> float:
        return self.accepted / ((self.n_db + self.n_query) - self.accepted)


class _KeySet:
    """Sorted-array membership set for pair keys (read * n_db + sid).

    The judge path tests hundreds of thousands of candidate keys against
    the rejected-pair set per compare; a Python int set costs a per-key
    interpreter hop (~1 s at 100k-read scale), while a sorted array +
    searchsorted is one vectorized pass."""

    def __init__(self):
        self._arr = np.empty(0, np.int64)
        self._pend: List[np.ndarray] = []

    def add(self, keys: np.ndarray) -> None:
        if len(keys):
            self._pend.append(np.asarray(keys, np.int64))

    def _materialize(self) -> np.ndarray:
        if self._pend:
            self._arr = np.unique(
                np.concatenate([self._arr] + self._pend)
            )
            self._pend = []
        return self._arr

    def contains(self, keys: np.ndarray) -> np.ndarray:
        a = self._materialize()
        if not len(a) or not len(keys):
            return np.zeros(len(keys), bool)
        i = np.minimum(np.searchsorted(a, keys), len(a) - 1)
        return a[i] == keys


def _rq_words(rids: np.ndarray, qoffs: np.ndarray) -> np.ndarray:
    """(read id << 12) | offset, bit-cast to int32: the two-word
    candidate format's second word (query read, qoff) and the packed
    index word (db read, doff)."""
    return ((rids.astype(np.uint32) << np.uint32(12))
            | qoffs.astype(np.uint32)).view(np.int32)


def _unpack_gate_bits(words: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """[2, n/32] int32 gate words -> (passes, exact) bool[n]."""
    pb = np.ascontiguousarray(words, dtype="<i4")
    flat = np.unpackbits(
        pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
    )[:, :n].astype(bool)
    return flat[0], flat[1]


def _runs_kernels(devices) -> bool:
    """Whether an engine on these devices launches the CUDA kernels."""
    return any(torch.device(d).type == "cuda" for d in devices)


def _read_bounds(s: SeqInfo, reads: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, one-past-end) of each of ``reads`` in ``s.codes``."""
    nxt = np.minimum(reads + 1, s.n_seqs - 1)
    return s.start[reads], np.where(reads + 1 < s.n_seqs, s.start[nxt],
                                    s.total_len)


class TorchEngine:
    """Compare query samples against one database sample on one device,
    or on a mesh of devices (Config.mesh_shape; parallel/)."""

    def __init__(
        self,
        db: SeqInfo,
        cfg: Optional[Config] = None,
        index: Optional[KmerIndex] = None,
        *,
        device,
        mesh_devices=None,
    ):
        """``device``: the torch device ("cuda", "cuda:k" or "cpu").
        ``mesh_devices``: the devices a mesh spans in place of the visible
        ones (parallel/mesh.py make_mesh; repeats allowed, e.g. a grid on
        one card, or on the CPU)."""
        self.timer = PhaseTimer()
        self.timer.trace()
        with self.timer.phase("engine"):
            self.db = db
            self.cfg = cfg or Config()
            self.cfg.validate()
            self.device = torch.device(device)
            # The NW kernels exist for nw_cuda.LENGTHS only; the CPU's
            # plain versions take any multiple of 128, as the JAX engine
            # does.
            missing = sorted(
                set(self.cfg.length_buckets) - set(nw_cuda.LENGTHS))
            if missing and _runs_kernels(
                    [self.device, *(mesh_devices or ())]):
                raise ValueError(
                    f"length buckets {missing} have no CUDA kernel: an "
                    f"engine on a card takes buckets of nw_cuda.LENGTHS "
                    f"{nw_cuda.LENGTHS}")
            mesh = self._mesh = self._make_mesh(mesh_devices)
            if mesh is not None:
                self.device = mesh.lead
            # The positions a pair batch splits over, the data shards of
            # a gate chunk and the dict shards of the index payload: 1
            # each on one device.
            self._n_pos, self._n_data, self._n_dict = (
                (mesh.size, mesh.shape["data"], mesh.shape["dict"])
                if mesh else (1, 1, 1))
            self.db_read_lens = db.read_lens()
            max_dlen = int(self.db_read_lens.max()) if db.n_seqs else 0
            if db.n_seqs:
                # a db read past the largest length bucket aborts here
                # with the reference's error, as in the JAX engine
                self._nw_bucket(max_dlen)
            with self.timer.phase("index_build"):
                # A prebuilt index (load_index / index_from_arrays) skips
                # the build; the reference rebuilds its dictionary from
                # FASTA every run (src/IMSAME.c:196-289).  A build counts
                # its entries in index_built_entries.
                self.index: KmerIndex = index
                if index is None:
                    self.index = build_index(db)
                    self.timer.count("index_built_entries",
                                     self.index.n_entries)
            with self.timer.phase("engine.upload"):
                # One-word index payload (sid << 12 | doff): one gather per
                # candidate in the gate.  Past it, the wide (pos, sid,
                # db_start) triple, as in the JAX engine.
                self._packed_idx = (db.n_seqs < PACKED_MAX_READS
                                    and max_dlen < 4096)
                # On a mesh the payload splits by row range over "dict",
                # _shard_rows rows a shard; db_start replicates.
                self._shard_rows = -(-self.index.n_entries // self._n_dict)
                if not self._packed_idx:
                    self._d_idx_tab = self._put_rows(
                        np.asarray(self.index.pos, np.int32),
                        np.asarray(self.index.sid, np.int32),
                        rep=self._put(np.asarray(db.start, np.int32)))
                else:
                    if self.index.packed is not None:
                        words = self.index.packed.view(np.int32)
                    else:
                        sid = np.asarray(self.index.sid, np.int64)
                        pos = np.asarray(self.index.pos, np.int64)
                        words = _rq_words(sid, pos - db.start[sid])
                    self._d_idx_tab = self._put_rows(words)
                # Device enumeration (Config.gate_enum) needs the packed
                # index words and the bucket prefix table on the device
                # (4^12 + 1 words); a mesh takes the host gate, as in the
                # JAX engine.
                self._use_enum = (bool(self.cfg.gate_enum)
                                  and self._packed_idx
                                  and self._n_pos == 1)
                self._d_bs = (
                    self._put(np.asarray(self.index.bucket_start, np.int32))
                    if self._use_enum else None
                )
                self._d_dlen = self._rep(
                    self._put(np.asarray(self.db_read_lens, np.int32)))
            self._dp_cache: Dict[int, torch.Tensor] = {}
            self._nw_cells = 0
            self._n_cands = 0
            # Device handles of the last compare()'s query-side tables; the
            # render path runs the bp kernel on accepted pairs from these.
            self._last_dev: Optional[Tuple] = None
            self.stage_stats: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # Mesh plumbing: the data axis splits gate chunks and NW batches (the
    # reference's pthread split of query work), the dict axis the index
    # payload (its shared dictionary).
    def _make_mesh(self, mesh_devices):
        """The Mesh of Config.mesh_shape over ``mesh_devices`` (default:
        the visible devices of the engine's device type), or None for one
        device.  An explicit grid whose batch shapes do not divide over
        it raises ValueError; "auto" takes the widest data axis they
        divide over, as the JAX engine does."""
        ms = self.cfg.mesh_shape
        if ms is None:
            return None
        devices = (list(mesh_devices) if mesh_devices is not None
                   else visible_devices(self.device))
        cfg = self.cfg
        nw_batches = cfg.nw_stats_batches + cfg.nw_render_batches

        def divides(n: int) -> bool:
            # gate chunks need n * 32 candidates for the per-shard bit
            # packing; NW batches n * 8 pairs
            return not (any(c % (n * 32) for c in cfg.gate_chunks)
                        or any(b % (n * 8) for b in nw_batches))

        if ms == "auto":
            d = len(devices)
            while d > 1 and not divides(d):
                d //= 2
            return make_mesh(d, 1, devices, self._put) if d > 1 else None
        n_data, n_dict = ms
        if n_data * n_dict <= 1:
            return None
        if not divides(n_data * n_dict):
            raise ValueError(
                "gate_chunks / NW batch shapes must divide evenly over the "
                "mesh (n_data*n_dict*32 and n_data*n_dict*8 respectively; "
                "the dict-routed gate slices chunks over both axes)")
        return make_mesh(n_data, n_dict, devices, self._put)

    # ------------------------------------------------------------------
    # Placement: these methods alone know whether a mesh exists.  Each
    # returns what the device step takes: a tensor on one device, on a
    # mesh one a position.
    def _put(self, x: np.ndarray, device=None) -> torch.Tensor:
        """Upload a host array to ``device`` (default: the engine's lead
        device), counted in h2d_bytes.  The mesh's uploads come here
        too."""
        x = np.ascontiguousarray(x)
        self.timer.count("h2d_bytes", x.nbytes)
        return torch.as_tensor(
            x, device=self.device if device is None else device)

    def _rep(self, t: torch.Tensor):
        """A lead-device table replicated over the positions
        (mesh.put)."""
        return t if self._mesh is None else self._mesh.put(t)

    def _put_rows(self, *xs, rep=None):
        """The index payload: host arrays ``xs`` split by row range over
        "dict", _shard_rows rows a shard (mesh.put_rows, after zero rows
        that no candidate hits), then the lead-device tensor ``rep``
        replicated; a tuple where there are several (on a mesh, one tuple
        a position)."""
        if self._mesh is None:
            parts = [self._put(x) for x in xs]
        else:
            n = self._shard_rows * self._n_dict
            parts = [self._mesh.put_rows(np.pad(x, (0, n - len(x))))
                     for x in xs]
        if rep is not None:
            parts.append(self._rep(rep))
        if len(parts) == 1:
            return parts[0]
        return tuple(parts) if self._mesh is None else list(zip(*parts))

    def _put_cols(self, x: np.ndarray, flat: bool = False):
        """A candidate chunk or pair batch split by column over "data", or
        with ``flat`` over the flattened ("data", "dict") axis
        (mesh.put_cols)."""
        if self._mesh is None:
            return self._put(x)
        return self._mesh.put_cols(x, flat)

    def _nw_stats(self, dev, rs: np.ndarray, L: int) -> torch.Tensor:
        """Queue the stats-only aligner over the [2, B] pair batch ``rs``
        at length bucket L: [3, B] (length, identities, ylen)."""
        d_qp, d_dp, d_qlen, d_dlen = dev
        args = (d_qp, d_dp, self._put_cols(rs, flat=True), d_qlen, d_dlen,
                self.cfg.igap, self.cfg.egap)
        if self._mesh is None:
            return nw_stats_rows(*args, max_len=L)
        return sharded.nw_stats_step(self._mesh, *args, max_len=L)

    def _nw_render(self, dev, rpad: np.ndarray, spad: np.ndarray, L: int):
        """Queue the backpointer kernel and the traceback over the pairs
        (rpad, spad) at length bucket L: their ResolveNWResult."""
        d_qp, d_dp, d_qlen, d_dlen = dev
        gaps = (self.cfg.igap, self.cfg.egap)
        if self._mesh is None:
            return nw_traceback_rows(d_qp, d_dp, self._put(rpad),
                                     self._put(spad), d_qlen, d_dlen, *gaps,
                                     max_len=L)
        rs = self._put_cols(np.stack([rpad, spad]), flat=True)
        return sharded.nw_render_step(self._mesh, d_qp, d_dp, rs, d_qlen,
                                      d_dlen, *gaps, max_len=L)

    def _gate_launch(self, fmt: str, dev, d_cand, d_thr, window: int):
        """Queue the gate over one uploaded chunk (``d_cand``: its arrays
        in the order the step takes them) in candidate format ``fmt``
        (_gate_format): flat_gate_seg, flat_gate_packed or flat_gate on
        one device, the sharded step of the format on a mesh.  Returns
        the [2, n/32] pass/exact words."""
        if self._mesh is None:
            step = {"seg": flat_gate_seg, "two_words": flat_gate_packed,
                    "wide": flat_gate}[fmt]
            return step(*dev, self._d_idx_tab, *d_cand, d_thr,
                        window=window)
        step = {"two_words": sharded.gate_step,
                "wide": sharded.gate_step_wide,
                "routed": sharded.gate_step_routed}[fmt]
        return step(self._mesh, *dev, self._d_idx_tab, *d_cand, d_thr,
                    window=window, shard_rows=self._shard_rows)

    def _rows_on_device(
        self, codes: np.ndarray, start: np.ndarray, lens: np.ndarray,
        row_len: int,
    ) -> torch.Tensor:
        """Packed read rows built ON DEVICE from the 2-bit concatenated
        stream: the host-to-device payload is len/4 bytes per read instead
        of row_len/4."""
        return rows_from_stream(
            self._put(pack_stream(codes).view(np.int32)),
            self._put(np.asarray(start, np.int32)),
            self._put(np.asarray(lens, np.int32)),
            row_len=row_len,
        )

    def _packed_db_rows(self, row_len: int):
        if row_len not in self._dp_cache:
            self._dp_cache[row_len] = self._rep(self._rows_on_device(
                self.db.codes, self.db.start, self.db_read_lens, row_len
            ))
        return self._dp_cache[row_len]

    # ------------------------------------------------------------------
    def _stream_bounds(self, q: SeqInfo):
        """Per-read k-mer stream bounds (host, vectorized, cheap).

        Returns (qlo, qhi, n_kmers): concatenated-coordinate stream window
        per read, with the boundary-base quirk (SURVEY.md 6.5) and the
        n_threads split semantics (a thread's first read does not inherit
        the previous read's trailing base, reference worker init)."""
        n = q.n_seqs
        starts = q.start.astype(np.int64)
        total = q.total_len
        qlo = starts.copy()
        if n > 0:
            qlo[1:] = starts[1:] - 1
            n_threads = self.cfg.n_threads
            if n_threads > 1:
                rpt = n // n_threads
                tstarts = np.array(
                    [t * rpt for t in range(n_threads)], dtype=np.int64
                )
                tstarts = tstarts[tstarts < n]
                qlo[tstarts] = starts[tstarts]
        qhi = np.empty(n, np.int64)
        if n > 1:
            qhi[:-1] = starts[1:] - 2
        if n > 0:
            qhi[-1] = total - 1
        n_kmers = np.maximum(0, qhi - FIXED_K + 1 - qlo + 1)  # [n]
        return qlo, qhi, n_kmers

    def _kmer_stream(self, q: SeqInfo):
        """Per-read candidate stream tables (host, vectorized).

        Returns (kp, K_off, lo, cnt, Ccum, C_off):
          kp[i]    k-mer start position of global k-mer slot i (stream order)
          K_off[r] first k-mer slot of read r (K_off[n] = total slots)
          lo[i]    index bucket start for slot i
          cnt[i]   bucket size for slot i
          Ccum[i]  exclusive cumsum of cnt (global candidate offsets)
          C_off[r] first global candidate rank boundary per read
        """
        n = q.n_seqs
        qlo, qhi, n_kmers = self._stream_bounds(q)
        K_off = np.zeros(n + 1, np.int64)
        K_off[1:] = n_kmers.cumsum()
        total_kmers = int(K_off[-1])

        # Native fused pass: rolling key + bucket lookup + prefix sum in one
        # linear scan (native/host.c imsame_kmer_stream).
        arrs = native.kmer_stream_arrays(
            q.codes, qlo, n_kmers, FIXED_K, self.index.bucket_start
        )
        if arrs is not None:
            kp, lo, cnt, Ccum = arrs
            C_off = Ccum[K_off]
            return kp, K_off, lo, cnt, Ccum, C_off

        # numpy fallback: k-mer start positions via vectorized repeat.
        kp = (
            np.repeat(qlo, n_kmers)
            + np.arange(total_kmers, dtype=np.int64)
            - np.repeat(K_off[:-1], n_kmers)
        )

        # keys + bucket ranges in one vectorized pass
        all_keys = rolling_keys(q.codes)  # key at every concat position
        keys = all_keys[kp] if total_kmers else np.empty(0, np.uint32)
        lo, hi = self.index.lookup_ranges(keys)
        cnt = (hi - lo).astype(np.int64)
        Ccum = np.zeros(total_kmers + 1, np.int64)
        np.cumsum(cnt, out=Ccum[1:])
        C_off = Ccum[K_off]
        return kp, K_off, lo, cnt, Ccum, C_off

    # ------------------------------------------------------------------
    def _nw_bucket(self, L: int):
        for b in self.cfg.length_buckets:
            if L <= b:
                return b
        raise ValueError("Read size reached for gapped alignment.")

    def _render_sizes(self, L: int) -> tuple:
        """Render ladder for length bucket L: the configured ladder capped
        so one chunk's bp tensor (8*L^2 bytes/pair) fits the budget per
        device (the pair batch shards over every mesh position), in
        multiples of 8 pairs a position."""
        gran = 8 * self._n_pos
        cap = int(self.cfg.nw_render_bp_budget * self._n_pos // (8 * L * L))
        cap = max(gran, (cap // gran) * gran)
        sizes = tuple(b for b in self.cfg.nw_render_batches if b <= cap)
        if not sizes:
            sizes = (cap,) if cap == gran else (cap, gran)
        return sizes

    def _nw_chunks(
        self, r_ids: np.ndarray, sids: np.ndarray, qlens: np.ndarray,
        sizes: tuple = None,
        render: bool = False,
        count_cells: bool = True,
    ):
        """Split pairs into padded chunks bucketed by length.

        Yields (chunk_indices, rpad, spad, L).  ``sizes`` is the descending
        ladder of batch sizes; chunks pad up to the smallest ladder size
        that covers the remainder, with (0, 0) pairs whose results are
        dropped.  With ``render=True`` the ladder is re-derived per length
        bucket (see _render_sizes).  With ``count_cells`` the real pairs'
        cells add to nw_cells and every chunk's B * L * L, padding
        included, to the counter nw_launched_cells; the pairs and chunks
        of buckets past nw_cuda.STRIP (the kernels' long paths) add the
        same to nw_long_cells and nw_long_launched_cells.  Render chunks
        add their B * L * L to render_launched_cells."""
        xls = self.db_read_lens[sids]
        yls = qlens[r_ids]
        maxl = np.maximum(xls, yls)
        lb = np.asarray(self.cfg.length_buckets, np.int64)
        b = np.searchsorted(lb, maxl)
        # past MAX_READ_SIZE or the largest bucket
        if len(b) and (maxl.max() > MAX_READ_SIZE or b.max() == len(lb)):
            raise ValueError("Read size reached for gapped alignment.")
        buckets = lb[b]
        if count_cells:  # render runs aren't compare GCUPS
            cells = xls.astype(np.int64) * yls
            self._nw_cells += int(cells.sum())
            long = buckets > nw_cuda.STRIP
            if long.any():
                self.timer.count("nw_long_cells", int(cells[long].sum()))
        for L in np.unique(buckets):
            idxs = np.flatnonzero(buckets == L)
            lsizes = self._render_sizes(int(L)) if render else sizes
            pos = 0
            while pos < len(idxs):
                rem = len(idxs) - pos
                B = lsizes[0]
                for z in lsizes[1:]:
                    if z >= rem:
                        B = z
                chunk = idxs[pos : pos + min(rem, B)]
                pos += len(chunk)
                rpad = np.zeros(B, np.int32)
                spad = np.zeros(B, np.int32)
                rpad[: len(chunk)] = r_ids[chunk]
                spad[: len(chunk)] = sids[chunk]
                launched = B * int(L) ** 2
                if render:
                    self.timer.count("render_launched_cells", launched)
                if count_cells:
                    self.timer.count("nw_launched_cells", launched)
                    if L > nw_cuda.STRIP:
                        self.timer.count("nw_long_launched_cells", launched)
                yield chunk, rpad, spad, int(L)

    def _nw_dispatch_pairs(self, r_ids, sids, qlens, dev):
        """Queue the stats-only aligner over pairs (no backpointer tensor)
        without waiting for it, so the caller can overlap further host and
        gate work before _nw_fetch_pairs reads the results back."""
        pending = []
        # sub-span of resolve.nw: host chunking + queueing
        with self.timer.phase("nw.dispatch"):
            for chunk, rpad, spad, L in self._nw_chunks(
                r_ids, sids, qlens, self.cfg.nw_stats_batches
            ):
                res = self._nw_stats(dev, np.stack([rpad, spad]), L)
                pending.append((chunk, res))
        return len(r_ids), pending

    def _nw_fetch_pairs(self, P: int, pending, label: str = "nw.fetch") -> np.ndarray:
        """Read the queued stats back with one ``.cpu()``.  Returns a
        [P, 3] int64 array of (length, identities, ylen) per pair -- the
        accept-gate inputs."""
        out = np.empty((P, 3), np.int64)
        if not pending:
            return out
        with self.timer.phase(label):
            flat = torch.cat([res for _, res in pending], dim=1).cpu().numpy()
        with self.timer.phase("nw.scatter"):
            col = 0
            for chunk, res in pending:
                B = res.shape[1]
                out[chunk] = flat[:, col : col + len(chunk)].T
                col += B
        return out

    # ------------------------------------------------------------------
    def _gate_spans(self, N: int, window: int):
        """The gate's chunks over N candidates at an extension window:
        (first candidate, candidates, padded chunk size) each.  A chunk
        pads to 32 candidates a data shard: bits pack 32 per word per
        shard."""
        gran = 32 * self._n_data
        sizes = gate_chunk_sizes(self.cfg.gate_chunks, window, gran)
        pos = 0
        while pos < N:
            rem = N - pos
            # The smallest size whose repetition count doesn't exceed a
            # single larger chunk's slots.
            size = sizes[0]
            for z in sizes[1:]:
                if -(-rem // z) * z <= size:
                    size = z
            take = min(rem, size)
            yield pos, take, -(-take // gran) * gran
            pos += take

    def _gate_format(self, n_q: int) -> str:
        """The candidate format of a compare of n_q query reads, by the
        JAX engine's rules (every format gives the same bits): "wide",
        three words (flat_gate), past 2^20 reads; "routed", two words
        sent to the position that holds their index row, with n_dict > 1;
        "seg", 4 B a candidate + 8 B a segment (flat_gate_seg), on one
        device with a packed index of rows that fit 25 bits; else
        "two_words", read id and qoff sharing one (flat_gate_packed)."""
        if n_q >= PACKED_MAX_READS:
            return "wide"
        if self._n_dict > 1:
            return "routed"
        if (self._n_pos == 1 and self._packed_idx
                and self.index.n_entries <= SEG_MAX_INDEX_ROWS):
            return "seg"
        return "two_words"

    def _gate_encode(self, fmt, rids, hits, qoffs, n_pad: int) -> tuple:
        """One chunk's candidate arrays in format ``fmt``, n_pad slots:
        the seg words and their segments' row tables, the two words, or
        the three words (hit, read id, qoff) and on a mesh a fourth row,
        valid, with which the step masks the padding."""
        if fmt == "seg":
            # segments <= candidates, so n_pad slots never overflow
            nat = native.seg_encode(rids, qoffs, hits, n_pad, n_pad)
            if nat is None:
                return encode_seg_chunk(rids, qoffs, hits, n_pad)
            cand, rt, rb, nseg = nat
            return cand, rt[:nseg], rb[:nseg]
        take = len(hits)
        if fmt == "two_words":
            cand = np.zeros((2, n_pad), np.int32)
            cand[1, :take] = _rq_words(rids, qoffs)
        else:
            cand = np.zeros((3 if self._n_pos == 1 else 4, n_pad), np.int32)
            cand[1, :take] = rids
            cand[2, :take] = qoffs
            if len(cand) == 4:
                cand[3, :take] = 1
        cand[0, :take] = hits
        return (cand,)

    def _gate_chunks_dispatch(self, fmt, rids, hits, qoffs, d_thr, dev,
                              window):
        """Queue the gate over candidate chunks and return the pending
        list WITHOUT waiting, so callers overlap the gate's device time
        with other work -- _gate_chunks_fetch collects the bits later.

        ``fmt`` is the compare's candidate format (_gate_format); ``rids``
        are query read ids, ``hits`` index rows, ``qoffs`` k-mer end
        offsets (int32 each).  Each pending entry is (where its bits go in
        the stage's arrays, which of its bits, the [2, n/32] words)."""
        if fmt == "routed":
            return self._gate_chunks_routed(rids, hits, qoffs, d_thr, dev,
                                            window)
        pending = []
        # gate.dispatch / gate.fetch are sub-spans of resolve.extend;
        # gate.encode, gate.upload and gate.launch are sub-spans of
        # gate.dispatch: the chunk's host encoding, its uploads (pageable
        # copies, which may wait for the stream's earlier work) and the
        # gate's launch.  The counter gate_cand_bytes sums the bytes of
        # the candidate arrays each chunk uploads, in every format.
        timer = self.timer
        with timer.phase("gate.dispatch"):
            for pos, take, n_pad in self._gate_spans(len(hits), window):
                sl = slice(pos, pos + take)
                with timer.phase("gate.encode"):
                    cand = self._gate_encode(fmt, rids[sl], hits[sl],
                                             qoffs[sl], n_pad)
                with timer.phase("gate.upload"):
                    timer.count("gate_cand_bytes",
                                sum(a.nbytes for a in cand))
                    d_cand = [self._put_cols(a) for a in cand]
                with timer.phase("gate.launch"):
                    bits = self._gate_launch(fmt, dev, d_cand, d_thr, window)
                pending.append((sl, slice(0, take), bits))
        return pending

    def _gate_chunks_routed(self, rids, hits, qoffs, d_thr, dev, window):
        """Dict-routed gate planner (a mesh with n_dict > 1, packed query
        format): candidates are grouped by the index shard that owns
        their hit row (hit // shard_rows) and laid out so that flat
        segment p = d * n_dict + k of a chunk holds only shard k's, so
        every position gates only candidates it owns (parallel/sharded.py
        gate_step_routed).  Queues the chunks and returns pending entries
        whose bits the fetch un-permutes.  A chunk holds as many slots for
        every shard, so skew over the shards costs padding, not
        correctness."""
        n_dict = self._n_dict
        rows = self._shard_rows
        timer = self.timer
        # shard slots a chunk: the largest chunk's share, or the remainder
        # padded to 32 candidates a position (bits pack 32 per word per
        # shard)
        gran = 32 * self._n_data
        s_max = gate_chunk_sizes(self.cfg.gate_chunks, window,
                                 32 * self._n_pos)[0] // n_dict
        qpos = np.zeros(n_dict, np.int64)
        pending = []
        with timer.phase("gate.dispatch"):
            with timer.phase("gate.encode"):
                shard = hits // np.int32(rows)
                order = np.argsort(shard, kind="stable")
                counts = np.bincount(shard, minlength=n_dict).astype(np.int64)
                shard_off = np.zeros(n_dict + 1, np.int64)
                np.cumsum(counts, out=shard_off[1:])
                rq = _rq_words(rids, qoffs)
            while (counts - qpos).max(initial=0) > 0:
                with timer.phase("gate.encode"):
                    rem = counts - qpos
                    S = min(s_max, -(-int(rem.max()) // gran) * gran)
                    C = S * n_dict
                    seg = S // self._n_data  # slots per position
                    cand = np.zeros((2, C), np.int32)
                    perm = np.full(C, -1, np.int64)
                    for k in range(n_dict):
                        take = int(min(S, rem[k]))
                        if take == 0:
                            continue
                        a = shard_off[k] + qpos[k]
                        idxs = order[a : a + take]
                        j = np.arange(take, dtype=np.int64)
                        posn = (j // seg * n_dict + k) * seg + (j % seg)
                        cand[0, posn] = hits[idxs]
                        cand[1, posn] = rq[idxs]
                        perm[posn] = idxs
                        qpos[k] += take
                    # padding rows stay inside the owning shard's row range
                    # (local row 0 after the step's rebase)
                    pad = np.flatnonzero(perm < 0)
                    cand[0, pad] = ((pad // seg % n_dict).astype(np.int32)
                                    * rows)
                    valid = perm >= 0
                with timer.phase("gate.upload"):
                    timer.count("gate_cand_bytes", cand.nbytes)
                    d_cand = self._put_cols(cand, flat=True)
                with timer.phase("gate.launch"):
                    bits = self._gate_launch("routed", dev, [d_cand], d_thr,
                                             window)
                pending.append((perm[valid], valid, bits))
        return pending

    def _enum_prepare(self, q: SeqInfo, dev):
        """Queue the device enumeration's slot tables of a compare (they
        need only the packed rows and per-read scalars, so they build
        while the host scans k-mers).  Returns (lo, cnt, Rcum, d_hasb)."""
        d_qp, _, d_qlen, _ = dev
        qlo, _, n_kmers = self._stream_bounds(q)
        d_hasb = self._put((qlo != q.start).astype(np.int32))
        nk = np.minimum(n_kmers, np.iinfo(np.int32).max).astype(np.int32)
        lo, cnt, Rcum, _ = build_enum_tables(
            d_qp, self._d_bs, d_hasb, self._put(nk), d_qlen,
            row_len=d_qp.shape[1] * 16,
        )
        return lo, cnt, Rcum, d_hasb

    def _enum_gate_dispatch(self, enum, frm, to, N, d_thr, dev, window):
        """The device-enumerated twin of _gate_chunks_dispatch: queues the
        gate over the N candidates of ranks [frm[r], to[r]) of every read
        r (int64 [n] host arrays) without waiting, in the same chunks and
        the same pending format.  Only the rank windows cross the link."""
        if not N:
            return []
        lo_g, cnt_g, Rcum, d_hasb = enum
        d_qp, d_dp, d_qlen, d_dlen = dev
        with self.timer.phase("gate.enum"):
            scum, start_off = enum_select_prefix(
                cnt_g, Rcum, self._put(frm.astype(np.int32)),
                self._put(to.astype(np.int32)),
            )
        pending = []
        with self.timer.phase("gate.dispatch"):
            for pos, take, n_pad in self._gate_spans(N, window):
                # no host encoding or upload: the chunk's addressing and
                # the gate are its launches
                with self.timer.phase("gate.launch"):
                    bits = enum_gate_chunk(
                        d_qp, d_dp, d_qlen, d_dlen, self._d_idx_tab, d_thr,
                        lo_g, scum, start_off, d_hasb, pos, chunk=n_pad,
                        window=window, row_len=d_qp.shape[1] * 16,
                    )
                pending.append((slice(pos, pos + take), slice(0, take),
                                bits))
        return pending

    def _gate_chunks_fetch(self, pending, N):
        """Wait for the queued chunks (one ``.cpu()``) and unpack the
        verdict bits: entry (dest, sel, words) puts the bits ``sel`` of
        its words at positions ``dest`` of the stage."""
        passes = np.zeros(N, bool)
        exact = np.zeros(N, bool)
        if not pending:
            return passes, exact
        with self.timer.phase("gate.fetch"):
            flat = torch.cat([bits for _, _, bits in pending],
                             dim=1).cpu().numpy()
        col = 0
        for dest, sel, bits in pending:
            nw = bits.shape[1]
            p, e = _unpack_gate_bits(flat[:, col : col + nw], 32 * nw)
            passes[dest] = p[sel]
            exact[dest] = e[sel]
            col += nw
        return passes, exact

    # ------------------------------------------------------------------
    def _dedup_pairs(self, pass_r, pass_sid, rejected_keys, extra=None):
        """Unique (read, db read) pairs in stream order of first
        occurrence -- excluding already-rejected pairs and the optional
        ``extra`` key array (pairs another in-flight wave already covers)
        -- plus the per-candidate pair-key array."""
        n_db = max(self.db.n_seqs, 1)
        key = pass_r.astype(np.int64) * n_db + pass_sid
        _, first_idx = np.unique(key, return_index=True)
        first_idx.sort()
        ck = key[first_idx]
        if len(ck):
            stale = rejected_keys.contains(ck)
            if extra is not None and len(extra):
                stale |= np.isin(ck, extra)
            fresh = ~stale
            first_idx, ck = first_idx[fresh], ck[fresh]
        return (
            pass_r[first_idx].astype(np.int64),
            pass_sid[first_idx].astype(np.int64),
            ck,
            key,
        )

    def _judge_and_replay(
        self, results, ck, pass_r, pass_sid, key,
        rejected_keys, resolved, accepted_records, cfg,
    ) -> None:
        """Apply the coverage/identity accept gates (reference
        src/alignmentFunctions.c:163) to per-pair NW stats, then replay the
        candidate stream: the first candidate whose pair accepts wins its
        read (NWaligned semantics, src/alignmentFunctions.c:172,189-190;
        the verdict depends only on the two full reads, so all verdicts
        can be computed up front and the sequential walk replayed for
        free)."""
        stats = np.asarray(results, np.int64).reshape(-1, 3)  # [K, 3]
        length, idents, ylen = stats[:, 0], stats[:, 1], stats[:, 2]
        ok = (length >= cfg.min_coverage * ylen) & (
            idents >= cfg.min_identity * length
        )
        rejected_keys.add(ck[~ok])
        acc_rows = np.flatnonzero(ok)
        if not len(acc_rows):
            return
        order = acc_rows[np.argsort(ck[acc_rows], kind="stable")]
        acc_sorted = ck[order]
        # First candidate (stream order) whose pair accepted wins its read.
        # Invariant: each read's candidates appear in stream order within
        # the flat arrays (reads from different gate segments may
        # interleave in id space, so pass_r is NOT globally monotonic);
        # np.unique(return_index) picks the first array occurrence per
        # read, which is that read's earliest surviving candidate.
        p = np.searchsorted(acc_sorted, key)
        pc = np.minimum(p, len(acc_sorted) - 1)
        hit = acc_sorted[pc] == key
        live = np.flatnonzero(hit & ~resolved[pass_r])
        if len(live):
            _, first = np.unique(pass_r[live], return_index=True)
            win = live[first]
            krow = order[pc[win]]  # stats row of the winning pair
            resolved[pass_r[win]] = True
            for i, k in zip(win, krow):
                accepted_records.append(
                    AcceptedRead(
                        int(pass_r[i]), int(pass_sid[i]),
                        int(length[k]), int(idents[k]), int(ylen[k]),
                    )
                )

    # ------------------------------------------------------------------
    def load(self) -> float:
        """The index's mean bucket load, n_entries / 4^K."""
        return self.index.n_entries / float(4 ** FIXED_K)

    def first_window(self) -> int:
        """Candidates per read of gate stage 1 (first_window_at)."""
        return first_window_at(self.cfg, self.load())

    def compare(self, q: SeqInfo) -> PipelineResult:
        """The reads of ``q`` against the db: accepted pairs and counters.
        ``timings`` holds the engine's phase sums up to the compare's end
        (they add up over an engine's compares)."""
        self.timer.trace()
        with self.timer.phase("compare"):
            res = self._compare(q)
        res.timings = dict(self.timer.items())
        return res

    def _compare(self, q: SeqInfo) -> PipelineResult:
        cfg = self.cfg
        db = self.db
        idx = self.index
        self._nw_cells = 0
        self._n_cands = 0

        n = q.n_seqs
        qlens = q.read_lens() if n else np.empty(0, np.int64)
        thr = raw_score_threshold(qlens, db.total_len, cfg.min_e_value)

        # shared packed-row length: one bucket covering both samples
        max_rl = 1
        if n:
            max_rl = max(max_rl, int(qlens.max()))
        if db.n_seqs:
            max_rl = max(max_rl, int(self.db_read_lens.max()))
        window = self._nw_bucket(max_rl)

        # Queue the uploads and the on-device row build FIRST; they run
        # while the host scans k-mers below.
        dev = None
        d_thr = None
        if n and db.n_seqs:
            with self.timer.phase("upload"):
                dev = (
                    self._rep(self._rows_on_device(
                        q.codes, q.start, qlens, window)),
                    self._packed_db_rows(window),
                    self._rep(self._put(np.asarray(qlens, np.int32))),
                    self._d_dlen,
                )
                d_thr = self._rep(self._put(thr))
                self._last_dev = dev

        # Device enumeration: queue the slot tables before the host k-mer
        # scan, so the two overlap.  The host keeps its stream tables in
        # either case: they map the passing bits back to (read, db read).
        enum = None
        if (self._use_enum and dev is not None
                and enum_padded_rows(n) <= ENUM_MAX_ROWS):
            with self.timer.phase("gate.enum"):
                enum = self._enum_prepare(q, dev)

        with self.timer.phase("kmer_stream"):
            stream = self._kmer_stream(q)
        C_off, Ccum = stream[5], stream[4]
        N_r = (C_off[1:] - C_off[:-1]) if n else np.empty(0, np.int64)
        if enum is not None and int(Ccum[-1]) >= ENUM_MAX_CANDIDATES:
            enum = None

        resolved = np.zeros(n, bool)
        rejected_keys = _KeySet()
        accepted_records: List[AcceptedRead] = []
        # Per-stage counters: candidate counts, gate-pass counts and NW
        # pair counts per stage.
        ss = self.stage_stats = {}

        if idx.n_entries and n and Ccum[-1]:
            q_start = q.start.astype(np.int64)
            fmt = self._gate_format(n)

            def sids_of(hits):
                if idx.packed is not None:
                    return (idx.packed[hits] >> np.uint32(12)).astype(np.int64)
                return np.asarray(idx.sid[hits], np.int64)

            def gate_begin(read_ids, from_rank, to_rank, allow_small=True):
                """Queue a gate for a rank window WITHOUT waiting; returns
                its candidate count and a closure that fetches and maps
                the passes later, so the gate's device time hides behind
                the NW wave and the wave-1 judging.  Large stages, and every stage past
                SHORT_WINDOW, run the SMALL extension window first (random
                reads' walks provably die inside it); the escapees
                re-gate at the full window inside finish().  With device
                enumeration the candidates are built on the device from
                the rank windows, and the host maps back only the
                escapees and the passes (map_selected)."""
                if enum is not None:
                    frm = np.zeros(n, np.int64)
                    to = np.zeros(n, np.int64)
                    frm[read_ids] = from_rank
                    to[read_ids] = to_rank
                    N = int(np.maximum(
                        np.minimum(to, N_r) - np.minimum(frm, N_r), 0).sum())
                else:
                    with self.timer.phase("gate.build"):
                        rids, hits, qoffs = build_flat(
                            stream, q_start, read_ids, from_rank, to_rank
                        )
                    N = len(hits)
                    self.timer.count("gate_built_cands", N)
                self._n_cands += N
                use_small = GATE_WINDOW_SMALL < window and (
                    window > SHORT_WINDOW
                    or (allow_small and N > SMALL_TIER_MIN_CANDIDATES)
                )
                w1 = GATE_WINDOW_SMALL if use_small else window
                with self.timer.phase("resolve.extend"):
                    if enum is not None:
                        pending = self._enum_gate_dispatch(
                            enum, frm, to, N, d_thr, dev, w1
                        )
                    else:
                        pending = self._gate_chunks_dispatch(
                            fmt, rids, hits, qoffs, d_thr, dev, w1
                        )

                def triples(sel):
                    """(rids, hits, qoffs) of the stage's candidates at
                    positions sel."""
                    if enum is not None:
                        return map_selected(stream, q_start, sel, frm, to)
                    return rids[sel], hits[sel], qoffs[sel]

                def finish():
                    with self.timer.phase("resolve.extend"):
                        passes, exact = self._gate_chunks_fetch(pending, N)
                        if use_small:
                            esc = np.flatnonzero(~exact)
                            if len(esc):
                                p2, _ = self._gate_chunks_fetch(
                                    self._gate_chunks_dispatch(
                                        fmt, *triples(esc), d_thr, dev,
                                        window), len(esc))
                                passes[esc] = p2
                    pr, ph, _ = triples(np.flatnonzero(passes))
                    return pr, sids_of(ph)

                return N, finish

            with self.timer.phase("resolve"):
                # Stage 1: first few candidates of every read (most reads
                # accept their first candidate, mirroring the reference's
                # early exit).  Its NW wave is queued but not fetched, and
                # the stage-2 gate for reads with no passing stage-1
                # candidate -- which wave 1 cannot possibly resolve --
                # queues behind that wave; only then is wave 1 fetched.
                # The rare reads whose stage-1 pairs all got rejected gate
                # their remainder afterwards (stage 3), and one final NW
                # wave resolves everything stages 2 and 3 surfaced.  Each
                # stage builds the candidates of only the reads it gates,
                # when it is queued: stage 2's build runs while the device
                # works on wave 1.  With device enumeration nothing is
                # built: stages 2 and 3 enumerate their rank windows on the
                # device.  Up to SHORT_WINDOW stage 1 keeps the full
                # extension window (allow_small=False): half its candidates
                # are true-pair seeds whose walks escape the small tier
                # anyway.
                F = self.first_window()
                all_reads = np.flatnonzero(N_r > 0)
                n1, fin1 = gate_begin(
                    all_reads,
                    np.zeros(len(all_reads), np.int64),
                    np.minimum(N_r[all_reads], F),
                    allow_small=False,
                )

                pr1, ps1 = fin1()
                with self.timer.phase("resolve.judge"):
                    cr1, cs1, ck1, key1 = self._dedup_pairs(
                        pr1, ps1, rejected_keys
                    )
                ss["s1"] = (n1, len(pr1), len(cr1))
                with self.timer.phase("resolve.nw"):
                    P1, pend1 = self._nw_dispatch_pairs(cr1, cs1, qlens, dev)

                has_pass = np.zeros(n, bool)
                if len(pr1):
                    has_pass[pr1] = True
                spec = np.flatnonzero(~has_pass & (N_r > F))
                # Stage 2 gates the tails [tail0, N_r) of the reads in
                # spec.  Where rung_engages, a read whose first K + 1
                # k-mers hold more than F candidates first gates the rung,
                # ranks [F, W_r), queued in stage 2's place; only the
                # reads it leaves open gate their tails from W_r.  A rung
                # read has no stage-1 pass, so its first accept in the
                # rung is its first in stream order.
                tail0 = np.full(n, F, np.int64)
                if len(spec) and rung_engages(F, self.load()):
                    tail0[spec] = np.maximum(F, rung_window(stream, spec))
                rung = spec[tail0[spec] > F]
                fin2 = finw = None
                n2 = 0
                if len(rung):
                    n_w, finw = gate_begin(
                        rung, np.full(len(rung), F, np.int64), tail0[rung]
                    )
                elif len(spec):
                    # Stage 2 queued behind wave 1 and fetched only after
                    # judging: its compute overlaps the host judging.
                    n2, fin2 = gate_begin(spec, tail0[spec], N_r[spec])

                with self.timer.phase("resolve.nw"):
                    results1 = self._nw_fetch_pairs(P1, pend1, "nw.fetch1")
                with self.timer.phase("resolve.judge"):
                    self._judge_and_replay(
                        results1, ck1, pr1, ps1, key1,
                        rejected_keys, resolved, accepted_records, cfg,
                    )

                leftover = np.flatnonzero(~resolved & (N_r > F) & has_pass)
                fin3 = None
                n3 = 0
                if len(leftover):
                    # queue the leftover gate BEFORE fetching stage 2: it
                    # computes while the host waits on stage 2.
                    n3, fin3 = gate_begin(
                        leftover, np.full(len(leftover), F, np.int64),
                        N_r[leftover],
                    )
                if finw is not None:
                    # The rung's passes are deduped, NW'd and judged like
                    # stage 1's; the spec reads it leaves unresolved (no
                    # rung pass, or every rung pair rejected) then gate
                    # their tails in stage 2's place.
                    prw, psw = finw()
                    with self.timer.phase("resolve.judge"):
                        crw, csw, ckw, keyw = self._dedup_pairs(
                            prw, psw, rejected_keys
                        )
                    ss["s2w"] = (n_w, len(prw), len(crw))
                    with self.timer.phase("resolve.nw"):
                        Pw, pendw = self._nw_dispatch_pairs(
                            crw, csw, qlens, dev)
                        results_w = self._nw_fetch_pairs(Pw, pendw,
                                                         "nw.fetch2")
                    with self.timer.phase("resolve.judge"):
                        self._judge_and_replay(
                            results_w, ckw, prw, psw, keyw,
                            rejected_keys, resolved, accepted_records, cfg,
                        )
                    self.timer.count("gate_rung_reads", len(rung))
                    self.timer.count("gate_rung_resolved",
                                     resolved[rung].sum())
                    tail = spec[~resolved[spec] & (tail0[spec] < N_r[spec])]
                    if len(tail):
                        n2, fin2 = gate_begin(tail, tail0[tail], N_r[tail])
                pr2 = np.empty(0, np.int32)
                ps2 = np.empty(0, np.int64)
                if fin2 is not None:
                    pr2, ps2 = fin2()
                # Speculative wave A: NW the stage-2 passes' unique pairs
                # NOW, before the leftover gate's fetch.  The leftover
                # reads are disjoint from spec, so their pairs join as
                # wave B and one combined judge replays both stream
                # segments.
                with self.timer.phase("resolve.judge"):
                    cr2, cs2, ck2, key2 = self._dedup_pairs(
                        pr2, ps2, rejected_keys
                    )
                ss["s2"] = (n2, len(pr2), len(cr2))
                with self.timer.phase("resolve.nw"):
                    P2, pend2 = self._nw_dispatch_pairs(cr2, cs2, qlens, dev)
                pr3 = np.empty(0, np.int32)
                ps3 = np.empty(0, np.int64)
                if fin3 is not None:
                    pr3, ps3 = fin3()
                with self.timer.phase("resolve.judge"):
                    cr3, cs3, ck3, key3 = self._dedup_pairs(
                        pr3, ps3, rejected_keys, extra=ck2
                    )
                ss["s3"] = (n3, len(pr3), len(cr3))
                with self.timer.phase("resolve.nw"):
                    P3, pend3 = self._nw_dispatch_pairs(cr3, cs3, qlens, dev)
                    results2 = self._nw_fetch_pairs(P2, pend2, "nw.fetch2")
                    results3 = self._nw_fetch_pairs(P3, pend3, "nw.fetch3")
                if len(pr2) or len(pr3):
                    with self.timer.phase("resolve.judge"):
                        self._judge_and_replay(
                            np.concatenate([results2, results3]),
                            np.concatenate([ck2, ck3]),
                            np.concatenate([pr2, pr3]),
                            np.concatenate([ps2, ps3]),
                            np.concatenate([key2, key3]),
                            rejected_keys, resolved, accepted_records, cfg,
                        )

        accepted_records.sort(key=lambda a: a.qread)
        return PipelineResult(
            accepted=len(accepted_records),
            n_query=n,
            n_db=db.n_seqs,
            pairs=[(a.qread, a.dbread) for a in accepted_records],
            records=accepted_records,
            timings={},
            nw_cells=self._nw_cells,
            n_candidates=self._n_cands,
        )

    # ------------------------------------------------------------------
    # Chain entries fetched with each render chunk's stats: chains are
    # diagonal-run compressed, so max(n_steps) + 1 is typically tens of
    # entries while the tensor is 2L wide.  A chunk whose chains exceed
    # the prefix re-fetches a wider power-of-two slice at collect time.
    _CHAIN_PREFIX = 64

    def _render_dispatch_chains(self, todo: List[AcceptedRead], dev):
        """Queue the render NW (backpointer kernel + traceback) over the
        ``todo`` records without reading anything back: per chunk, its
        pair indices, a [B, 3 + _CHAIN_PREFIX] int32 tensor of (length,
        identities, n_steps, chain prefix) and the whole [B, 2L] chain.
        _render_collect_chains reads them.  ``dev`` is a compare's
        (d_qp, d_dp, d_qlen, d_dlen)."""
        r_ids = np.array([rec.qread for rec in todo], np.int64)
        sids = np.array([rec.dbread for rec in todo], np.int64)
        qlens = np.zeros(int(r_ids.max()) + 1, np.int64)
        qlens[r_ids] = [rec.ylen for rec in todo]
        pending = []
        for chunk, rpad, spad, L in self._nw_chunks(
            r_ids, sids, qlens, render=True, count_cells=False
        ):
            res = self._nw_render(dev, rpad, spad, L)
            head = torch.cat([
                torch.stack([res.length, res.identities, res.n_steps], 1),
                res.chain[:, : self._CHAIN_PREFIX],
            ], dim=1)
            pending.append((chunk, head, res.chain))
        return pending

    def _render_collect_chains(self, todo: List[AcceptedRead], pending) -> None:
        """Read back the chunks queued by _render_dispatch_chains (one
        ``.cpu()`` for every chunk's stats and prefix, one more per chunk
        whose chains pass the prefix) and assign each record its chain.
        Cross-checks each pair's path stats against the stats aligner's:
        the two kernels must agree on every accepted pair."""
        if not pending:
            return
        timer = self.timer
        with timer.phase("render.fetch"):
            flat = torch.cat([head for _, head, _ in pending]).cpu().numpy()
        with timer.phase("render.collect"):
            row = 0
            for chunk, head, chain in pending:
                host = flat[row : row + head.shape[0]]
                row += head.shape[0]
                lengths, idents, nsteps = host[:, 0], host[:, 1], host[:, 2]
                chains = host[:, 3:]
                need = int(nsteps[: len(chunk)].max()) + 1
                if need > self._CHAIN_PREFIX:
                    W = self._CHAIN_PREFIX
                    while W < need:
                        W *= 2
                    with timer.phase("render.fetch"):
                        chains = chain[:, :W].cpu().numpy()
                for b, i in enumerate(chunk):
                    rec = todo[i]
                    assert int(lengths[b]) == rec.length
                    assert int(idents[b]) == rec.identities
                    rec.n_steps = int(nsteps[b])
                    rec.chain = chains[b]

    def _materialize_chains(self, records: List[AcceptedRead], dev=None) -> None:
        """Produce traceback chains for accepted pairs by running the
        backpointer kernel + traceback on exactly those pairs (the accept
        path used the stats-only aligner, which writes no bp tensor).

        ``dev`` is a snapshot of the compare's device tables (d_qp, d_dp,
        d_qlen, d_dlen): pass it when the render runs after a later
        compare on the same engine, since each compare replaces
        self._last_dev."""
        todo = [rec for rec in records if rec.chain is None]
        if not todo:
            return
        dev = dev if dev is not None else self._last_dev
        assert dev is not None, "render before compare"
        with self.timer.phase("render.dispatch"):
            pending = self._render_dispatch_chains(todo, dev)
        self._render_collect_chains(todo, pending)

    def render_report(
        self, q: SeqInfo, result: PipelineResult, dev=None
    ) -> bytes:
        """Byte-identical -out file content (records in read order, matching
        the reference at n_threads=1).  With the native host library the
        whole report is one pass over the records (backtrack, header and
        60-col blocks, native/host.c imsame_render_report); the Python
        path below is the bit-identical fallback.  ``dev``: see
        _materialize_chains (default: the last compare's tables).
        Afterwards ``result.timings`` holds the engine's phase sums up to
        the render's end, its ``render_report`` and ``render.*`` phases
        included; the counter ``render_native_records`` counts the records
        the native pass wrote."""
        timer = self.timer
        timer.trace()
        with timer.phase("render_report"):
            self._materialize_chains(result.records, dev=dev)
            recs = result.records
            rendered = None
            if recs and native.lib is not None:
                with timer.phase("render.blocks"):
                    rendered = self._render_native(q, recs)
            with timer.phase("render.format"):
                if rendered is not None:
                    report, emitted, identities = rendered
                    bad = np.flatnonzero(emitted != identities)
                    if len(bad):  # traceback/render agreement
                        p = int(bad[0])
                        raise AssertionError(
                            f"record {p} ({recs[p].qread}, {recs[p].dbread})"
                            f": the render emits {emitted[p]} identities, "
                            f"the NW stats {identities[p]}")
                    out = report.tobytes()
                else:
                    out = self._render_python(q, recs)
        timer.count("render_native_records",
                    len(recs) if rendered is not None else 0)
        result.timings = dict(timer.items())
        return out

    def _render_python(self, q: SeqInfo, recs) -> bytes:
        """The report without the native library: each record's
        backtrack and block in Python."""
        db = self.db
        out = bytearray()
        for a in recs:
            xs = int(db.start[a.dbread])
            xe = db.read_end(a.dbread)
            ys = int(q.start[a.qread])
            ye = q.read_end(a.qread)
            x_chars = CODE_TO_CHAR[db.codes[xs:xe]]
            y_chars = CODE_TO_CHAR[q.codes[ys:ye]]
            rec_x, rec_y, hx, hy, ml = backtrack_from_chain(
                a.chain, a.n_steps, xe - xs, ye - ys, x_chars, y_chars
            )
            block, identities = render_alignment(rec_x, rec_y, hx, hy, ml)
            assert identities == a.identities  # traceback/render agreement
            out.extend(
                format_record(
                    a.qread, a.dbread, identities, a.length, a.ylen, block
                )
            )
        return bytes(out)

    def _render_native(self, q: SeqInfo, recs):
        """The records' report in one native pass: (report as uint8,
        identities the render emitted, the NW stats' identities), or None
        where the native renderer refuses the records."""
        db = self.db
        P = len(recs)

        def field(name, dtype):
            return np.fromiter(map(attrgetter(name), recs), dtype, P)

        qr = field("qread", np.int64)
        dr = field("dbread", np.int64)
        identities = field("identities", np.int32)
        chains = list(map(attrgetter("chain"), recs))
        chain_off = np.zeros(P + 1, np.int64)
        np.cumsum(np.fromiter(map(len, chains), np.int64, P),
                  out=chain_off[1:])
        xoff, xend = _read_bounds(db, dr)
        yoff, yend = _read_bounds(q, qr)
        res = native.render_report(
            db.codes, q.codes, qr, dr, xoff, yoff,
            (xend - xoff).astype(np.int32), (yend - yoff).astype(np.int32),
            field("length", np.int32), identities, field("ylen", np.int32),
            field("n_steps", np.int32), np.concatenate(chains), chain_off,
        )
        if res is None:
            return None
        report, emitted = res
        return report, emitted, identities
