"""FASTA ingestion with the reference's exact semantics, vectorized in numpy.

Reference behavior reproduced (reference: src/IMSAME.c:196-289 db load,
:320-371 query load):

  * Sequence characters are uppercased; only A/C/G/T are kept and
    concatenated into one array.  Everything else is dropped.
  * Per-read start offsets into the concatenated array are recorded at each
    ``>`` header (``SeqInfo.start_pos`` semantics, src/structs.h:40-45).
  * The k-mer *window* resets on any dropped character except newline
    (src/IMSAME.c:229-231: ``if(c != '\\n') word_size = 0``) and at every
    read start.  Because dropped characters do not appear in the
    concatenated array, the index build must know where resets happened:
    we record a ``fresh`` flag per kept base (True = a window restart
    happens at this base).  A database k-mer starting at position ``p`` is
    inserted iff no base in ``p+1 .. p+k-1+1``... precisely: iff
    ``fresh[p+1 : p+k]`` contains no True and ``p+k <= read_end``.
    The *query* scan in the reference walks the already-filtered
    concatenated array and therefore never sees resets (only read
    boundaries); the asymmetry is intentional and preserved.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import List, Union

import numpy as np

from ..constants import FIXED_K

_NL = ord("\n")
_GT = ord(">")

# Byte -> 2-bit code lookup: A/a=0, C/c=1, G/g=2, T/t=3, everything else 255.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_LUT[ord(_ch)] = _code
    _CODE_LUT[ord(_ch.lower())] = _code

# Code -> ASCII base for report rendering.
CODE_TO_CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class SeqInfo:
    """Concatenated sequence store (reference: SeqInfo, src/structs.h:40-45).

    codes:   uint8[total_len], 2-bit base codes (A=0 C=1 G=2 T=3).
    start:   int64[n_seqs], offset of each read's first base.
    fresh:   bool[total_len], True where the k-mer window restarts
             (read start or preceded by a dropped non-newline char).
    headers: raw header lines (without '>' or newline), for tooling only --
             the reference reports read *indices*, never names.
    """

    codes: np.ndarray
    start: np.ndarray
    fresh: np.ndarray
    headers: List[bytes]

    @property
    def n_seqs(self) -> int:
        return len(self.start)

    @property
    def total_len(self) -> int:
        return len(self.codes)

    def read_len(self, r: int) -> int:
        end = self.start[r + 1] if r + 1 < self.n_seqs else self.total_len
        return int(end - self.start[r])

    def read_lens(self) -> np.ndarray:
        ends = np.append(self.start[1:], self.total_len)
        return (ends - self.start).astype(np.int64)

    def read_end(self, r: int) -> int:
        """One-past-last index of read r in the concatenated array."""
        return int(self.start[r + 1]) if r + 1 < self.n_seqs else self.total_len

    def slice_reads(self, lo: int, hi: int) -> "SeqInfo":
        """SeqInfo holding reads [lo, hi).  The first read of the slice
        starts a fresh k-mer window, like the first read of a reference
        worker thread (src/alignmentFunctions.c:93-105)."""
        lo = max(0, min(lo, self.n_seqs))
        hi = max(lo, min(hi, self.n_seqs))
        if lo == 0 and hi == self.n_seqs:
            return self
        b = int(self.start[lo]) if lo < self.n_seqs else self.total_len
        e = int(self.start[hi]) if hi < self.n_seqs else self.total_len
        fresh = self.fresh[b:e].copy()
        if len(fresh):
            fresh[0] = True
        return SeqInfo(
            codes=self.codes[b:e],
            start=self.start[lo:hi] - b,
            fresh=fresh,
            headers=self.headers[lo:hi],
        )


def parse_fasta_bytes(data: bytes) -> SeqInfo:
    """Parse FASTA content into a SeqInfo, reproducing reference ingest.

    Dispatches to the native single-pass parser (native/host.c
    imsame_parse_fasta) when available; the numpy path below is the
    bit-identical fallback (tests/test_fasta.py compares them)."""
    from .. import native

    if len(data) >= (1 << 12) and native.lib is not None:
        res = native.parse_fasta_arrays(data, _CODE_LUT)
        if res is not None:
            codes, fresh_u8, start, hdr_se, n_reads = res
            m = len(codes)
            # base-less reads take the next read's start (searchsorted
            # semantics of the numpy path); trailing ones take m.
            if (start < 0).any():
                t = np.where(start < 0, np.int64(m), start)
                start = np.minimum.accumulate(t[::-1])[::-1]
            headers = [
                data[int(hdr_se[2 * i]) : int(hdr_se[2 * i + 1])]
                for i in range(n_reads)
            ]
            return SeqInfo(
                codes=codes,
                start=start.astype(np.int64),
                fresh=fresh_u8.astype(bool),
                headers=headers,
            )
    return _parse_fasta_bytes_np(data)


def _parse_fasta_bytes_np(data: bytes) -> SeqInfo:
    """Numpy fallback parse (line-oriented vectorization: all per-element
    work runs over the ~line count except one index-expansion gather for
    the sequence bytes)."""
    raw = np.frombuffer(data, dtype=np.uint8)
    n = len(raw)
    if n == 0:
        return SeqInfo(
            codes=np.empty(0, np.uint8),
            start=np.empty(0, np.int64),
            fresh=np.empty(0, bool),
            headers=[],
        )

    nl_pos = np.flatnonzero(raw == _NL).astype(np.int64)
    starts = np.concatenate([np.zeros(1, np.int64), nl_pos + 1])
    ends = np.append(nl_pos, n)  # same length as starts
    header = raw[np.minimum(starts, n - 1)] == _GT
    header &= starts < n  # a trailing newline yields one empty pseudo-line
    line_read = np.cumsum(header) - 1  # -1 before the first '>'

    seq_line = ~header & (line_read >= 0) & (ends > starts)
    s_starts = starts[seq_line]
    s_lens = ends[seq_line] - s_starts
    tot = int(s_lens.sum())
    cum = np.zeros(len(s_lens), np.int64)
    np.cumsum(s_lens[:-1], out=cum[1:])
    idx = np.repeat(s_starts - cum, s_lens) + np.arange(tot, dtype=np.int64)
    codes_all = _CODE_LUT[raw[idx]]
    byte_read = np.repeat(line_read[seq_line], s_lens)

    # Window-reset events: dropped non-ACGT bytes inside a read's sequence
    # region (reference: src/IMSAME.c:229-231).  Newlines never appear
    # here (lines exclude them), matching the reference's non-reset walk
    # over line breaks.
    invalid = codes_all == 255
    if invalid.any():
        kept = ~invalid
        concat_codes = codes_all[kept]
        concat_read = byte_read[kept]
        kres = np.cumsum(invalid)[kept]
        m = len(concat_codes)
        fresh = np.empty(m, bool)
        if m:
            fresh[0] = True
            fresh[1:] = (concat_read[1:] != concat_read[:-1]) | (
                kres[1:] != kres[:-1]
            )
    else:
        concat_codes = codes_all
        concat_read = byte_read
        fresh = np.empty(tot, bool)
        if tot:
            fresh[0] = True
            fresh[1:] = concat_read[1:] != concat_read[:-1]

    n_reads = int(header.sum())
    start = np.searchsorted(concat_read, np.arange(n_reads)).astype(np.int64)

    headers: List[bytes] = [
        data[int(p) + 1 : int(e)]
        for p, e in zip(starts[header], ends[header])
    ]

    return SeqInfo(codes=concat_codes, start=start, fresh=fresh, headers=headers)


# Above this file size read_fasta switches to the chunked streaming
# parser (the reference streams through a 50 MB buffer,
# src/commonFunctions.c:15-23 / READBUF src/structs.h:11; whole-file
# parsing needs ~4x the file in temporaries, a real constraint at the
# ~1M-read metagenome scale of BASELINE config 3).
STREAM_THRESHOLD = 256 << 20
STREAM_CHUNK = 64 << 20


def read_fasta(path_or_bytes: Union[str, bytes]) -> SeqInfo:
    if isinstance(path_or_bytes, bytes):
        return parse_fasta_bytes(path_or_bytes)
    import os

    if os.path.getsize(path_or_bytes) > STREAM_THRESHOLD:
        return read_fasta_stream(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return parse_fasta_bytes(f.read())


def _pending_fresh(seg: np.ndarray, carry: bool) -> bool:
    """Will the next kept base start a fresh k-mer window?  ``seg`` holds
    the sequence-line bytes scanned since the last read start (or chunk
    carry); ``carry`` is the state entering the segment (True right after
    a header -- a read's first base is always fresh).  A dropped
    non-newline char with no kept base after it leaves a reset pending
    (reference rule, src/IMSAME.c:229-231)."""
    if len(seg) == 0:
        return carry
    kept = _CODE_LUT[seg] != 255
    dropped = ~kept & (seg != _NL)
    kept_idx = np.flatnonzero(kept)
    if len(kept_idx) == 0:
        return carry or bool(dropped.any())
    return bool(dropped[kept_idx[-1] + 1 :].any())


def read_fasta_stream(
    path: str, chunk_bytes: int = STREAM_CHUNK
) -> SeqInfo:
    """Chunked-streaming FASTA parse, bit-identical to parse_fasta_bytes
    on the whole file (tests/test_fasta.py), in bounded extra memory:
    one chunk of raw bytes plus the growing output arrays.

    Chunks split at line boundaries (a partial trailing line carries into
    the next chunk).  A chunk that starts inside a read is parsed with a
    synthetic ``>`` header; the resulting pseudo-read's bases append to
    the previous read, and its first base's fresh flag comes from the
    carried window state instead of the parser's read-start True."""
    codes_parts: List[np.ndarray] = []
    fresh_parts: List[np.ndarray] = []
    start_parts: List[np.ndarray] = []
    headers: List[bytes] = []
    total = 0
    in_read = False  # some '>' has been seen in an earlier chunk
    pending_fresh = True
    leftover = b""
    with open(path, "rb") as f:
        eof = False
        while not eof:
            raw = f.read(chunk_bytes)
            eof = not raw
            data = leftover + raw
            leftover = b""
            if not eof:  # carry the partial trailing line
                cut = data.rfind(b"\n")
                if cut < 0:
                    leftover = data
                    continue
                leftover = data[cut + 1 :]
                data = data[: cut + 1]
            if not data:
                continue

            cont = in_read
            info = parse_fasta_bytes((b">\n" + data) if cont else data)

            # advance the fresh-carry over this chunk's unfinished tail:
            # seg = sequence bytes after the last header line (fresh
            # resets to True at a read start), or the whole chunk if it
            # holds no header (continuation)
            h = data.rfind(b"\n>")
            if h >= 0 or data.startswith(b">"):
                seg_from = h + 1 if h >= 0 else 0
                nlp = data.find(b"\n", seg_from)
                seg = np.frombuffer(
                    data[nlp + 1 :] if nlp >= 0 else b"", np.uint8
                )
                next_fresh = _pending_fresh(seg, True)
            else:
                next_fresh = _pending_fresh(
                    np.frombuffer(data, np.uint8), pending_fresh
                )

            if info.n_seqs:
                c, fr, st, hd = info.codes, info.fresh, info.start, info.headers
                if cont:
                    # read 0 is the synthetic continuation; its bases (if
                    # any) belong to the previous read
                    cont_has_bases = len(c) > 0 and (
                        st.size == 1 or int(st[1]) > 0
                    )
                    if cont_has_bases:
                        # dropped chars in this chunk before the first
                        # kept continuation base also leave a reset
                        fh = data.find(b"\n>")
                        region = np.frombuffer(
                            data[: fh + 1] if fh >= 0 else data, np.uint8
                        )
                        ki = np.flatnonzero(_CODE_LUT[region] != 255)
                        pre = region[: ki[0]]
                        fr = fr.copy()
                        fr[0] = pending_fresh or bool(
                            (
                                (_CODE_LUT[pre] == 255) & (pre != _NL)
                            ).any()
                        )
                    st = st[1:]
                    hd = hd[1:]
                codes_parts.append(c)
                fresh_parts.append(fr)
                start_parts.append(st + total)
                headers.extend(hd)
                total += len(c)
            # a header only counts at line start (matching the parser's
            # semantics): a stray mid-line '>' before the first real
            # header must not flip continuation mode (ADVICE r4)
            in_read = in_read or data.startswith(b">") or (b"\n>" in data)
            pending_fresh = next_fresh
    if not codes_parts:
        return SeqInfo(
            codes=np.empty(0, np.uint8),
            start=np.empty(0, np.int64),
            fresh=np.empty(0, bool),
            headers=headers,
        )
    return SeqInfo(
        codes=np.concatenate(codes_parts),
        start=np.concatenate(start_parts).astype(np.int64),
        fresh=np.concatenate(fresh_parts),
        headers=headers,
    )


# --- reverse complement tool (reference: src/reverseComplement.c) ---

_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"), ("U", "A")):
    _COMP_LUT[ord(_a)] = ord(_b)
    _COMP_LUT[ord(_a.lower())] = ord(_b.lower())


def revcomp_fasta_bytes(data: bytes) -> bytes:
    """Reverse-complement a FASTA file's reads, emitting reads in *reverse
    file order* with each sequence on one line -- exactly the reference
    revComp tool (src/reverseComplement.c:56-112).

    Only alphabetic characters are kept from the sequence (isupper/islower
    filter at src/reverseComplement.c:66); the complement map preserves case
    and passes unknown letters through unchanged.
    """
    out = _io.BytesIO()
    # Split into records on '>' at the stream level, like the two-pass C tool.
    raw = np.frombuffer(data, dtype=np.uint8)
    n = len(raw)
    nl = raw == _NL
    line_start = np.flatnonzero(np.concatenate([np.ones(1, bool), nl[:-1]]))
    rec_starts = [int(p) for p in line_start if p < n and raw[p] == _GT]
    rec_bounds = rec_starts + [n]
    letters = ((raw >= ord("A")) & (raw <= ord("Z"))) | (
        (raw >= ord("a")) & (raw <= ord("z"))
    )
    for i in range(len(rec_starts) - 1, -1, -1):
        s, e = rec_bounds[i], rec_bounds[i + 1]
        # Header line (through its newline, as fgets does).
        he = s
        while he < e and raw[he] != _NL:
            he += 1
        out.write(raw[s : min(he + 1, e)].tobytes())
        if he >= e or raw[he] != _NL:
            out.write(b"\n")  # unterminated final header
        body = raw[he + 1 : e]
        seq = body[letters[he + 1 : e]]
        out.write(_COMP_LUT[seq[::-1]].tobytes())
        out.write(b"\n")
    return out.getvalue()


def revcomp_fasta(in_path: str, out_path: str) -> None:
    with open(in_path, "rb") as f:
        data = f.read()
    with open(out_path, "wb") as f:
        f.write(revcomp_fasta_bytes(data))


def valid_db_kmer_starts(info: SeqInfo, k: int = FIXED_K) -> np.ndarray:
    """Positions p where a database k-mer [p, p+k) is inserted into the index.

    A k-mer is inserted iff its k bases were appended consecutively with no
    window reset in between: no ``fresh`` flag at positions p+1..p+k-1, and
    p+k-1 < total_len.  Read boundaries are fresh, so in-read containment is
    implied.  (reference build loop: src/IMSAME.c:232-281)
    """
    n = info.total_len
    if n < k:
        return np.empty(0, np.int64)
    freshcum = np.concatenate([[0], np.cumsum(info.fresh)])
    # count of fresh flags in [p+1, p+k-1] for every p, via slices
    resets_inside = freshcum[k : n + 1] - freshcum[1 : n - k + 2]
    return np.flatnonzero(resets_inside == 0).astype(np.int64)
