"""The port's device-side candidate enumeration (imsame_tpu_torch
ops/enum_gate.py and TorchEngine with Config(gate_enum=True)) against the
JAX package's (imsame_tpu ops/enum_gate.py, TpuEngine with gate_enum=True)
and against the port's own host-built candidates, on the same seeded
inputs: the slot tables, the selection prefix, the candidate triples, the
gate bits, and whole compares.  Integer results throughout, so every
comparison is exact (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.ops import enum_gate as jenum
from imsame_tpu.pipeline import TpuEngine, _pad_pow2_1d
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.constants import FIXED_K, MAX_READ_SIZE
from imsame_tpu_torch.io.fasta import parse_fasta_bytes, read_fasta
from imsame_tpu_torch.ops import candidates as tcand
from imsame_tpu_torch.ops import enum_gate as tenum
from imsame_tpu_torch.ops.extend import raw_score_threshold
from imsame_tpu_torch.ops.extend_packed import pack_read_rows
from imsame_tpu_torch.pipeline import (
    TorchEngine, build_flat, enum_padded_rows, map_selected,
)
from test_longreads import _make_long_pair
from test_torch_pipeline import WORKLOADS
from util_synth import make_pair, mutate, random_read, write_fasta


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The engine's CPU tensors are small; more intra-op threads than two
    only contend with the JAX engine and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _seqinfo(reads):
    return parse_fasta_bytes(
        "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    )


def _table_sample(row_len, seed):
    """Ragged query reads that fit row_len: an empty read, a read shorter
    than K, an all-T read (key 0xFFFFFF, the last bucket) after a read
    ending in T (a boundary key with its top bits set); the db holds
    mutated copies of half of them, so buckets hold hits."""
    rng = random.Random(seed)
    hi = min(row_len, MAX_READ_SIZE)
    q = [random_read(rng, rng.randint(FIXED_K + 1, hi)) for _ in range(24)]
    q[3] = ""
    q[5] = random_read(rng, FIXED_K - 5)
    q[8] = q[8][:-1] + "T"
    q[9] = "T" * rng.randint(FIXED_K + 20, hi)
    db = [mutate(rng, r, 0.05, 0.02) for r in q[:14] if r]
    db += [random_read(rng, rng.randint(40, hi)) for _ in range(6)]
    return _seqinfo(q), _seqinfo(db)


def _table_inputs(row_len, n_threads, seed=5):
    """(qp, bs, hasb, n_kmers, qlen) as numpy (qp uint32), and the host
    stream of the same compare."""
    q, db = _table_sample(row_len, seed)
    eng = TorchEngine(db, TConfig(n_threads=n_threads), device="cpu")
    qlo, _, n_kmers = eng._stream_bounds(q)
    qlen = q.read_lens()
    qp = pack_read_rows(q.codes, q.start, qlen, row_len)
    return (
        qp,
        np.asarray(eng.index.bucket_start, np.int32),
        (qlo != q.start).astype(np.int32),
        np.minimum(n_kmers, np.iinfo(np.int32).max).astype(np.int32),
        qlen.astype(np.int32),
    ), eng._kmer_stream(q)


def _t(a):
    """numpy -> torch, with uint32 words bit-cast to int32."""
    a = np.asarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("row_len", [128, 256, 3072])
def test_build_enum_tables_matches_jax(monkeypatch, row_len, n_threads):
    inputs, stream = _table_inputs(row_len, n_threads)
    qp, bs, hasb, nk, qlen = inputs
    want = jenum.build_enum_tables(*[jnp.asarray(a) for a in inputs],
                                   row_len=row_len)
    got = tenum.build_enum_tables(*[_t(a) for a in inputs], row_len=row_len)
    for g, w, name in zip(got, want, ("lo", "cnt", "Rcum", "tot")):
        assert g.dtype == torch.int32, name
        _eq(g, w, name)
    # the per-read totals are the host stream's candidate counts
    C_off = stream[5]
    _eq(got[3], C_off[1:] - C_off[:-1], "tot")
    # row blocks of 3 reads build the same tables
    S = row_len - FIXED_K + 2
    monkeypatch.setattr(tenum, "BUILD_BLOCK_SLOTS", 3 * S)
    for g, b in zip(got, tenum.build_enum_tables(*[_t(a) for a in inputs],
                                                 row_len=row_len)):
        _eq(b, g)
    # the sample reaches what it is built for: the last bucket, a
    # boundary slot, and (n_threads = 4) a thread-first read without one
    assert ((np.asarray(got[0]) == bs[4**FIXED_K - 1])
            & (np.asarray(got[1]) > 0)).any()
    assert hasb[9] == 1 and nk[3] == 0 and nk[5] == 0
    assert (hasb[1:] == 0).any() == (n_threads > 1)


@pytest.mark.parametrize("seed", [1, 2])
def test_enum_select_prefix_matches_jax(seed):
    """Rank windows that are empty, partial, whole, past the read's total
    and reversed (to < frm), and unselected reads."""
    inputs, _ = _table_inputs(256, 1, seed)
    _, cnt, Rcum, tot = jenum.build_enum_tables(
        *[jnp.asarray(a) for a in inputs], row_len=256)
    tot = np.asarray(tot).astype(np.int64)
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 6, len(tot))
    frm = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
        [tot // 2, np.minimum(2, tot), np.zeros_like(tot), tot + 3, tot // 2 + 1],
        0)
    to = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
        [tot // 2, np.maximum(tot - 1, 0), tot, tot + 10, tot // 2],
        0)
    frm, to = frm.astype(np.int32), to.astype(np.int32)
    assert len(set(kind.tolist())) == 6
    want = jenum.enum_select_prefix(cnt, Rcum, jnp.asarray(frm),
                                    jnp.asarray(to))
    got = tenum.enum_select_prefix(_t(cnt), _t(Rcum), _t(frm), _t(to))
    for g, w, name in zip(got, want, ("scum", "start_off")):
        assert g.dtype == torch.int32, name
        _eq(g, w, name)
    sel = np.maximum(np.minimum(to, tot) - np.minimum(frm, tot), 0)
    assert int(got[0][-1]) == int(sel.sum()) > 0


def _enum_engine(tmp_path, seed, long=False):
    """An enumerating port engine on a synthetic pair: short reads whose
    first query read is empty, or tests/test_longreads.py's long reads
    (300..3000 bp).  Returns (engine, query, the compare's device tables,
    host stream)."""
    if long:
        qp, dp = _make_long_pair(tmp_path, random.Random(seed))
    else:
        qp, dp = make_pair(tmp_path, random.Random(seed), n_query=30,
                           n_db=30, read_len=150, sub_rate=0.05,
                           indel_rate=0.04)
        qp.write_text(">empty\n" + qp.read_text())
    q, db = read_fasta(str(qp)), read_fasta(str(dp))
    eng = TorchEngine(db, TConfig(gate_enum=True), device="cpu")
    # the device tables of a compare (TorchEngine.compare's uploads)
    qlens = q.read_lens()
    window = eng._nw_bucket(max(int(qlens.max()), int(eng.db_read_lens.max())))
    dev = (eng._rows_on_device(q.codes, q.start, qlens, window),
           eng._packed_db_rows(window), eng._put(qlens.astype(np.int32)),
           eng._d_dlen)
    return eng, q, dev, eng._kmer_stream(q)


def _selection(N_r):
    """Per-read rank windows: whole streams, [3, N_r), reads left out,
    and a window past the read's total."""
    n = len(N_r)
    kind = np.arange(n) % 4
    frm = np.where(kind == 1, 3, 0).astype(np.int64)
    to = np.where(kind == 2, 0, N_r).astype(np.int64)
    frm[kind == 3] = N_r[kind == 3] + 2
    to[kind == 3] = N_r[kind == 3] + 9
    frm[-1], to[-1] = 1, N_r[-1] + 4
    return frm, to


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_enum_candidates_match_host_and_jax(tmp_path, monkeypatch, path):
    """Device-enumerated (rid, hit, qoff) triples, in chunks smaller than
    the selection (o_base > 0), equal the host build_flat's and JAX's
    enum_candidates_debug's; map_selected inverts them."""
    import imsame_tpu_torch.native as tnative

    if path == "numpy":
        monkeypatch.setattr(tnative, "load", lambda: None)
        assert tnative.lib is None
    eng, q, dev, stream = _enum_engine(tmp_path, 35)
    C_off = stream[5]
    N_r = C_off[1:] - C_off[:-1]
    frm, to = _selection(N_r)
    reads = np.arange(q.n_seqs)
    q_start = q.start.astype(np.int64)
    host = build_flat(stream, q_start, reads, frm, to)
    N = len(host[0])
    assert N == np.maximum(np.minimum(to, N_r) - np.minimum(frm, N_r), 0).sum()
    for h, m in zip(host, map_selected(stream, q_start, np.arange(N), frm, to)):
        _eq(m, h)

    lo_g, cnt_g, Rcum, d_hasb = eng._enum_prepare(q, dev)
    scum, start_off = tenum.enum_select_prefix(
        cnt_g, Rcum, _t(frm.astype(np.int32)), _t(to.astype(np.int32)))
    jscum, jstart = jenum.enum_select_prefix(
        jnp.asarray(np.asarray(cnt_g)), jnp.asarray(np.asarray(Rcum)),
        jnp.asarray(frm.astype(np.int32)), jnp.asarray(to.astype(np.int32)))
    row_len = dev[0].shape[1] * 16
    chunk = 96
    assert N > 2 * chunk
    got, want = [], []
    for o_base in range(0, N, chunk):
        got.append(tenum.enum_candidates(lo_g, scum, start_off, d_hasb,
                                         o_base, chunk=chunk, row_len=row_len))
        want.append(jenum.enum_candidates_debug(
            jnp.asarray(np.asarray(lo_g)), jscum, jstart,
            jnp.asarray(np.asarray(d_hasb)), np.int32(o_base), chunk=chunk,
            row_len=row_len))
    for i, h in enumerate(host):
        _eq(torch.cat([g[i] for g in got])[:N], h)
        _eq(np.concatenate([np.asarray(w[i]) for w in want])[:N], h)


@pytest.mark.parametrize("window", [64, 256, 3072])
def test_enum_gate_chunk_matches_flat_gate_packed(tmp_path, window):
    """The gate bits of enumerated chunks equal flat_gate_packed's on the
    host-built candidates of the same selection (the long-read sample at
    the 3072 window, ranks [0, 300) of each read), and JAX's
    enum_gate_chunk's."""
    long = window > 256
    eng, q, dev, stream = _enum_engine(tmp_path, 41, long=long)
    d_qp, d_dp, d_qlen, d_dlen = dev
    row_len = d_qp.shape[1] * 16
    C_off = stream[5]
    N_r = C_off[1:] - C_off[:-1]
    frm = np.zeros(q.n_seqs, np.int64)
    to = np.minimum(N_r, 300) if long else N_r.copy()
    to[1::3] = 0
    rids, hits, qoffs = build_flat(stream, q.start.astype(np.int64),
                                   np.arange(q.n_seqs), frm, to)
    N = len(hits)
    thr = _t(raw_score_threshold(q.read_lens(), eng.db.total_len,
                                 eng.cfg.min_e_value))
    n_pad = -(-N // 32) * 32
    cand = np.zeros((2, n_pad), np.int32)
    cand[0, :N] = hits
    cand[1, :N] = ((rids.astype(np.uint32) << np.uint32(12))
                   | qoffs.astype(np.uint32)).view(np.int32)
    want = tcand.flat_gate_packed(d_qp, d_dp, d_qlen, d_dlen, eng._d_idx_tab,
                                  _t(cand), thr, window=window)

    lo_g, cnt_g, Rcum, d_hasb = eng._enum_prepare(q, dev)
    scum, start_off = tenum.enum_select_prefix(
        cnt_g, Rcum, _t(frm.astype(np.int32)), _t(to.astype(np.int32)))
    chunk = 256
    args = (d_qp, d_dp, d_qlen, d_dlen, eng._d_idx_tab, thr, lo_g, scum,
            start_off, d_hasb)
    got = torch.cat([
        tenum.enum_gate_chunk(*args, o, chunk=chunk, window=window,
                              row_len=row_len)
        for o in range(0, N, chunk)], dim=1)
    # the JAX package keeps packed rows as uint32
    jargs = [jnp.asarray(np.asarray(a).view(np.uint32) if i < 2
                         else np.asarray(a)) for i, a in enumerate(args)]
    jgot = np.concatenate([
        np.asarray(jenum.enum_gate_chunk(
            *jargs, np.int32(o), chunk=chunk, window=window,
            packed_idx=True, row_len=row_len))
        for o in range(0, N, chunk)], axis=1)
    bits = [_bits(w, N) for w in (want, got, jgot)]
    _eq(bits[1], bits[0])
    _eq(bits[2], bits[0])
    assert N > chunk and bits[0][0].any() and not bits[0][0].all()
    if window == 64:  # walks that outrun the small window
        assert not bits[0][1].all()


def _bits(words, n):
    pb = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    return np.unpackbits(
        pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
    )[:, :n]


def _run_three(qp, dp, cfg_kw):
    """The JAX engine and the port's, both enumerating, and the port's
    host-gate engine on one pair: [(engine, query, result)] * 3."""
    out = []
    jq = jread_fasta(str(qp))
    jeng = TpuEngine(jread_fasta(str(dp)),
                     JConfig(mesh_shape=None, gate_enum=True, **cfg_kw))
    assert jeng._use_enum
    out.append((jeng, jq, jeng.compare(jq)))
    tq, tdb = read_fasta(str(qp)), read_fasta(str(dp))
    for enum in (True, False):
        teng = TorchEngine(tdb, TConfig(gate_enum=enum, **cfg_kw),
                           device="cpu")
        out.append((teng, tq, teng.compare(tq)))
    return out


def _assert_same(runs):
    (jeng, jq, jres), *ports = runs
    jreport = jeng.render_report(jq, jres)
    for teng, tq, tres in ports:
        assert tres.pairs == jres.pairs
        assert tres.n_candidates == jres.n_candidates
        assert tres.nw_cells == jres.nw_cells
        assert teng.stage_stats == jeng.stage_stats
        assert teng.render_report(tq, tres) == jreport


def _enumerated(res) -> bool:
    """Whether a compare gated device-enumerated candidates: it built no
    candidate array on the host."""
    return "gate.enum" in res.timings and "gate.build" not in res.timings


@pytest.mark.parametrize("case", ["default", "small_round", "threads4",
                                  "long_reads", "empty_first_reads"])
def test_enum_engine_matches_jax(tmp_path, case):
    """Pairs, counters, stage stats and report bytes of the enumerating
    engine equal the JAX enumerating engine's and the port's host-gate
    engine's: multi-chunk stages (small_round), the n_threads = 4 stream
    split, long reads (window 3072: every stage gates the small window
    first and re-gates its escapees), and empty first reads."""
    cfg_kw = {}
    if case in WORKLOADS:
        seed, kw, pair_kw = WORKLOADS[case]
        cfg_kw = dict(kw or {})
        qp, dp = make_pair(tmp_path, random.Random(seed), **pair_kw)
    elif case == "long_reads":
        rng = random.Random(77)
        q = [random_read(rng, n) for n in (300, 420, 510, 380, 460, 350)]
        db = [mutate(rng, q[i], 0.04, 0.01) for i in (0, 2, 3, 4)]
        db += [random_read(rng, 500), random_read(rng, 330)]
        qp, dp = tmp_path / "q.fa", tmp_path / "db.fa"
        write_fasta(qp, q, "q")
        write_fasta(dp, db, "d")
        cfg_kw = {"nw_stats_batches": (8,), "nw_render_bp_budget": 64 << 20}
    else:
        qp, dp = make_pair(tmp_path, random.Random(43), n_query=24, n_db=24,
                           read_len=120, sub_rate=0.05, indel_rate=0.02)
        if case == "threads4":
            cfg_kw = {"n_threads": 4}
        else:
            for p in (qp, dp):
                p.write_text(">empty\n" + p.read_text())
    runs = _run_three(qp, dp, cfg_kw)
    (_, _, jres), (teng, tq, tres), (heng, _, hres) = runs
    assert teng._use_enum and _enumerated(tres)
    assert not heng._use_enum and not _enumerated(hres)
    assert tres.accepted > 0
    if case == "small_round":  # stages of several gate chunks
        assert teng.stage_stats["s2"][0] > max(teng.cfg.gate_chunks)
    if case == "long_reads":  # past SHORT_WINDOW: the small tier first
        assert teng._nw_bucket(int(tq.read_lens().max())) == 512
    _assert_same(runs)


@pytest.mark.parametrize("case", ["wide_index", "rows_over_limit",
                                  "rows_at_limit", "candidates_over_limit"])
def test_enum_eligibility(tmp_path, monkeypatch, case):
    """Enumeration is off for a wide index, for a query whose padded row
    count (256 for 40 reads) passes ENUM_MAX_ROWS, and for a compare of
    ENUM_MAX_CANDIDATES candidates or more; on at the row limit.  The
    result equals the JAX enumerating engine's either way."""
    import imsame_tpu_torch.pipeline as tpipe

    jkw = {}
    if case == "wide_index":
        monkeypatch.setattr(tpipe, "PACKED_MAX_READS", 1)
    elif case == "rows_over_limit":
        monkeypatch.setattr(tpipe, "ENUM_MAX_ROWS", 255)
    elif case == "rows_at_limit":
        monkeypatch.setattr(tpipe, "ENUM_MAX_ROWS", 256)
        jkw = {"gate_enum_max_rows": 256}
    else:
        monkeypatch.setattr(tpipe, "ENUM_MAX_CANDIDATES", 50)
    qp, dp = make_pair(tmp_path, random.Random(47), n_query=40, n_db=40,
                       read_len=120, sub_rate=0.05, indel_rate=0.02)
    jq = jread_fasta(str(qp))
    jeng = TpuEngine(jread_fasta(str(dp)),
                     JConfig(mesh_shape=None, gate_enum=True, **jkw))
    jres = jeng.compare(jq)
    tq = read_fasta(str(qp))
    teng = TorchEngine(read_fasta(str(dp)), TConfig(gate_enum=True),
                       device="cpu")
    tres = teng.compare(tq)
    assert teng._use_enum == (case != "wide_index")
    assert _enumerated(tres) == (case == "rows_at_limit")
    assert tres.n_candidates > 50
    _assert_same([(jeng, jq, jres), (teng, tq, tres)])


def test_enum_padded_rows_match_jax():
    """The row count ENUM_MAX_ROWS bounds is the JAX engine's padded query
    row count, and the limit is the JAX engine's default one."""
    import imsame_tpu_torch.pipeline as tpipe

    for n in (0, 1, 40, 255, 256, 257, 5000, 1 << 17, (1 << 17) + 1):
        want = len(_pad_pow2_1d(np.empty(max(n, 1), np.int32), 0))
        assert enum_padded_rows(n) == want, n
    assert TConfig().gate_enum is False
    assert tpipe.ENUM_MAX_ROWS == JConfig().gate_enum_max_rows == 1 << 17
