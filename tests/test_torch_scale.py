"""The port at scale: samples of 2^20 reads or more on either side, held
against the JAX package on the CPU.

  * Function level: the gate (imsame_tpu_torch.ops.candidates gate_core
    through flat_gate_packed and the wide flat_gate) against the JAX
    package's, in both index formats -- the packed (sid << 12) | doff
    words, and the wide (pos, sid, db_start) triple derived from the same
    words, so a small table reaches the wide index's code -- and both
    candidate formats of a packed and a wide query, at the windows 64,
    256 and 3072, with hits past the table's end.  Integer results: the
    bits of the real candidates must be equal.
  * Engine level: tests/test_capacity.py's wide regimes (a database of
    2^20 + 8 reads; a query of 2^20 + 8 reads), the port's TorchEngine on
    the CPU, on one device and on the (2, 4) mesh, against TpuEngine: the
    same pairs and byte-equal reports (the plain NW functions compute
    each pair row once, tests/test_torch_sharded.py plain_rows_once).

``wide_anchors()`` computes the JAX anchors that chip_smoke.py holds the
card to at config-3's widths (REF_WIDE_DB_2K, REF_WIDE_QUERY), and
``hundredk_anchor()`` the one of its 100k x 100k phase (REF_100K_2K)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_config3
import chip_smoke
from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import SeqInfo as JSeqInfo
from imsame_tpu.ops import candidates as jcand
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.io.fasta import SeqInfo as TSeqInfo
from imsame_tpu_torch.ops import candidates as tcand
from imsame_tpu_torch.parallel import sharded
from imsame_tpu_torch.pipeline import PACKED_MAX_READS, TorchEngine
from test_capacity import WIDE_N, planted_pair
from test_torch_sharded import plain_rows_once  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the JAX engine and other test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bits(words, n):
    pb = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    return np.unpackbits(
        pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
    )[:, :n]


def _scale_gate_inputs(seed, window):
    """Rows of length max(window, 256), index words with a wide-format
    twin, and a stream-ordered candidate list padded to a multiple of 32:
    a diagonal hit on an identical row pair for a third of the reads (walks
    that pass and, past the small window, escape it), random hits, and hits
    past the table's end (clamped to its last row)."""
    rng = np.random.default_rng(seed)
    L = max(window, 256)
    n_q, n_db, n_idx = 48, 48, 400
    qp = rng.integers(0, 2**32, (n_q, L // 16), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (n_db, L // 16), dtype=np.uint32)
    dp[:16] = qp[:16]
    qlen = rng.integers(L * 2 // 5, L - 5, n_q).astype(np.int32)
    dlen = rng.integers(L * 2 // 5, L - 5, n_db).astype(np.int32)
    dlen[:16] = qlen[:16]
    sid = rng.integers(0, n_db, n_idx).astype(np.uint32)
    doff = (rng.integers(12, L * 2 // 5, n_idx)).astype(np.uint32)
    N, size = 300, 320
    rids = np.sort(rng.integers(0, n_q, N)).astype(np.int32)
    qoffs = np.empty(N, np.int32)
    for r in np.unique(rids):
        m = rids == r
        qoffs[m] = np.sort(rng.integers(12, int(qlen[r]), int(m.sum())))
    hits = rng.integers(0, n_idx, N).astype(np.int32)
    diag = np.flatnonzero(rids < 16)[::2]
    hits[diag] = np.arange(len(diag))  # row h: the diagonal of candidate h
    sid[: len(diag)] = rids[diag]
    doff[: len(diag)] = qoffs[diag]
    hits[-6:] = n_idx + np.arange(6) * 1000  # past the table's end
    words = ((sid << np.uint32(12)) | doff).view(np.int32)
    db_start = np.zeros(n_db, np.int32)
    np.cumsum(dlen[:-1], out=db_start[1:])
    triple = (db_start[sid] + doff.astype(np.int32), sid.view(np.int32),
              db_start)
    thr = rng.integers(-50, 200, n_q).astype(np.int32)
    thr[:16] = 60  # the diagonal walks pass
    rows = (qp, dp, qlen, dlen)  # uint32 rows: bit-cast for torch
    return rows, words, triple, thr, (rids, hits, qoffs), N, size


@pytest.mark.parametrize("window", [64, 256, 3072])
@pytest.mark.parametrize("cands", ["two_word", "wide"])
@pytest.mark.parametrize("index", ["packed", "triple"])
def test_gate_formats_match_jax(index, cands, window):
    rows, words, triple, thr, (rids, hits, qoffs), N, size = \
        _scale_gate_inputs(window + (index == "triple"), window)
    j_idx = (jnp.asarray(words) if index == "packed"
             else tuple(jnp.asarray(a) for a in triple))
    t_idx = (torch.as_tensor(words) if index == "packed"
             else tuple(torch.as_tensor(a) for a in triple))
    j_rows = [jnp.asarray(a) for a in rows]
    t_rows = [torch.as_tensor(a.view(np.int32)) for a in rows]
    if cands == "two_word":
        cand = np.zeros((2, size), np.int32)
        cand[0, :N] = hits
        cand[1, :N] = ((rids.astype(np.uint32) << np.uint32(12))
                       | qoffs.astype(np.uint32)).view(np.int32)
        want = jcand.flat_gate_packed(
            *j_rows, j_idx, jnp.asarray(cand), jnp.asarray(thr),
            window=window, packed_idx=index == "packed",
        )
        got = tcand.flat_gate_packed(
            *t_rows, t_idx, torch.as_tensor(cand), torch.as_tensor(thr),
            window=window,
        )
    else:
        pad = lambda a: np.concatenate([a, np.zeros(size - N, np.int32)])
        want = jcand.flat_gate(
            *j_rows, j_idx, jnp.asarray(pad(rids)), jnp.asarray(pad(hits)),
            jnp.asarray(pad(qoffs)), jnp.asarray(pad(thr[rids])),
            jnp.asarray(np.int32(N)), window=window,
            packed_idx=index == "packed",
        )
        cand = np.stack([pad(hits), pad(rids), pad(qoffs)])
        got = tcand.flat_gate(
            *t_rows, t_idx, torch.as_tensor(cand), torch.as_tensor(thr),
            window=window,
        )
    got, want = _bits(got, N), _bits(want, N)
    np.testing.assert_array_equal(got, want)
    # both verdicts occur, and the small window has escapees
    assert got[0].any() and not got[0].all()
    assert got[1].any() and (window > 64 or not got[1].all())


def _seqinfos(reads: np.ndarray):
    """The JAX and the port's SeqInfo of a [n, L] code matrix (no FASTA
    round trip: million-read FASTA text would dominate the test)."""
    n, L = reads.shape
    start = np.arange(n, dtype=np.int64) * L
    fresh = np.zeros(n * L, bool)
    fresh[start] = True
    codes = reads.reshape(-1).copy()
    return tuple(cls(codes=codes, start=start, fresh=fresh, headers=[b""] * n)
                 for cls in (JSeqInfo, TSeqInfo))


def _wide_regime(regime):
    """(q codes, db codes) of tests/test_capacity.py's wide regimes."""
    if regime == "wide_db":
        return planted_pair(WIDE_N, 400, 100, seed=6)
    rng = np.random.default_rng(7)
    db_codes = rng.integers(0, 4, (2000, 100), dtype=np.uint8)
    q_codes = rng.integers(0, 4, (WIDE_N, 100), dtype=np.uint8)
    q_codes[:: WIDE_N // 400][:400] = db_codes[:400]
    return q_codes, db_codes


@pytest.mark.parametrize("regime,rung", [
    pytest.param("wide_db", False, id="wide_db"),
    pytest.param("wide_query", False, id="wide_query"),
    pytest.param("wide_db", True, id="wide_db-rung"),
])
def test_engine_wide_regime_matches_jax(monkeypatch, plain_rows_once, regime,
                                        rung):
    """2^20 + 8 reads on one side: the port (on the CPU) takes the wide
    index or the wide candidate format, as the JAX engine does, and gives
    its pairs and report bytes, on one device and on the (2, 4) mesh
    (tests/test_capacity.py's regimes under the mesh): the wide index
    split over "dict" behind the routed gate, or the wide query through
    the sharded wide gate.  With the gate's rung off the candidates and
    stage stats are the JAX engine's; the wide db's load engages the rung
    (``rung``), which gates fewer."""
    import imsame_tpu_torch.pipeline as tpipe

    rule = tpipe.rung_engages
    if not rung:
        monkeypatch.setattr(tpipe, "rung_engages", lambda F, load: False)
    q_codes, db_codes = _wide_regime(regime)
    jq, tq = _seqinfos(q_codes)
    jdb, tdb = _seqinfos(db_codes)
    jeng = TpuEngine(jdb, JConfig(mesh_shape=None))
    jres = jeng.compare(jq)
    jreport = jeng.render_report(jq, jres)
    jstages = dict(jeng.stage_stats)
    del jeng

    formats = []
    for name in ("flat_gate", "flat_gate_packed", "flat_gate_seg"):
        def spy(*a, _real=getattr(tpipe, name), _name=name, **k):
            formats.append((_name, isinstance(a[4], tuple)))
            return _real(*a, **k)
        monkeypatch.setattr(tpipe, name, spy)
    teng = TorchEngine(tdb, TConfig(), device="cpu")
    tres = teng.compare(tq)
    assert tres.pairs == jres.pairs
    stages = teng.stage_stats
    if rung:
        # The wide db holds 5.57 index entries a bucket, past the load at
        # which stage 1's capped window covers K + 1 k-mers: the rung
        # engages and the reads it resolves build no tails.  Stages 1 and
        # 3 are the JAX engine's; the rung and the tails gate fewer
        # candidates than its stage 2.
        assert dict(teng.timer.counts())["gate_rung_resolved"] > 0
        assert stages["s1"] == jstages["s1"]
        assert stages["s3"] == jstages["s3"]
        assert stages["s2w"][0] + stages["s2"][0] < jstages["s2"][0]
        assert tres.n_candidates < jres.n_candidates
    else:
        assert tres.n_candidates == jres.n_candidates
        assert stages == jstages
    assert teng.render_report(tq, tres) == jreport
    assert rule(teng.first_window(), teng.load()) == (regime == "wide_db")
    if regime == "wide_db":
        assert tdb.n_seqs >= PACKED_MAX_READS and jres.accepted >= 200
        assert teng.index.packed is None and not teng._packed_idx
        assert set(formats) == {("flat_gate_packed", True)}
    else:
        assert tq.n_seqs >= PACKED_MAX_READS and jres.accepted > 0
        assert teng._packed_idx
        assert set(formats) == {("flat_gate", False)}
    n_cands = tres.n_candidates
    del teng, tres

    steps = []
    for name in ("gate_step", "gate_step_routed", "gate_step_wide"):
        def step_spy(*a, _real=getattr(sharded, name), _name=name, **k):
            steps.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(sharded, name, step_spy)
    meng = TorchEngine(tdb, TConfig(mesh_shape=(2, 4)), device="cpu",
                       mesh_devices=["cpu"] * 8)
    mres = meng.compare(tq)
    assert mres.pairs == jres.pairs
    if rung:
        assert mres.n_candidates == n_cands
    else:
        assert mres.n_candidates == jres.n_candidates
    assert meng.stage_stats == stages
    assert meng.render_report(tq, mres) == jreport
    if regime == "wide_db":
        assert set(steps) == {"gate_step_routed"}
        for p, (pos, sid, db_start) in enumerate(meng._d_idx_tab):
            k = p % 4
            assert pos.shape == sid.shape == (meng._shard_rows,)
            n = len(meng.index.pos[k * meng._shard_rows:][:meng._shard_rows])
            np.testing.assert_array_equal(
                pos[:n].numpy(), meng.index.pos[k * meng._shard_rows:][:n])
    else:
        assert set(steps) == {"gate_step_wide"}


def test_config3_generator_is_bench_config3s():
    """chip_smoke.py's copy of bench_config3.synth makes the same reads."""
    args = (3000, 250, bench_config3.MATCH_FRAC, bench_config3.SUB_RATE, 99)
    for got, want in zip(chip_smoke.synth_config3(*args),
                         bench_config3.synth(*args)):
        np.testing.assert_array_equal(got, want)


def test_100k_generator_is_benchs():
    """chip_smoke.py's copy of bench.synth_pair makes phase 11's reads
    (bench.py large_bench's 100k x 100k workload)."""
    args = (chip_smoke.N_100K, 250, 0.5, 12345)
    for got, want in zip(chip_smoke.synth_pair(*args),
                         bench.synth_pair(*args)):
        np.testing.assert_array_equal(got, want)


def wide_anchors():
    """The JAX engine's (accepted, report sha256) on the CPU for
    chip_smoke.py's phase 8: the first 2,000 query reads of config-3's
    workload at N_WIDE reads a side against the whole database
    (REF_WIDE_DB_2K), and the whole query side against the first 2,000
    database reads (REF_WIDE_QUERY).  Takes minutes and ~10 GB.  Run:

        JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.',
        'tests']; import test_torch_scale as t; print(t.wide_anchors())"
    """
    qc, dbc = chip_smoke.synth_config3(
        chip_smoke.N_WIDE, *chip_smoke.CONFIG3_SHAPE)
    cfg = JConfig(mesh_shape=None, **chip_smoke.WIDE_CONFIG)
    out = {}
    for name, q, db in (("REF_WIDE_DB_2K", qc[:2000], dbc),
                        ("REF_WIDE_QUERY", qc, dbc[:2000])):
        jq, _ = _seqinfos(q)
        jdb, _ = _seqinfos(db)
        eng = TpuEngine(jdb, cfg)
        res = eng.compare(jq)
        out[name] = (res.accepted, hashlib.sha256(
            eng.render_report(jq, res)).hexdigest())
        del eng, res, jq, jdb
    return out


def hundredk_anchor():
    """The JAX engine's (accepted, report sha256) on the CPU for
    chip_smoke.py's phase 11: the first 2,000 query reads of bench.py
    large_bench's workload (synth_pair(100_000, 250, 0.5, seed=12345))
    against its whole database (REF_100K_2K).  Takes a few minutes.  Run:

        JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.',
        'tests']; import test_torch_scale as t; print(t.hundredk_anchor())"
    """
    qc, dbc = chip_smoke.synth_pair(chip_smoke.N_100K, 250, 0.5, seed=12345)
    jq, _ = _seqinfos(qc[:2000])
    jdb, _ = _seqinfos(dbc)
    eng = TpuEngine(jdb, JConfig(mesh_shape=None))
    res = eng.compare(jq)
    return {"REF_100K_2K": (res.accepted, hashlib.sha256(
        eng.render_report(jq, res)).hexdigest())}
