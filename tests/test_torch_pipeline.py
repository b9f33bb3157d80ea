"""End-to-end parity of the port's engine (imsame_tpu_torch TorchEngine on
the CPU, plain torch in place of the CUDA kernels) with the JAX engine
(imsame_tpu TpuEngine, single device): identical accepted pairs, counters
and report bytes.  These anchor on the JAX engine, so they run without the
reference binary.  Also: a JAX-saved index loaded by the port, the port's
CLI against the JAX CLI, and the port importing with jax blocked."""

import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imsame_tpu import cli as jcli
from imsame_tpu.config import Config as JConfig
from imsame_tpu.index.kmer import save_index
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch import cli as tcli
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.index.kmer import index_from_arrays, load_index
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.pipeline import (
    GATE_MAX_ELEMENTS, SHORT_WINDOW, TorchEngine, gate_chunk_sizes,
)
from imsame_tpu_torch.constants import MAX_READ_SIZE
from test_longreads import _make_long_pair
from util_synth import make_pair, random_read, write_fasta

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The engine's CPU tensors are small; more intra-op threads than two
    only contend with the JAX engine and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# the workloads and configs of tests/test_pipeline_parity.py
WORKLOADS = {
    "default": (21, None, dict(n_query=40, n_db=40, read_len=150,
                               sub_rate=0.05, indel_rate=0.02)),
    "heavy": (22, None, dict(n_query=30, n_db=30, read_len=140,
                             sub_rate=0.22, indel_rate=0.06)),
    "small_round": (23, {"first_window": 4, "gate_chunks": (64, 32),
                         "nw_stats_batches": (8,), "nw_render_batches": (8,)},
                    dict(n_query=25, n_db=25, read_len=150, sub_rate=0.08,
                         indel_rate=0.03)),
    "thresholds": (24, {"min_coverage": 0.3, "min_identity": 0.65,
                        "igap": -3, "egap": -1},
                   dict(n_query=25, n_db=25, read_len=150, sub_rate=0.12,
                        indel_rate=0.05)),
    "varied_lengths": (25, None, dict(n_query=30, n_db=30, read_len=120,
                                      sub_rate=0.06, indel_rate=0.12)),
}


def _synth_fastas(tmp_path, n, read_len, seed):
    """bench.py's workload (half the db reads ~4%-mutated query copies)
    written as FASTA."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    db = q[: n // 2].copy()
    mask = rng.random(db.shape) < 0.04
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate([db, rng.integers(0, 4, (n - n // 2, read_len), dtype=np.uint8)])
    db = db[rng.permutation(n)]
    chars = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for name, mat in (("q.fa", q), ("db.fa", db)):
        write_fasta(tmp_path / name, [chars[r].tobytes().decode() for r in mat])
        paths.append(tmp_path / name)
    return paths


def _run_both(qp, dp, cfg_kw=None, t_index=None):
    cfg_kw = cfg_kw or {}
    jq, jdb = jread_fasta(str(qp)), jread_fasta(str(dp))
    jeng = TpuEngine(jdb, JConfig(mesh_shape=None, **cfg_kw))
    jres = jeng.compare(jq)
    tq, tdb = tread_fasta(str(qp)), tread_fasta(str(dp))
    teng = TorchEngine(tdb, TConfig(**cfg_kw), index=t_index, device="cpu")
    tres = teng.compare(tq)
    return (jeng, jq, jres), (teng, tq, tres)


def _assert_same(j, t):
    (jeng, jq, jres), (teng, tq, tres) = j, t
    assert tres.accepted == jres.accepted
    assert tres.jaccard == jres.jaccard
    assert tres.pairs == jres.pairs
    assert tres.n_candidates == jres.n_candidates
    assert tres.nw_cells == jres.nw_cells
    assert teng.render_report(tq, tres) == jeng.render_report(jq, jres)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_engine_matches_jax(tmp_path, name):
    seed, cfg_kw, pair_kw = WORKLOADS[name]
    qp, dp = make_pair(tmp_path, random.Random(seed), **pair_kw)
    j, t = _run_both(qp, dp, cfg_kw)
    assert t[2].accepted > 0
    _assert_same(j, t)


@pytest.mark.parametrize("path", ["small_tier", "two_word_gate", "no_native"])
def test_engine_paths_match_jax(tmp_path, monkeypatch, path):
    """Paths the default workloads do not take: the gate's small-window
    first tier with escalation of inexact candidates (large stages only),
    the two-word candidate encoding (indexes too large for the segment
    words), and the numpy paths taken when the native library cannot be
    built (ingest, index, k-mer stream, candidates, seg encoding, render)."""
    import imsame_tpu_torch.native as tnative
    import imsame_tpu_torch.pipeline as tpipe

    if path == "small_tier":
        monkeypatch.setattr(tpipe, "SMALL_TIER_MIN_CANDIDATES", 0)
    elif path == "two_word_gate":
        monkeypatch.setattr(tpipe, "SEG_MAX_INDEX_ROWS", 0)
    else:
        monkeypatch.setattr(tnative, "load", lambda: None)
        assert tnative.lib is None
    qp, dp = make_pair(tmp_path, random.Random(27), n_query=30, n_db=30,
                       read_len=100, sub_rate=0.05, indel_rate=0.02)
    _assert_same(*_run_both(qp, dp))


def test_engine_matches_jax_empty_first_reads(tmp_path):
    """Both samples open with an empty read: read 0 fills every NW
    batch's padding pairs, so the aligners see zero-length reads."""
    qp, dp = make_pair(tmp_path, random.Random(41), n_query=20, n_db=20,
                       read_len=100, sub_rate=0.05, indel_rate=0.02)
    for p in (qp, dp):
        p.write_text(">empty\n" + p.read_text())
    j, t = _run_both(qp, dp)
    assert t[1].read_lens()[0] == 0 and t[2].accepted > 0
    _assert_same(j, t)


def test_engine_matches_jax_bench_workload(tmp_path):
    """256 reads of bench.py's 250 bp workload (length bucket 256)."""
    qp, dp = _synth_fastas(tmp_path, 256, 250, seed=12345)
    j, t = _run_both(qp, dp)
    assert t[2].accepted >= 128
    _assert_same(j, t)


def test_jax_saved_index_loads_in_port(tmp_path):
    qp, dp = make_pair(tmp_path, random.Random(31), n_query=30, n_db=30,
                       read_len=120, sub_rate=0.05, indel_rate=0.02)
    j, _ = _run_both(qp, dp)
    ji = j[0].index
    save_index(ji, str(tmp_path / "idx.npz"))
    tdb, tq = tread_fasta(str(dp)), tread_fasta(str(qp))
    loaded = load_index(str(tmp_path / "idx.npz"), db_start=tdb.start)
    from_arrays = index_from_arrays(
        ji.bucket_start, ji.keys, packed=ji.packed,
        db_total_len=ji.db_total_len, db_n_seqs=ji.db_n_seqs,
        db_start=tdb.start,
    )
    for idx in (loaded, from_arrays):
        np.testing.assert_array_equal(idx.bucket_start, ji.bucket_start)
        np.testing.assert_array_equal(idx.pos, ji.pos)
        np.testing.assert_array_equal(idx.sid, ji.sid)
        teng = TorchEngine(tdb, TConfig(), index=idx, device="cpu")
        assert teng.index is idx
        _assert_same(j, (teng, tq, teng.compare(tq)))


# Timing values differ run to run -- mask the numeric field of every
# "%e seconds" occurrence before comparing stdout.
TIME_RE = re.compile(r"\d\.\d{6}e[+-]\d{2,3}(?= seconds)")


def test_cli_matches_jax_cli(tmp_path, capsys):
    qp, dp = make_pair(tmp_path, random.Random(6), n_query=25, n_db=25,
                       read_len=100, sub_rate=0.05, indel_rate=0.02)
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}), ("torch", tcli.main, {"device": "cpu"})):
        rc = main(["-query", str(qp), "-db", str(dp), "-n_threads", "1",
                   "-out", str(tmp_path / f"{name}.align"), "--verbose"], **kw)
        assert rc == 0
        info = [TIME_RE.sub("<t>", ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[INFO]")]
        # the --verbose line carries rates; keep its counters only
        outs[name] = [re.sub(r"\(.*", "", ln) if "seed candidates" in ln else ln
                      for ln in info]
    assert outs["torch"] == outs["jax"]
    assert any("Jaccard-index" in ln for ln in outs["torch"])
    assert (tmp_path / "torch.align").read_bytes() == (tmp_path / "jax.align").read_bytes()
    assert (tmp_path / "torch.align").stat().st_size > 0


def test_cli_help_and_flags():
    assert tcli.REFERENCE_HELP == jcli.REFERENCE_HELP
    args = tcli.build_parser().parse_args(
        ["-query", "q", "-db", "d", "-igap", "3", "-egap", "1"]
    )
    cfg = tcli.config_from_args(args)
    assert cfg.igap == -3 and cfg.egap == -1


def test_engine_matches_jax_long_reads(tmp_path):
    """Reads of 300..3000 bp, the exact 3000 bp cap included: length
    buckets 512, 2048 and 3072, the gate's small-window tier at a 3072
    window, and render chunks of 8 pairs (tests/test_longreads.py's
    config: stats batches of 8, a 64 MiB render budget)."""
    qp, dp = _make_long_pair(tmp_path, random.Random(77))
    j, t = _run_both(qp, dp, {"nw_stats_batches": (8,),
                              "nw_render_bp_budget": 64 << 20})
    assert t[2].accepted >= 3
    assert max(t[1].read_lens()) == MAX_READ_SIZE
    _assert_same(j, t)


@pytest.mark.parametrize("extra", [40, 100])
def test_read_above_cap_raises_like_jax(tmp_path, extra):
    """A read past MAX_READ_SIZE aborts with the reference's error: in the
    gapped aligner's chunking (3040 bp, still inside the 3072 bucket), or
    at engine construction for a db read past the largest bucket (3100
    bp)."""
    base = random_read(random.Random(5), MAX_READ_SIZE + extra)
    write_fasta(tmp_path / "q.fa", [base], "q")
    write_fasta(tmp_path / "db.fa", [base], "d")
    qp, dp = str(tmp_path / "q.fa"), str(tmp_path / "db.fa")
    for run in (
        lambda: TpuEngine(jread_fasta(dp), JConfig(mesh_shape=None))
        .compare(jread_fasta(qp)),
        lambda: TorchEngine(tread_fasta(dp), device="cpu")
        .compare(tread_fasta(qp)),
    ):
        with pytest.raises(ValueError, match="Read size reached"):
            run()


@pytest.mark.parametrize("budget", [2 << 30, 64 << 20])
def test_render_ladder_matches_jax(tmp_path, budget):
    """Per length bucket the render ladder keeps B * 8L^2 under the
    budget, in multiples of 8 pairs, exactly as the JAX engine's (24 and
    8 pairs at 3072 under the default 2 GiB)."""
    qp, dp = make_pair(tmp_path, random.Random(8), n_query=2, n_db=2,
                       read_len=100)
    jeng = TpuEngine(jread_fasta(str(dp)),
                     JConfig(mesh_shape=None, nw_render_bp_budget=budget))
    teng = TorchEngine(tread_fasta(str(dp)),
                       TConfig(nw_render_bp_budget=budget), device="cpu")
    for L in teng.cfg.length_buckets:
        sizes = teng._render_sizes(L)
        assert sizes == jeng._render_sizes(L), L
        assert all(b % 8 == 0 for b in sizes)
        assert sizes[0] * 8 * L * L <= max(budget, 8 * 8 * L * L), (L, sizes)
        assert list(sizes) == sorted(sizes, reverse=True)
    if budget == 2 << 30:
        assert teng._render_sizes(3072) == (24, 8)
        assert teng._render_sizes(2048) == (64, 8)


@pytest.mark.parametrize("window", [64, 128, 256, 512, 3072])
def test_gate_chunk_sizes(window):
    """Up to the 256 window the gate chunks are the configured ones, as in
    the JAX engine; past it the largest chunk keeps chunk x window under
    GATE_MAX_ELEMENTS, in multiples of 32."""
    chunks = TConfig().gate_chunks
    assert chunks == JConfig().gate_chunks
    sizes = gate_chunk_sizes(chunks, window)
    assert sizes == sorted(sizes, reverse=True)
    assert all(z % 32 == 0 for z in sizes)
    if window <= SHORT_WINDOW:
        assert sizes == sorted(chunks, reverse=True)
    else:
        assert sizes[0] * window <= GATE_MAX_ELEMENTS
        assert sizes[0] + 32 > GATE_MAX_ELEMENTS // window
    if window == 3072:
        assert sizes == [87_360, 1 << 16]


def test_native_source_is_the_ports_own():
    """The host runtime is compiled from the port's own copy of host.c,
    never from a file of the JAX package."""
    import imsame_tpu_torch
    import imsame_tpu_torch.native as tnative

    src = Path(tnative.SRC).resolve()
    assert src.is_relative_to(Path(imsame_tpu_torch.__file__).resolve().parent)
    assert src.is_file()


def test_port_imports_without_jax(tmp_path):
    """The port never imports jax or imsame_tpu: with both blocked it
    imports (the sweep's, the mesh's, the dry run's and the scaling scan's
    modules included) and runs a tiny compare on the CPU, on one device and
    on a (1, 2) mesh."""
    qp, dp = make_pair(tmp_path, random.Random(9), n_query=6, n_db=6,
                       read_len=100)
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["imsame_tpu"] = None
from imsame_tpu_torch.io.fasta import read_fasta
from imsame_tpu_torch.pipeline import TorchEngine
from imsame_tpu_torch import (
    bench_scaling, distributed, dryrun, orchestrator, revcomp,
)
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.parallel import mesh, sharded
eng = TorchEngine(read_fasta({str(dp)!r}), device="cpu")
q = read_fasta({str(qp)!r})
res = eng.compare(q)
report = eng.render_report(q, res)
assert res.accepted == 3 and report
eng = TorchEngine(read_fasta({str(dp)!r}), Config(mesh_shape=(1, 2)),
                  device="cpu", mesh_devices=["cpu"] * 2)
res = eng.compare(q)
assert res.accepted == 3 and eng.render_report(q, res) == report
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "imsame_tpu.")) or m == "imsame_tpu"]
assert all(sys.modules[m] is None for m in bad), bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
