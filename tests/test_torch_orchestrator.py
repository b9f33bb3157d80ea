"""The port's all-vs-all sweep (imsame_tpu_torch.orchestrator, engines on
the CPU with the kernels' plain torch versions) held against the JAX
package's (imsame_tpu.orchestrator, single device): the same jobs,
byte-equal reports and stats equal apart from wall seconds; resume, host
striping, failure isolation in the compare and in the render, the engine
LRU and the index cache (a JAX sweep's cache included), a render deferred
past the next compare on the same engine, the revcomp tool, the console
scripts, and the reverse-complement anchor that chip_smoke.py holds the
card to."""

import collections
import importlib
import json
import random
import tomllib
from pathlib import Path

import pytest
import torch

from chip_smoke import (
    RC_READS, REF_SWEEP_RC, report_digests, write_rc_samples,
)
from imsame_tpu import revcomp as jrevcomp
from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import parse_fasta_bytes as jparse_fasta_bytes
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.io.fasta import revcomp_fasta_bytes as jrevcomp_fasta_bytes
from imsame_tpu.orchestrator import AllVsAllRunner as JRunner
from imsame_tpu.orchestrator import make_jobs as jmake_jobs
from imsame_tpu.orchestrator import main as jmain
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch import orchestrator as torch_orch
from imsame_tpu_torch import revcomp as trevcomp
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.index.kmer import build_index
from imsame_tpu_torch.io.fasta import (
    parse_fasta_bytes, read_fasta, revcomp_fasta_bytes,
)
from imsame_tpu_torch.orchestrator import AllVsAllRunner, list_samples, make_jobs
from imsame_tpu_torch.pipeline import TorchEngine
from util_synth import mutate, random_read, write_fasta

REPO = Path(__file__).resolve().parent.parent
_COMP = str.maketrans("ACGT", "TGCA")
# NW batch ladders of a few pairs, on both sides: the default ladders pad
# each chunk of these small samples to 256 pairs, which the plain torch
# aligners compute in full on the CPU.  Reports do not depend on them.
SMALL = dict(nw_stats_batches=(32, 8), nw_render_batches=(32, 8))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The engines' CPU tensors are small; more intra-op threads than two
    only contend with the JAX engine and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def write_samples(d: Path, rng: random.Random, n_samples=3, n_reads=12,
                  read_len=120):
    """Related samples: read i is a mutated copy of base read i in every
    sample when i % 3 == 0, a forward copy in even samples and a reverse
    complemented one in odd samples when i % 3 == 1, and random otherwise;
    so forward and revcomp jobs both accept reads."""
    d.mkdir()
    base = [random_read(rng, read_len) for _ in range(n_reads)]
    for s in range(n_samples):
        reads = []
        for i, r in enumerate(base):
            m = mutate(rng, r, sub_rate=0.04, indel_rate=0.01)
            if i % 3 == 0 or (i % 3 == 1 and s % 2 == 0):
                reads.append(m)
            elif i % 3 == 1:
                reads.append(m.translate(_COMP)[::-1])
            else:
                reads.append(random_read(rng, read_len))
        write_fasta(d / f"s{s}.fasta", reads, prefix=f"s{s}r")
    return list_samples(str(d), "fasta")


def no_seconds(entry: dict) -> dict:
    return {k: v for k, v in entry.items() if k != "seconds"}


def strip_seconds(stats: dict) -> dict:
    return {name: no_seconds(e) for name, e in stats.items()}


def assert_same_sweep(jdir: Path, tdir: Path, jstats: dict, tstats: dict):
    """Every report byte-equal and every stats entry (returned and in its
    .json file) equal apart from seconds."""
    names = sorted(p.name for p in jdir.glob("*.align"))
    assert names == sorted(p.name for p in tdir.glob("*.align"))
    assert sorted(jstats) == names
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
        jfile, tfile = (json.loads((d / f"{name}.json").read_text())
                        for d in (jdir, tdir))
        assert no_seconds(tfile) == no_seconds(jfile), name
    assert strip_seconds(tstats) == strip_seconds(jstats)


def run_jax(out: Path, samples, **kw):
    runner = JRunner(str(out), JConfig(mesh_shape=None, **SMALL), **kw)
    return runner, runner.run(samples)


def run_port(out: Path, samples, **kw):
    runner = AllVsAllRunner(str(out), TConfig(**SMALL), device="cpu", **kw)
    return runner, runner.run(samples)


def test_job_names_match_jax(tmp_path):
    samples = write_samples(tmp_path / "samples", random.Random(0))
    names = [j.out_name for j in make_jobs(samples)]
    assert names == [j.out_name for j in jmake_jobs(samples)]
    # reference script: for i<j, X-Y.align and X-Y.r.align (sh:35-48)
    assert names == [
        "s0-s1.align", "s0-s1.r.align",
        "s0-s2.align", "s0-s2.r.align",
        "s1-s2.align", "s1-s2.r.align",
    ]


@pytest.mark.parametrize("n_samples,n_reads", [(3, 12), (4, 24)])
def test_sweep_matches_jax(tmp_path, n_samples, n_reads):
    samples = write_samples(tmp_path / "samples", random.Random(n_reads),
                            n_samples, n_reads)
    _, jstats = run_jax(tmp_path / "jax", samples)
    runner, tstats = run_port(tmp_path / "torch", samples)
    assert runner.failures == {}
    assert len(tstats) == n_samples * (n_samples - 1)
    assert any(e["accepted"] for e in tstats.values() if e["reverse"])
    assert any(e["accepted"] for e in tstats.values() if not e["reverse"])
    assert_same_sweep(tmp_path / "jax", tmp_path / "torch", jstats, tstats)


def test_main_matches_jax_main(tmp_path, capsys):
    """The console scripts' argument lists and printed lines (default
    Config, as the scripts build it)."""
    samples_dir = tmp_path / "samples"
    write_samples(samples_dir, random.Random(4))
    lines = {}
    for name, main, kw in (("jax", jmain, {}),
                           ("torch", torch_orch.main, {"device": "cpu"})):
        assert main([str(samples_dir), "0.5", "0.5", "4", "fasta",
                     str(tmp_path / name)], **kw) == 0
        lines[name] = capsys.readouterr().out.splitlines()
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 6
    for p in (tmp_path / "jax").glob("*.align"):
        assert (tmp_path / "torch" / p.name).read_bytes() == p.read_bytes()


def test_resume_keeps_existing(tmp_path):
    samples = write_samples(tmp_path / "samples", random.Random(2), 2)
    out = tmp_path / "o"
    _, first = run_port(out, samples)
    marker = out / "s0-s1.align"
    marker.write_bytes(b"SENTINEL")
    runner, again = run_port(out, samples)
    assert marker.read_bytes() == b"SENTINEL"
    assert again == first and len(runner._engines) == 0


def test_host_striping_partitions_jobs(tmp_path):
    samples = write_samples(tmp_path / "samples", random.Random(3))
    stripes = []
    for h in range(2):
        _, jstats = run_jax(tmp_path / f"j{h}", samples, host_id=h, n_hosts=2)
        _, tstats = run_port(tmp_path / f"t{h}", samples, host_id=h,
                             n_hosts=2)
        assert_same_sweep(tmp_path / f"j{h}", tmp_path / f"t{h}", jstats,
                          tstats)
        stripes.append(set(tstats))
    assert stripes[0] | stripes[1] == {j.out_name for j in make_jobs(samples)}
    assert not (stripes[0] & stripes[1])


@pytest.mark.parametrize("side", ["compare", "render"])
def test_failure_isolation(tmp_path, monkeypatch, side):
    """A job that raises, in its compare or in its render, must not kill
    the sweep: it is recorded in failures and failures.host0.json and
    leaves no report (so a resumed run retries it); the other job
    completes."""
    d = tmp_path / "samples"
    d.mkdir()
    (d / "a.fasta").write_text(">r0\nACGTACGTACGTACGTACGT\n")
    (d / "b.fasta").write_text(">r0\nACGTACGTACGTACGTACGT\n")
    out = tmp_path / "out"
    runner = AllVsAllRunner(str(out), TConfig(**SMALL), device="cpu")
    orig_engine_for = runner._engine_for
    if side == "compare":
        def engine_for(job):
            if job.reverse:
                raise RuntimeError("injected device failure")
            return orig_engine_for(job)
    else:
        orig_render = TorchEngine.render_report

        def render(self, q, result, dev=None):
            if getattr(self, "_boom", False):
                raise RuntimeError("injected render failure")
            return orig_render(self, q, result, dev=dev)

        monkeypatch.setattr(TorchEngine, "render_report", render)

        def engine_for(job):
            eng = orig_engine_for(job)
            eng._boom = job.reverse
            return eng

    runner._engine_for = engine_for
    stats = runner.run(list_samples(str(d), "fasta"))
    assert "a-b.align" in stats
    assert "a-b.r.align" not in stats
    assert runner.failures["a-b.r.align"].startswith("RuntimeError")
    failp = out / "failures.host0.json"
    assert json.loads(failp.read_text())["a-b.r.align"].startswith("RuntimeError")
    assert not (out / "a-b.r.align").exists()


@pytest.mark.parametrize("max_engines", [1, 2])
def test_engine_lru_bound_and_index_persistence(tmp_path, max_engines):
    """A sweep holds at most max_engines engines; each (db sample, strand)
    index is built once into .index/ and reloaded on resume, where a
    fresh runner builds no engine."""
    rng = random.Random(5)
    d = tmp_path / "samples"
    d.mkdir()
    for i in range(4):
        write_fasta(d / f"s{i}.fasta", [random_read(rng, 150) for _ in range(6)])
    samples = list_samples(str(d), "fasta")
    out = tmp_path / "out"
    runner, first = run_port(out, samples, max_engines=max_engines)
    assert len(runner._engines) <= max_engines
    idx_files = sorted(p.name for p in (out / ".index").glob("*.npz"))
    assert idx_files == sorted({f"{j.dbname}{'.r' if j.reverse else ''}.npz"
                                for j in make_jobs(samples)})
    runner2, again = run_port(out, samples, max_engines=max_engines)
    assert len(runner2._engines) == 0
    assert again == first and len(again) == 12


def test_port_sweep_on_jax_index_cache(tmp_path, monkeypatch):
    """A port sweep resumed in a JAX sweep's outdir loads the JAX index
    cache (.index/*.npz, the same format) instead of building, and gives
    the JAX reports."""
    samples = write_samples(tmp_path / "samples", random.Random(6))
    out = tmp_path / "out"
    _, jstats = run_jax(out, samples)
    want = {p.name: p.read_bytes() for p in out.glob("*.align")}
    for p in list(out.glob("*.align")) + list(out.glob("*.json")):
        p.unlink()

    def no_build(db):
        raise AssertionError("the port rebuilt a cached index")

    monkeypatch.setattr(torch_orch, "build_index", no_build)
    runner, tstats = run_port(out, samples)
    assert runner.failures == {}
    assert {p.name: p.read_bytes() for p in out.glob("*.align")} == want
    assert strip_seconds(tstats) == strip_seconds(jstats)


@pytest.mark.parametrize("reverse", [False, True])
def test_deferred_render_on_shared_engine(tmp_path, reverse):
    """A render run after the next compare on the same engine (as jobs
    s0-s2 and s1-s2 share db s2): the first job's render with its dev=
    snapshot, and the second's without one, both give the serial reports
    of the JAX engine; on db s2 and on its reverse complement."""
    samples = dict(write_samples(tmp_path / "samples", random.Random(7),
                                 n_samples=4, n_reads=24))
    # odd samples hold the reverse-complemented copies that accept on
    # revcomp(s2)
    q_names = ("s1", "s3") if reverse else ("s0", "s1")
    raw = samples["s2"].read_bytes()
    if reverse:
        db = parse_fasta_bytes(revcomp_fasta_bytes(raw))
        jdb = jparse_fasta_bytes(jrevcomp_fasta_bytes(raw))
    else:
        db, jdb = parse_fasta_bytes(raw), jparse_fasta_bytes(raw)
    qs = [read_fasta(str(samples[n])) for n in q_names]
    eng = TorchEngine(db, TConfig(**SMALL), device="cpu")
    res1 = eng.compare(qs[0])
    dev1 = eng._last_dev
    res2 = eng.compare(qs[1])
    assert res1.accepted and res2.accepted
    got = [eng.render_report(qs[0], res1, dev=dev1),
           eng.render_report(qs[1], res2)]
    assert got[0] != got[1]
    jeng = TpuEngine(jdb, JConfig(mesh_shape=None, **SMALL))
    for q_name, report in zip(q_names, got):
        jq = jread_fasta(str(samples[q_name]))
        assert report == jeng.render_report(jq, jeng.compare(jq)), q_name


SWEEP_PHASES = {f"sweep.{p}" for p in (
    "read", "revcomp", "index", "engine", "compare", "render", "write",
    "save_wait")}


def test_sweep_phases_and_counters(tmp_path):
    """A 4-sample sweep at max_engines=2 times every sweep.* phase and
    counts its 12 jobs, 6 engines and 6 index builds, their entries, and
    every byte that lands in the outdir; its engines' summed counters,
    though the LRU evicted four engines, are those of the 12 compares run
    through one fresh engine a (db, strand) given its index, construction
    included.  Rerun on the kept cache after its reports and stats are
    deleted, it loads the 6 indexes, builds none, writes only reports and
    stats, and gives the same stats."""
    samples = write_samples(tmp_path / "samples", random.Random(8),
                            n_samples=4, n_reads=24)
    out = tmp_path / "out"
    runner, stats = run_port(out, samples)
    assert runner.failures == {} and len(stats) == 12
    assert set(dict(runner.timer.items())) == SWEEP_PHASES
    counts = dict(runner.timer.counts())
    landed = [p for p in out.rglob("*") if p.is_file()]
    assert len([p for p in landed if p.suffix == ".npz"]) == 6
    built = counts.pop("index_built_entries")
    assert counts == {
        "sweep_jobs": 12, "sweep_engine_builds": 6, "sweep_index_builds": 6,
        "sweep_bytes_written": sum(p.stat().st_size for p in landed)}

    want, engines = collections.Counter(), {}
    for job in make_jobs(samples):
        key = (job.dbname, job.reverse)
        if key not in engines:
            raw = job.dbpath.read_bytes()
            db = parse_fasta_bytes(revcomp_fasta_bytes(raw) if job.reverse
                                   else raw)
            engines[key] = TorchEngine(db, TConfig(**SMALL),
                                       index=build_index(db), device="cpu")
        q = read_fasta(str(job.qpath))
        engines[key].render_report(q, engines[key].compare(q))
    for eng in engines.values():
        want.update(dict(eng.timer.counts()))
    assert built == sum(eng.index.n_entries for eng in engines.values()) > 0
    assert want["nw_launched_cells"] and want["gate_built_cands"]
    assert dict(runner.engine_counts) == dict(want)
    assert {"engine", "compare", "render_report"} <= set(
        runner.engine_timings)

    for p in list(out.glob("*.align")) + list(out.glob("*.json")):
        p.unlink()
    runner2, again = run_port(out, samples)
    counts2 = dict(runner2.timer.counts())
    assert counts2["sweep_index_loads"] == 6
    assert "sweep_index_builds" not in counts2
    assert "index_built_entries" not in counts2
    assert counts2["sweep_engine_builds"] == 6
    assert counts2["sweep_bytes_written"] == sum(
        p.stat().st_size for p in out.iterdir() if p.is_file())
    assert strip_seconds(again) == strip_seconds(stats)


def test_sweep_phases_are_profiler_ranges(tmp_path):
    """Under a recording torch profiler each sweep.* phase is an
    imsame.sweep.* range (read off the profiler's raw events: its
    key_averages take minutes over a sweep's CPU ops)."""
    samples = write_samples(tmp_path / "samples", random.Random(9),
                            n_samples=2, n_reads=6)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        runner, _ = run_port(tmp_path / "out", samples)
    assert runner.failures == {}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"imsame." + p for p in SWEEP_PHASES} <= names


REVCOMP_INPUTS = {
    "mixed": ">a desc\nACGTacgtNU\nGGT\n>empty\n>b\nTTnna\n",
    "crlf": ">x\r\nACGT\r\nAAC\r\n>y\r\nG\r\n",
    "no_final_newline": ">x\nACGTT\n>y\nCCA",
    "iupac": ">x\nRYKMSWBDHVN\nacgtn\n",
    "empty_last": ">x\nAC\n>y\n",
}


@pytest.mark.parametrize("name", sorted(REVCOMP_INPUTS))
def test_revcomp_main_matches_jax(tmp_path, name):
    fa = tmp_path / "in.fa"
    fa.write_text(REVCOMP_INPUTS[name])
    outs = []
    for tag, mod in (("jax", jrevcomp), ("torch", trevcomp)):
        out = tmp_path / f"{tag}.fa"
        assert mod.main([str(fa), str(out)]) == 0
        assert mod.main([str(fa)]) == 1
        outs.append(out.read_bytes())
    assert outs[1] == outs[0]
    if name == "mixed":
        assert outs[1].startswith(b">b\ntnnAA\n")


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_chip_smoke_rc_anchor(tmp_path, side):
    """The reverse-complement anchor of chip_smoke.py: the JAX sweep and
    the port's (on the CPU) give its stored counts and report hashes, and
    four .r jobs accept reads."""
    samples = write_rc_samples(tmp_path / "samples", RC_READS)
    run = run_jax if side == "jax" else run_port
    runner, stats = run(tmp_path / "out", samples)
    assert runner.failures == {}
    assert report_digests(tmp_path / "out", sorted(stats)) == REF_SWEEP_RC
    assert sum(1 for k, (a, _) in REF_SWEEP_RC.items()
               if ".r." in k and a) == 4


def test_console_scripts_resolve():
    """Every console script of pyproject.toml names a callable; the port's
    three stand beside the JAX package's."""
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, target in scripts.items():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn)), name
    assert {k: v for k, v in scripts.items() if "torch" in k} == {
        "imsame-tpu-torch": "imsame_tpu_torch.cli:main",
        "imsame-tpu-torch-revcomp": "imsame_tpu_torch.revcomp:main",
        "imsame-tpu-torch-all-vs-all": "imsame_tpu_torch.orchestrator:main",
    }
