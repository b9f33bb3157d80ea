"""The port's multi-process runtime (imsame_tpu_torch.distributed) held
against the JAX package's: the single-process context does nothing, a
rendezvous with a dead peer fails within its timeout, the per-host query
stripes equal JAX's field by field and merge to the reference's thread
split (n_threads), and a REAL
4-process sweep -- the port's orchestrator with --distributed over a gloo
process group on localhost, engines on the CPU -- writes the
single-process port sweep's and the JAX sweep's files byte for byte, with
equal tallies.  (chip_smoke.py runs the same with two processes on the
card.)"""

import json
import os
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from imsame_tpu import distributed as jdist
from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import parse_fasta_bytes as jparse
from imsame_tpu.orchestrator import AllVsAllRunner as JRunner
from imsame_tpu.orchestrator import list_samples
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.distributed import (
    DistContext,
    allreduce_sum,
    init_distributed,
    read_offset_for_host,
    shard_query_for_host,
)
from imsame_tpu_torch.io.fasta import parse_fasta_bytes as tparse
from imsame_tpu_torch.pipeline import TorchEngine
from test_torch_sharded import plain_rows_once  # noqa: F401 (fixture)
from util_synth import make_pair, mutate, random_read

REPO = Path(__file__).resolve().parent.parent
# the port's sweep entry point on the CPU (tests ask for the CPU through
# main's keyword; the console script has no device flag)
PORT_MAIN = ("import sys; from imsame_tpu_torch.orchestrator import main; "
             "sys.exit(main(sys.argv[1:], device='cpu'))")


def test_single_process_degenerate(monkeypatch):
    for var in ("IMSAME_COORDINATOR", "IMSAME_NUM_PROCESSES",
                "IMSAME_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for ctx in (init_distributed(), init_distributed(num_processes=1)):
        assert ctx == DistContext(0, 1)
        assert not ctx.is_distributed
        assert allreduce_sum(7, ctx) == 7
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0)


def test_dead_peer_fails_within_timeout():
    """Rank 0 of a two-process group whose peer never starts raises once
    the rendezvous timeout passes, instead of hanging the run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        init_distributed(f"127.0.0.1:{port}", 2, 0, timeout_s=3)
    assert time.perf_counter() - t0 < 60
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n", [1, 3, 7, 8, 41])
def test_host_stripes_match_jax(tmp_path, n):
    """Every process's stripe and read offset at P = 1..4 processes, on odd
    and even read counts (stripes past the last read are empty), equal the
    JAX package's field by field; the stripes tile the reads in order, and
    each stripe's first base starts a fresh k-mer window."""
    qp, _ = make_pair(tmp_path, random.Random(n), n_query=n, n_db=1,
                      read_len=60)
    data = qp.read_bytes()
    jq, tq = jparse(data), tparse(data)
    for P in range(1, 5):
        codes = []
        for pid in range(P):
            jctx, tctx = jdist.DistContext(pid, P), DistContext(pid, P)
            want, got = (jdist.shard_query_for_host(jq, jctx),
                         shard_query_for_host(tq, tctx))
            for f in ("codes", "start", "fresh"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.headers == want.headers
            off = read_offset_for_host(n, tctx)
            assert off == jdist.read_offset_for_host(n, jctx)
            assert got.headers == tq.headers[off:off + got.n_seqs]
            if got.total_len:
                assert got.fresh[0]
            codes.append(got.codes)
        np.testing.assert_array_equal(np.concatenate(codes), tq.codes)
    assert shard_query_for_host(tq, DistContext(0, 1)) is tq


@pytest.mark.parametrize("P", [2, 4])
def test_host_sharding_matches_thread_split(tmp_path, plain_rows_once, P):
    """P host stripes of 40 reads (P divides it: ceil(n/P) host stripes ==
    floor(n/P) thread ranges): the union of per-host accepted pairs, offset
    back to global read ids, equals the port's single engine with
    n_threads=P and the JAX engine's -- host boundaries behave exactly
    like the reference's thread boundaries (src/alignmentFunctions.c:
    93-105)."""
    n = 40
    qp, dp = make_pair(tmp_path, random.Random(91), n_query=n, n_db=n,
                       read_len=150, sub_rate=0.05, indel_rate=0.02)
    q, db = tparse(qp.read_bytes()), tparse(dp.read_bytes())
    want = TorchEngine(db, TConfig(n_threads=P, mesh_shape=None),
                       device="cpu").compare(q).pairs
    jq, jdb = jparse(qp.read_bytes()), jparse(dp.read_bytes())
    assert want == TpuEngine(jdb, JConfig(n_threads=P, mesh_shape=None)
                             ).compare(jq).pairs
    eng = TorchEngine(db, TConfig(mesh_shape=None), device="cpu")
    got, total = set(), 0
    for pid in range(P):
        ctx = DistContext(pid, P)
        res = eng.compare(shard_query_for_host(q, ctx))
        off = read_offset_for_host(q.n_seqs, ctx)
        got |= {(r + off, s) for r, s in res.pairs}
        total += res.accepted
    assert got == set(want)
    assert total == len(want)


def _write_samples(d: Path, rng: random.Random, n_samples=3, n_reads=24):
    """Small related sample set so cross-sample pairs accept some reads."""
    base = [random_read(rng, 120) for _ in range(n_reads)]
    d.mkdir(exist_ok=True)
    for s in range(n_samples):
        lines = []
        for i, r in enumerate(base):
            seq = mutate(rng, r, sub_rate=0.04, indel_rate=0.01) if s else r
            lines.append(f">s{s}r{i}\n{seq}\n")
        (d / f"sample{s}.fasta").write_text("".join(lines))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # N small processes on a shared CPU
    for var in ("IMSAME_COORDINATOR", "IMSAME_NUM_PROCESSES",
                "IMSAME_PROCESS_ID"):
        env.pop(var, None)
    return env


ARGS = ("0.5", "0.5", "4", "fasta")


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The samples, the JAX sweep's outdir and the single-process port
    sweep's outdir (a subprocess of main(argv, device='cpu'))."""
    root = tmp_path_factory.mktemp("dist")
    samples = root / "samples"
    _write_samples(samples, random.Random(314))
    jax_out = root / "jax_out"
    JRunner(str(jax_out), JConfig(mesh_shape=None)).run(
        list_samples(str(samples), "fasta"))
    ref_out = root / "ref_out"
    r = subprocess.run(
        [sys.executable, "-c", PORT_MAIN, str(samples), *ARGS, str(ref_out)],
        env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    return samples, jax_out, ref_out


@pytest.mark.parametrize("nproc", [4])
def test_multiprocess_distributed_sweep(tmp_path, references, nproc):
    """nproc REAL processes of the port's orchestrator, --distributed over
    a gloo group on localhost: the merged sweep equals the single-process
    port sweep and the JAX sweep byte for byte, and every process prints
    the same allreduced total, the sum of the sweep's accepted counts."""
    samples, jax_out, ref_out = references
    env = _env()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist_out = tmp_path / "dist_out"
    procs = []
    for pid in range(nproc):
        penv = dict(env)
        penv["IMSAME_COORDINATOR"] = f"127.0.0.1:{port}"
        penv["IMSAME_NUM_PROCESSES"] = str(nproc)
        penv["IMSAME_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PORT_MAIN, str(samples), *ARGS,
             str(dist_out), "--distributed"],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    names = sorted(f.name for f in jax_out.glob("*.align"))
    assert len(names) == 6
    for d in (ref_out, dist_out):
        assert sorted(f.name for f in d.glob("*.align")) == names
        for name in names:
            assert (d / name).read_bytes() == (jax_out / name).read_bytes(), name
    want_total = sum(json.loads(p.read_text())["accepted"]
                     for p in jax_out.glob("*.align.json"))
    tallies = []
    for out in outs:
        for line in out.splitlines():
            if "Distributed sweep total accepted" in line:
                tallies.append(int(line.split(":")[1].split("(")[0]))
    assert tallies == [want_total] * nproc
    assert want_total > 0
