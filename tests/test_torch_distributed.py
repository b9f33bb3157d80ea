"""The port's multi-process runtime (imsame_tpu_torch.distributed) held
against the JAX package's: the single-process context does nothing, a
rendezvous with a dead peer fails within its timeout, and a REAL
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

import pytest
import torch

from imsame_tpu.config import Config as JConfig
from imsame_tpu.orchestrator import AllVsAllRunner as JRunner
from imsame_tpu.orchestrator import list_samples
from imsame_tpu_torch.distributed import (
    DistContext,
    allreduce_sum,
    init_distributed,
)
from util_synth import mutate, random_read

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
