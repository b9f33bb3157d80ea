"""Smoke test of the PyTorch/CUDA port (imsame_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. device  -- requires torch.cuda; prints the card's name and power limit
                (nvidia-smi) and the torch / CUDA versions.
  2. build   -- compiles the native host runtime (gcc) and both NW kernels
                (nvcc, sm_90a) from this checkout; prints each build's
                seconds and the ptxas register report.
  3. kernels -- nw_stats and nw_forward against their plain torch versions
                on the same CUDA tensors (seeded mixed pairs, lengths
                2..256, L = 256) at the batch sizes the compare path uses,
                and on pairs with empty and 1-base reads; every output
                must be exactly equal (integer DP); times both with CUDA
                events.
  4. slice   -- TorchEngine(db, Config(), device="cuda").compare(q) and
                render_report on the 20k x 20k, 250 bp bench workload
                (bench.py synth_pair(20000, 250, 0.5, seed=12345)): must
                accept 10,005 reads with both kernels launched; then the
                first 2,000 query reads against the same database, whose
                report must hash to the JAX engine's (REF_2K_SHA256).

The last two lines are a JSON object with each kernel's launches on the
20k compare + render, error and times, then {"ok": true, "device": ...}.
"""

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from imsame_tpu_torch import native
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.io.fasta import SeqInfo
from imsame_tpu_torch.ops import nw, nw_cuda
from imsame_tpu_torch.pipeline import TorchEngine

# sha256 of the report written by the JAX engine,
# imsame_tpu.pipeline.TpuEngine(db, Config(mesh_shape=None)) on the CPU, for
# the first 2,000 query reads of synth_pair(20000, 250, 0.5, seed=12345)
# against all 20,000 database reads (2,000 accepted, 1,599,831 bytes).
REF_2K_SHA256 = "36add83ee0c8ca80d331cf320f306c446ee44e4d28c43c93e18a762f1aded995"
REF_2K_ACCEPTED = 2000
ACCEPTED_20K = 10005  # the JAX engine's count on the whole workload
L = 256
IGAP, EGAP = -5, -2


def synth_pair(n: int, read_len: int, match_frac: float, seed: int):
    """bench.py's workload: n random query reads; match_frac of the db
    reads are ~4%-mutated copies of query reads, the rest random."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < 0.04
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
    )
    perm = rng.permutation(n)
    return q, db[perm]


def codes_to_seqinfo(reads: np.ndarray) -> SeqInfo:
    n, rl = reads.shape
    start = np.arange(n, dtype=np.int64) * rl
    fresh = np.zeros(n * rl, bool)
    fresh[start] = True
    return SeqInfo(
        codes=reads.reshape(-1).copy(), start=start, fresh=fresh,
        headers=[b""] * n,
    )


def mixed_pairs(rng, B: int):
    """Half mutated copies (substitutions, some with a shifted suffix that
    forces gap moves), half random; lengths 2..L, both ends included."""
    xlen = rng.integers(2, L + 1, B).astype(np.int32)
    ylen = rng.integers(2, L + 1, B).astype(np.int32)
    xlen[:4] = (2, L, 2, L)
    ylen[:4] = (2, L, L, 2)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(4, B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b]
        mut = rng.random(L) < 0.08
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 3 == 0 and xlen[b] > 8:
            cut = int(rng.integers(4, xlen[b] - 4))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 4)))
    dev = torch.device("cuda")
    return (
        torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(xlen, device=dev), torch.as_tensor(ylen, device=dev),
    )


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    errs = [int((a.long() - b.long()).abs().max()) for a, b in zip(got, want)]
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel differs from plain: max err {max(errs)}")
    return max(errs)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}"
    )
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    native.build()
    if native.load() is None:
        raise RuntimeError("native host library did not load")
    print(f"build host.c (gcc): {time.perf_counter() - t0:.2f} s")
    info = nw_cuda.build()
    print(f"build nw kernels (nvcc sm_90a): {info['seconds']:.2f} s")
    print(info["log"].strip())


def phase_kernels() -> dict:
    """Each kernel against its plain version, bit for bit."""
    rng = np.random.default_rng(20260)
    # degenerate pairs: an empty read can be read 0 of a sample, and read
    # 0 fills the padding pairs of every NW batch
    X, Y, xlen, ylen = mixed_pairs(rng, 4)
    xlen[:] = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    ylen[:] = torch.tensor([0, 7, 1, L], dtype=torch.int32)
    for wrapped, plain in ((nw_cuda.nw_stats, nw.nw_stats_batch),
                           (nw_cuda.nw_forward, nw.nw_forward_batch)):
        max_abs_err(wrapped(X, Y, xlen, ylen, IGAP, EGAP, max_len=L),
                    plain(X, Y, xlen, ylen, IGAP, EGAP, max_len=L))
    print("degenerate pairs (lengths 0 and 1): equal")
    out = {}
    for B in (256, 2048, 32768):
        args = mixed_pairs(rng, B)
        got = nw_cuda.nw_stats(*args, IGAP, EGAP, max_len=L)
        want = nw.nw_stats_batch(*args, IGAP, EGAP, max_len=L)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: nw_cuda.nw_stats(*args, IGAP, EGAP, max_len=L), 10)
        plain_ms = cuda_ms(
            lambda: nw.nw_stats_batch(*args, IGAP, EGAP, max_len=L), 2
        )
        print(f"nw_stats   L={L} B={B}: equal, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        out["nw_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, B=B)
    for B in (256, 2048):
        args = mixed_pairs(rng, B)
        got = nw_cuda.nw_forward(*args, IGAP, EGAP, max_len=L)
        want = nw.nw_forward_batch(*args, IGAP, EGAP, max_len=L)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        del got, want
        ms = cuda_ms(lambda: nw_cuda.nw_forward(*args, IGAP, EGAP, max_len=L), 10)
        plain_ms = cuda_ms(
            lambda: nw.nw_forward_batch(*args, IGAP, EGAP, max_len=L), 2
        )
        print(f"nw_forward L={L} B={B}: equal, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        out["nw_forward"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, B=B)
    return out


def phase_slice() -> dict:
    qc, dbc = synth_pair(20000, 250, 0.5, seed=12345)
    q, db = codes_to_seqinfo(qc), codes_to_seqinfo(dbc)
    nw_cuda.nw_stats.launches = 0
    nw_cuda.nw_forward.launches = 0
    t0 = time.perf_counter()
    eng = TorchEngine(db, Config(), device="cuda")
    t1 = time.perf_counter()
    res = eng.compare(q)
    t2 = time.perf_counter()
    report = eng.render_report(q, res)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {
        "nw_stats": nw_cuda.nw_stats.launches,
        "nw_forward": nw_cuda.nw_forward.launches,
    }
    print(f"20k: engine init {t1 - t0:.3f} s, compare {t2 - t1:.3f} s, "
          f"render {t3 - t2:.3f} s, accepted {res.accepted}, "
          f"candidates {res.n_candidates}, nw_cells {res.nw_cells}, "
          f"report {len(report)} B, launches {launches}")
    print("20k phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    print("20k stages: " + json.dumps(eng.stage_stats))
    if res.accepted != ACCEPTED_20K:
        raise AssertionError(f"20k accepted {res.accepted} != {ACCEPTED_20K}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if [a.qread for a in res.records] != sorted({a.qread for a in res.records}):
        raise AssertionError("records are not one per read in read order")

    # steady state: the same compare again on the warm engine
    t4 = time.perf_counter()
    res_w = eng.compare(q)
    t5 = time.perf_counter()
    report_w = eng.render_report(q, res_w)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    print(f"20k warm: compare {t5 - t4:.3f} s, render {t6 - t5:.3f} s")
    if report_w != report:
        raise AssertionError("a second compare gave another report")

    q2 = codes_to_seqinfo(qc[:2000])
    res2 = eng.compare(q2)
    sha = hashlib.sha256(eng.render_report(q2, res2)).hexdigest()
    print(f"2k: accepted {res2.accepted}, report sha256 {sha}")
    if res2.accepted != REF_2K_ACCEPTED or sha != REF_2K_SHA256:
        raise AssertionError("2k report differs from the JAX engine's")
    return launches


def main() -> int:
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_slice()
    sources = {
        "nw_stats": ("imsame_tpu_torch/csrc/nw_stats.cu",
                     "imsame_tpu/ops/nw_pallas.py:1953"),
        "nw_forward": ("imsame_tpu_torch/csrc/nw_forward.cu",
                       "imsame_tpu/ops/nw_pallas.py:2307"),
    }
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
        }
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
