"""First builds of the port's native pieces from several threads at once:
one build and one loaded library per process.  The host runtime is
really compiled with gcc into a fresh directory; the CUDA build, which
needs nvcc, runs with a stand-in compiler that writes its outputs and
checks its inputs."""

import os
import sys
import threading
import time
from pathlib import Path

import pytest

import imsame_tpu_torch.native as tnative
from imsame_tpu_torch.ops import nw_cuda

N_THREADS = 4


def run_together(fn, n=N_THREADS):
    """fn() on n threads released at once, with a short switch interval;
    returns (results, errors)."""
    barrier = threading.Barrier(n)
    results, errors = [], []

    def work():
        try:
            barrier.wait(timeout=60)
            results.append(fn())
        except Exception as e:  # reported by the caller's asserts
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_native_first_load_from_threads(tmp_path, monkeypatch):
    build_dir = tmp_path / "build"
    monkeypatch.setattr(tnative, "BUILD_DIR", str(build_dir))
    gcc_calls = []
    real_run = tnative.subprocess.run

    def counting_run(cmd, **kw):
        gcc_calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(tnative.subprocess, "run", counting_run)
    tnative._load.cache_clear()
    try:
        libs, errors = run_together(tnative.load)
    finally:
        tnative._load.cache_clear()
    assert errors == []
    assert len(libs) == N_THREADS and libs[0] is not None
    assert all(lib is libs[0] for lib in libs)
    assert len(gcc_calls) == 1
    files = [p.name for p in build_dir.iterdir()]
    assert len(files) == 1 and files[0].startswith("libhost_"), files
    assert files[0].endswith(".so")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """nw_cuda with a stand-in for nvcc (each command writes its -o file
    after a short sleep; the link first checks that its objects exist) and
    for ctypes.CDLL; returns (build directory, list of _run calls)."""
    build_dir = tmp_path / "build"
    monkeypatch.setattr(nw_cuda, "BUILD_DIR", str(build_dir))
    runs = []

    def fake_run(cmds, timeout):
        runs.append(cmds)
        time.sleep(0.05)
        for c in cmds:
            out = c[c.index("-o") + 1]
            if "-shared" in c:
                missing = [o for o in c[c.index("-o") + 2:]
                           if not os.path.exists(o)]
                if missing:
                    raise RuntimeError(f"link inputs removed: {missing}")
            Path(out).write_bytes(b"\0")
        return ""

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):  # every symbol: a function
            def fn(*args):
                return 0

            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(nw_cuda, "_run", fake_run)
    monkeypatch.setattr(nw_cuda.ctypes, "CDLL", FakeLib)
    nw_cuda._load.cache_clear()
    yield build_dir, runs
    nw_cuda._load.cache_clear()


def test_nw_cuda_first_load_from_threads(fake_nvcc):
    build_dir, runs = fake_nvcc
    libs, errors = run_together(nw_cuda._lib)
    assert errors == []
    assert len(libs) == N_THREADS and all(lib is libs[0] for lib in libs)
    assert len(runs) == 2  # one compile step (every source) and one link
    compiled = sorted(os.path.basename(c[-1]) for c in runs[0])
    assert compiled == ["gate.cu", "nw_forward.cu", "nw_stats.cu",
                        "traceback.cu"]
    files = [p.name for p in build_dir.iterdir()]
    assert len(files) == 1 and files[0].startswith("libnw_"), files

