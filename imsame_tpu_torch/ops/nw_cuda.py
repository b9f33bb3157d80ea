"""Hand-written CUDA kernels for the two NW functions, and their wrappers.

  nw_stats    csrc/nw_stats.cu    function S (stats-only NW): best cell +
                                  path length/identities per pair
  nw_forward  csrc/nw_forward.cu  function F (forward NW with packed
                                  backpointer words) per pair

Both sources are compiled on first use by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface in the repository's ``build/``
directory, keyed by the sources' hash, and loaded with ctypes.  Nothing is
built or imported at module import.

Each wrapper takes the plain torch version's arguments.  A CPU tensor
goes to the plain version in ops/nw.py; a CUDA tensor launches the kernel
on the current stream, or raises: there is no fallback.  The wrapper
validates device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, raises if the launcher returns a CUDA error, and adds one
to its ``launches`` attribute per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time

import torch

from ..native import BUILD_DIR
from .nw import NWResult, NWStatsResult, nw_forward_batch, nw_stats_batch

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
_SOURCES = ("nw_stats.cu", "nw_forward.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TILE = 4  # pairs per thread block (kWarpsPerBlock in both sources)
LENGTHS = (128, 256)  # buckets the kernels are instantiated for


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build() -> dict:
    """Compile both kernels unless a library for the current sources
    exists.  Returns {"path", "seconds", "log"} (log: ptxas register and
    spill report of a fresh build).  Raises CalledProcessError on a
    failed build."""
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libnw_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True, timeout=600,
        )
        if r.returncode:
            raise subprocess.CalledProcessError(
                r.returncode, r.args, r.stdout, r.stderr
            )
        log = r.stdout + r.stderr
        os.replace(tmp, so)
    return {"path": so, "seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nw_stats_launch.restype = i
    lib.nw_stats_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p]
    lib.nw_forward_launch.restype = i
    lib.nw_forward_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p]
    return lib


def _check_inputs(X, Y, xlen, ylen, max_len):
    dev = X.device
    B, L = X.shape if X.dim() == 2 else (None, None)
    if L != max_len or L not in LENGTHS:
        raise ValueError(f"X must be [B, L] with L == max_len in {LENGTHS}")
    if B % TILE or B == 0:
        raise ValueError(f"B must be a positive multiple of {TILE}, got {B}")
    for name, t, dtype, shape in (
        ("X", X, torch.uint8, (B, L)),
        ("Y", Y, torch.uint8, (B, L)),
        ("xlen", xlen, torch.int32, (B,)),
        ("ylen", ylen, torch.int32, (B,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, L


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def nw_stats(X, Y, xlen, ylen, igap: int, egap: int, *, max_len: int):
    """Function S over [B, L] code rows.  Returns NWStatsResult of [B]
    int32 (best_score, best_i, best_j, length, identities), bit-equal to
    ops/nw.py nw_stats_batch.  B must be a multiple of TILE."""
    if X.device.type == "cpu":
        return nw_stats_batch(X, Y, xlen, ylen, igap, egap, max_len=max_len)
    if X.device.type != "cuda":
        raise ValueError(f"nw_stats runs on cpu or cuda, not {X.device}")
    B, L = _check_inputs(X, Y, xlen, ylen, max_len)
    outs = [torch.empty(B, dtype=torch.int32, device=X.device) for _ in range(5)]
    err = _lib().nw_stats_launch(
        X.data_ptr(), Y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(),
        B, L, int(igap), int(egap), *[o.data_ptr() for o in outs],
        _stream_ptr(X.device),
    )
    if err:
        raise RuntimeError(f"nw_stats launch failed: cudaError_t {err}")
    nw_stats.launches += 1
    return NWStatsResult(*outs)


nw_stats.launches = 0


def nw_forward(X, Y, xlen, ylen, igap: int, egap: int, *, max_len: int):
    """Function F over [B, L] code rows.  Returns NWResult (bp [B, 2L-1, L]
    int32 in the per-pair diagonal layout, best_score, best_i, best_j),
    bit-equal to ops/nw.py nw_forward_batch.  B must be a multiple of
    TILE."""
    if X.device.type == "cpu":
        return nw_forward_batch(X, Y, xlen, ylen, igap, egap, max_len=max_len)
    if X.device.type != "cuda":
        raise ValueError(f"nw_forward runs on cpu or cuda, not {X.device}")
    B, L = _check_inputs(X, Y, xlen, ylen, max_len)
    bp = torch.empty((B, 2 * L - 1, L), dtype=torch.int32, device=X.device)
    best = [torch.empty(B, dtype=torch.int32, device=X.device) for _ in range(3)]
    err = _lib().nw_forward_launch(
        X.data_ptr(), Y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(),
        B, L, int(igap), int(egap), bp.data_ptr(),
        *[o.data_ptr() for o in best], _stream_ptr(X.device),
    )
    if err:
        raise RuntimeError(f"nw_forward launch failed: cudaError_t {err}")
    nw_forward.launches += 1
    return NWResult(bp, *best)


nw_forward.launches = 0
