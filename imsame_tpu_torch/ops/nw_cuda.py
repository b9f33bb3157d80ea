"""Hand-written CUDA kernels for the NW functions and the traceback, and
their wrappers; the loader of every kernel of the port.

  nw_stats    csrc/nw_stats.cu    function S (stats-only NW): best cell +
                                  path length/identities per pair
  nw_forward  csrc/nw_forward.cu  function F (forward NW with packed
                                  backpointer words) per pair
  traceback   csrc/traceback.cu   the walk back over F's words from each
                                  pair's best cell: path stats and chain
  gate        csrc/gate.cu        the extension gate (its wrapper is
                                  ops/gate_cuda.py)

The four sources (and the header the first three share,
csrc/nw_common.cuh) are compiled on first use by ``nvcc`` for ``sm_90a``
(one process per source, run together) and linked into one shared library
with a plain C interface in the repository's ``build/`` directory, keyed
by the sources' hash, and loaded with ctypes.  Nothing is built or
imported at module import.

Each wrapper takes the plain torch version's arguments.  A CPU tensor
goes to the plain version (ops/nw.py, ops/traceback.py); a CUDA tensor
launches the kernel on the current stream, or raises: there is no
fallback.  ``launch`` and ``launch_traceback`` validate device, dtype,
shape, contiguity and alignment, allocate the outputs (and, for
``nw_stats`` past L = 256, its strip-boundary scratch) with
``torch.empty`` and raise if the launcher returns a CUDA error; each
wrapper adds one to its ``launches`` attribute per kernel launch.

The NW kernels are instantiated for every length bucket of
``Config.length_buckets``.  Up to L = 256 a launch has one warp per pair.
Past it ``nw_stats`` walks a pair's rows in strips of 256 on one warp,
handing each strip's bottom boundary to the next through a scratch of 2 x
2L x 16 bytes per warp, so a launch holds at most as many warps as fit on
the card at once (``resident_pairs``) and each warp loops over pairs;
``nw_forward`` runs a pair's strips at once on the warps of one block,
one block per pair.  ``traceback`` has one warp per pair at every bucket,
which walks from a band of the pair's bp words copied into shared memory
(``TRACEBACK_BAND``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time

import torch

from ..config import Config
from ..native import BUILD_DIR
from .nw import NWResult, NWStatsResult, nw_forward_batch, nw_stats_batch
from .traceback import TracebackResult, traceback_batch

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
_SOURCES = ("nw_stats.cu", "nw_forward.cu", "traceback.cu", "gate.cu")
_HEADERS = ("nw_common.cuh",)  # included by the NW sources and traceback.cu
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# The traceback kernel's band at each bucket, (W, G): a round copies the
# 2W antidiagonals at and below the walk's cell into shared memory, each
# row the cells within G of the cell's diagonal offset; W = 0: no band,
# each move reads its word from device memory (csrc/traceback.cu).  Given
# to nvcc as -DTB_W<L>=W -DTB_G<L>=G.  Chosen by chip_smoke.py
# --ab-traceback on the render's chunk shapes (PERF.md §6).
TRACEBACK_BAND = {128: (0, 2), 256: (0, 2), 512: (64, 4),
                  1024: (256, 4), 2048: (512, 4), 3072: (512, 4)}
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    *(f"-DTB_{k}{L}={v}" for L, band in TRACEBACK_BAND.items()
      for k, v in zip("WG", band)),
)
TILE = 4  # batch multiple: pairs per block up to L = 256 (kWarpsPerBlock)
LENGTHS = Config.length_buckets  # buckets the kernels are instantiated for
STRIP = 256  # rows per strip past this length (32 lanes x 8 rows)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _run(cmds: list, timeout: int) -> str:
    """Run the commands at once; returns their joined output, raises
    RuntimeError with the output of the first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f"{' '.join(c)} failed ({p.returncode}):\n"
                               + out[-8000:])
    return "".join(outs)


def build() -> dict:
    """Compile the kernels unless a library for their sources exists.
    Returns {"path", "seconds", "log"} (log: ptxas register and spill
    report of a fresh build).  Raises RuntimeError on a failed build."""
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(_CSRC, s) for s in _HEADERS]:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libnw_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
        try:
            log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s]
                        for o, s in zip(objs, srcs)], timeout=900)
            log += _run([[_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]],
                        timeout=300)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        os.replace(tmp, so)
    return {"path": so, "seconds": time.perf_counter() - t0, "log": log}


_LOAD_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded once per process: threads
    that reach the first launch together wait for one build (temp names
    are unique per process only)."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nw_stats_launch.restype = i
    lib.nw_stats_launch.argtypes = [
        p, p, p, p, i, i, i, i, p, i, p, p, p, p, p, p
    ]
    lib.nw_forward_launch.restype = i
    lib.nw_forward_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p]
    lib.traceback_launch.restype = i
    lib.traceback_launch.argtypes = [p, p, p, i, i, p, p, p, p, p, p, p]
    ll = ctypes.c_longlong
    lib.gate_launch.restype = i
    lib.gate_launch.argtypes = [p, i, i, p, i, i, p, p, p, p, p, p, ll, p, i,
                                ll, p, p, i, p, i, p, p]
    for name in ("nw_stats_slots", "nw_forward_resident"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i]
    return lib


def resident_pairs(kernel: str, L: int, device=None) -> int:
    """Pairs of `kernel` ("nw_stats" or "nw_forward") at bucket L in
    flight at once on `device` (default: the current card): nw_stats's
    warp slots (past L = STRIP a launch holds at most this many, each
    looping over pairs), nw_forward's warps up to STRIP and blocks past it
    (a launch past this many runs in waves)."""
    index = (torch.cuda.current_device() if device is None
             else torch.device(device).index)
    return _resident(kernel, L, index)


@functools.cache
def _resident(kernel: str, L: int, index: int) -> int:
    fn = "nw_stats_slots" if kernel == "nw_stats" else "nw_forward_resident"
    with torch.cuda.device(index):  # the query reads the current card
        n = getattr(_lib(), fn)(L)
    if n <= 0:
        raise RuntimeError(f"{kernel}: no resident pair at L={L}")
    return n


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
        if dtype == torch.uint8 and t.data_ptr() % 16:  # rows load as uint4
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, L


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(kernel: str, X, Y, xlen, ylen, igap: int, egap: int, *,
           max_len: int):
    """One launch of `kernel` ("nw_stats" or "nw_forward") on CUDA
    tensors; returns its raw outputs and counts nothing.  The wrappers
    below count their launches; chip_smoke.py calls this directly to time
    another checkout's kernels beside these."""
    B, L = _check_inputs(X, Y, xlen, ylen, max_len)
    dev = X.device
    ptrs = [X.data_ptr(), Y.data_ptr(), xlen.data_ptr(), ylen.data_ptr(),
            B, L, int(igap), int(egap)]
    # the launcher runs on the current card: make it X's, whatever the
    # caller's current device is
    with torch.cuda.device(dev):
        if kernel == "nw_stats":
            outs = [torch.empty(B, dtype=torch.int32, device=dev)
                    for _ in range(5)]
            n_slots, scratch = B, None
            if L > STRIP:
                n_slots = min(B, resident_pairs(kernel, L, dev))
                scratch = torch.empty((n_slots, 2, 2 * L, 4),
                                      dtype=torch.int32, device=dev)
            ptrs += [None if scratch is None else scratch.data_ptr(), n_slots]
        else:
            # the kernel writes every word of bp (-1 outside the valid
            # region)
            outs = [torch.empty((B, 2 * L - 1, L), dtype=torch.int32,
                                device=dev)]
            outs += [torch.empty(B, dtype=torch.int32, device=dev)
                     for _ in range(3)]
        err = getattr(_lib(), f"{kernel}_launch")(
            *ptrs, *[o.data_ptr() for o in outs], _stream_ptr(dev))
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
    return outs


def nw_stats(X, Y, xlen, ylen, igap: int, egap: int, *, max_len: int):
    """Function S over [B, L] code rows.  Returns NWStatsResult of [B]
    int32 (best_score, best_i, best_j, length, identities), bit-equal to
    ops/nw.py nw_stats_batch.  B must be a multiple of TILE."""
    if X.device.type == "cpu":
        return nw_stats_batch(X, Y, xlen, ylen, igap, egap, max_len=max_len)
    if X.device.type != "cuda":
        raise ValueError(f"nw_stats runs on cpu or cuda, not {X.device}")
    outs = launch("nw_stats", X, Y, xlen, ylen, igap, egap, max_len=max_len)
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
    outs = launch("nw_forward", X, Y, xlen, ylen, igap, egap, max_len=max_len)
    nw_forward.launches += 1
    return NWResult(*outs)


nw_forward.launches = 0


def launch_traceback(bp, best_i, best_j, *, max_len: int):
    """One launch of the traceback kernel on CUDA tensors (bp [B, 2L-1, L]
    int32 as nw_forward writes it, best_i / best_j [B] int32); returns its
    six raw outputs (length, identities, igaps, egaps, chain, n_steps) and
    counts nothing.  chip_smoke.py calls this directly to time another
    checkout's kernel beside this one."""
    dev = bp.device
    B = bp.shape[0] if bp.dim() == 3 else 0
    L = max_len
    if L not in LENGTHS or B == 0:
        raise ValueError(f"bp must be [B > 0, 2L-1, L] with L == max_len "
                         f"in {LENGTHS}")
    for name, t, shape in (("bp", bp, (B, 2 * L - 1, L)),
                           ("best_i", best_i, (B,)),
                           ("best_j", best_j, (B,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bp on {dev}")
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bp.data_ptr() % 16:  # the band's rows copy as 16-byte segments
        raise ValueError("bp must be 16-byte aligned")
    with torch.cuda.device(dev):
        # the kernel writes every word: stats, chain entries, -1 tail
        stats = [torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(5)]
        chain = torch.empty((B, 2 * L), dtype=torch.int32, device=dev)
        err = _lib().traceback_launch(
            bp.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), B, L,
            *[o.data_ptr() for o in stats], chain.data_ptr(),
            _stream_ptr(dev))
    if err:
        raise RuntimeError(f"traceback launch failed: cudaError_t {err}")
    length, identities, igaps, egaps, n_steps = stats
    return length, identities, igaps, egaps, chain, n_steps


def traceback(bp, best_i, best_j, *, max_len: int):
    """The traceback over nw_forward's per-pair bp words.  Returns
    TracebackResult (length, identities, igaps, egaps [B] int32; chain
    [B, 2L] int32; n_steps [B] int32), bit-equal to ops/traceback.py
    traceback_batch."""
    if bp.device.type == "cpu":
        return traceback_batch(bp, best_i, best_j, max_len=max_len)
    if bp.device.type != "cuda":
        raise ValueError(f"traceback runs on cpu or cuda, not {bp.device}")
    outs = launch_traceback(bp, best_i, best_j, max_len=max_len)
    traceback.launches += 1
    return TracebackResult(*outs)


traceback.launches = 0
