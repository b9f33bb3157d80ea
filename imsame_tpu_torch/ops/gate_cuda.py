"""The extension gate's hand-written CUDA kernel (csrc/gate.cu) and its
wrapper.

``gate`` takes the plain gate's arguments (ops/candidates.py gate_plain):
packed query and db rows, read lengths, the index payload (the packed
words, or the wide (pos, sid, db_start) triple), a candidate chunk in one
of the three formats -- [N] seg words with their segments' ``rtab`` and
``rbase``, [2, N] two words, [3, N] three words -- and the per-read
thresholds.  A CPU tensor goes to the plain version; a CUDA tensor
launches the kernel on the current stream, or raises: there is no
fallback.  ``launch_gate`` validates device, dtype, shape, contiguity,
N > 0, N % 32 == 0 and the window, allocates the [2, N/32] output (and,
for the seg format, the blocks' prefix scratch) with ``torch.empty`` and
raises if the launcher returns a CUDA error; ``gate`` adds one to its
``launches`` attribute per kernel it launches: three for a seg chunk
(the blocks' totals, their scan, the gate), one for the other formats.
The kernel builds into the library of ops/nw_cuda.py, on first use.
"""

from __future__ import annotations

import torch

from . import nw_cuda

SEG, TWO_WORDS, THREE_WORDS = 1, 2, 3  # csrc/gate.cu's formats
BLOCK = 256  # candidates a block of the kernel


def _check(name, t, dev, shape=None):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, qp on {dev}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab=None,
                rbase=None, *, window: int) -> torch.Tensor:
    """One gate on CUDA tensors; returns the [2, N/32] int32 pass/exact
    words and counts nothing.  chip_smoke.py calls it directly to hold
    the kernel against the plain version."""
    dev = qp.device
    if qp.dim() != 2 or dp.dim() != 2 or 0 in qp.shape or 0 in dp.shape:
        raise ValueError("qp and dp must be non-empty [rows, words]")
    n_q, wp_q = qp.shape
    n_db, wp_d = dp.shape
    for name, t, shape in (("qp", qp, None), ("dp", dp, None),
                           ("qlen", qlen, (n_q,)), ("dlen", dlen, (n_db,)),
                           ("thr_tab", thr_tab, (n_q,))):
        _check(name, t, dev, shape)
    if isinstance(idx_tab, torch.Tensor):
        idx, sid, db_start = idx_tab, None, None
    else:
        idx, sid, db_start = idx_tab
    n_idx = idx.shape[0] if idx.dim() == 1 else 0
    if n_idx == 0:
        raise ValueError("the index payload must be a non-empty [n_idx]")
    _check("index", idx, dev, (n_idx,))
    if sid is not None:
        _check("idx_sid", sid, dev, (n_idx,))
        _check("db_start", db_start, dev, (n_db,))
    if cand.dim() == 1:
        fmt, N = SEG, cand.shape[0]
        if rtab is None or rbase is None or rtab.dim() != 1 \
                or rtab.shape[0] == 0:
            raise ValueError("seg words need non-empty rtab and rbase")
        _check("rtab", rtab, dev)
        _check("rbase", rbase, dev, tuple(rtab.shape))
    elif cand.dim() == 2 and cand.shape[0] in (2, 3):
        fmt, N = (TWO_WORDS if cand.shape[0] == 2 else THREE_WORDS), \
            cand.shape[1]
        if rtab is not None or rbase is not None:
            raise ValueError("rtab and rbase go with seg words only")
    else:
        raise ValueError("cand must be [N] seg words, [2, N] or [3, N]")
    _check("cand", cand, dev)
    if N == 0 or N % 32:
        raise ValueError(f"N = {N} candidates is not a positive multiple "
                         "of 32")
    if window <= 0 or window % 16:
        raise ValueError(f"window {window} is not a positive multiple of 16")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        # the kernel writes every word
        out = torch.empty((2, N // 32), dtype=torch.int32, device=dev)
        scratch = (torch.empty(2 * -(-N // BLOCK), dtype=torch.int32,
                               device=dev) if fmt == SEG else None)
        err = nw_cuda._lib().gate_launch(
            qp.data_ptr(), n_q, wp_q, dp.data_ptr(), n_db, wp_d,
            qlen.data_ptr(), dlen.data_ptr(), thr_tab.data_ptr(),
            idx.data_ptr(), ptr(sid), ptr(db_start), n_idx,
            cand.data_ptr(), fmt, N, ptr(rtab), ptr(rbase),
            0 if rtab is None else rtab.shape[0], ptr(scratch), int(window),
            out.data_ptr(), nw_cuda._stream_ptr(dev))
    if err:
        raise RuntimeError(f"gate launch failed: cudaError_t {err}")
    return out


def gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab=None, rbase=None,
         *, window: int) -> torch.Tensor:
    """The extension gate of one candidate chunk: [2, N/32] int32 words
    (row 0 pass, row 1 exact; bit k of word w is candidate 32w + k),
    bit-equal to ops/candidates.py gate_plain."""
    if qp.device.type == "cpu":
        # ops/candidates.py imports this module for its dispatchers
        from .candidates import gate_plain
        return gate_plain(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab,
                          rbase, window=window)
    if qp.device.type != "cuda":
        raise ValueError(f"gate runs on cpu or cuda, not {qp.device}")
    out = launch_gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab,
                      rbase, window=window)
    gate.launches += 3 if cand.dim() == 1 else 1
    return out


gate.launches = 0
