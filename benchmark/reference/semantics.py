"""The compare's semantics, written out plainly: what the reference binary
(Bitlab-UMA/IMSAME, `src/alignmentFunctions.c`) computes for one query
read, one candidate and one pair, at n_threads = 1.

Nothing here imports the program.  The scalar functions are the
definition the vectorised ones in `dense.py` are tested against:

- `extend_scalar`: the ungapped extension of one seed hit and its raw
  score (forward walk from one past the seed, backward walk seeded with
  the forward pass's high score but its own watermark at the seed score,
  matches counted beyond the watermarks, t_len without +1).
- `evalue_passes`: the e-value gate, K * qlen * total_db * exp(-lambda *
  raw) < min_e in long double, strict.
- `nw_scalar`: the gapped aligner over two whole reads: free end gaps,
  "long gap" moves from a row tracker (compares table[i][j-2], assigns
  table[i-1][j-2]) and a column tracker (from table[i-2][j-1], strict >),
  best cell on the last row or column with later cells winning ties.
- `buffers_from_path`, `render_alignment`, `format_record`: the report
  record of an accepted pair, identities counted while rendering.

"""

from __future__ import annotations

import numpy as np

K = 12  # seed length (structs.h FIXED_K)
POINT = 4  # match / mismatch score
MAX_READ_SIZE = 3000
ALIGN_LEN = 60  # report line width
QF_LAMBDA = 0.275
QF_KARLIN = 0.333
SEED_SCORE = K * POINT

_DASH, _SPACE, _NL, _STAR = ord("-"), ord(" "), ord("\n"), ord("*")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def evalue_passes(qlen, total_db: int, raw, min_e: float) -> np.ndarray:
    """The e-value gate, elementwise over arrays of read lengths and raw
    scores: the reference's long double expression, operand by operand."""
    qlen = np.asarray(qlen)
    raw = np.asarray(raw)
    ld = np.longdouble
    with np.errstate(over="ignore", under="ignore"):
        e = (ld(QF_KARLIN) * qlen.astype(ld) * ld(float(total_db))
             * np.exp(-ld(QF_LAMBDA) * raw.astype(ld)))
    return e < ld(min_e)


def min_passing_raw(qlens, total_db: int, min_e: float) -> np.ndarray:
    """For each read length, the least integer raw score that passes
    `evalue_passes` (the e-value falls as raw grows): a float64 estimate,
    then the gate itself on the eight integers around it."""
    qlens = np.asarray(qlens, np.int64)
    est = np.ceil((np.log(QF_KARLIN * qlens.astype(np.float64) * total_db)
                   - np.log(min_e)) / QF_LAMBDA).astype(np.int64)
    steps = np.arange(-4, 5)
    tries = est[:, None] + steps[None, :]
    ok = evalue_passes(np.repeat(qlens[:, None], len(steps), 1), total_db,
                       tries, min_e)
    if ok[:, 0].any() or not ok[:, -1].all():
        raise ArithmeticError("e-value boundary outside the search")
    return tries[np.arange(len(qlens)), ok.argmax(1)]


def extend_scalar(q: np.ndarray, d: np.ndarray, q_lo: int, q_hi: int,
                  d_lo: int, d_hi: int, qpos: int, dpos: int):
    """One seed hit's ungapped extension.  q and d are whole code arrays;
    the read around the hit spans [q_lo, q_hi] and [d_lo, d_hi] (last
    base included); qpos / dpos are one past the seed's last base.
    Returns (raw score, idents, t_len)."""
    score = SEED_SCORE
    high_r = score
    end_x = dpos - 1
    start_x = end_x - K + 1
    idents = K
    x, y = dpos, qpos
    while score > 0 and x <= d_hi and y <= q_hi:
        if d[x] == q[y]:
            score += POINT
            idents += 1
        else:
            score -= POINT
        if high_r <= score:
            end_x = x
            high_r = score
        x += 1
        y += 1
    score = high_r
    high_l = SEED_SCORE
    x, y = dpos - K - 1, qpos - K - 1
    while score > 0 and x >= d_lo and y >= q_lo:
        if d[x] == q[y]:
            score += POINT
            idents += 1
        else:
            score -= POINT
        if high_l <= score:
            start_x = x
            high_l = score
        x -= 1
        y -= 1
    t_len = end_x - start_x
    raw = idents * POINT - (t_len - idents) * POINT
    return raw, idents, t_len


def nw_scalar(X: np.ndarray, Y: np.ndarray, igap: int, egap: int):
    """The gapped aligner over db read X and query read Y, cell by cell.
    Returns (frm [len X, len Y, 2], (best i, best j))."""
    nx, ny = len(X), len(Y)
    T = np.zeros((nx, ny), np.int64)
    frm = np.zeros((nx, ny, 2), np.int64)
    T[0, :] = np.where(X[0] == Y, POINT, -POINT)
    mc_s = T[0, :].copy()
    mc_x = np.zeros(ny, np.int64)
    best = (None, 0, 0)
    for i in range(1, nx):
        T[i, 0] = POINT if X[i] == Y[0] else -POINT
        mf_s, mf_x, mf_y = T[i, 0], i, 0
        for j in range(1, ny):
            if j > 1 and mf_s <= T[i, j - 2]:
                mf_s, mf_x, mf_y = T[i - 1, j - 2], i - 1, j - 2
            s = POINT if X[i] == Y[j] else -POINT
            diag = T[i - 1, j - 1] + s
            left = (mf_s + igap + (j - (mf_y + 1)) * egap + s) if j > 1 else None
            up = (mc_s[j - 1] + igap + (i - (mc_x[j - 1] + 1)) * egap + s
                  if i > 1 else None)
            if (left is None or diag >= left) and (up is None or diag >= up):
                T[i, j], frm[i, j] = diag, (i - 1, j - 1)
            elif up is not None and (left is None or up > left):
                T[i, j], frm[i, j] = up, (mc_x[j - 1], j - 1)
            else:
                T[i, j], frm[i, j] = left, (mf_x, mf_y)
            if i > 1 and j > 1 and T[i - 2, j - 1] > mc_s[j - 1]:
                mc_s[j - 1], mc_x[j - 1] = T[i - 2, j - 1], i - 2
            if (i == nx - 1 or j == ny - 1) and (
                    best[0] is None or T[i, j] >= best[0]):
                best = (T[i, j], i, j)
    return frm, (best[1], best[2])


def path_from_frm(frm: np.ndarray, bi: int, bj: int) -> list:
    """The cells the traceback visits from the best cell: [(bi, bj), ...]
    until a cell on row 0 or column 0."""
    path = [(bi, bj)]
    x, y = bi, bj
    while x > 0 and y > 0:
        x, y = int(frm[x, y, 0]), int(frm[x, y, 1])
        path.append((x, y))
    return path


def buffers_from_path(X: np.ndarray, Y: np.ndarray, path: list):
    """The backtracker's two right-aligned buffers from the visited cells.
    Returns (rec_x, rec_y, head_x, head_y, maximum_len, length)."""
    nx, ny = len(X), len(Y)
    xc, yc = ACGT[X], ACGT[Y]
    maximum_len = 2 * max(nx, ny)
    rec_x = np.full(2 * maximum_len + 2, _SPACE, np.uint8)
    rec_y = rec_x.copy()
    hx = hy = maximum_len
    bx, by = path[0]
    for _ in range(nx - 1 - bx):
        rec_x[hx] = _DASH
        hx -= 1
    for _ in range(ny - 1 - by):
        rec_y[hy] = _DASH
        hy -= 1
    length = 0
    px, py = bx, by
    for cx, cy in path[1:]:
        if cx == px - 1 and cy == py - 1:
            rec_x[hx], rec_y[hy] = xc[px], yc[py]
            hx -= 1
            hy -= 1
            length += 1
        elif px - cx > py - cy:
            for k in range(px, cx, -1):
                rec_y[hy], rec_x[hx] = _DASH, xc[k]
                hy -= 1
                hx -= 1
                length += 1
        else:
            for k in range(py, cy, -1):
                rec_x[hx], rec_y[hy] = _DASH, yc[k]
                hx -= 1
                hy -= 1
                length += 1
        px, py = cx, cy
    gx = gy = 0
    for _ in range(px - 1, -1, -1):
        rec_x[hx] = _DASH
        hx -= 1
        gx += 1
    for _ in range(py - 1, -1, -1):
        rec_y[hy] = _DASH
        hy -= 1
        gy += 1
    if gx >= gy:
        for _ in range(gx):
            rec_y[hy] = _SPACE
            hy -= 1
    else:
        for _ in range(gy):
            rec_x[hx] = _SPACE
            hx -= 1
    return rec_x, rec_y, hx, hy, maximum_len, length


def render_alignment(rec_x, rec_y, head_x: int, head_y: int,
                     maximum_len: int):
    """60-column blocks (db line, query line, match line) and the '*'
    count, which is the record's identities."""
    out = bytearray()
    ident = 0
    i, j = head_x + 1, head_y + 1
    while i <= maximum_len and j <= maximum_len:
        bi, bj = i, j
        i = min(i + ALIGN_LEN, maximum_len + 1)
        out += rec_x[bi:i].tobytes() + b"\n"
        j = min(j + ALIGN_LEN, maximum_len + 1)
        out += rec_y[bj:j].tobytes() + b"\n"
        cx, cy = rec_x[bi:i], rec_y[bj:bj + i - bi]
        hit = (cx != _DASH) & (cy != _DASH) & (cx == cy)
        out += np.where(hit, _STAR, _SPACE).astype(np.uint8).tobytes()
        out.append(_NL)
        ident += int(hit.sum())
    out.append(_NL)
    return bytes(out), ident


def percent(num: int, den: int) -> int:
    """The record's integer percentage: floor, clamped to 100."""
    return min(100, (100 * num) // den)


def accepts(length: int, ident: int, ylen: int, min_cov: float,
            min_id: float) -> bool:
    """Coverage over the query read's length and identity over the
    alignment's, each at least its threshold."""
    return length / ylen >= min_cov and ident / length >= min_id


def format_record(qread: int, dbread: int, ident: int, length: int,
                  ylen: int, block: bytes) -> bytes:
    head = (f"({qread}, {dbread}) : {percent(ident, length)}% "
            f"{percent(length, ylen)}% {ylen}\n $$$$$$$ \n")
    return head.encode() + block
