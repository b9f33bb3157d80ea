"""The semantics of `semantics.py`, vectorised in plain torch so that the
reference covers the timed sizes: the db k-mer index, each query read's
candidate stream in the reference binary's order, the ungapped extension
of many candidates at once, and the gapped aligner over many pairs at
once (one anti-diagonal a step), with the traceback's visited cells.

Written from the semantics, not from the program: the index is one sort,
the streams one expansion, the extension prefix sums over a window of
bases, the aligner a wavefront whose trackers are kept per row (mf) and
per column (mc) as in the reference's loops.
"""

from __future__ import annotations

import numpy as np
import torch

from .semantics import K, POINT, SEED_SCORE

NEG = -(1 << 28)
_I64 = torch.int64


class Sample:
    """A read set on a device: codes, starts, lengths, ends (one past)."""

    def __init__(self, codes: np.ndarray, starts: np.ndarray, device):
        self.n = len(starts)
        self.total = len(codes)
        self.codes = torch.as_tensor(codes, device=device).to(torch.uint8)
        self.start = torch.as_tensor(starts, device=device).to(_I64)
        self.end = torch.cat([self.start[1:], torch.tensor(
            [self.total], device=device, dtype=_I64)])
        self.lens = self.end - self.start
        self.device = device

    def kmer_keys(self) -> torch.Tensor:
        """Key of the k-mer starting at every position p < total - K + 1,
        first base most significant."""
        c = self.codes.to(_I64)
        n = self.total - K + 1
        key = torch.zeros(max(n, 0), dtype=_I64, device=self.device)
        for t in range(K):
            key = (key << 2) | c[t:t + n]
        return key


class DbIndex:
    """Every k-mer lying inside one db read, sorted by key and, within a
    key, by descending position (the reference prepends to its buckets and
    walks them from the head)."""

    def __init__(self, db: Sample):
        keys = db.kmer_keys()
        p = torch.arange(len(keys), device=db.device, dtype=_I64)
        sid = torch.searchsorted(db.start, p, right=True) - 1
        inside = p + K <= db.end[sid]
        p, sid, keys = p[inside], sid[inside], keys[inside]
        order = torch.argsort((keys << 32) | ((1 << 31) - 1 - p))
        self.pos = (p[order] + K)  # one past the k-mer's last base
        self.sid = sid[order]
        counts = torch.bincount(keys, minlength=4 ** K)
        self.bucket = torch.zeros(4 ** K + 1, dtype=_I64, device=db.device)
        self.bucket[1:] = torch.cumsum(counts, 0)


def stream_bounds(q: Sample, reads: torch.Tensor):
    """First and last k-mer start of each read's stream: a read's stream
    begins with the previous read's last base, and its own last base goes
    to the next read (the reference consumes no base at a read boundary)."""
    lo = torch.where(reads > 0, q.start[reads] - 1, q.start[reads])
    hi = torch.where(reads < q.n - 1, q.end[reads] - 2, q.end[reads] - 1)
    last = hi - (K - 1)
    return lo, torch.clamp(last - lo + 1, min=0)


def candidates(q: Sample, qkeys: torch.Tensor, idx: DbIndex,
               reads: torch.Tensor):
    """Every candidate of the given reads in stream order: k-mers in scan
    order, each k-mer's hits newest first.  Returns (read, qpos, dpos,
    sid, count per read, rank in the read's stream), qpos / dpos one past
    the seed's last base."""
    lo, nk = stream_bounds(q, reads)
    rk = torch.repeat_interleave(torch.arange(len(reads), device=q.device),
                                 nk)
    first = torch.cumsum(nk, 0) - nk
    ks = lo[rk] + torch.arange(len(rk), device=q.device) - first[rk]
    key = qkeys[ks]
    b0 = idx.bucket[key]
    cnt = idx.bucket[key + 1] - b0
    ck = torch.repeat_interleave(torch.arange(len(ks), device=q.device), cnt)
    cfirst = torch.cumsum(cnt, 0) - cnt
    hit = b0[ck] + torch.arange(len(ck), device=q.device) - cfirst[ck]
    per_read = torch.zeros(len(reads), dtype=_I64, device=q.device)
    per_read.index_add_(0, rk, cnt)
    owner = rk[ck]
    rank = (torch.arange(len(ck), device=q.device)
            - (torch.cumsum(per_read, 0) - per_read)[owner])
    return (reads[owner], ks[ck] + K, idx.pos[hit], idx.sid[hit], per_read,
            rank)


def _walk(qc, dc, q0, d0, step, nmax, start_score, W):
    """W steps of the walk from (q0, d0) in direction step (+1 / -1), at
    most nmax[i] steps, stopping after the score reaches 0.  Returns
    (matches, high score, offset of the last watermark update or -1,
    whether the walk ended inside the window)."""
    k = torch.arange(W, device=qc.device, dtype=_I64)
    qi = (q0[:, None] + step * k).clamp(0, len(qc) - 1)
    di = (d0[:, None] + step * k).clamp(0, len(dc) - 1)
    m = (qc[qi] == dc[di])
    c = start_score[:, None] + torch.cumsum(
        torch.where(m, POINT, -POINT), 1)
    dead = c <= 0
    # step k runs if k < nmax and no earlier step took the score to 0
    before = torch.cumsum(dead.to(torch.int32), 1) - dead.to(torch.int32)
    ran = (k[None, :] < nmax[:, None]) & (before == 0)
    matches = (m & ran).sum(1)
    cm = torch.where(ran, c, NEG)
    run_max = torch.cummax(torch.clamp(cm, min=SEED_SCORE), 1).values
    upd = ran & (c == run_max)
    last = torch.where(upd, k[None, :], -1).amax(1)
    high = torch.clamp(cm.amax(1), min=SEED_SCORE)
    done = (ran.sum(1) < W) | (nmax <= W) | dead[:, -1]
    return matches, high, last, done


def _walk_full(qc, dc, q0, d0, step, nmax, start_score, w0=64,
               budget=1 << 24):
    """`_walk` over the whole read: a short window first, then the whole
    length, in blocks of about `budget` bases, for the walks still alive
    at its end."""
    matches, high, last, done = _walk(qc, dc, q0, d0, step, nmax,
                                      start_score, w0)
    todo = torch.nonzero(~done).flatten()
    if len(todo):
        matches, high, last = matches.clone(), high.clone(), last.clone()
        W = int(nmax[todo].max())
        per = max(1, budget // W)
        for a in range(0, len(todo), per):
            t = todo[a:a + per]
            m2, h2, l2, _ = _walk(qc, dc, q0[t], d0[t], step, nmax[t],
                                  start_score[t], W)
            matches[t], high[t], last[t] = m2, h2, l2
    return matches, high, last


def raw_scores(q: Sample, db: Sample, read, qpos, dpos, sid):
    """The ungapped extension's raw score of each candidate."""
    fmax = torch.minimum(q.end[read] - qpos, db.end[sid] - dpos).clamp(min=0)
    seed = torch.full_like(qpos, SEED_SCORE)
    mf, hr, lf = _walk_full(q.codes, db.codes, qpos, dpos, 1, fmax, seed)
    end_x = torch.where(lf >= 0, dpos + lf, dpos - 1)
    qb, db_ = qpos - K - 1, dpos - K - 1
    bmax = torch.minimum(qb - q.start[read], db_ - db.start[sid]) + 1
    mb, _, lb = _walk_full(q.codes, db.codes, qb, db_, -1, bmax.clamp(min=0),
                           hr)
    start_x = torch.where(lb >= 0, db_ - lb, dpos - K)
    idents = K + mf + mb
    t_len = end_x - start_x
    return idents * POINT - (t_len - idents) * POINT


def gate(q: Sample, db: Sample, thr: torch.Tensor, read, qpos, dpos, sid,
         chunk: int = 1 << 20) -> torch.Tensor:
    """Whether each candidate passes the e-value gate, thr[read] being
    the least passing raw score of the read's length."""
    out = torch.empty(len(read), dtype=torch.bool, device=q.device)
    for a in range(0, len(read), chunk):
        s = slice(a, a + chunk)
        raw = raw_scores(q, db, read[s], qpos[s], dpos[s], sid[s])
        out[s] = raw >= thr[read[s]]
    return out


def _shift(a: torch.Tensor, n: int) -> torch.Tensor:
    """a[:, i - n] at row i, NEG for i < n."""
    out = torch.full_like(a, NEG)
    out[:, n:] = a[:, :-n]
    return out


class _Wavefront:
    """The aligner's state over a batch of pairs, advanced one
    anti-diagonal a `step`, every update in place so that a step can be
    captured once as a CUDA graph and replayed."""

    def __init__(self, X: list, Y: list, igap: int, egap: int, device,
                 paths: bool):
        B = len(X)
        self.B, self.igap, self.egap = B, igap, egap
        xl = np.array([len(x) for x in X])
        yl = np.array([len(y) for y in Y])
        R, C = int(xl.max()), int(yl.max())
        self.R, self.C, self.ND = R, C, R + C - 1
        Xh = np.full((B, R), 4, np.int32)
        Yh = np.full((B, C), 5, np.int32)
        for b in range(B):
            Xh[b, :len(X[b])] = X[b]
            Yh[b, :len(Y[b])] = Y[b]
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.Xt, self.Yt = t(Xh), t(Yh)
        self.xl, self.yl = t(xl)[:, None], t(yl)[:, None]
        self.i = torch.arange(R, device=device, dtype=torch.int32)[None, :]
        neg = torch.full((B, R), NEG, dtype=torch.int32, device=device)
        zero = torch.zeros_like(neg)
        self.D = [neg.clone(), neg.clone(), neg.clone()]  # d-1, d-2, d-3
        self.W = [zero.clone(), zero.clone(), zero.clone()]
        self.mf = [neg.clone(), zero.clone(), zero.clone(), zero.clone()]
        mc_s = torch.where(self.Xt[:, :1] == self.Yt, POINT, -POINT)
        self.mc = [mc_s.to(torch.int32), torch.zeros_like(self.Yt),
                   torch.zeros_like(self.Yt)]
        self.frm = (torch.full((B, self.ND, R), -1, dtype=torch.int32,
                               device=device) if paths else None)
        self.bkey = torch.full((B,), -(1 << 62), dtype=_I64, device=device)
        self.bj = torch.zeros(B, dtype=_I64, device=device)
        self.bw = torch.zeros(B, dtype=torch.int32, device=device)
        self.d = torch.zeros((), dtype=torch.int32, device=device)

    def step(self) -> None:
        B, R, C, i, d = self.B, self.R, self.C, self.i, self.d
        D1, D2, D3 = self.D
        W1, W2, W3 = self.W
        mf_s, mf_x, mf_y, mf_w = self.mf
        mc_s, mc_x, mc_w = self.mc
        j = d - i
        valid = (j >= 0) & (j < self.yl) & (i < self.xl)
        inner = valid & (i >= 1) & (j >= 1)
        yj = torch.gather(self.Yt, 1, j.clamp(0, C - 1).to(_I64).expand(B, R))
        eq = self.Xt == yj
        s = torch.where(eq, POINT, -POINT).to(torch.int32)
        t_dg, t_cmp = _shift(D2, 1), D2
        t_asg, t_up2 = _shift(D3, 1), _shift(D3, 2)
        upd = inner & (j >= 2) & (mf_s <= t_cmp)
        mf_s.copy_(torch.where(upd, t_asg, mf_s))
        mf_x.copy_(torch.where(upd, i - 1, mf_x))
        mf_y.copy_(torch.where(upd, j - 2, mf_y))
        mf_w.copy_(torch.where(upd, _shift(W3, 1), mf_w))
        c = (j - 1).clamp(0, C - 1).to(_I64).expand(B, R)
        mcs, mcx = torch.gather(mc_s, 1, c), torch.gather(mc_x, 1, c)
        mcw = torch.gather(mc_w, 1, c)
        diag = t_dg + s
        left = mf_s + self.igap + (j - (mf_y + 1)) * self.egap + s
        up = mcs + self.igap + (i - (mcx + 1)) * self.egap + s
        l_ok, u_ok = j >= 2, i >= 2
        take_d = (~l_ok | (diag >= left)) & (~u_ok | (diag >= up))
        take_u = ~take_d & u_ok & (~l_ok | (up > left))
        cell = torch.where(take_d, diag, torch.where(take_u, up, left))
        w = torch.where(
            take_d, _shift(W2, 1) + 1 + (eq.to(torch.int32) << 16),
            torch.where(take_u, mcw + torch.clamp(i - mcx, min=1),
                        mf_w + torch.maximum(i - mf_x, j - mf_y)))
        cell = torch.where(valid & ((i == 0) | (j == 0)), s, cell)
        cell = torch.where(valid, cell, NEG).to(torch.int32)
        w = torch.where(inner, w, 0).to(torch.int32)
        mupd = inner & (i >= 2) & (j >= 2) & (t_up2 > mcs)
        mc_s.scatter_(1, c, torch.where(mupd, t_up2, mcs))
        mc_x.scatter_(1, c, torch.where(mupd, i - 2, mcx).to(torch.int32))
        mc_w.scatter_(1, c, torch.where(mupd, _shift(W3, 2), mcw))
        # row d starts on this diagonal: its tracker begins at (d, 0)
        row = (i == d) & valid
        mf_s.copy_(torch.where(row, cell, mf_s))
        mf_x.copy_(torch.where(row, i, mf_x))
        mf_y.copy_(torch.where(row, 0, mf_y))
        mf_w.copy_(torch.where(row, 0, mf_w))
        elig = inner & ((i == self.xl - 1) | (j == self.yl - 1))
        key = torch.where(elig, cell.to(_I64) * 65536 + i, -(1 << 62))
        dk = key.amax(1)
        take = elig.any(1) & (dk >= self.bkey)
        self.bkey.copy_(torch.where(take, dk, self.bkey))
        self.bj.copy_(torch.where(take, d - (dk & 65535), self.bj))
        self.bw.copy_(torch.where(
            take, torch.gather(w, 1, (dk & 65535)[:, None])[:, 0], self.bw))
        if self.frm is not None:
            fx = torch.where(take_d, i - 1, torch.where(take_u, mcx, mf_x))
            fy = torch.where(take_d | take_u, j - 1, mf_y)
            self.frm.index_copy_(1, d.view(1).to(_I64), torch.where(
                inner, (fx << 12) | fy, -1).to(torch.int32)[:, None, :])
        D3.copy_(D2)
        D2.copy_(D1)
        D1.copy_(cell)
        W3.copy_(W2)
        W2.copy_(W1)
        W1.copy_(w)
        d += 1

    def run(self, eager: int = 3) -> None:
        """All the diagonals: on a card the first few eagerly, the rest
        as replays of one captured step."""
        n = min(eager, self.ND) if self.Xt.is_cuda else self.ND
        for _ in range(n):
            self.step()
        if n < self.ND:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step()
            for _ in range(self.ND - n):
                graph.replay()


def align(X: list, Y: list, igap: int, egap: int, device,
          paths: bool = False):
    """The gapped aligner over pairs (X[b] db read, Y[b] query read), all
    at once, one anti-diagonal a step.  Each cell carries the length and
    the identities of the traceback that would start there: a move from
    (fx, fy) to (i, j) adds max(i - fx, j - fy) to the length, and a
    diagonal move onto equal bases one identity (the report's '*'s are
    exactly those).  Returns [(length, identities), ...] of the best
    cells, and with `paths` also the cells each traceback visits,
    [[(i, j), ...], ...], from the best cell to row 0 or column 0."""
    wf = _Wavefront(X, Y, igap, egap, device, paths)
    wf.run()
    B, ND, frm = wf.B, wf.ND, wf.frm
    found = wf.bkey > -(1 << 62)
    bw = torch.where(found, wf.bw, 0).cpu().numpy()
    stats = [(int(v & 0xFFFF), int(v >> 16)) for v in bw]
    if not paths:
        return stats
    bi = torch.where(found, wf.bkey & 65535, 0)
    bj = torch.where(found, wf.bj, 0)
    # the traceback: from the best cell until row 0 or column 0
    px, py = bi.clone(), bj.clone()
    steps = [torch.stack([px, py], 1)]
    rows = torch.arange(B, device=device)
    while True:
        for _ in range(32):
            live = (px > 0) & (py > 0)
            w = frm[rows, (px + py).clamp(max=ND - 1), px].to(_I64)
            px = torch.where(live, w >> 12, px)
            py = torch.where(live, w & 4095, py)
            steps.append(torch.stack([px, py], 1))
        if not bool(((px > 0) & (py > 0)).any()):
            break
    walk = torch.stack(steps, 1).cpu().numpy()  # [B, steps, 2]
    out = []
    for b in range(B):
        wb = walk[b]
        stop = np.flatnonzero((wb[:, 0] == 0) | (wb[:, 1] == 0))
        n = stop[0] + 1 if len(stop) else len(wb)
        out.append([(int(x), int(y)) for x, y in wb[:n]])
    return stats, out
