"""The plain reference's answers, and the comparison that decides
`correct`.

For each query read the reference walks the read's candidate stream in
the reference binary's order, gates every candidate, aligns the passing
pairs, and takes the first in stream order that accepts: the read's
answer is that db read, or none.  For a sample of the reads it renders
the accepted pair's record.  Each job of the window is held to it: the
answers of the reads the configuration names (`check_answers`: all, or a
sample drawn from the seed; with every accepted read where reads rarely
accept), the records of a sample (`check_records`),
and, where a job accepted nothing, its candidate count and aligned DP
cells against the counts over every read's whole stream.  Nothing here
imports the program or takes anything it made.

The control (`window=F`) is this reference with one guarantee broken:
each read walks only the first F candidates of its stream, the shortcut
that the compare's first window would tempt, so a read whose first F
candidates do not accept is answered none.
"""

from __future__ import annotations

import hashlib
import re
import time

import numpy as np
import torch

from . import dense, semantics

_HEAD = re.compile(rb"\((\d+), (\d+)\) : ")
_RECORD = re.compile(rb"\n \$\$\$\$\$\$\$ \n")
CONTROL_WINDOW = 16


class Reference:
    def __init__(self, data: dict, cfg: dict, device, window=None,
                 nw_budget: int = 6 << 30):
        self.cfg = cfg
        self.device = device
        self.window = window
        self.nw_budget = nw_budget
        self.seconds = {}  # where the reference's time went, by stage
        t0 = time.perf_counter()
        self.q_codes, self.db_codes = data["q_codes"], data["db_codes"]
        self.q = dense.Sample(data["q_codes"], data["q_starts"], device)
        self.db = dense.Sample(data["db_codes"], data["db_starts"], device)
        self.q_start = np.asarray(data["q_starts"], np.int64)
        self.db_start = np.asarray(data["db_starts"], np.int64)
        self.q_lens = self.q.lens.cpu().numpy()
        self.db_lens = self.db.lens.cpu().numpy()
        self.idx = dense.DbIndex(self.db)
        self.qkeys = self.q.kmer_keys()
        thr = semantics.min_passing_raw(self.q_lens, self.db.total,
                                        cfg["min_e_value"])
        self.thr = torch.as_tensor(thr, device=device)
        self._took("index", t0)

    def _took(self, stage: str, t0: float) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.seconds[stage] = (self.seconds.get(stage, 0.0)
                               + time.perf_counter() - t0)

    def _passing(self, reads: np.ndarray):
        """(read, db read) pairs that pass the gate, in stream order, each
        pair once; and the candidates each read walks."""
        t0 = time.perf_counter()
        r = torch.as_tensor(reads, device=self.device, dtype=torch.int64)
        cr, qp, dp, sid, per_read, rank = dense.candidates(
            self.q, self.qkeys, self.idx, r)
        if self.window is not None:
            keep = rank < self.window
            cr, qp, dp, sid = cr[keep], qp[keep], dp[keep], sid[keep]
            per_read = per_read.clamp(max=self.window)
        ok = dense.gate(self.q, self.db, self.thr, cr, qp, dp, sid)
        pr = cr[ok].cpu().numpy()
        ps = sid[ok].cpu().numpy()
        key = pr * self.db.n + ps
        _, first = np.unique(key, return_index=True)
        first.sort()
        self._took("gate", t0)
        return pr[first], ps[first], per_read.cpu().numpy()

    def _pair(self, r: int, s: int) -> tuple:
        X = self.db_codes[self.db_start[s]:self.db_start[s] + self.db_lens[s]]
        Y = self.q_codes[self.q_start[r]:self.q_start[r] + self.q_lens[r]]
        return X, Y

    def _blocks(self, pairs: list, per_pair):
        """Blocks of pairs of like size, longest first, each within the
        budget given per_pair(L) bytes a pair."""
        size = [max(self.q_lens[r], self.db_lens[s]) for r, s in pairs]
        order = sorted(range(len(pairs)), key=lambda k: -size[k])
        a = 0
        while a < len(order):
            per = max(1, self.nw_budget // per_pair(size[order[a]]))
            yield order[a:a + per]
            a += per

    def _align(self, pairs: list, paths: bool):
        t0 = time.perf_counter()
        out = [None] * len(pairs)
        per_pair = (lambda L: 8 * L * L) if paths else (lambda L: 256 * L)
        for block in self._blocks(pairs, per_pair):
            XY = [self._pair(*pairs[k]) for k in block]
            got = dense.align([x for x, _ in XY], [y for _, y in XY],
                              self.cfg["igap"], self.cfg["egap"], self.device,
                              paths=paths)
            if not paths:
                for k, st in zip(block, got):
                    out[k] = st
                continue
            for k, (X, Y), st, path in zip(block, XY, *got):
                rx, ry, hx, hy, ml, length = semantics.buffers_from_path(
                    X, Y, path)
                text, ident = semantics.render_alignment(rx, ry, hx, hy, ml)
                if (length, ident) != st:
                    raise AssertionError(
                        f"reference: pair {pairs[k]} path gives {length}, "
                        f"{ident}; the aligner's stats {st}")
                out[k] = (length, ident, text)
        self._took("paths" if paths else "align", t0)
        return out

    def answers(self, reads: np.ndarray, chunk: int = 20000) -> dict:
        """{read: db read or None}: the first passing pair in stream order
        that accepts, as the reference binary finds it."""
        c = self.cfg
        won = {int(r): None for r in reads}
        for a in range(0, len(reads), chunk):
            pr, ps, _ = self._passing(reads[a:a + chunk])
            pairs = [(int(r), int(s)) for r, s in zip(pr, ps)]
            for (r, s), (length, ident) in zip(pairs,
                                               self._align(pairs, False)):
                if won[r] is None and length and semantics.accepts(
                        length, ident, int(self.q_lens[r]),
                        c["min_coverage"], c["min_identity"]):
                    won[r] = s
        return won

    def records(self, won: dict) -> dict:
        """{read: record bytes} of the accepted pairs in `won`."""
        chosen = [(r, s) for r, s in won.items() if s is not None]
        return {r: semantics.format_record(r, s, ident, length,
                                           int(self.q_lens[r]), text)
                for (r, s), (length, ident, text)
                in zip(chosen, self._align(chosen, True))}

    def full_counts(self, chunk: int = 4000) -> tuple:
        """(candidates the reads walk over their streams, sum of db length
        x query length over every passing pair, each pair once)."""
        n_cand, cells = 0, 0
        for a in range(0, self.q.n, chunk):
            reads = np.arange(a, min(a + chunk, self.q.n))
            pr, ps, per_read = self._passing(reads)
            n_cand += int(per_read.sum())
            cells += int((self.q_lens[pr].astype(np.int64)
                          * self.db_lens[ps]).sum())
        return n_cand, cells


def program_records(report: bytes, reads) -> dict:
    """{read: record bytes} read off a job's report for the given reads
    (several records of one read come back joined)."""
    arr = np.frombuffer(report, np.uint8)
    at = np.flatnonzero(arr == ord("("))
    ends = np.append(at[1:], len(report))
    want = {int(r) for r in reads}
    got = {}
    for k, p in enumerate(at):
        m = _HEAD.match(report, int(p))
        r = int(m.group(1)) if m else -1
        if r in want:
            got[r] = got.get(r, b"") + report[p:ends[k]]
    return got


def job_digest(job: dict) -> str:
    h = hashlib.sha256(job["report"])
    h.update(repr((job["pairs"], job["accepted"], job["n_candidates"],
                   job["nw_cells"])).encode())
    return h.hexdigest()


def pick_reads(rng, n_reads: int, q_lens: np.ndarray, how) -> np.ndarray:
    """All reads, or `how` of them drawn from the seed with the longest
    read among them."""
    if how == "all":
        return np.arange(n_reads)
    pick = rng.choice(n_reads, size=min(int(how), n_reads), replace=False)
    return np.unique(np.append(pick, int(np.argmax(q_lens))))


def plan(config: dict, q_lens: np.ndarray, rng) -> tuple:
    """(reads whose answers are held, reads whose records are held: some
    of the former, the longest read among them)."""
    n = len(q_lens)
    ans = pick_reads(rng, n, q_lens, config["check_answers"])
    k = min(int(config["check_records"]), len(ans))
    rec = np.unique(np.append(rng.choice(ans, size=k, replace=False),
                              int(np.argmax(q_lens))))
    return np.union1d(ans, rec), rec


def with_accepted(ans_reads: np.ndarray, jobs: list) -> np.ndarray:
    """The reads whose answers are held, and every read a job accepted
    where the jobs accepted no more reads than that (a cell where reads
    rarely accept has each accept held)."""
    acc = np.unique(np.array([r for j in jobs for r, _ in j["pairs"]],
                             np.int64))
    return np.union1d(ans_reads, acc) if len(acc) <= len(ans_reads) \
        else ans_reads


def reference_view(ref: Reference, ans_reads, rec_reads, full: bool) -> dict:
    """What the reference (or the control) says about those reads."""
    won = ref.answers(ans_reads)
    view = dict(won=won,
                records=ref.records({r: won[r] for r in rec_reads}))
    if full:
        view["counts"] = ref.full_counts()
    return view


def job_view(job: dict, ans_reads, rec_reads) -> dict:
    """What a job of the window says about those reads."""
    pairs = {}
    for r, s in job["pairs"]:
        pairs.setdefault(int(r), []).append(int(s))
    won = {int(r): (pairs[r][0] if len(pairs.get(r, ())) == 1 else
                    None if r not in pairs else -1) for r in ans_reads}
    return dict(won=won, records=program_records(job["report"], rec_reads),
                counts=(job["n_candidates"], job["nw_cells"]),
                accepted=job["accepted"],
                n_records=len(_RECORD.findall(job["report"])),
                digest=job_digest(job))


def compare(want: dict, views: list, full: bool) -> dict:
    """The numbers compared, {name: (value, limit)}: reads whose answer
    differs, sampled records that differ, jobs unlike the first, records
    against the accepted count, and (`full`, where every job accepted
    nothing) the candidate count and the aligned cells."""
    rec_reads = set(want["records"]) | {
        r for v in views for r in v["records"]}
    out = {
        "answers_wrong": (sum(v["won"][r] != want["won"][r]
                              for v in views for r in want["won"]), 0),
        "records_wrong": (sum(v["records"].get(r) != want["records"].get(r)
                              for v in views for r in rec_reads), 0),
        "jobs_unlike_first": (sum(v["digest"] != views[0]["digest"]
                                  for v in views), 0),
        "records_vs_accepted": (sum(abs(v["n_records"] - v["accepted"])
                                    for v in views), 0),
    }
    if full and views and all(v["accepted"] == 0 for v in views):
        n_cand, cells = want["counts"]
        out["candidates_off"] = (sum(abs(v["counts"][0] - n_cand)
                                     for v in views), 0)
        out["nw_cells_off"] = (sum(abs(v["counts"][1] - cells)
                                   for v in views), 0)
    return out


def control_view(ctrl: Reference, ans_reads, rec_reads, full: bool) -> dict:
    """The control's answers, as a job's view, to hold against the
    reference's in the program's place."""
    won = ctrl.answers(ans_reads)
    acc = sum(s is not None for s in won.values())
    return dict(won=won, records=ctrl.records({r: won[r] for r in rec_reads}),
                counts=ctrl.full_counts() if full else (0, 0), accepted=acc,
                n_records=acc, digest="control")
