"""The gate's rung (imsame_tpu_torch pipeline.rung_engages, rung_window,
TorchEngine._compare): where stage 1's window reaches fewer than K + 1
k-mers at the index's mean bucket load, the reads stage 1 leaves open gate
the candidates of their first K + 1 k-mers, ranks [F, W_r), before their
tails [W_r, N_r).

The rule is a pure function of stage 1's window and the load, off at every
load the auto-widened window covers.  Forced on (the rule's function
patched) on small samples whose reads carry decoys -- db reads holding a
few of a query read's first bases, whose candidates fill stage 1's window
and fail the gate, or pass it and reject -- the port's pairs, NW cells and
report bytes equal the JAX engine's, every candidate built is gated once,
and the rung saves the tails of the reads it resolves: on one device, on a
two-position CPU mesh, through the dict-routed gate, in the three-word
candidate format and with device enumeration."""

import random

import numpy as np
import pytest
import torch

from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch import pipeline
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.constants import FIXED_K
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.pipeline import (
    TorchEngine, first_window_at, rung_engages, rung_window,
)
from util_synth import make_pair, random_read, write_fasta

# The cells' mean bucket loads (index entries / 4^12) and stage-1 windows:
# mock100k's 23.9 M entries, gut1m's 258,441,216.
LOAD_MOCK100K, LOAD_GUT1M = 1.4245, 15.404


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the rule
def test_rule_at_the_cells():
    assert first_window_at(TConfig(), LOAD_MOCK100K) == 24
    assert first_window_at(TConfig(), LOAD_GUT1M) == 64
    assert not rung_engages(24, LOAD_MOCK100K)
    assert rung_engages(64, LOAD_GUT1M)


def test_rule_off_under_auto_up_to_load_4_92():
    """The auto-widened window covers K + 1 k-mers up to the load where
    its cap of 64 binds past it: 64 / 13 = 4.923."""
    cfg = TConfig()
    for load in np.linspace(0.0, 4.92, 4921):
        assert not rung_engages(first_window_at(cfg, load), load), load
    assert rung_engages(first_window_at(cfg, 4.93), 4.93)


def test_rule_honours_an_explicit_first_window():
    pinned = {"first_window_auto": False}
    for cfg, load, F, on in (
        (TConfig(first_window=256, **pinned), LOAD_GUT1M, 256, False),
        (TConfig(first_window=32, **pinned), LOAD_GUT1M, 32, True),
        (TConfig(first_window=8, **pinned), 1.0, 8, True),
        (TConfig(first_window=8), 1.0, 16, False),
        # auto on: an explicitly larger window is honored past the cap
        (TConfig(first_window=300), LOAD_GUT1M, 300, False),
    ):
        assert first_window_at(cfg, load) == F
        assert rung_engages(F, load) == on, (cfg, load)


def test_rung_window_from_a_stream_table():
    """W_r is the candidates of read r's first K + 1 k-mer slots, at most
    its N_r: a read of 20 slots, one of fewer than K + 1, one whose first
    K + 1 slots hold no more than stage 1's window, and one of none."""
    cnt = np.array(
        [2, 0, 3] + [1] * 17          # read 0: 20 slots, 22 candidates
        + [4, 1, 0, 2, 5]             # read 1: 5 slots (< K + 1)
        + [0] * 12 + [1, 7, 7]        # read 2: 15 slots, 1 in the first 13
        , np.int64)
    K_off = np.array([0, 20, 25, 40, 40], np.int64)
    Ccum = np.zeros(len(cnt) + 1, np.int64)
    np.cumsum(cnt, out=Ccum[1:])
    stream = (None, K_off, None, cnt, Ccum, Ccum[K_off])
    N_r = Ccum[K_off[1:]] - Ccum[K_off[:-1]]
    reads = np.arange(4)
    W = rung_window(stream, reads)
    assert FIXED_K + 1 == 13
    assert W.tolist() == [2 + 0 + 3 + 10, 12, 1, 0]
    assert (W <= N_r).all() and W[1] == N_r[1]
    # a read whose W_r is no more than F skips the rung
    assert W[2] <= first_window_at(TConfig(), 1e-3)
    assert rung_window(stream, np.array([2, 0])).tolist() == [1, 15]


# ------------------------------------------------------ the rung, forced on
def _sub_at(rng, read, positions):
    s = list(read)
    for p in positions:
        s[p] = rng.choice([c for c in "ACGT" if c != s[p]])
    return "".join(s)


def _embed(rng, seg, at, length, avoid=None):
    """A random read of ``length`` bases holding ``seg`` at ``at``; the base
    before it is not ``avoid`` (the previous query read's last base, which
    the query read's first k-mer slot spans)."""
    left = random_read(rng, at)
    if avoid is not None and left[-1] == avoid:
        left = left[:-1] + rng.choice([c for c in "ACGT" if c != avoid])
    return left + seg + random_read(rng, length - at - len(seg))


# The kinds of query read a decoy sample holds, by the db reads each brings
# (a copy's substitutions at 11 and 22 kill its k-mers starting at bases
# 0-22, so its first clean seed lies past the rung):
#   plain          a 3 %-substituted copy (stage 1 resolves it)
#   rung_resolves  a copy substituted at bases 3 and 6, and a decoy of the
#                  first 20 bases: stage 1 sees the decoy, the rung the copy
#   tail_resolves  a copy substituted at 11 and 22 and that decoy: the rung
#                  has no pass, the tail [W_r, N_r) finds the copy
#   no_copy        decoys of bases 0-19 and 80-99: the rung, then the tail
#   rung_rejects   a decoy of bases 0-13, one of bases 5-64 (it passes the
#                  gate and rejects at 90 % identity) and the late copy:
#                  the rung's passes all reject, the tail accepts
#   skip_rung      a decoy of bases 0-12 and the late copy: at F = 2 the
#                  first K + 1 k-mers hold no more than F candidates
KINDS = ("plain", "rung_resolves", "tail_resolves", "no_copy",
         "rung_rejects", "skip_rung")


def decoy_pair(tmp, rng, kinds=KINDS, n_each=4, read_len=150):
    q, db = [], []
    for i in range(n_each * len(kinds)):
        kind = kinds[i % len(kinds)]
        r = random_read(rng, read_len)
        prev = q[-1][-1] if q else None
        q.append(r)
        late = [11, 22] + [p for p in range(23, read_len)
                           if rng.random() < 0.02]
        db += {
            "plain": lambda: [_sub_at(rng, r, [
                p for p in range(read_len) if rng.random() < 0.03])],
            "rung_resolves": lambda: [
                _sub_at(rng, r, [3, 6]),
                _embed(rng, r[:20], 60, read_len, prev)],
            "tail_resolves": lambda: [
                _sub_at(rng, r, late),
                _embed(rng, r[:20], 60, read_len, prev)],
            "no_copy": lambda: [
                _embed(rng, r[:20], 60, read_len, prev),
                _embed(rng, r[80:100], 30, read_len)],
            "rung_rejects": lambda: [
                _sub_at(rng, r, late),
                _embed(rng, r[:14], 70, read_len, prev),
                _embed(rng, r[5:65], 40, read_len)],
            "skip_rung": lambda: [
                _sub_at(rng, r, late),
                _embed(rng, r[:13], 70, read_len, prev)],
        }[kind]()
    rng.shuffle(db)
    qp, dp = tmp / "q.fa", tmp / "db.fa"
    write_fasta(qp, q, "q")
    write_fasta(dp, db, "d")
    return qp, dp


# the decoy of bases 5-64 rejects at this identity; the copies accept
STRICT = {"min_identity": 0.9}
# test_torch_lazy_tail.py's "stage1_resolves" sample at F = 1: 5 %
# substitutions and 2 % indels put some copies' first seed past stage 1
MAKE_PAIR = dict(n_query=40, n_db=40, read_len=150, match_frac=0.9,
                 sub_rate=0.05, indel_rate=0.02)
# name: (seed, stage-1 window, the kinds of a decoy sample or None for
# make_pair's, mesh grid or None, engine config, PACKED_MAX_READS or None)
CASES = {
    "make_pair": (21, 1, None, None, {}, None),
    "rung_resolves": (31, 1, ("plain", "rung_resolves"), None, STRICT,
                      None),
    "rung_then_tail": (32, 2, ("no_copy", "tail_resolves", "skip_rung"),
                       None, STRICT, None),
    "rung_rejects": (33, 1, ("rung_rejects",), None, STRICT, None),
    "mesh (2, 1)": (35, 1, KINDS, (2, 1), STRICT, None),
    "routed mesh (1, 2)": (36, 2, KINDS, (1, 2), STRICT, None),
    "three words": (37, 1, KINDS, None, STRICT, 16),
    "enumeration": (38, 2, KINDS, None, {"gate_enum": True, **STRICT},
                    None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rung_matches_jax(tmp_path, monkeypatch, case):
    seed, F, kinds, grid, extra, packed_max = CASES[case]
    rng = random.Random(seed)
    qp, dp = (make_pair(tmp_path, rng, **MAKE_PAIR) if kinds is None
              else decoy_pair(tmp_path, rng, kinds))
    kw = {"first_window": F,
          **{k: v for k, v in extra.items() if k != "gate_enum"}}
    jq = jread_fasta(str(qp))
    jeng = TpuEngine(jread_fasta(str(dp)), JConfig(mesh_shape=None, **kw))
    jres = jeng.compare(jq)

    monkeypatch.setattr(pipeline, "rung_engages", lambda F, load: True)
    if packed_max is not None:
        monkeypatch.setattr(pipeline, "PACKED_MAX_READS", packed_max)
    q = tread_fasta(str(qp))
    mesh_kw = {} if grid is None else {"mesh_devices": ["cpu"] * 2}
    eng = TorchEngine(tread_fasta(str(dp)),
                      TConfig(mesh_shape=grid, first_window=F, **extra),
                      device="cpu", **mesh_kw)
    assert eng._use_enum == bool(extra.get("gate_enum"))
    fmt = eng._gate_format(q.n_seqs)
    assert fmt == {"routed mesh (1, 2)": "routed", "three words": "wide",
                   "mesh (2, 1)": "two_words"}.get(case, "seg")
    res = eng.compare(q)

    counts = dict(eng.timer.counts())
    ss = eng.stage_stats
    rung_reads = counts["gate_rung_reads"]
    resolved = counts["gate_rung_resolved"]
    assert 0 < rung_reads <= q.n_seqs and 0 <= resolved <= rung_reads
    assert ss["s2w"][0] >= rung_reads
    # stage 1 and stage 3 are the JAX engine's; the rung splits stage 2
    assert ss["s1"] == jeng.stage_stats["s1"]
    assert ss["s3"] == jeng.stage_stats["s3"]
    if case == "rung_resolves":
        assert resolved > 0
    elif case == "rung_then_tail":
        assert resolved == 0 and ss["s2w"][1] == 0
        assert ss["s2"][0] > 0 and res.accepted > 0
        assert res.n_candidates == jres.n_candidates
    elif case == "rung_rejects":
        assert resolved == 0 and ss["s2w"][2] > 0 and ss["s2"][0] > 0
        assert res.accepted == q.n_seqs
        assert res.n_candidates == jres.n_candidates
    else:
        assert resolved > 0

    assert res.pairs == jres.pairs
    assert res.nw_cells == jres.nw_cells
    assert eng.render_report(q, res) == jeng.render_report(jq, jres)
    assert res.n_candidates <= jres.n_candidates
    if resolved:
        assert res.n_candidates < jres.n_candidates
    if eng._use_enum:
        assert "gate.enum" in res.timings and "gate_built_cands" not in counts
    else:
        assert counts["gate_built_cands"] == res.n_candidates


def test_rule_off_on_a_decoy_sample(tmp_path):
    """At a test sample's load the rule is off: no rung, no rung counters,
    and the stage stats and candidates are the JAX engine's."""
    qp, dp = decoy_pair(tmp_path, random.Random(39))
    kw = {"first_window": 1, **STRICT}
    jq = jread_fasta(str(qp))
    jeng = TpuEngine(jread_fasta(str(dp)), JConfig(mesh_shape=None, **kw))
    jres = jeng.compare(jq)
    q = tread_fasta(str(qp))
    eng = TorchEngine(tread_fasta(str(dp)), TConfig(mesh_shape=None, **kw),
                      device="cpu")
    assert not rung_engages(eng.first_window(), eng.load())
    res = eng.compare(q)
    counts = dict(eng.timer.counts())
    assert "gate_rung_reads" not in counts
    assert "gate_rung_resolved" not in counts
    assert eng.stage_stats == jeng.stage_stats
    assert res.n_candidates == jres.n_candidates
    assert counts["gate_built_cands"] == res.n_candidates
    assert res.pairs == jres.pairs and res.nw_cells == jres.nw_cells
