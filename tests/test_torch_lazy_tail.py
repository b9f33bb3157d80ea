"""The host gate's lazy candidate tails (imsame_tpu_torch pipeline
TorchEngine._compare): stages 2 and 3 build the [F, N_r) candidates of
only the reads they gate.  On samples where stage 1 resolves most reads,
where stage-1 passes all reject (stage 3 gates their tails), and where
no read passes stage 1, the port's pairs, counters, stage stats and report
bytes equal the JAX engine's, and every candidate built is gated once:
the counter ``gate_built_cands`` equals ``n_candidates``, on one device
and on a two-position mesh of the CPU device."""

import random

import pytest
import torch

from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.pipeline import TorchEngine
from util_synth import make_pair

THRESHOLDS = {"min_coverage": 0.3, "min_identity": 0.65, "igap": -3,
              "egap": -1}

# name: (seed, engine config, make_pair arguments, mesh grid or None)
CASES = {
    # 90 % of the db copies of query reads: most reads accept in stage 1
    "stage1_resolves": (21, {"first_window": 4},
                        dict(n_query=40, n_db=40, read_len=150,
                             match_frac=0.9, sub_rate=0.05,
                             indel_rate=0.02), None),
    # test_pipeline_parity_thresholds' sample at F = 2: stage-1 passes
    # that all reject, so stage 3 gates their tails
    "stage1_rejects": (24, {"first_window": 2, **THRESHOLDS},
                       dict(n_query=25, n_db=25, read_len=150,
                            sub_rate=0.12, indel_rate=0.05), None),
    # copies 40 % substituted: no stage-1 pass, stage 2 finds the accept
    "no_stage1_pass": (58, {"first_window": 1},
                       dict(n_query=30, n_db=30, read_len=150,
                            match_frac=1.0, sub_rate=0.4,
                            indel_rate=0.03), None),
    "mesh_stage1_rejects": (24, {"first_window": 2, **THRESHOLDS},
                            dict(n_query=25, n_db=25, read_len=150,
                                 sub_rate=0.12, indel_rate=0.05), (2, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lazy_tail_matches_jax(tmp_path, case):
    seed, kw, pair_kw, grid = CASES[case]
    qp, dp = make_pair(tmp_path, random.Random(seed), **pair_kw)
    jq = jread_fasta(str(qp))
    jeng = TpuEngine(jread_fasta(str(dp)), JConfig(mesh_shape=None, **kw))
    jres = jeng.compare(jq)

    q = tread_fasta(str(qp))
    mesh_kw = {} if grid is None else {"mesh_devices": ["cpu"] * 2}
    eng = TorchEngine(tread_fasta(str(dp)), TConfig(mesh_shape=grid, **kw),
                      device="cpu", **mesh_kw)
    assert not eng._use_enum
    assert (eng._mesh is None) == (grid is None)
    res = eng.compare(q)

    ss = eng.stage_stats
    if case == "stage1_resolves":
        assert ss["s1"][2] > ss["s2"][2] and ss["s2"][0] > 0
    elif case.endswith("stage1_rejects"):
        assert ss["s3"][0] > 0
    else:
        assert ss["s1"][0] > 0 and ss["s1"][1] == 0
        assert ss["s2"][0] > 0 and res.accepted > 0

    assert res.pairs == jres.pairs
    assert res.n_candidates == jres.n_candidates
    assert res.nw_cells == jres.nw_cells
    assert ss == jeng.stage_stats
    assert eng.render_report(q, res) == jeng.render_report(jq, jres)
    assert dict(eng.timer.counts())["gate_built_cands"] == res.n_candidates
