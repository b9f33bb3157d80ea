"""The engine's placement seam (imsame_tpu_torch/pipeline.py TorchEngine):
the counters and phase names of a small CPU compare and render in each
candidate format -- seg words, two words on the wide index, three words,
the dict-routed gate of a (2, 2) mesh -- equal the values recorded before
the seam was drawn, and every host array that reaches a device goes
through the engine's one upload function, ``TorchEngine._put``."""

import random

import numpy as np
import pytest
import torch

from imsame_tpu_torch import pipeline
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.io.fasta import read_fasta
from imsame_tpu_torch.pipeline import TorchEngine
from util_synth import make_pair

# test_torch_spans.py's "small_round" config: several gate chunks and NW
# batches a stage, a second gate stage and wave
SMALL = {"first_window": 4, "gate_chunks": (64, 32),
         "nw_stats_batches": (8,), "nw_render_batches": (8,)}
# the same on a (2, 2) mesh: gate chunks of 32 candidates a position, NW
# batches of 8 pairs a position
MESH = {"first_window": 4, "gate_chunks": (256, 128),
        "nw_stats_batches": (32,), "nw_render_batches": (32,),
        "mesh_shape": (2, 2)}

# (PACKED_MAX_READS, query reads, config) of each candidate format
CASES = {
    "seg": (None, 40, SMALL),
    "two words, wide index": (30, 20, SMALL),
    "three words": (16, 40, SMALL),
    "mesh (2, 2)": (None, 40, MESH),
}
# each case's counters after its compare and render, recorded on the
# engine before the seam; index_built_entries, the entries of the db's
# index (40 reads, 5,992 bases), counts the engine's build, and
# render_launched_cells the render's chunks: 20 pairs at L = 256 in
# chunks of 8 (24 pairs) or, on the mesh, one chunk of 32
COUNTS = {
    "seg": {"gate_built_cands": 326, "gate_cand_bytes": 1648,
            "h2d_bytes": 28360, "nw_launched_cells": 1572864,
            "render_native_records": 20,
            "index_built_entries": 5552,
            "render_launched_cells": 1572864},
    "two words, wide index": {"gate_built_cands": 325,
                              "gate_cand_bytes": 2816, "h2d_bytes": 50828,
                              "nw_launched_cells": 1572864,
                              "render_native_records": 20,
                              "index_built_entries": 5552,
                              "render_launched_cells": 1572864},
    "three words": {"gate_built_cands": 326, "gate_cand_bytes": 4224,
                    "h2d_bytes": 53304, "nw_launched_cells": 1572864,
                    "render_native_records": 20,
                    "index_built_entries": 5552,
                    "render_launched_cells": 1572864},
    "mesh (2, 2)": {"gate_built_cands": 326, "gate_cand_bytes": 3072,
                    "h2d_bytes": 30168, "nw_launched_cells": 4194304,
                    "render_native_records": 20,
                    "index_built_entries": 5552,
                    "render_launched_cells": 2097152},
}
# the phases of every case, recorded with the counters
PHASES = {
    "compare", "engine", "engine.upload", "gate.build", "gate.dispatch",
    "gate.encode", "gate.fetch", "gate.launch", "gate.upload",
    "index_build", "kmer_stream", "nw.dispatch", "nw.fetch1", "nw.fetch2",
    "nw.scatter", "render.blocks", "render.collect", "render.dispatch",
    "render.fetch", "render.format", "render_report", "resolve",
    "resolve.extend", "resolve.judge", "resolve.nw", "upload",
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    qp, dp = make_pair(tmp_path_factory.mktemp("placement"),
                       random.Random(21), n_query=40, n_db=40, read_len=150,
                       sub_rate=0.05, indel_rate=0.02)
    return read_fasta(str(qp)), read_fasta(str(dp))


def _job(samples, case, mp):
    """Engine, compare and render of one case: (engine, result)."""
    packed_max, n_q, kw = CASES[case]
    if packed_max is not None:
        mp.setattr(pipeline, "PACKED_MAX_READS", packed_max)
    q, db = samples
    q = q.slice_reads(0, n_q)
    grid = kw.get("mesh_shape")
    eng = TorchEngine(db, Config(**kw), device="cpu",
                      mesh_devices=None if grid is None
                      else ["cpu"] * (grid[0] * grid[1]))
    res = eng.compare(q)
    assert res.accepted > 0 and eng.render_report(q, res)
    return eng, res


@pytest.mark.parametrize("case", list(CASES))
def test_counters_and_phases_are_the_recorded_ones(samples, case):
    with pytest.MonkeyPatch.context() as mp:
        eng, res = _job(samples, case, mp)
    assert res.accepted == 20
    assert dict(eng.timer.counts()) == COUNTS[case]
    assert set(dict(eng.timer.items())) == PHASES


@pytest.mark.parametrize("grid", [None, (2, 1)])
def test_every_host_array_reaches_a_device_through_put(samples, grid):
    """With the torch functions that take a host array wrapped, each
    array a compare and render hands them is handed inside
    TorchEngine._put, and their bytes sum to h2d_bytes."""
    inside, sent, strays = [], [], []

    def watch(fn):
        def watched(x, *a, **kw):
            if isinstance(x, np.ndarray):
                (sent if inside else strays).append(x.nbytes)
            return fn(x, *a, **kw)
        return watched

    put = TorchEngine._put

    def watched_put(self, x, device=None):
        inside.append(True)
        try:
            return put(self, x, device)
        finally:
            inside.pop()

    q, db = samples
    kw = SMALL if grid is None else dict(MESH, mesh_shape=grid)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("as_tensor", "from_numpy", "tensor"):
            mp.setattr(torch, name, watch(getattr(torch, name)))
        mp.setattr(TorchEngine, "_put", watched_put)
        eng = TorchEngine(db, Config(**kw), device="cpu",
                          mesh_devices=None if grid is None
                          else ["cpu"] * 2)
        res = eng.compare(q)
        assert res.accepted > 0 and eng.render_report(q, res)
    assert (eng._mesh is None) == (grid is None)
    assert sent and not strays
    assert sum(sent) == dict(eng.timer.counts())["h2d_bytes"]
