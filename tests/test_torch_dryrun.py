"""The port's dry run (imsame_tpu_torch.dryrun) against the JAX package's
(__graft_entry__.dryrun_multichip): the same synthetic reads, and at n =
2, 4 and 8 positions on the CPU the same 32 accepted pairs and report
bytes as the JAX engine on a (n/2, 2) mesh of the conftest's virtual CPU
devices and as the port's one-device engine; its refusals.

The plain NW functions compute each pair row once per test
(tests/test_torch_sharded.py plain_rows_once)."""

import types

import numpy as np
import pytest
import torch

import __graft_entry__
from imsame_tpu import pipeline as jpipeline
from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import SeqInfo as JSeqInfo
from imsame_tpu_torch import dryrun
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.pipeline import TorchEngine
from test_torch_sharded import plain_rows_once  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jseqinfo(mat):
    t = dryrun.seqinfo(mat)
    return JSeqInfo(codes=t.codes, start=t.start, fresh=t.fresh,
                    headers=t.headers)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_matches_jax_mesh_and_single(plain_rows_once, capsys, n):
    res, report = dryrun.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith(
        f"DRYRUN_MULTICHIP OK: mesh=(data={n // 2}, dict=2) devices={n} "
        f"cards=1 accepted=32/64 report_bytes={len(report)} wall=")
    assert res.accepted == 32

    qm, dbm = dryrun.dryrun_inputs()
    jq, jdb = _jseqinfo(qm), _jseqinfo(dbm)
    jeng = jpipeline.TpuEngine(jdb, JConfig(mesh_shape=(n // 2, 2)))
    assert jeng._mesh is not None and jeng._mesh.devices.size == n
    jres = jeng.compare(jq)
    assert res.pairs == jres.pairs
    assert report == jeng.render_report(jq, jres)

    q, db = dryrun.seqinfo(qm), dryrun.seqinfo(dbm)
    one = TorchEngine(db, TConfig(mesh_shape=None), device="cpu")
    want = one.compare(q)
    assert res.pairs == want.pairs
    assert report == one.render_report(q, want)


class _Stop(Exception):
    pass


def test_dryrun_inputs_are_graft_entrys(monkeypatch):
    """dryrun_inputs() and seqinfo() give the query and database that
    __graft_entry__.dryrun_multichip hands its engine (caught by a stand-in
    engine that stops the run at its compare)."""
    seen = {}

    class Spy:
        def __init__(self, db, cfg):
            seen["db"] = db
            self._mesh = types.SimpleNamespace(devices=np.empty(2))

        def compare(self, q):
            seen["q"] = q
            raise _Stop

    monkeypatch.setattr(jpipeline, "TpuEngine", Spy)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(_Stop):
        __graft_entry__.dryrun_multichip(2)
    for key, mat in zip(("q", "db"), dryrun.dryrun_inputs()):
        want, got = seen[key], dryrun.seqinfo(mat)
        assert mat.shape == (dryrun.N_READS, dryrun.READ_LEN)
        for f in ("codes", "start", "fresh"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.headers == want.headers


def test_dryrun_refusals(monkeypatch):
    """One position is no mesh; a grid the batch shapes do not divide over
    fails with the engine's own ValueError; a CUDA device with no card
    raises instead of falling back to the CPU."""
    for n in (0, 1):
        with pytest.raises(ValueError, match="2 positions"):
            dryrun.dryrun_multichip(n, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        dryrun.dryrun_multichip(3, device="cpu")  # (3, 1): 2^16 % 96
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(8, device=dev)
