"""Length buckets on the card and on the CPU.

The NW kernels are instantiated for the buckets of ops/nw_cuda.py LENGTHS
only.  An engine on a card refuses a Config.length_buckets with another
bucket when it is built, before any index build or gate, naming those
buckets; on the CPU the plain versions take any multiple of 128, as the
JAX engine does, and give its results."""

import random

import pytest

import imsame_tpu_torch.pipeline as tpipe
from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.ops import nw_cuda
from util_synth import mutate, random_read, write_fasta

BUCKETS = (256, 768, 3072)


def _pair(tmp_path):
    """Reads of 150-700 bp (buckets 256 and 768 of BUCKETS), half the db
    reads mutated copies."""
    rng = random.Random(768)
    q = [random_read(rng, n) for n in (150, 300, 520, 700, 640, 230)]
    db = [mutate(rng, q[i], 0.04, 0.01) for i in (0, 2, 3)]
    db += [random_read(rng, n) for n in (400, 690, 200)]
    write_fasta(tmp_path / "q.fa", q, "q")
    write_fasta(tmp_path / "db.fa", db, "d")
    return str(tmp_path / "q.fa"), str(tmp_path / "db.fa")


@pytest.mark.parametrize("how", ["cuda_device", "patched_check",
                                 "mesh_devices"])
def test_card_engine_refuses_uninstantiated_buckets(tmp_path, monkeypatch,
                                                    how):
    """A CUDA engine (here: device "cuda", the device check patched to
    see a card, or mesh positions on "cuda:0") raises at construction,
    before the index build, and names nw_cuda.LENGTHS."""
    def no_index(*a, **k):
        raise AssertionError("the index was built")

    monkeypatch.setattr(tpipe, "build_index", no_index)
    _, dp = _pair(tmp_path)
    kw = dict(device="cpu")
    if how == "cuda_device":
        kw = dict(device="cuda")
    elif how == "patched_check":
        monkeypatch.setattr(tpipe, "_runs_kernels", lambda devices: True)
    else:
        kw = dict(device="cpu", mesh_devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="nw_cuda.LENGTHS") as e:
        tpipe.TorchEngine(tread_fasta(dp), TConfig(length_buckets=BUCKETS),
                          **kw)
    assert "[768]" in str(e.value) and str(nw_cuda.LENGTHS) in str(e.value)


def test_cpu_engine_takes_other_buckets_like_jax(tmp_path):
    qp, dp = _pair(tmp_path)
    kw = dict(length_buckets=BUCKETS, nw_stats_batches=(8,),
              nw_render_bp_budget=64 << 20)
    jq, jdb = jread_fasta(qp), jread_fasta(dp)
    jeng = TpuEngine(jdb, JConfig(mesh_shape=None, **kw))
    jres = jeng.compare(jq)
    tq, tdb = tread_fasta(qp), tread_fasta(dp)
    teng = tpipe.TorchEngine(tdb, TConfig(**kw), device="cpu")
    tres = teng.compare(tq)
    assert tres.accepted == jres.accepted >= 3
    assert tres.pairs == jres.pairs
    assert tres.n_candidates == jres.n_candidates
    assert tres.nw_cells == jres.nw_cells
    assert teng.render_report(tq, tres) == jeng.render_report(jq, jres)
