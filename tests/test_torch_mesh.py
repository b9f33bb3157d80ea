"""The port's engine on a mesh (Config.mesh_shape, TorchEngine(...,
mesh_devices=)) against the JAX engine on one device and the port's own
single-device engine: the same accepted pairs, candidates, NW cells and
report bytes at the grids (8, 1), (4, 2) and (2, 4) of eight positions on
the CPU device (the counterpart of the conftest's eight virtual JAX CPU
devices, tests/test_engine_mesh.py), on 150 bp reads and on 300-3,000 bp
reads (every long bucket, the gate's small-window tier at the 3072
window).  Also: the index payload split over "dict", the shapes a mesh
refuses, "auto" on the CPU, and device enumeration's host gate on a mesh.

The plain NW functions compute each pair row once per test
(tests/test_torch_sharded.py plain_rows_once): the mesh's per-position
calls are answered from the rows its first run computed."""

import random

import numpy as np
import pytest
import torch

from imsame_tpu.config import Config as JConfig
from imsame_tpu.io.fasta import read_fasta as jread_fasta
from imsame_tpu.pipeline import TpuEngine
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.parallel.mesh import make_mesh, visible_devices
from imsame_tpu_torch.pipeline import TorchEngine
from test_torch_sharded import plain_rows_once  # noqa: F401 (fixture)
from util_synth import make_pair, mutate, random_read, write_fasta

GRIDS = [(8, 1), (4, 2), (2, 4)]
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _short(tmp_path):
    """tests/test_engine_mesh.py's workload: 48 reads of 150 bp a side."""
    return make_pair(tmp_path, random.Random(32), n_query=48, n_db=48,
                     read_len=150, sub_rate=0.05, indel_rate=0.02)


def _long(tmp_path):
    """Reads of 400-2,900 bp: a mutated copy of a query read in each long
    bucket (512, 1024, 2048, 3072), random reads beside them."""
    rng = random.Random(78)
    q = [random_read(rng, n) for n in (400, 900, 1800, 2900, 600, 2400)]
    db = [mutate(rng, q[i], 0.04, 0.01) for i in range(4)]
    db += [random_read(rng, 1500), random_read(rng, 3000)]
    write_fasta(tmp_path / "q.fa", q, "q")
    write_fasta(tmp_path / "db.fa", db, "d")
    return tmp_path / "q.fa", tmp_path / "db.fa"


# the JAX and single-device configs of each workload, and the mesh's:
# NW batches must divide over 8 positions x 8 pairs
WORKLOADS = {
    "short": (_short, {}, {}),
    "long": (_long, {"nw_stats_batches": (8,), "nw_render_bp_budget": 64 << 20},
             {"nw_stats_batches": (64,), "nw_render_bp_budget": 64 << 20}),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_mesh_engine_matches_jax_and_single(tmp_path, plain_rows_once, name):
    make, kw, mesh_kw = WORKLOADS[name]
    qp, dp = make(tmp_path)
    jq, jdb = jread_fasta(str(qp)), jread_fasta(str(dp))
    jeng = TpuEngine(jdb, JConfig(mesh_shape=None, **kw))
    jres = jeng.compare(jq)
    jreport = jeng.render_report(jq, jres)
    assert jres.accepted >= 4

    q, db = tread_fasta(str(qp)), tread_fasta(str(dp))
    one = TorchEngine(db, TConfig(mesh_shape=None, **kw), device="cpu")
    assert one._mesh is None
    res1 = one.compare(q)
    assert res1.pairs == jres.pairs
    assert one.render_report(q, res1) == jreport
    if name == "long":
        qlens = q.read_lens()
        buckets = {one._nw_bucket(max(qlens[r], one.db_read_lens[s]))
                   for r, s in res1.pairs}
        assert buckets == {512, 1024, 2048, 3072}
    for grid in GRIDS:
        eng = TorchEngine(db, TConfig(mesh_shape=grid, **mesh_kw),
                          device="cpu", mesh_devices=CPU8)
        assert eng._mesh.shape == {"data": grid[0], "dict": grid[1]}
        res = eng.compare(q)
        assert res.pairs == jres.pairs, grid
        assert res.n_candidates == jres.n_candidates, grid
        assert res.nw_cells == jres.nw_cells, grid
        assert eng.render_report(q, res) == jreport, grid


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_dict_axis_shards_payload(tmp_path, grid):
    """Each position holds its dict shard: _shard_rows rows of the packed
    index words (padded to a multiple of n_dict), shard k of position
    (d, k) starting at row k * _shard_rows."""
    qp, dp = _short(tmp_path)
    db = tread_fasta(str(dp))
    eng = TorchEngine(db, TConfig(mesh_shape=grid), device="cpu",
                      mesh_devices=CPU8)
    n_data, n_dict = grid
    n = eng.index.n_entries
    assert eng._shard_rows == -(-n // n_dict)
    words = eng.index.packed.view(np.int32)
    for p, shard in enumerate(eng._d_idx_tab):
        k = p % n_dict
        assert shard.shape == (eng._shard_rows,)
        part = words[k * eng._shard_rows : (k + 1) * eng._shard_rows]
        np.testing.assert_array_equal(shard[: len(part)].numpy(), part)


def test_mesh_rejects_indivisible_batches(tmp_path):
    qp, dp = make_pair(tmp_path, random.Random(34), n_query=8, n_db=8)
    db = tread_fasta(str(dp))
    for cfg in (TConfig(mesh_shape=(8, 1), gate_chunks=(96, 32)),
                TConfig(mesh_shape=(2, 4), nw_stats_batches=(32,)),
                TConfig(mesh_shape=(2, 2), nw_render_batches=(24,))):
        with pytest.raises(ValueError):
            TorchEngine(db, cfg, device="cpu", mesh_devices=CPU8)
    with pytest.raises(ValueError):  # more positions than devices
        TorchEngine(db, TConfig(mesh_shape=(4, 4)), device="cpu",
                    mesh_devices=CPU8)
    with pytest.raises(ValueError):  # a grid over the one CPU device
        TorchEngine(db, TConfig(mesh_shape=(2, 1)), device="cpu")


def test_auto_mesh(tmp_path):
    """"auto" (the default) resolves to one device on the CPU, whose torch
    device is one; over eight given positions it takes the widest data
    axis the batch shapes divide over, as the JAX engine does."""
    assert TConfig().mesh_shape == JConfig().mesh_shape == "auto"
    qp, dp = make_pair(tmp_path, random.Random(35), n_query=8, n_db=8)
    db = tread_fasta(str(dp))
    assert TorchEngine(db, TConfig(), device="cpu")._mesh is None
    eng = TorchEngine(db, TConfig(), device="cpu", mesh_devices=CPU8)
    assert eng._mesh.shape == {"data": 8, "dict": 1}
    eng = TorchEngine(db, TConfig(nw_stats_batches=(32,)), device="cpu",
                      mesh_devices=CPU8)
    assert eng._mesh.shape == {"data": 4, "dict": 1}
    eng = TorchEngine(db, TConfig(gate_chunks=(96,)), device="cpu",
                      mesh_devices=CPU8)
    assert eng._mesh is None
    assert visible_devices("cpu") == [torch.device("cpu")]
    assert visible_devices("cuda:1") == [torch.device("cuda", 1)]
    if not torch.cuda.is_available():  # no fallback to another device
        with pytest.raises(ValueError):
            make_mesh(2, 1, ["cuda:0", "cuda:0"])


def test_mesh_takes_host_gate_with_gate_enum(tmp_path, plain_rows_once):
    """Config(gate_enum=True) on a mesh takes the host gate, as the JAX
    engine does, and gives its pairs."""
    qp, dp = _short(tmp_path)
    q, db = tread_fasta(str(qp)), tread_fasta(str(dp))
    host = TorchEngine(db, TConfig(mesh_shape=None), device="cpu")
    want = host.compare(q)
    eng = TorchEngine(db, TConfig(mesh_shape=(4, 2), gate_enum=True),
                      index=host.index, device="cpu", mesh_devices=CPU8)
    assert not eng._use_enum
    res = eng.compare(q)
    assert res.pairs == want.pairs
    assert res.n_candidates == want.n_candidates


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_ladders_match_jax(tmp_path, grid):
    """On a mesh the render ladder keeps B * 8L^2 under the budget per
    device in multiples of 8 pairs a position, exactly as the JAX engine's
    mesh ladder; the gate's chunks past SHORT_WINDOW split into 32
    candidates a position."""
    qp, dp = make_pair(tmp_path, random.Random(8), n_query=2, n_db=2,
                       read_len=100)
    jeng = TpuEngine(jread_fasta(str(dp)), JConfig(mesh_shape=grid))
    teng = TorchEngine(tread_fasta(str(dp)), TConfig(mesh_shape=grid),
                       device="cpu", mesh_devices=CPU8)
    for L in teng.cfg.length_buckets:
        assert teng._render_sizes(L) == jeng._render_sizes(L), L
        assert all(b % 64 == 0 for b in teng._render_sizes(L))
    spans = list(teng._gate_spans(100_000, 3072))
    assert sum(take for _, take, _ in spans) == 100_000
    assert all(n_pad % (32 * grid[0]) == 0 and n_pad * 3072 <= 1 << 28
               for _, _, n_pad in spans)
