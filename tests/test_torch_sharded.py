"""The port's sharded steps (imsame_tpu_torch.parallel.sharded) against the
JAX package's (imsame_tpu.parallel.sharded) on the conftest's 8-device CPU
mesh, and against the port's single-device ops, on the same numpy-seeded
inputs: the broadcast gate with the packed index words and with the wide
(pos, sid, db_start) triple, the dict-routed gate, the wide-query gate,
the NW stats step at L = 256 and 1024 and the render step at 256 and 512,
each at the grids (8, 1), (4, 2) and (2, 4) of eight positions on the CPU
device.  Integer results: exact equality.

``plain_rows_once`` (also used by tests/test_torch_mesh.py) computes each
pair of the plain NW functions once per test: a pair's row of S or F
depends on that pair alone, so the steps' per-position calls are answered
from the rows the single-device op computed (or an earlier call), and only
the JAX steps compute independently.  That keeps the CPU time of eight
positions x three grids near one batch's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.ops import candidates as jcand
from imsame_tpu.ops.extend_packed import pack_read_rows
from imsame_tpu.ops.resolve import nw_stats_rows as j_stats_rows
from imsame_tpu.ops.resolve import nw_traceback_rows as j_tb_rows
from imsame_tpu.parallel import sharded as jsh
from imsame_tpu.parallel.mesh import make_mesh as j_make_mesh
from imsame_tpu_torch.ops import candidates as tcand
from imsame_tpu_torch.ops import nw, nw_cuda
from imsame_tpu_torch.ops.resolve import nw_stats_rows, nw_traceback_rows
from imsame_tpu_torch.parallel import sharded
from imsame_tpu_torch.parallel.mesh import make_mesh

GRIDS = [(8, 1), (4, 2), (2, 4)]
N_READS, READ_LEN, N_IDX = 64, 100, 512
IGAP, EGAP = -5, -2


def _memo(real, cls):
    """``real`` (a plain NW function) answering each distinct pair row
    from a cache, computing only the rows it has not seen."""
    cache = {}

    def run(X, Y, xlen, ylen, igap, egap, *, max_len):
        Xn, Yn = X.numpy(), Y.numpy()
        xl, yl = xlen.tolist(), ylen.tolist()
        keys = [(Xn[b].tobytes(), Yn[b].tobytes(), xl[b], yl[b], igap, egap,
                 max_len) for b in range(len(xl))]
        new = list({k: b for b, k in enumerate(keys) if k not in cache}
                   .values())
        if new:
            i = torch.tensor(new)
            res = real(X[i], Y[i], xlen[i], ylen[i], igap, egap,
                       max_len=max_len)
            for j, b in enumerate(new):
                cache[keys[b]] = [f[j].clone() for f in res]
        return cls(*(torch.stack([cache[k][f] for k in keys])
                     for f in range(len(cls._fields))))

    return run


@pytest.fixture
def plain_rows_once(monkeypatch):
    """The plain NW functions, as the CPU path of the kernel wrappers
    reaches them, each pair row computed once per test (see the module
    docstring)."""
    for name, cls in (("nw_stats_batch", nw.NWStatsResult),
                      ("nw_forward_batch", nw.NWResult)):
        monkeypatch.setattr(nw_cuda, name, _memo(getattr(nw_cuda, name), cls))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rows(rng, L):
    """Packed rows of N_READS random reads of READ_LEN bases at row length
    L (uint32 words, for JAX) and their lengths."""
    codes = rng.integers(0, 4, N_READS * READ_LEN, dtype=np.uint8)
    start = np.arange(N_READS, dtype=np.int64) * READ_LEN
    lens = np.full(N_READS, READ_LEN, np.int64)
    return pack_read_rows(codes, start, lens, L), lens.astype(np.int32)


def _gate_inputs(rng, hits):
    """Rows at window 128 (query = db table), a candidate (read, qoff) per
    hit, and an index whose rows a third of the candidates hit on their
    own diagonal (those walks pass): (rows, qlen, rids, qoffs, words,
    triple, thr)."""
    rows, qlen = _rows(rng, 128)
    N = len(hits)
    rids = rng.integers(0, N_READS, N).astype(np.int32)
    qoffs = rng.integers(12, READ_LEN, N).astype(np.int32)
    sid = rng.integers(0, N_READS, N_IDX).astype(np.int64)
    doff = rng.integers(12, READ_LEN, N_IDX).astype(np.int64)
    plant = rng.choice(N, N // 3, replace=False)
    sid[hits[plant]] = rids[plant]
    doff[hits[plant]] = qoffs[plant]
    db_start = (np.arange(N_READS) * READ_LEN).astype(np.int32)
    words = ((sid.astype(np.uint32) << np.uint32(12))
             | doff.astype(np.uint32)).view(np.int32)
    triple = ((db_start[sid] + doff).astype(np.int32), sid.astype(np.int32),
              db_start)
    thr = np.full(N_READS, 60, np.int32)
    return rows, qlen, rids, qoffs, words, triple, thr


def _rq(rids, qoffs):
    return ((rids.astype(np.uint32) << np.uint32(12))
            | qoffs.astype(np.uint32)).view(np.int32)


def _bits(words, n=None):
    pb = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    return np.unpackbits(pb.view(np.uint8).reshape(2, -1), axis=1,
                         bitorder="little")[:, :n]


def _t_tables(mesh, rows, qlen, thr, idx):
    """The port's per-position tables: rows, lengths and thresholds
    replicated, the index payload split over "dict"."""
    t_rows = mesh.put(torch.as_tensor(rows.view(np.int32)))
    t_len = mesh.put(qlen)
    if isinstance(idx, tuple):
        t_idx = list(zip(mesh.put_rows(idx[0]), mesh.put_rows(idx[1]),
                         mesh.put(idx[2])))
    else:
        t_idx = mesh.put_rows(idx)
    return t_rows, t_len, t_idx, mesh.put(thr)


def _single_idx(idx):
    if isinstance(idx, tuple):
        return tuple(torch.as_tensor(a) for a in idx)
    return torch.as_tensor(idx)


def _j_idx(idx):
    return (tuple(jnp.asarray(a) for a in idx) if isinstance(idx, tuple)
            else jnp.asarray(idx))


@pytest.mark.parametrize("index", ["packed", "triple"])
@pytest.mark.parametrize("grid", GRIDS)
def test_gate_step_matches_jax_and_single(grid, index):
    """The broadcast gate (candidates over "data", index rows over
    "dict", masked and summed): JAX's make_engine_gate_step's words and
    flat_gate_packed's on one device."""
    n_data, n_dict = grid
    rng = np.random.default_rng(11)
    N = 512
    hits = rng.integers(0, N_IDX, N).astype(np.int32)
    rows, qlen, rids, qoffs, words, triple, thr = _gate_inputs(rng, hits)
    idx = words if index == "packed" else triple
    cand = np.stack([hits, _rq(rids, qoffs)])
    t_rows = torch.as_tensor(rows.view(np.int32))
    want = tcand.flat_gate_packed(
        t_rows, t_rows, torch.as_tensor(qlen), torch.as_tensor(qlen),
        _single_idx(idx), torch.as_tensor(cand), torch.as_tensor(thr),
        window=128)
    b = _bits(want)
    assert b[0].any() and not b[0].all()

    jstep = jsh.make_engine_gate_step(
        j_make_mesh(n_data, n_dict), 128, N_IDX // n_dict, index == "packed")
    jr = jnp.asarray(rows)
    jl = jnp.asarray(qlen)
    j_words = jstep(jr, jr, jl, jl, _j_idx(idx), jnp.asarray(cand),
                    jnp.asarray(thr))
    mesh = make_mesh(n_data, n_dict, ["cpu"] * 8)
    r, ln, ti, th = _t_tables(mesh, rows, qlen, thr, idx)
    got = sharded.gate_step(mesh, r, r, ln, ln, ti, mesh.put_cols(cand), th,
                            window=128, shard_rows=N_IDX // n_dict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_words))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid", GRIDS)
def test_routed_gate_step_matches_jax_and_single(grid):
    """The dict-routed gate: each position's block of the chunk holds
    only hits of its dict shard; JAX's make_engine_gate_step_routed's
    words and flat_gate_packed's on one device."""
    n_data, n_dict = grid
    rng = np.random.default_rng(12)
    S = N_IDX // n_dict
    seg = 64  # candidates a position
    hits = np.concatenate([
        rng.integers(0, S, seg) + (p % n_dict) * S for p in range(8)
    ]).astype(np.int32)
    rows, qlen, rids, qoffs, words, triple, thr = _gate_inputs(rng, hits)
    cand = np.stack([hits, _rq(rids, qoffs)])
    t_rows = torch.as_tensor(rows.view(np.int32))
    want = tcand.flat_gate_packed(
        t_rows, t_rows, torch.as_tensor(qlen), torch.as_tensor(qlen),
        torch.as_tensor(words), torch.as_tensor(cand), torch.as_tensor(thr),
        window=128)
    assert _bits(want)[0].any()

    jstep = jsh.make_engine_gate_step_routed(j_make_mesh(n_data, n_dict),
                                             128, S, True)
    jr = jnp.asarray(rows)
    jl = jnp.asarray(qlen)
    j_words = jstep(jr, jr, jl, jl, jnp.asarray(words), jnp.asarray(cand),
                    jnp.asarray(thr))
    mesh = make_mesh(n_data, n_dict, ["cpu"] * 8)
    r, ln, ti, th = _t_tables(mesh, rows, qlen, thr, words)
    got = sharded.gate_step_routed(
        mesh, r, r, ln, ln, ti, mesh.put_cols(cand, flat=True), th,
        window=128, shard_rows=S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_words))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid", GRIDS)
def test_wide_gate_step_matches_jax_and_single(grid):
    """The wide-query gate (hit, read id, qoff, valid over "data", the
    wide index triple over "dict"): JAX's make_engine_gate_step_wide's
    words (its fourth row the thresholds the port gathers from its
    table) including the zero bits of padding, and flat_gate's bits of
    the real candidates on one device."""
    n_data, n_dict = grid
    rng = np.random.default_rng(13)
    N, n_real = 512, 480
    hits = rng.integers(0, N_IDX, N).astype(np.int32)
    rows, qlen, rids, qoffs, words, triple, thr = _gate_inputs(rng, hits)
    valid = (np.arange(N) < n_real).astype(np.int32)
    cand = np.stack([hits, rids, qoffs, valid])
    t_rows = torch.as_tensor(rows.view(np.int32))
    want = tcand.flat_gate(
        t_rows, t_rows, torch.as_tensor(qlen), torch.as_tensor(qlen),
        _single_idx(triple), torch.as_tensor(cand[:3]), torch.as_tensor(thr),
        window=128)
    assert _bits(want, n_real)[0].any()

    jstep = jsh.make_engine_gate_step_wide(j_make_mesh(n_data, n_dict), 128,
                                           N_IDX // n_dict, False)
    jr = jnp.asarray(rows)
    jl = jnp.asarray(qlen)
    j_cand = np.stack([hits, rids, qoffs, thr[rids], valid])
    j_words = jstep(jr, jr, jl, jl, _j_idx(triple), jnp.asarray(j_cand))
    mesh = make_mesh(n_data, n_dict, ["cpu"] * 8)
    r, ln, ti, th = _t_tables(mesh, rows, qlen, thr, triple)
    got = sharded.gate_step_wide(mesh, r, r, ln, ln, ti, mesh.put_cols(cand),
                                 th, window=128, shard_rows=N_IDX // n_dict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_words))
    assert not _bits(got)[:, n_real:].any()
    np.testing.assert_array_equal(_bits(got, n_real), _bits(want, n_real))


def _pairs(rng, B):
    return np.stack([rng.integers(0, N_READS, B),
                     rng.integers(0, N_READS, B)]).astype(np.int32)


@pytest.mark.parametrize("L", [256, 1024])
def test_nw_stats_step_matches_jax_and_single(plain_rows_once, L):
    """The stats step (pair batch over the flattened axis): JAX's
    make_engine_nw_stats_step's [3, B] and nw_stats_rows' on one device,
    at every grid."""
    rng = np.random.default_rng(L)
    rows, qlen = _rows(rng, L)
    rs = _pairs(rng, 64)
    t_rows = torch.as_tensor(rows.view(np.int32))
    t_len = torch.as_tensor(qlen)
    want = nw_stats_rows(t_rows, t_rows, torch.as_tensor(rs), t_len, t_len,
                         IGAP, EGAP, max_len=L).numpy()
    jr, jl = jnp.asarray(rows), jnp.asarray(qlen)
    np.testing.assert_array_equal(want, np.asarray(j_stats_rows(
        jr, jr, jnp.asarray(rs), jl, jl, IGAP, EGAP, max_len=L,
        use_pallas=False)))
    for n_data, n_dict in GRIDS:
        jstep = jsh.make_engine_nw_stats_step(j_make_mesh(n_data, n_dict), L,
                                              False)
        j_out = np.asarray(jstep(jr, jr, jnp.asarray(rs), jl, jl, IGAP, EGAP))
        mesh = make_mesh(n_data, n_dict, ["cpu"] * 8)
        r, ln = mesh.put(t_rows), mesh.put(t_len)
        got = sharded.nw_stats_step(mesh, r, r, mesh.put_cols(rs, flat=True),
                                    ln, ln, IGAP, EGAP, max_len=L).numpy()
        np.testing.assert_array_equal(got, j_out)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", [256, 512])
def test_nw_render_step_matches_jax_and_single(plain_rows_once, L):
    """The render step (F + traceback, pair batch over the flattened
    axis): every field of JAX's make_engine_nw_render_step and of
    nw_traceback_rows on one device, at every grid."""
    rng = np.random.default_rng(L + 1)
    rows, qlen = _rows(rng, L)
    rs = _pairs(rng, 64)
    t_rows = torch.as_tensor(rows.view(np.int32))
    t_len = torch.as_tensor(qlen)
    want = nw_traceback_rows(t_rows, t_rows, torch.as_tensor(rs[0]),
                             torch.as_tensor(rs[1]), t_len, t_len, IGAP, EGAP,
                             max_len=L)
    jr, jl = jnp.asarray(rows), jnp.asarray(qlen)
    j_one = j_tb_rows(jr, jr, jnp.asarray(rs[0]), jnp.asarray(rs[1]), jl, jl,
                      IGAP, EGAP, max_len=L, use_pallas=False)
    for a, b in zip(want, j_one):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n_data, n_dict in GRIDS:
        jstep = jsh.make_engine_nw_render_step(j_make_mesh(n_data, n_dict),
                                               L, False)
        j_out = jstep(jr, jr, jnp.asarray(rs), jl, jl, IGAP, EGAP)
        mesh = make_mesh(n_data, n_dict, ["cpu"] * 8)
        r, ln = mesh.put(t_rows), mesh.put(t_len)
        got = sharded.nw_render_step(mesh, r, r, mesh.put_cols(rs, flat=True),
                                     ln, ln, IGAP, EGAP, max_len=L)
        for f, a, b, c in zip(got._fields, got, j_out, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)
            np.testing.assert_array_equal(a.numpy(), c.numpy(), f)


def test_mesh_layout():
    """Positions run in JAX's flattened ("data", "dict") order; uploads
    go once per distinct (device, shard); too few devices raise."""
    mesh = make_mesh(2, 4, ["cpu"] * 8)
    assert mesh.shape == {"data": 2, "dict": 4} and mesh.size == 8
    assert [mesh.grid(p) for p in (0, 3, 4, 7)] == [(0, 0), (0, 3), (1, 0),
                                                     (1, 3)]
    x = np.arange(16, dtype=np.int32)
    rows = mesh.put_rows(x)
    assert [int(t[0]) for t in rows] == [0, 4, 8, 12] * 2
    assert rows[1] is rows[5]  # one tensor per (device, shard)
    cols = mesh.put_cols(np.stack([x, -x]))
    assert [int(t[0, 0]) for t in cols] == [0] * 4 + [8] * 4
    flat = mesh.put_cols(x, flat=True)
    assert [int(t[0]) for t in flat] == list(range(0, 16, 2))
    rep = mesh.put(x)
    assert all(t is rep[0] for t in rep)
    with pytest.raises(ValueError):
        make_mesh(4, 4, ["cpu"] * 8)
    with pytest.raises(ValueError):
        mesh.put_rows(np.arange(6))
