"""The port's multi-device layer (sina_tpu_torch/parallel) against the
JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py makes;
the port on a mesh that names the CPU 8 times (5 for the odd case), so
each shard is a tensor of its own scored by the plain version.  Scores
and ids are integers: every comparison is exact.  A JAX-package object
reaches the port as numpy arrays (the database as its bundle arrays).
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu import testing
from sina_tpu.famfinder import FamFinder as JaxFamFinder
from sina_tpu.famfinder import FamFinderConfig as JaxFamFinderConfig
from sina_tpu.ops.kmer import query_kmers_padded
from sina_tpu.ops.kmer_index import KmerIndex
from sina_tpu.parallel import sharding as jsh
from sina_tpu_torch import famfinder as port_famfinder
from sina_tpu_torch.ops import kernels
from sina_tpu_torch.ops import kmer_kernel as kk
from sina_tpu_torch.parallel import sharding as psh
from sina_tpu_torch.parallel.dryrun import dryrun_multichip
from sina_tpu_torch.refdb import ReferenceDb as PortDb
from sina_tpu_torch.sequence import Sequence as PortSequence

CPU = torch.device("cpu")


def cpus(n: int) -> list:
    return [CPU] * n


def carry_db(db) -> PortDb:
    offsets, positions, masks = db.packed_arrays()
    return PortDb.from_arrays(db.names, offsets, positions, masks, db.width,
                              [s.attrs for s in db.sequences], db.pairs, db.astats)


def carry_seq(s) -> PortSequence:
    return PortSequence(s.name, s.positions.copy(), s.masks.copy(), s.width, dict(s.attrs))


# -- make_mesh (tests/test_sharding.py:66-112) -------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_equals_jax(n):
    want = jsh.make_mesh(jax.devices()[:n]).shape
    mesh = psh.make_mesh(cpus(n))
    assert mesh.shape == dict(want)
    assert mesh.shape["dp"] * mesh.shape["mp"] == n
    assert len(mesh.devices) == mesh.shape["dp"] and mesh.rows == tuple(range(mesh.shape["dp"]))
    assert not mesh.spans_processes


def test_make_mesh_explicit_dp():
    mesh = psh.make_mesh(cpus(8), dp=4)
    assert mesh.shape == {"dp": 4, "mp": 2}
    assert [len(r) for r in mesh.devices] == [2] * 4


def test_make_mesh_rejects_nondividing_dp():
    with pytest.raises(ValueError):
        psh.make_mesh(cpus(8), dp=3)  # 8 % 3 != 0


def test_make_mesh_logs_odd_fallback(caplog):
    with caplog.at_level(logging.WARNING, logger="sina.sharding"):
        mesh = psh.make_mesh(cpus(5))
    assert mesh.shape == {"dp": 1, "mp": 5}
    assert any("odd" in r.message for r in caplog.records if r.name == "sina.sharding")


# -- sharded_search against the JAX package's, four routes ---------------


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharding.py:54-63: 64 references, k = 8, 8 queries."""
    db = testing.make_reference(n_seqs=64, n_core=300, width=500, seed=31)
    idx = KmerIndex.build(db, k=8, fast=True)
    masks = [s.masks for s in db.sequences[:8]]
    kmers, _ = query_kmers_padded(masks, 8, fast=True, pad_to=512)
    return idx, kmers


@pytest.fixture(scope="module")
def midscale_index():
    """tests/test_sharding.py:115-143: a 20k-reference index built from
    CSR (n_seqs not a multiple of the packing granularity)."""
    rng = np.random.default_rng(42)
    k, fast = 6, True
    n_rows = 4 ** (k - 1)
    n_seqs = 20_000
    lists = [np.unique(rng.integers(0, n_rows, size=30).astype(np.int32))
             for _ in range(n_seqs)]
    offsets = np.zeros(n_seqs + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=offsets[1:])
    idx = KmerIndex(k, fast, n_seqs, np.concatenate(lists), offsets)
    B, L = 8, 96
    kmers = np.full((B, L), n_rows, dtype=np.int32)
    for b in range(B):
        src = np.concatenate([lists[int(i)] for i in rng.integers(0, n_seqs, 3)])
        m = min(L, len(src))
        kmers[b, :m] = src[:m]
    return idx, kmers


def _uneven():
    """tests/test_sharding.py:183-195: a random (257, 136) packed matrix."""
    rng = np.random.default_rng(7)
    P = rng.integers(0, 256, size=(257, 136), dtype=np.uint8)
    P[-1] = 0
    return P, rng.integers(0, 256, size=(8, 32)).astype(np.int32)


def _route(route: str, mp: int, problem, midscale_index):
    """(matrix, kmers, k_top) of one route, laid out for mp shards."""
    if route == "dense":
        idx, kmers = problem
        return idx.dense(), kmers, 10
    if route == "flat":
        idx, kmers = problem
        P = idx.dense_packed()
        return np.pad(P, ((0, 0), (0, -P.shape[1] % mp))), kmers, 10
    if route == "tiled":
        idx, kmers = midscale_index
        P3 = idx.dense_packed_tiled(byte_multiple=4096 * mp)
        assert P3.shape[2] % (128 * mp) == 0
        return P3, kmers, 40
    P, kmers = _uneven()
    return np.pad(P, ((0, 0), (0, -P.shape[1] % mp))), kmers, 16


def jax_search(P, kmers, k_top: int, dp: int):
    mesh = jsh.make_mesh(jax.devices(), dp=dp)
    vals, ids = jsh.sharded_search(mesh, k_top)(jsh.shard_index_matrix(mesh, P),
                                                jnp.asarray(kmers))
    return np.asarray(vals), np.asarray(ids)


def port_search(P, kmers, k_top: int, dp: int):
    mesh = psh.make_mesh(cpus(8), dp=dp)
    vals, ids = psh.sharded_search(mesh, k_top)(psh.shard_index_matrix(mesh, P), kmers)
    assert vals.dtype == ids.dtype == torch.int32 and vals.device == CPU
    return vals.numpy(), ids.numpy()


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("route", ["dense", "flat", "tiled", "uneven"])
def test_sharded_search_equals_jax(route, dp, problem, midscale_index):
    """Values and ids equal to the JAX package's sharded_search on the
    same (dp, mp), and every id reaches its value on one device."""
    P, kmers, k_top = _route(route, 8 // dp, problem, midscale_index)
    rv, ri = jax_search(P, kmers, k_top, dp)
    gv, gi = port_search(P, kmers, k_top, dp)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)
    scores = kk.kmer_scores(torch.from_numpy(P), torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(np.take_along_axis(scores, gi.astype(np.int64), 1), gv)
    np.testing.assert_array_equal(gv, -np.sort(-scores, axis=1)[:, :k_top])


def _tied_tiled(n_refs: int, mp: int):
    """A tiled index whose scores are set by construction (the query
    hits rows 0..47 once each, reference s holds rows 0..c_s-1, so
    score(s) = c_s in 0..12): the k-th value is tied among thousands."""
    rng = np.random.default_rng(n_refs)
    L = 48
    c = rng.integers(0, 13, n_refs)
    bits = np.arange(L + 1)[:, None] < c[None, :]
    bits[-1] = False
    P = np.packbits(bits, axis=1, bitorder="little")
    bm = 4096 * mp
    P = np.pad(P, ((0, 0), (0, -P.shape[1] % bm)))
    kmers = np.tile(np.arange(L, dtype=np.int32), (4, 1))
    kmers[1, ::2] = L
    kmers[2] = rng.integers(0, L + 1, L)
    kmers[3, ::3] = L
    return P.reshape(P.shape[0], 32, -1), kmers


@pytest.mark.parametrize("k", [256, 1000])
def test_tiled_ties_follow_the_merge_not_one_device(k):
    """On the tiled route the merged ids follow lax.top_k's tie rule
    over the gathered candidates (shard-major position), which the port
    keeps: ids equal the JAX package's sharded ids, and differ from one
    device's score_topk on the same bytes, whose values are the same."""
    P3, kmers = _tied_tiled(131_072, 4)
    rv, ri = jax_search(P3, kmers, k, 2)
    gv, gi = port_search(P3, kmers, k, 2)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)
    one = kk.score_topk(torch.from_numpy(P3), torch.from_numpy(kmers), k).numpy()
    np.testing.assert_array_equal(gv, one[:, :k])
    assert not np.array_equal(gi, one[:, k:])


def test_k_top_above_the_shards_pads(problem):
    """k_top = 200 over 8 shards of 16 dense references: the 128
    candidates, then -1 / 0 padding, as the JAX package pads."""
    idx, kmers = problem
    P = idx.dense()
    assert P.shape[1] == 128
    rv, ri = jax_search(P, kmers, 200, 1)
    gv, gi = port_search(P, kmers, 200, 1)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)
    assert (gv[:, 128:] == -1).all() and (gi[:, 128:] == 0).all()
    assert (gv[:, :128] >= 0).all()
    assert all(sorted(row) == list(range(128)) for row in gi[:, :128].tolist())


def test_sharded_scores_are_in_the_global_order(midscale_index):
    idx, kmers = midscale_index
    P3 = idx.dense_packed_tiled(byte_multiple=4096 * 4)
    mesh = psh.make_mesh(cpus(8))
    got = psh.sharded_scores(mesh, psh.shard_index_matrix(mesh, P3), kmers)
    want = kk.kmer_scores(torch.from_numpy(P3), torch.from_numpy(kmers))
    assert torch.equal(got, want)


def test_replicas_on_one_device_share_a_shard():
    P = np.arange(64, dtype=np.uint8).reshape(4, 16)
    mesh = psh.make_mesh(cpus(4))                       # (2, 2), one device
    Pm = psh.shard_index_matrix(mesh, P)
    assert Pm.shards[0][1] is Pm.shards[1][1]
    assert torch.equal(Pm.shards[0][1], torch.from_numpy(P[:, 8:].copy()))


# -- FamFinder on a mesh against the JAX famfinder's mesh -----------------


def _finders(jdb, cfg: dict, dp_mp=(2, 4)):
    """The JAX package's FamFinder (which shards over the 8 virtual
    devices: a (2, 4) mesh) and the port's on a (2, 4) CPU mesh, the
    database carried across."""
    jf = JaxFamFinder(jdb, JaxFamFinderConfig(**cfg))
    assert jf._matrix() is not None and jf._mesh is not None
    assert dict(jf._mesh.shape) == {"dp": dp_mp[0], "mp": dp_mp[1]}
    mesh = psh.make_mesh(cpus(8))
    pf = port_famfinder.FamFinder(carry_db(jdb), port_famfinder.FamFinderConfig(**cfg),
                                  CPU, mesh=mesh)
    return jf, pf


def _families(results):
    return [(r.failed, r.astats_name, r.log,
             [(score, s.name) for score, s in r.family]) for r in results]


@pytest.fixture(scope="module")
def flat_case():
    db = testing.make_reference(n_seqs=150, n_core=300, width=500, seed=21)
    qs = [testing.unaligned_copy(q) for q in testing.make_queries(db, n=12, seed=4, branch_len=0.6)]
    return db, qs, dict(fs_min=10, fs_max=10, fs_full_len=300, fs_req_gaps=1)


@pytest.fixture(scope="module")
def tiled_case():
    """33,000 references (33,792 padded: the tiled layout), 6-mers so
    the tiled matrix stays small (1,025 x 16,384 bytes)."""
    db = testing.make_reference(n_seqs=33_000, n_core=100, width=160, seed=5)
    qs = [testing.unaligned_copy(q) for q in testing.make_queries(db, n=8, seed=6, branch_len=0.6)]
    return db, qs, dict(fs_kmer_len=6, fs_min=10, fs_max=10, fs_full_len=80,
                        fs_req_gaps=1, fs_min_len=40)


@pytest.mark.parametrize("case", ["flat_case", "tiled_case"])
def test_famfinder_on_a_mesh_equals_jax(case, request):
    """FamFinder(mesh=...)'s score_topk, score_batch and the batched
    submit_batch / process_batch return the JAX famfinder's candidates
    and families, on the flat route and on the tiled one."""
    jdb, qs, cfg = request.getfixturevalue(case)
    jf, pf = _finders(jdb, cfg)
    assert isinstance(pf._matrix(), psh.ShardedMatrix)
    assert pf._matrix().tiled == (case == "tiled_case")
    masks = [q.masks for q in qs]
    for k in (8, 256):
        rv, ri = jf.score_topk(masks, k)
        gv, gi = pf.score_topk(masks, k)
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(pf.score_batch(masks[:3]), jf.score_batch(masks[:3]))
    want = _families(jf.process_batch([q.copy() for q in qs],
                                      handle=jf.submit_batch([q.copy() for q in qs])))
    pq = [carry_seq(q) for q in qs]
    got = _families(pf.process_batch(pq, handle=pf.submit_batch(pq)))
    assert got == want
    assert all(not failed for failed, *_ in got)


def test_on_device_keeps_its_mesh_and_matrix(flat_case):
    jdb, qs, cfg = flat_case
    pf = port_famfinder.FamFinder(carry_db(jdb), port_famfinder.FamFinderConfig(**cfg), CPU,
                                  mesh=psh.make_mesh(cpus(4), dp=1))
    P = pf._matrix()
    same = pf.on_device("cpu")
    assert same.mesh is pf.mesh and same._matrix() is P


def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    dryrun_multichip(cpus(8))
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 mp=4" in out
    assert "NR-scale sharded search ok" in out


# -- every kernel launch on its operands' device ---------------------------


def test_launch_makes_the_operands_device_current(monkeypatch):
    """kernels.launch calls the C entry point with the operands' device
    current and that device's stream, then counts the launch; a failed
    launch raises and is not counted.  (Fakes stand in for the CUDA
    runtime, which this machine lacks.)"""
    current = [None]
    events = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current[0] = self.dev

        def __exit__(self, *exc):
            current[0] = None

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=1000 + dev.index))
    monkeypatch.setattr(kernels, "lib", lambda: SimpleNamespace(
        sina_cuda_error_string=lambda err: b"fake error"))

    def entry(a, b, stream):
        events.append((current[0], a, b, stream))
        return 0 if a else 7

    dev = torch.device("cuda", 3)
    before = kernels.launches["kmer_score"]
    kernels.launch("kmer_score", entry, 1, 2, device=dev)
    assert events == [(dev, 1, 2, 1003)]
    assert kernels.launches["kmer_score"] == before + 1
    with pytest.raises(RuntimeError, match="kmer_score kernel failed"):
        kernels.launch("kmer_score", entry, 0, 2, device=dev)
    assert kernels.launches["kmer_score"] == before + 1
    assert current[0] is None
