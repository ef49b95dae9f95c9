"""The port's own copies of the host modules against the JAX package's.

The port keeps a copy of every host module it uses (sina_tpu_torch/
alphabet, sequence, io/, native/, refdb, ops/kmer_index, ops/graph, ...)
and imports nothing of sina_tpu.  On the same inputs the copies must
compute what the originals compute, and write the same bytes: the
.sref bundle and the .sidx.npz index cache are read both ways, the
k-mer index layouts, the native library's outputs, the graph build and
the writers' bytes are equal, and the from_arrays carry-across gives
the original arrays.
"""

import json

import numpy as np
import pytest

from sina_tpu import native as jax_native
from sina_tpu import testing
from sina_tpu.io.csv import CsvWriter as JaxCsvWriter
from sina_tpu.io.fasta import FastaWriter as JaxFastaWriter
from sina_tpu.io.fasta import read_fasta as jax_read_fasta
from sina_tpu.ops import graph as jax_graph
from sina_tpu.ops.kmer_index import KmerIndex as JaxKmerIndex
from sina_tpu.refdb import ReferenceDb as JaxDb
from sina_tpu_torch import native as port_native
from sina_tpu_torch import testing as port_testing
from sina_tpu_torch.io.csv import CsvWriter as PortCsvWriter
from sina_tpu_torch.io.fasta import FastaWriter as PortFastaWriter
from sina_tpu_torch.io.fasta import read_fasta as port_read_fasta
from sina_tpu_torch.ops import graph as port_graph
from sina_tpu_torch.ops.kmer_index import KmerIndex as PortKmerIndex
from sina_tpu_torch.refdb import ReferenceDb as PortDb
from sina_tpu_torch.sequence import Sequence as PortSequence


def _db():
    db = testing.make_reference(n_seqs=90, n_core=300, width=520, seed=31)
    db.pairs = np.arange(520, dtype=np.int32)[::-1].copy()
    rng = np.random.default_rng(2)
    db.astats = [{"name": "bacteria", "ntaxa": 7,
                  "freqs": rng.random((520, 4)).astype(np.float32)}]
    return db


def carry_db(db) -> PortDb:
    """The JAX package's database carried into the port as numpy arrays."""
    offsets, positions, masks = db.packed_arrays()
    return PortDb.from_arrays(
        db.names, offsets, positions, masks, db.width,
        [s.attrs for s in db.sequences], db.pairs, db.astats,
    )


def _same_db(a, b):
    assert a.names == b.names and a.width == b.width
    for x, y in zip(a.packed_arrays(), b.packed_arrays()):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert [s.attrs for s in a.sequences] == [s.attrs for s in b.sequences]
    np.testing.assert_array_equal(a.pairs, b.pairs)
    assert len(a.astats) == len(b.astats)
    for p, q in zip(a.astats, b.astats):
        assert (p["name"], p["ntaxa"]) == (q["name"], q["ntaxa"])
        np.testing.assert_array_equal(p["freqs"], q["freqs"])


def test_sref_bundle_opens_in_either_package(tmp_path):
    db = _db()
    db.save(tmp_path / "jax.sref")
    port = PortDb.load(tmp_path / "jax.sref")
    _same_db(db, port)
    port.save(tmp_path / "port.sref")
    back = JaxDb.load(tmp_path / "port.sref")
    _same_db(db, back)
    assert (tmp_path / "port.sref" / "meta.json").read_text() == (
        tmp_path / "jax.sref" / "meta.json").read_text()
    a = np.load(tmp_path / "jax.sref" / "arrays.npz")
    b = np.load(tmp_path / "port.sref" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_from_arrays_carries_the_db_and_index():
    db = _db()
    _same_db(db, carry_db(db))
    idx = JaxKmerIndex.build(db, k=8, fast=True)
    got = PortKmerIndex.from_arrays(idx.seq_kmers, idx.seq_offsets, idx.n_seqs, idx.k, idx.fast)
    assert (got.k, got.fast, got.n_seqs, got.n_rows) == (idx.k, idx.fast, idx.n_seqs, idx.n_rows)
    np.testing.assert_array_equal(got.seq_kmers, idx.seq_kmers)
    np.testing.assert_array_equal(got.seq_offsets, idx.seq_offsets)


@pytest.mark.parametrize("k,fast", [(8, True), (6, False)])
def test_kmer_index_layouts_equal(k, fast):
    db = _db()
    want = JaxKmerIndex.build(db, k=k, fast=fast)
    got = PortKmerIndex.build(carry_db(db), k=k, fast=fast)
    np.testing.assert_array_equal(got.seq_kmers, want.seq_kmers)
    np.testing.assert_array_equal(got.seq_offsets, want.seq_offsets)
    np.testing.assert_array_equal(got.dense(), want.dense())
    np.testing.assert_array_equal(got.dense_packed(), want.dense_packed())
    np.testing.assert_array_equal(got.dense_packed_tiled(), want.dense_packed_tiled())


def test_sidx_cache_is_read_both_ways(tmp_path):
    db = _db()
    db.save(tmp_path / "a.sref")
    jdb = JaxDb.load(tmp_path / "a.sref")
    want = JaxKmerIndex.build(jdb, k=8, fast=True)        # writes the cache
    cache = tmp_path / "a.sref" / "index-k8f.sidx.npz"
    assert cache.exists()
    got = PortKmerIndex.try_load(cache, 8, True, len(db))
    np.testing.assert_array_equal(got.seq_kmers, want.seq_kmers)
    np.testing.assert_array_equal(got.seq_offsets, want.seq_offsets)
    # and the port's cache, read by the JAX package
    db.save(tmp_path / "b.sref")
    pdb = PortDb.load(tmp_path / "b.sref")
    mine = PortKmerIndex.build(pdb, k=6, fast=False)
    back = JaxKmerIndex.try_load(tmp_path / "b.sref" / "index-k6.sidx.npz", 6, False, len(db))
    np.testing.assert_array_equal(back.seq_kmers, mine.seq_kmers)
    np.testing.assert_array_equal(back.seq_offsets, mine.seq_offsets)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_native_functions_give_the_same_outputs(tmp_path):
    assert jax_native.get_lib() is not None and port_native.get_lib() is not None
    db = _db()
    offsets, flat_pos, flat_masks = db.packed_arrays()
    _, _, mask4 = db.flat_arrays()
    lengths = np.diff(offsets)
    fams = [np.arange(b, b + 9) for b in range(0, 60, 10)]
    starts = np.concatenate([offsets[f] for f in fams]).astype(np.int64)
    counts = np.concatenate([lengths[f] for f in fams]).astype(np.int64)
    sizes = np.array([len(f) for f in fams], np.int64)
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=6, seed=4, branch_len=0.4)]
    qm4 = [q.masks & 0xF for q in queries]
    qoffsets = np.concatenate([[0], np.cumsum([len(m) for m in qm4])]).astype(np.int64)
    qcol = np.zeros(db.width, np.uint8)
    aq = testing.make_queries(db, n=1, seed=9, branch_len=0.4)[0]
    qcol[aq.positions] = aq.masks
    ids = np.arange(0, 90, 3, dtype=np.int64)
    graphs = jax_graph.build_graphs_batch([[db.sequences[i] for i in f] for f in fams])
    npad = max(g.n_nodes for g in graphs) + 5
    graphs = [jax_graph.pad_graph(g, npad) for g in graphs]
    preds = np.stack([g.preds for g in graphs]).astype(np.int32)
    is_start = np.stack([g.is_start for g in graphs]).astype(np.uint8)
    is_end = np.stack([g.is_end for g in graphs]).astype(np.uint8)
    n_real = np.full(len(graphs), npad - 5, np.int64)
    lo = np.array([-1, 100, 0, 200, 50, 10], np.int64)
    hi = np.array([0, 400, 520, 300, 450, 500], np.int64)
    fasta = tmp_path / "r.fasta"
    with JaxFastaWriter(str(fasta)) as w:
        for s in db.sequences[:20]:
            w.write(s)
    calls = {
        "parse_fasta_buffer": (fasta.read_bytes(),),
        "build_kmer_lists": (mask4, offsets, 8, True),
        "contains_batch": (mask4, starts, counts, sizes, np.concatenate(qm4), qoffsets),
        "count_cols": (flat_pos, starts, counts, sizes, db.width),
        "count_cols_range": (flat_pos, starts, counts, sizes, lo, hi, db.width),
        "member_ranges": (flat_pos, starts, counts, sizes, lo, hi),
        "build_profiles": (flat_pos, flat_masks, starts, counts, sizes, db.width, db.width),
        "build_profiles_packed": (flat_pos, flat_masks, starts, counts, sizes, db.width,
                                  db.width, 5.0, 2.0, 256.0),
        "score_counts": (flat_pos, flat_masks, offsets, ids, qcol, int(aq.positions[0]),
                         int(aq.positions[-1]) + 1, 0, False),
        "pack_graph": (preds, is_start, is_end, n_real),
    }
    for name, args in calls.items():
        want = getattr(jax_native, name)(*args)
        got = getattr(port_native, name)(*args)
        assert want is not None, name
        _equal(got, want)
    idx = JaxKmerIndex.build(db, k=8, fast=True)
    P = [np.zeros((idx.n_rows + 1, 16), np.uint8) for _ in range(2)]
    assert jax_native.fill_packed(idx.seq_kmers, idx.seq_offsets, idx.n_seqs, P[0])
    assert port_native.fill_packed(idx.seq_kmers, idx.seq_offsets, idx.n_seqs, P[1])
    np.testing.assert_array_equal(P[0], P[1])


def test_build_graphs_batch_equal():
    db = _db()
    fams = [db.sequences[b : b + 12] for b in range(0, 72, 12)]
    pfams = [carry_db(db).sequences[b : b + 12] for b in range(0, 72, 12)]
    want = jax_graph.build_graphs_batch(fams, fs_weight=0.5)
    got = port_graph.build_graphs_batch(pfams, fs_weight=0.5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in vars(w):
            _equal(getattr(g, f), getattr(w, f))
        assert port_graph.graph_to_dot(g, "x") == jax_graph.graph_to_dot(w, "x")


def test_sequence_turns_equal():
    db = _db()
    for s in db.sequences[:5]:
        p = carry_db(db).get(s.name)
        for turn in ("reverse", "complement"):
            a, b = getattr(s.copy(), turn)(), getattr(p.copy(), turn)()
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.masks, b.masks)
            assert a.get_bases() == b.get_bases()


@pytest.mark.parametrize("meta", ["none", "header", "comment", "csv"])
def test_writers_write_the_same_bytes(meta, tmp_path):
    db = _db()
    seqs = db.sequences[:12]
    for i, s in enumerate(seqs):
        s.set_attr("align_ident_slv", 0.5 + i / 30)
        s.set_attr("nearest_slv", f"ACC{i}.1~0.9{i}")
    pseqs = [PortSequence(s.name, s.positions.copy(), s.masks.copy(), s.width, dict(s.attrs))
             for s in seqs]
    out = {}
    for name, FW, CW, recs in (("jax", JaxFastaWriter, JaxCsvWriter, seqs),
                               ("port", PortFastaWriter, PortCsvWriter, pseqs)):
        fa, csv = tmp_path / f"{name}.fasta", tmp_path / f"{name}.csv"
        with FW(str(fa), meta=meta, line_length=60, min_idty=0.6,
                copy_relatives=2) as w:
            for r in recs:
                w.write_result(r, recs[:3])
        cw = CW(str(csv), fields=["align_ident_slv", "nearest_slv"])
        for r in recs:
            cw.write(r)
        cw.close()
        out[name] = fa.read_bytes(), csv.read_bytes()
    assert out["port"] == out["jax"]
    # and the readers read it back alike
    want = [(s.name, s.get_bases(), json.dumps(s.attrs, default=str))
            for s in jax_read_fasta(str(tmp_path / "jax.fasta"))]
    got = [(s.name, s.get_bases(), json.dumps(s.attrs, default=str))
           for s in port_read_fasta(str(tmp_path / "port.fasta"))]
    assert got == want


def test_port_testing_builds_the_same_fixtures():
    """chip_smoke.py and the CUDA tests build their fixtures with the
    port's copy of testing.py: the same seed gives the same data."""
    a = testing.make_reference(n_seqs=40, n_core=200, width=350, seed=21)
    b = port_testing.make_reference(n_seqs=40, n_core=200, width=350, seed=21)
    _same_db(a, b)
    qa = testing.make_queries(a, n=5, seed=3, branch_len=0.6)
    qb = port_testing.make_queries(b, n=5, seed=3, branch_len=0.6)
    for x, y in zip(qa, qb):
        assert (x.name, x.attrs) == (y.name, y.attrs)
        np.testing.assert_array_equal(x.positions, y.positions)
        np.testing.assert_array_equal(x.masks, y.masks)
