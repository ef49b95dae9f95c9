"""A reference bundle kept as its flat arrays (sina_tpu_torch.refdb.
FlatSequences): opened with ReferenceDb.load it equals the database
built from a list of sequences, reference by reference; opening it and
making its flat arrays make no reference object; a reference is made
once, of read-only views into the store, stamped so that the batch
consumers' identity check passes, and kept; the flat arrays are the
store's own memory; a pipeline built on the bundle has made no
reference, and its run writes what the list-built database writes, on
both engines."""

import numpy as np
import pytest
import torch

from sina_tpu_torch import alphabet, testing, timing
from sina_tpu_torch.align import AlignerConfig, _flat_ranges
from sina_tpu_torch.famfinder import FamFinderConfig
from sina_tpu_torch.io.fasta import FastaWriter
from sina_tpu_torch.ops.profile import _gather_family_arrays
from sina_tpu_torch.pipeline import Pipeline, PipelineConfig
from sina_tpu_torch.refdb import FlatSequences, ReferenceDb

MADE = "refdb.materialized"


def made() -> int:
    return timing.counters.get(MADE, 0)


@pytest.fixture(scope="module")
def listed():
    """A list-built database: 24 references, the sixth written in lower
    case (the masks' 0x10 bit), with an attribute each."""
    db = testing.make_reference(n_seqs=24, n_core=120, width=200, seed=5)
    s = db.sequences[5]
    s.masks = s.masks | alphabet.M_LC
    for i, s in enumerate(db.sequences):
        s.attrs["tax_slv"] = f"Bacteria;G{i % 3};"
    return db


@pytest.fixture()
def bundle(tmp_path, listed):
    listed.save(tmp_path / "ref.sref")
    return tmp_path / "ref.sref"


def test_load_equals_list_built(bundle, listed):
    db = ReferenceDb.load(bundle)
    assert isinstance(db.sequences, FlatSequences)
    assert len(db) == len(listed) and db.width == listed.width
    assert db.names == listed.names
    for a, b in zip(db.sequences, listed.sequences):
        assert (a.name, a.width, a.attrs) == (b.name, b.width, b.attrs)
        assert a.positions.dtype == b.positions.dtype and a.masks.dtype == b.masks.dtype
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.masks, b.masks)
    for x, y in zip(db.packed_arrays(), listed.packed_arrays()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for x, y in zip(db.flat_arrays(), listed.flat_arrays()):
        np.testing.assert_array_equal(x, y)


def test_open_and_flat_make_no_reference(bundle):
    before = made()
    db = ReferenceDb.open(bundle)
    assert made() == before
    db.ensure_flat()
    db.flat_arrays()
    db.packed_arrays()
    assert (len(db), db.index_of(db.names[7]), len(db.names)) == (24, 7, 24)
    assert made() == before
    db.get(db.names[7])
    assert made() == before + 1


def test_reference_made_once_and_kept(bundle):
    db = ReferenceDb.load(bundle)
    seqs = db.sequences
    before = made()
    s = seqs[3]
    assert s is seqs[3] is seqs[np.int64(3)] is seqs[-21]
    assert made() == before + 1
    assert seqs[2:5][1] is s and seqs[::-1][20] is s
    assert [t.name for t in seqs[::5]] == db.names[::5]
    everything = list(seqs)
    assert everything[3] is s and len(everything) == 24
    assert made() == before + 24
    assert list(seqs) == everything and made() == before + 24
    for bad in (24, -25):
        with pytest.raises(IndexError):
            seqs[bad]


@pytest.mark.parametrize("field", ["positions", "masks"])
def test_reference_arrays_are_read_only(bundle, field):
    db = ReferenceDb.load(bundle)
    s = db.sequences[4]
    with pytest.raises(ValueError, match="read-only"):
        getattr(s, field)[0] = 1
    store = getattr(db.sequences, field)
    assert np.shares_memory(getattr(s, field), store)
    copied = s.copy()
    getattr(copied, field)[0] = 1  # a copy is the caller's own


def test_flat_arrays_share_the_store(bundle, listed):
    db = ReferenceDb.load(bundle)
    offsets, positions, mask4 = db.flat_arrays()
    st = db.sequences
    assert positions is st.positions and offsets is st.offsets
    assert np.shares_memory(positions, db.packed_arrays()[1])
    # the lower-case reference sets the 0x10 bit: mask4 is computed once
    assert not np.shares_memory(mask4, st.masks)
    np.testing.assert_array_equal(mask4, st.masks & 0xF)
    assert db.flat_arrays()[2] is mask4
    # with no bit above 0xF, the masks are their own mask4
    plain = ReferenceDb.from_arrays(listed.names, offsets, positions, st.masks & 0xF,
                                    listed.width, [{}] * len(listed))
    assert plain.flat_arrays()[2] is plain.sequences.masks


def test_stamps_pass_the_consumers_check(bundle, listed):
    db = ReferenceDb.load(bundle)
    fam = db.sequences[2:14]
    flat = _flat_ranges(fam)
    assert flat is not None
    starts, counts, ref = flat
    offsets, positions, mask4 = db.flat_arrays()
    assert ref[0] is positions and ref[1] is mask4
    np.testing.assert_array_equal(starts, offsets[2:14])
    np.testing.assert_array_equal(counts, np.diff(offsets)[2:14])
    for s in fam:
        assert s._flat_ref[4] is s.positions and s._flat_ref[0] is positions
    got = _gather_family_arrays(fam)
    listed.ensure_flat()
    want = _gather_family_arrays(listed.sequences[2:14])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_save_keeps_attributes_of_made_references(bundle, tmp_path):
    db = ReferenceDb.load(bundle)
    db.sequences[9].attrs["strain"] = "ST9"
    db.save(tmp_path / "again.sref")
    again = ReferenceDb.load(tmp_path / "again.sref")
    assert again.sequences[9].attrs["strain"] == "ST9"
    assert "strain" not in again.sequences[8].attrs
    assert again.names == db.names


def _pipeline(ref, out, engine):
    return Pipeline(PipelineConfig(
        in_path=str(out.parent / "q.fasta"), outputs=[("fasta", str(out))],
        db=str(ref), device="cpu", batch_size=4,
        famfinder=FamFinderConfig(fs_min=6, fs_max=6, fs_full_len=100, fs_req_gaps=1,
                                  fs_min_len=50),
        aligner=AlignerConfig(engine=engine)))


@pytest.mark.parametrize("engine", ["profile", "graph"])
def test_pipeline_on_bundle_makes_only_what_it_uses(tmp_path, listed, engine):
    """The first open of a FASTA reference builds the list database
    (and its bundle beside it); the second opens that bundle."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with FastaWriter(str(tmp_path / "ref.fasta"), meta="comment") as w:
            for s in listed.sequences:
                w.write(s)
        with FastaWriter(str(tmp_path / "q.fasta")) as w:
            for q in testing.make_queries(listed, n=6, seed=3, branch_len=0.5):
                w.write(testing.unaligned_copy(q))
        outs = []
        for k in range(2):
            before = made()
            pipe = _pipeline(tmp_path / "ref.fasta", tmp_path / f"out{k}.fasta", engine)
            assert isinstance(pipe.db.sequences, FlatSequences) == (k == 1)
            assert made() == before
            pipe.run()
            if k == 1:
                assert 0 < made() - before <= len(listed)
            outs.append((tmp_path / f"out{k}.fasta").read_bytes())
        assert outs[0] == outs[1] and outs[0].count(b">") == 6
    finally:
        torch.set_num_threads(n)
