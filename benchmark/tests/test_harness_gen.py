"""The generators are deterministic in their seeds, and the queries'
parents follow the traffic's stated law."""

import numpy as np
import pytest
import torch

from benchlib import gen


def _ref(seed):
    return gen.make_reference(400, 300, 2000, 16, seed, "cpu")


def test_reference_deterministic_in_reference_seed():
    a, b, c = _ref(5), _ref(5), _ref(6)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.masks, b.masks)
    assert torch.equal(a.offsets, b.offsets)
    assert not (a.positions.numel() == c.positions.numel()
                and torch.equal(a.positions, c.positions) and torch.equal(a.masks, c.masks))


def test_reference_is_an_alignment():
    r = _ref(5)
    off = r.offsets.numpy()
    pos = r.positions.numpy()
    for i in range(r.n):
        p = pos[off[i]:off[i + 1]]
        assert (np.diff(p) > 0).all() and p.min() >= 0 and p.max() < r.width
    assert set(np.unique(r.masks.numpy())) <= {1, 2, 4, 8}


@pytest.mark.parametrize("amplicon", [None, {"length": 120, "max_start": 100}])
def test_queries_deterministic_in_seed(amplicon):
    r = _ref(5)
    a = gen.make_queries(r, 50, 2**40 + 3, 0.7, "uniform", amplicon, "cpu")
    b = gen.make_queries(r, 50, 2**40 + 3, 0.7, "uniform", amplicon, "cpu")
    c = gen.make_queries(r, 50, 2**40 + 4, 0.7, "uniform", amplicon, "cpu")
    assert torch.equal(a.masks, b.masks) and torch.equal(a.offsets, b.offsets)
    assert not torch.equal(a.parents, c.parents)
    if amplicon:
        assert (torch.diff(a.offsets) == 120).all()
    fa, _ = gen.to_fasta(a)
    assert fa == gen.to_fasta(b)[0]


# sha256 of to_fasta's bytes for test_queries_deterministic_in_seed's
# seed, as the generator gave them before traffic could turn reads
PARENT_FASTA = {
    None: "5cfeabb0486d000b0b5d42c88809efc432971ece226aa0cf0edafddeae98a84e",
    120: "8268e1ee3ddecd5893db71731b098cad71ecf2d634b0e31320e28f30d59f8cae",
}


@pytest.mark.parametrize("amplicon", [None, {"length": 120, "max_start": 100}])
@pytest.mark.parametrize("turned", ["absent", None])
def test_queries_unchanged_without_turned(amplicon, turned):
    """Without `turned`, every byte generated is the parent's."""
    import hashlib

    kw = {} if turned == "absent" else {"turned": turned}
    q = gen.make_queries(_ref(5), 50, 2**40 + 3, 0.7, "uniform", amplicon, "cpu", **kw)
    assert q.turned is None
    key = amplicon and amplicon["length"]
    assert hashlib.sha256(gen.to_fasta(q)[0]).hexdigest() == PARENT_FASTA[key]


@pytest.mark.parametrize("amplicon", [None, {"length": 120, "max_start": 100}])
@pytest.mark.parametrize("share", [0.5, 1.0, 0.0])
def test_turned_share_reverse_complemented(amplicon, share):
    """`turned` reverse-complements round(share x n) queries drawn from
    the seed, after the cut; the rest, every parent and every length
    stay as without it."""
    r = _ref(5)
    a = gen.make_queries(r, 51, 2**40 + 3, 0.7, "uniform", amplicon, "cpu")
    b = gen.make_queries(r, 51, 2**40 + 3, 0.7, "uniform", amplicon, "cpu", turned=share)
    assert int(b.turned.sum()) == round(share * 51)
    assert torch.equal(a.parents, b.parents) and torch.equal(a.offsets, b.offsets)
    comp = {1: 8, 8: 1, 2: 4, 4: 2}
    for i in range(a.n):
        lo, hi = int(a.offsets[i]), int(a.offsets[i + 1])
        x, y = a.masks[lo:hi].tolist(), b.masks[lo:hi].tolist()
        assert y == ([comp[v] for v in reversed(x)] if b.turned[i] else x)
    c = gen.make_queries(r, 51, 2**40 + 4, 0.7, "uniform", amplicon, "cpu", turned=share)
    if 0 < share < 1:
        assert not torch.equal(b.turned, c.turned)


def test_fasta_records_parse():
    r = _ref(5)
    q = gen.make_queries(r, 5, 9, 0.7, "uniform", None, "cpu")
    text, offs = gen.to_fasta(q)
    recs = text.decode().split("\n")
    assert recs[0] == ">" + gen.record_name(0)
    assert len(recs[1]) == int(q.offsets[1] - q.offsets[0])
    assert offs[-1] == len(text)


@pytest.mark.parametrize("traffic", ["full-length", "v4-amplicon"])
def test_parents_follow_the_stated_law(traffic):
    """Every traffic mix states uniform parents: over 20,000 queries the
    genus counts pass a chi-square test of equal shares at the 0.999
    quantile (148.23 for 99 degrees of freedom), and so do the counts of
    each place within a genus (37.70 for 15)."""
    import json

    from conftest import HERE

    trf = json.loads((HERE.parent / "traffic" / f"{traffic}.json").read_text())
    assert trf["parents"] == "uniform"
    r = gen.make_reference(1600, 60, 200, 16, 5, "cpu")
    q = gen.make_queries(r, 20_000, 2**35 + 1, 0.7, trf["parents"], None, "cpu")
    for counts, limit in ((torch.bincount(q.parents // 16, minlength=100), 148.23),
                          (torch.bincount(q.parents % 16, minlength=16), 37.70)):
        e = q.n / counts.numel()
        chi2 = float(((counts.double() - e) ** 2 / e).sum())
        assert chi2 < limit, chi2


def test_unknown_law_refused():
    with pytest.raises(ValueError):
        gen.make_queries(_ref(5), 5, 1, 0.7, {"zipf_exponent": 1.0}, None, "cpu")
