"""tests/test_align.py on the port: every case runs on the port's CPU
path (device="cpu", the kernels' plain versions) beside the JAX
package on the same fixtures.  Each keeps the original's assertions,
made on the port's output, and the port's aligned records must equal
the JAX package's: positions, masks, width and every attribute (the
`aligned_slv` stamp aside)."""

import numpy as np
import pytest
import torch

import sina_tpu.align as jalign
from sina_tpu import testing as jtesting
from sina_tpu.ops.graph import build_graph as jax_build_graph
from sina_tpu.sequence import Sequence as JaxSequence
from sina_tpu_torch import align as talign
from sina_tpu_torch import testing as ttesting
from sina_tpu_torch.comparator import COVER_QUERY, IUPAC_EXACT, Comparator
from sina_tpu_torch.ops.graph import build_graph
from sina_tpu_torch.sequence import Sequence

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain graph DP is a loop over small torch operations: under
    # the suite's parallel workers extra threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fam(*seqs):
    return [(1.0, s) for s in seqs]


def state(seq):
    """What the two packages must agree on in an aligned record."""
    assert seq is not None
    attrs = {k: v for k, v in seq.attrs.items() if k != "aligned_slv"}
    return (seq.name, seq.positions.tolist(), seq.masks.tolist(), seq.width, attrs)


def cfgs(**kw):
    """The same AlignerConfig in both packages."""
    return talign.AlignerConfig(**kw), jalign.AlignerConfig(**kw)


def test_graph_build():
    def build(seq_cls, build_fn):
        return build_fn([seq_cls.from_string("a", "AG-CU"), seq_cls.from_string("b", "AGGC-")])

    g = build(Sequence, build_graph)
    # columns: 0:A(2) 1:G(2) 2:G(1) 3:C(2) 4:U(1) -> 5 nodes
    assert g.n_nodes == 5
    assert g.pos.tolist() == [0, 1, 2, 3, 4]
    # node A at col0 shared -> weight 1/2 + 1*2/2 = 1.5
    assert g.weight[0] == pytest.approx(1.5)
    assert g.weight[2] == pytest.approx(1.0)  # G col2 only in b
    assert g.is_start.tolist() == [True, False, False, False, False]
    assert g.is_end.tolist() == [False, False, False, False, True]
    j = build(JaxSequence, jax_build_graph)
    for name in ("pos", "mask", "weight", "preds", "is_start", "is_end", "max_insert"):
        np.testing.assert_array_equal(getattr(g, name), getattr(j, name), err_msg=name)
    assert g.width == j.width


# (references, query, AlignerConfig keywords, the original's checks on
# the port's output)
SMALL = {
    "identical_copies_alignment": (
        ["..AG-CU-A.."], "AGCUA", {},
        lambda out, refs: (out.positions.tolist() == refs[0].positions.tolist()
                           and out.get_attr("align_quality_slv") == 100)),
    "superstring_copies_subalignment": (
        ["AG-CU-AG"], "CUA", {},
        lambda out, refs: out.get_aligned(dots=False) == "---CU-A-"),
    # a query one substitution away from r1 (A->G at r1 col 8) must
    # adopt r1's column layout with the substituted base in place
    "dp_recovers_reference_like_alignment": (
        ["..AG-CUGA-UC..", "..AGGC-GAAUC.."], "AGCUGGUC", {"engine": "graph"},
        lambda out, refs: out.get_aligned(dots=False) == "--AG-CUGG-UC--"),
    "deletion": (  # G at col 5 missing
        ["AGACGUCA"], "AGACUCA", {"realign": True, "engine": "graph"},
        lambda out, refs: out.get_aligned(dots=False) == "AGAC-UCA"),
    # the reference alignment has a gap column the extra U can use
    "insertion_shifted": (
        ["AGA-CGUCA", "AGA-CGUCA"], "AGAUCGUCA", {"realign": True, "engine": "graph"},
        lambda out, refs: (out.get_bases() == "AGAUCGUCA"
                           and out.get_aligned(dots=False) == "AGAUCGUCA")),
    # a query with 2 extra bases on each side
    "overhang_attach_and_edge": (
        ["--AGCU--"], "GGAGCUCC", {"realign": True, "engine": "graph"},
        lambda out, refs: (out.get_bases() == "GGAGCUCC"
                           and out.get_aligned(dots=False) == "GGAGCUCC"
                           and out.get_attr("align_cutoff_head_slv") == 2
                           and out.get_attr("align_cutoff_tail_slv") == 2)),
    "overhang_remove": (
        ["--AGCU--"], "GGAGCUCC",
        {"realign": True, "overhang": talign.OVERHANG_REMOVE, "engine": "graph"},
        lambda out, refs: out.get_bases() == "AGCU"),
    "lowercase_unaligned": (
        ["--AGCU--"], "GGAGCUCC",
        {"realign": True, "lowercase": talign.LOWERCASE_UNALIGNED, "engine": "graph"},
        lambda out, refs: out.get_bases() == "ggAGCUcc"),
}


@pytest.mark.parametrize("case", sorted(SMALL))
def test_align_small_case(case):
    """test_align.py's hand-made cases (identical and superstring
    copies, the DP recovering a reference-like alignment, a deletion, a
    shifted insertion, overhangs attached, edged and removed, lowercase
    unaligned bases)."""
    refs, query, kw, check = SMALL[case]
    tcfg, jcfg = cfgs(**kw)
    trefs = [Sequence.from_string(f"r{i + 1}", r) for i, r in enumerate(refs)]
    jrefs = [JaxSequence.from_string(f"r{i + 1}", r) for i, r in enumerate(refs)]
    out = talign.align_sequence(Sequence.from_string("q", query), fam(*trefs), tcfg, device=CPU)
    want = jalign.align_sequence(JaxSequence.from_string("q", query), fam(*jrefs), jcfg)
    assert out is not None
    assert check(out, trefs), out.get_aligned(dots=False)
    assert state(out) == state(want)


def test_accuracy_on_synthetic_db():
    """Realign evolved queries against the synthetic reference; exact
    per-column identity with the true alignment must be high (the
    analogue of tests/accuracy_kmer.test avg_sps)."""
    tcfg, jcfg = cfgs(realign=True, engine="graph")
    tdb = ttesting.make_reference(n_seqs=80, n_core=400, width=700, seed=11)
    jdb = jtesting.make_reference(n_seqs=80, n_core=400, width=700, seed=11)
    cmp_exact = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    sps = []
    for true_q, jtrue_q in zip(ttesting.make_queries(tdb, n=8, seed=5, branch_len=0.5),
                               jtesting.make_queries(jdb, n=8, seed=5, branch_len=0.5)):
        # family: the parent and the 9 references after it
        pid = tdb.index_of(true_q.get_attr("parent"))
        out = talign.align_sequence(ttesting.unaligned_copy(true_q),
                                    fam(*(tdb.sequences[(pid + k) % len(tdb)] for k in range(10))),
                                    tcfg, device=CPU)
        want = jalign.align_sequence(jtesting.unaligned_copy(jtrue_q),
                                     fam(*(jdb.sequences[(pid + k) % len(jdb)] for k in range(10))),
                                     jcfg)
        assert out is not None
        assert out.get_bases().upper() == true_q.get_bases().upper()
        assert state(out) == state(want)
        sps.append(cmp_exact(true_q, out))
    assert np.mean(sps) > 0.95, f"avg_sps {np.mean(sps)} too low"


def test_host_traceback_matches_device():
    """The host walk (the oracle) and the device walk's path (here its
    plain version) give identical alignments, each equal to the JAX
    package's."""
    tcfg, jcfg = cfgs(realign=True, engine="graph")
    tdb = ttesting.make_reference(n_seqs=60, n_core=300, width=500, seed=23)
    jdb = jtesting.make_reference(n_seqs=60, n_core=300, width=500, seed=23)
    for true_q, jtrue_q in zip(ttesting.make_queries(tdb, n=5, seed=9, branch_len=0.6),
                               jtesting.make_queries(jdb, n=5, seed=9, branch_len=0.6)):
        pid = tdb.index_of(true_q.get_attr("parent"))
        tfam = fam(*(tdb.sequences[(pid + k) % len(tdb)] for k in range(8)))
        jfam = fam(*(jdb.sequences[(pid + k) % len(jdb)] for k in range(8)))
        q, jq = ttesting.unaligned_copy(true_q), jtesting.unaligned_copy(jtrue_q)
        dev = talign.align_sequence(q, tfam, tcfg, device=CPU)
        host = talign.align_sequence_host_traceback(q, tfam, tcfg, device=CPU)
        assert dev is not None and host is not None
        assert dev.positions.tolist() == host.positions.tolist()
        assert dev.masks.tolist() == host.masks.tolist()
        assert state(dev) == state(jalign.align_sequence(jq, jfam, jcfg))
        assert state(host) == state(jalign.align_sequence_host_traceback(jq, jfam, jcfg))


@pytest.mark.parametrize("insertion", ["shift", "forbid"])
def test_batch_family_dedup_matches_individual(insertion):
    """A batch where several queries share one family list gives
    exactly the per-query alignments (the deduplicated profile transfer
    changes nothing), in shift mode (test_batch_family_dedup_matches_
    individual) and forbid mode (test_batch_family_dedup_forbid_mode),
    each equal to the JAX package's batch."""
    tcfg, jcfg = cfgs(insertion=insertion)
    if insertion == "shift":
        seed, n_seqs, qseed, slices = 11, 24, 3, [slice(0, 8), slice(8, 16)]
        pick = [0, 1, 0, 0, 1, 0]
    else:
        seed, n_seqs, qseed, slices = 12, 16, 5, [slice(0, 8)]
        pick = [0, 0, 0, 0]
    tdb = ttesting.make_reference(n_seqs=n_seqs, n_core=300, width=600, seed=seed)
    jdb = jtesting.make_reference(n_seqs=n_seqs, n_core=300, width=600, seed=seed)
    n = len(pick)
    tq = [ttesting.unaligned_copy(q)
          for q in ttesting.make_queries(tdb, n=n, seed=qseed, branch_len=0.7)]
    jq = [jtesting.unaligned_copy(q)
          for q in jtesting.make_queries(jdb, n=n, seed=qseed, branch_len=0.7)]
    tshared = [[(1.0, s) for s in tdb.sequences[sl]] for sl in slices]
    jshared = [[(1.0, s) for s in jdb.sequences[sl]] for sl in slices]
    batch = talign.align_batch(tq, [list(tshared[i]) for i in pick], tcfg, device=CPU)
    jbatch = jalign.align_batch(jq, [list(jshared[i]) for i in pick], jcfg)
    for q, i, got, want in zip(tq, pick, batch, jbatch):
        one = talign.align_sequence(q, list(tshared[i]), tcfg, device=CPU)
        assert got is not None and one is not None
        assert got.positions.tolist() == one.positions.tolist()
        assert got.get_attr("align_quality_slv") == one.get_attr("align_quality_slv")
        assert state(got) == state(want)
