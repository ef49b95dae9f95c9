"""The turn check and search + LCA in the port, against the JAX package.

- The CLIs: `python -m sina_tpu` and `python -m sina_tpu_torch --device
  cpu` write byte-identical FASTA and CSV (apart from the `aligned_slv`
  stamps) with --turn, --turn all (a quarter of the queries reversed, a
  quarter complemented, a quarter reversed and complemented), -S with
  --lca-fields, --search-all, --search-db with --search-copy-fields,
  --search-ignore-super, and -P -S.
- lca_classify gives the JAX package's answer on its own cases
  (tests/test_pipeline.py) and on ties.
- SearchFilter.process_batch on a database and queries carried across
  as numpy arrays gives the JAX package's nearest_slv, lca_tax_slv,
  copied fields and search_result.
- FamFinder.find and FamFinder.__call__ (the per-query turn check) on
  quarter-turned queries give the JAX package's ranking, turn_slv,
  turned query and family.
"""

import numpy as np
import pytest

from sina_tpu import famfinder as jax_famfinder
from sina_tpu import search as jax_search
from sina_tpu import testing
from sina_tpu_torch import famfinder as port_famfinder
from sina_tpu_torch import search as port_search
from sina_tpu_torch.sequence import Sequence
from test_torch_host import carry_db
from test_torch_slice import CASES as PROFILE_CASES
from test_torch_slice import _turned, run_both_clis

TURN_NAMES = ["none", "reversed", "complemented", "reversed and complemented"]

VERIFY = PROFILE_CASES["verify"]
CASES = {
    "turn": dict(VERIFY, n=12, turn=True, extra=["--turn"]),
    "turn_all": dict(VERIFY, n=12, turn=True, extra=["--turn", "all"]),
    "search_lca": dict(VERIFY, extra=["-S", "--lca-fields", "tax_slv"]),
    "search_all": dict(VERIFY, extra=["-S", "--search-all", "--lca-fields", "tax_slv"]),
    # a second database: the search builds a finder of its own
    "search_db": dict(VERIFY, search_db=True,
                      extra=["-S", "--search-copy-fields", "tax_slv",
                             "--lca-fields", "tax_slv"]),
    "search_ignore_super": dict(VERIFY, extra=["-S", "--search-ignore-super",
                                               "--lca-fields", "tax_slv"]),
    # search on prealigned input: no family search, the search's own finder
    "prealigned_search": dict(VERIFY, prealigned=True,
                              extra=["-P", "-S", "--lca-fields", "tax_slv"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_turn_and_search_cli_output_is_byte_identical(case, tmp_path):
    c = CASES[case]
    _, got = run_both_clis(c, tmp_path)
    turns = [r.get_attr("turn_slv") for r in got]
    if case == "turn_all":
        assert turns == [TURN_NAMES[i % 4] for i in range(c["n"])]
    elif case == "turn":
        assert turns[0::4] == ["none"] * 3
        assert turns[3::4] == ["reversed and complemented"] * 3
    else:
        assert "-S" in c["extra"]
        assert all(r.get_attr("lca_tax_slv") for r in got)
        nearest = [r.get_attr("nearest_slv") for r in got]
        assert all(n is not None for n in nearest) and any(nearest)
        if c.get("search_db"):
            assert any(k.startswith("copy_") and k.endswith("_tax_slv")
                       for r in got for k in r.attrs)


LCA_CASES = [
    # tests/test_pipeline.py:113-122
    ([["A", "B", "C"], ["A", "B", "C"], ["A", "B", "D"]], 3, 0.7),
    ([["A", "B", "C"], ["A", "B", "C"], ["A", "B", "D"]], 3, 1.0),
    ([], 0, 0.7),
    # ties: two paths of each kind, or one of each
    ([["A", "B"], ["A", "C"]], 2, 0.7),
    ([["A", "B"], ["A", "C"]], 2, 0.5),
    ([["A", "B", "X"], ["A", "B", "Y"], ["A", "C", "X"], ["A", "C", "Y"]], 4, 0.7),
    ([["A"], ["B"], ["A"], ["B"]], 4, 0.5),
    ([[], ["A", "B"], ["A", "B"]], 3, 0.7),
]


def _random_lca_cases():
    rng = np.random.default_rng(17)
    out = []
    for _ in range(40):
        n = int(rng.integers(1, 8))
        paths = [[str(x) for x in rng.integers(0, 3, int(rng.integers(0, 4)))]
                 for _ in range(n)]
        out.append((paths, n, float(rng.choice([0.5, 0.7, 0.9, 1.0]))))
    return out


@pytest.mark.parametrize("paths,n,quorum", LCA_CASES)
def test_lca_classify_matches_jax(paths, n, quorum):
    want = jax_search.lca_classify([list(p) for p in paths], n, quorum)
    assert port_search.lca_classify([list(p) for p in paths], n, quorum) == want


def test_lca_classify_matches_jax_on_random_paths():
    for paths, n, quorum in _random_lca_cases():
        want = jax_search.lca_classify([list(p) for p in paths], n, quorum)
        assert port_search.lca_classify([list(p) for p in paths], n, quorum) == want


def carry_seq(s) -> Sequence:
    return Sequence(s.name, s.positions.copy(), s.masks.copy(), s.width, dict(s.attrs))


@pytest.fixture(scope="module")
def search_env():
    db = testing.make_reference(n_seqs=120, n_core=400, width=700, seed=21)
    queries = testing.make_queries(db, n=12, seed=3, branch_len=0.5)
    return db, queries


SEARCH_CFGS = {
    "kmer": dict(max_result=5, min_sim=0.3, kmer_candidates=50),
    "all": dict(max_result=5, min_sim=0.3, search_all=True),
    "ignore_super": dict(max_result=8, min_sim=0.3, kmer_candidates=1000,
                         ignore_super=True),
}


@pytest.mark.parametrize("name", sorted(SEARCH_CFGS))
def test_search_filter_matches_jax(search_env, name):
    db, queries = search_env
    kw = dict(SEARCH_CFGS[name], lca_fields=["tax_slv"], copy_fields=["acc"])
    jax_out = jax_search.SearchFilter(db, jax_search.SearchConfig(**kw)).process_batch(
        [q.copy() for q in queries] + [None])
    port = port_search.SearchFilter(carry_db(db), port_search.SearchConfig(**kw),
                                    device="cpu")
    port_out = port.process_batch([carry_seq(q) for q in queries] + [None])
    assert port_out[-1] is None and jax_out[-1] is None
    for a, b in zip(jax_out[:-1], port_out[:-1]):
        assert b.attrs == a.attrs
        assert [(sc, r.name) for sc, r in b.search_result] == [
            (sc, r.name) for sc, r in a.search_result]
    assert any(q.get_attr("nearest_slv") for q in port_out[:-1])


@pytest.mark.parametrize("turn", ["revcomp", "all"])
def test_per_query_turn_check_matches_jax(search_env, turn):
    db, queries = search_env
    kw = dict(turn=turn, fs_min=10, fs_max=10, fs_full_len=400, fs_req_gaps=1)
    jax_finder = jax_famfinder.FamFinder(db, jax_famfinder.FamFinderConfig(**kw))
    port_finder = port_famfinder.FamFinder(
        carry_db(db), port_famfinder.FamFinderConfig(**kw), device="cpu")
    for i, q in enumerate(queries):
        given = _turned(testing.unaligned_copy(q), TURN_NAMES[i % 4])
        a, b = given.copy(), carry_seq(given)
        assert port_finder.find(b, 20) == jax_finder.find(a, 20)
        want, got = jax_finder(a), port_finder(b)
        if turn == "all":
            assert b.get_attr("turn_slv") == TURN_NAMES[i % 4]
        assert b.attrs == a.attrs
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(b.masks, a.masks)
        assert [(sc, s.name) for sc, s in got.family] == [
            (sc, s.name) for sc, s in want.family]
        assert (got.astats_name, got.log, got.failed) == (
            want.astats_name, want.log, want.failed)
