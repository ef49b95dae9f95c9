"""The graph engine's dense route through the port's entry points, on
the CPU, against the JAX package.

A family member with a long insertion that its relatives skip puts a
predecessor 32 or more nodes back in the family's POA graph, and the
graph's bucket takes the dense route: the reference's XLA dense core
(sina_tpu/align.py:1051, 1084-1105), in the port
ops/align_kernel.graph_dp_dense and graph_traceback_dense (on the CPU
their plain versions).  Here half of the references carry a 40-base
insertion (sina_tpu_torch.testing.with_long_insertion), so every
bucket takes that route (the graph_dense_route counter says so):

- the CLI with --fs-graph, --fs-graph --insertion forbid and
  --use-subst-matrix writes the JAX package's bytes;
- align_batch, align_sequence_host_traceback (the dense DP and the host
  walk), traceback and emit_to_pairs return the JAX package's results,
  and the host walk's pairs equal the device walk's emit.
"""

import inspect

import numpy as np
import pytest
import torch

from sina_tpu import align as jax_align
from sina_tpu import testing as jax_testing
from sina_tpu.ops import align_kernel as jak
from sina_tpu_torch import align as talign
from sina_tpu_torch import testing
from sina_tpu_torch.ops import align_kernel as tak
from sina_tpu_torch.ops import kernels
from sina_tpu_torch.timing import get_timer, reset_all
from test_torch_graph_dense import dense_bucket
from test_torch_slice import CASES as PROFILE_CASES
from test_torch_slice import run_both_clis

INS = 40
LONG_INSERTION = dict(length=INS, every=2, seed=3)
CLI_CASES = {
    "graph": ["--fs-graph"],
    "graph_forbid": ["--fs-graph", "--insertion", "forbid"],
    "subst": ["--use-subst-matrix"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: under
    the test run's parallel workers, torch's intra-op threads would
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_buckets_only() -> int:
    """The graph buckets dispatched since the last reset, after
    asserting that every one took the dense route."""
    buckets = get_timer("GraphDP").counts["launch"]
    assert buckets > 0
    assert kernels.launches["graph_dense_route"] == buckets
    return buckets


@pytest.mark.parametrize("mode", sorted(CLI_CASES))
def test_dense_route_cli_output_is_byte_identical(mode, tmp_path):
    c = dict(PROFILE_CASES["verify"], n=6, extra=CLI_CASES[mode], long_insertion=LONG_INSERTION)
    kernels.reset_launches()
    reset_all()
    run_both_clis(c, tmp_path)
    _dense_buckets_only()


def _family_case(mod):
    """Queries and 8-member families of a small reference with the long
    insertion, built with the JAX package's (mod = jax_testing) or the
    port's testing module from the same seeds."""
    db = testing.with_long_insertion(
        mod.make_reference(n_seqs=60, n_core=300, width=500, seed=23), **LONG_INSERTION)
    queries = mod.make_queries(db, n=3, seed=9, branch_len=0.6)
    fams = []
    for q in queries:
        pid = db.index_of(q.get_attr("parent"))
        fams.append([(1.0, db.sequences[(pid + k) % len(db)]) for k in range(8)])
    return [mod.unaligned_copy(q) for q in queries], fams


def _same(a, b):
    assert a is not None and b is not None
    assert a.positions.tolist() == b.positions.tolist()
    assert a.masks.tolist() == b.masks.tolist()
    drop = {talign.FN_DATE}
    assert ({k: v for k, v in a.attrs.items() if k not in drop}
            == {k: v for k, v in b.attrs.items() if k not in drop})


def test_align_batch_matches_jax():
    tq, tf = _family_case(testing)
    jq, jf = _family_case(jax_testing)
    kernels.reset_launches()
    reset_all()
    got = talign.align_batch(tq, tf, talign.AlignerConfig(engine="graph"), device="cpu")
    _dense_buckets_only()
    want = jax_align.align_batch(jq, jf, jax_align.AlignerConfig(engine="graph"))
    for a, b in zip(got, want):
        _same(a, b)


def test_host_traceback_matches_jax_and_the_device_walk():
    """align_sequence_host_traceback (the dense DP, then the host walk)
    equals the JAX package's and the port's own align_sequence (the
    dense route's device walk, here its plain version)."""
    tq, tf = _family_case(testing)
    jq, jf = _family_case(jax_testing)
    tcfg = talign.AlignerConfig(realign=True, engine="graph")
    jcfg = jax_align.AlignerConfig(realign=True, engine="graph")
    for q, fam, qj, famj in zip(tq, tf, jq, jf):
        host = talign.align_sequence_host_traceback(q, fam, tcfg, device="cpu")
        _same(host, jax_align.align_sequence_host_traceback(qj, famj, jcfg))
        dev = talign.align_sequence(q, fam, tcfg, device="cpu")
        assert host.positions.tolist() == dev.positions.tolist()
        assert host.masks.tolist() == dev.masks.tolist()


def test_host_walk_and_emit_to_pairs_match_jax_and_the_device_walk():
    """On tests/test_torch_graph_dense.py's bucket: the host walk
    traceback equals the JAX package's on the same plane, and its pairs
    and head equal emit_to_pairs of traceback_dense's emit (the JAX
    package's emit_to_pairs too)."""
    c = dense_bucket()
    t = torch.from_numpy
    bp, bj, bi, _ = tak.poa_dp_dense(
        t(c["pos"]), t(c["mask"].astype(np.uint8)), t(c["weight"]), t(c["preds"]),
        t(c["is_start"]), t(c["is_end"]), t(c["qm"].astype(np.uint8)), t(c["ql"]),
        t(c["nr"]), torch.ones((3, c["width"])), tak.DpParams())
    emit, done = tak.traceback_dense(bp, bj, bi, t(c["preds"]), t(c["is_start"]))
    assert done.tolist() == [1, 1, 1]
    for b in range(3):
        args = (bp[b].numpy(), int(bj[b]), int(bi[b]), c["pos"][b], c["preds"][b],
                c["is_start"][b])
        pairs, head = tak.traceback(*args)
        assert (pairs, head) == jak.traceback(*args)
        row = emit[b].numpy()
        assert tak.emit_to_pairs(row) == jak.emit_to_pairs(row) == (pairs, head)


def test_align_module_has_the_jax_packages_public_names():
    """Every public function and class of sina_tpu.align (align_batch,
    align_sequence_host_traceback and AlignmentFailure among them) has
    its namesake in the port."""
    def public(mod):
        return {n for n, o in vars(mod).items()
                if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
                and o.__module__ == mod.__name__}

    assert public(jax_align) <= public(talign)
    assert issubclass(talign.AlignmentFailure, Exception)
