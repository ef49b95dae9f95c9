"""The port's --debug-lattice dump (sina_tpu_torch/debug_dump.py)
against the JAX package's (sina_tpu/debug_dump.py), on the fixture of
tests/test_debug_dump.py: the dense DP's lattice (backpointers, best
cell, raw, V and D planes), the graphviz text, and the CLI's
lattice_<name>.dot files, all on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from sina_tpu import testing
from sina_tpu.debug_dump import compute_lattice as jax_compute_lattice
from sina_tpu.debug_dump import lattice_to_dot as jax_lattice_to_dot
from sina_tpu.ops.graph import build_graph as jax_build_graph
from sina_tpu_torch import debug_dump
from sina_tpu_torch import testing as ttesting
from sina_tpu_torch.ops.graph import build_graph
from test_torch_slice import CASES as PROFILE_CASES
from test_torch_slice import run_both_clis


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The dense DP is a loop of small tensor operations: under the
    test run's parallel workers, torch's intra-op threads would only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixtures():
    """tests/test_debug_dump.py's graph and query, made by each
    package's own testing module and graph builder from the same
    seeds."""
    out = []
    for mod, build in ((testing, jax_build_graph), (ttesting, build_graph)):
        db = mod.make_reference(n_seqs=12, n_core=80, width=140, seed=5)
        graph = build(db.sequences[:6])
        q = mod.unaligned_copy(mod.make_queries(db, n=1, seed=9, branch_len=0.4)[0])
        q.upper_case_all()
        out.append((graph, q))
    return out


def test_compute_lattice_matches_reference():
    (jg, jq), (tg, tq) = _fixtures()
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(getattr(tg, f.name), getattr(jg, f.name))
    want = jax_compute_lattice(jg, jq)
    got = debug_dump.compute_lattice(tg, tq, device="cpu")
    assert got[0].dtype == np.uint16
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:4] == tuple(want[1:4])
    for a, b in zip(got[4:], want[4:]):
        assert a.shape == b.shape == (tg.n_nodes, len(tq.masks))
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # the scored optimum is the best cell's value
    np.testing.assert_allclose(got[4][got[1], got[2]], got[3], rtol=1e-5)


@pytest.mark.parametrize("cols", [(20, 45), (0, None)], ids=["20:45", "all"])
def test_lattice_to_dot_is_byte_identical(cols):
    (jg, jq), (tg, tq) = _fixtures()
    want = jax_lattice_to_dot(jg, jq, col_from=cols[0], col_to=cols[1])
    got = debug_dump.lattice_to_dot(tg, tq, col_from=cols[0], col_to=cols[1], device="cpu")
    assert got == want
    nodes = sum(1 for j in range(tg.n_nodes) if cols[0] <= int(tg.pos[j]) < (cols[1] or 140))
    assert got.count("<TABLE") == nodes * len(tq.masks)


@pytest.mark.parametrize("engine", [[], ["--fs-graph"]], ids=["profile", "graph"])
def test_cli_debug_lattice_dumps_are_byte_identical(engine, tmp_path):
    """--debug-lattice 20:45 writes one lattice_<name>.dot a query that
    reaches the DP, with the JAX package's bytes, on either engine;
    the aligned output is unchanged."""
    c = dict(PROFILE_CASES["verify"], extra=[*engine, "--debug-lattice", "20:45"])
    dumps, _ = run_both_clis(c, tmp_path)
    dots = {k: v for k, v in dumps.items() if k.startswith("lattice_") and k.endswith(".dot")}
    assert len(dots) == c["n"]
    assert all(v.startswith("digraph {") and v.endswith("}\n") for v in dots.values())


def test_compute_lattice_refuses_a_missing_card():
    """The dump runs on the device its caller names: without a GPU the
    default (the card) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, (tg, tq) = _fixtures()
    with pytest.raises((RuntimeError, AssertionError)):
        debug_dump.compute_lattice(tg, tq)
