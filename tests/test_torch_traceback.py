"""The port's plain traceback walks against the JAX package's own loops,
on adversarial backpointer planes.

The planes come from sina_tpu_torch.testing (chain_traceback_case,
graph_traceback_case): random cells, deletion chains and insertion runs
longer than any window the CUDA kernels stage, graph jumps of 31 nodes,
zero match and deletion distances on match cells, and starts on the
plane's edges.  The chain walk (ops/profile_kernel.chain_traceback_plain)
is held to sina_tpu.ops.profile_pallas.chain_traceback_log, run on each
query's (C, M) slice, with emit rebuilt from its column log by
sina_tpu.ops.profile._unpack_log_result (the k-th emission consumed
base best_i - k); the graph walk (ops/graph_kernel.graph_traceback_plain)
to sina_tpu.ops.graph_pallas.traceback_device_dist.  Both are integer
state machines, so every comparison is exact.

Starts outside the plane and walks that hit the step cap have no JAX
counterpart (its loop has no cap, and its gathers read other cells):
they are pinned here by hand-worked cases and by the plane they clamp
to, and held to the kernels on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu.ops.graph_pallas import traceback_device_dist
from sina_tpu.ops.profile import _unpack_log_result
from sina_tpu.ops.profile_pallas import chain_traceback_log
from sina_tpu_torch import testing
from sina_tpu_torch.ops import graph_kernel as gk
from sina_tpu_torch.ops import profile_kernel as pk

# (B, C or N, M): one crossing the kernels' windows in both directions,
# one below a window with odd sizes
SHAPES = [(4, 700, 600), (3, 40, 37)]
GRAPH_SHAPES = [(4, 700, 500), (3, 40, 37)]
CHAIN_JAX_CASES = ("random", "deletion_run", "insertion_run", "edge_starts", "step_cap")
GRAPH_JAX_CASES = ("random", "deletion_run", "insertion_run", "edge_starts", "jumps",
                   "zero_dist")

_chain_log = jax.jit(chain_traceback_log, static_argnums=(3, 4))
_graph_walk = jax.jit(traceback_device_dist, static_argnums=(4, 5))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _chain_plain(bp, bc, bi):
    steps = np.zeros(len(bc), np.int64)
    emit = pk.chain_traceback_plain(*_t(bp, bc, bi), steps=steps).numpy()
    return emit, steps


def _graph_plain(bp, bj, bi, flags):
    steps = np.zeros(len(bj), np.int64)
    emit, done = gk.graph_traceback_plain(*_t(bp, bj, bi, flags), steps=steps)
    return emit.numpy(), done.numpy(), steps


def _jax_chain_emit(bp, bc, bi):
    C, B, M = bp.shape
    logs = np.stack([np.asarray(_chain_log(jnp.asarray(bp[:, b]), bc[b], bi[b], C, M))
                     for b in range(B)])
    aux = np.stack([bc, bi, np.zeros(B, np.int32)], axis=1)
    emit, *_ = _unpack_log_result(np.concatenate([logs, aux], axis=1).astype(np.int32), M)
    return emit


def _jax_graph_emit(bp, bj, bi, flags):
    B, N, M = bp.shape
    return np.stack([
        np.asarray(_graph_walk(jnp.asarray(bp[b]), bj[b], bi[b],
                               jnp.asarray((flags[b] & 1) != 0), N, M))
        for b in range(B)])


def _largest_drop(emit, start):
    """Per row: the largest fall in column (node) between consecutive
    consumed bases, the start cell's column first."""
    out = []
    for b in range(emit.shape[0]):
        row = emit[b]
        cols = np.concatenate([[start[b]], row[row >= 0][::-1]])
        out.append(int((cols[:-1] - cols[1:]).max()) if len(cols) > 1 else 0)
    return np.array(out)


def _longest_column(emit):
    """Per row: the most bases one column (node) consumed."""
    return np.array([np.bincount(r[r >= 0]).max() if (r >= 0).any() else 0 for r in emit])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CHAIN_JAX_CASES)
def test_chain_walk_matches_jax(case, shape):
    bp, bc, bi = testing.chain_traceback_case(case, 11, *shape)
    emit, steps = _chain_plain(bp, bc, bi)
    np.testing.assert_array_equal(emit, _jax_chain_emit(bp, bc, bi))
    if shape == SHAPES[0]:
        # the case is what it claims to be at the size that crosses windows
        B, (C, _, M) = shape[0], bp.shape
        assert steps.max() > 500
        if case == "deletion_run":
            assert (_largest_drop(emit, bc) > testing.RUN).all()
        elif case == "insertion_run":
            assert (_longest_column(emit) >= testing.RUN).all()
        elif case == "step_cap":
            assert (steps == C + 2 * M + 8).all()
        elif case == "random":
            assert ((emit >= 0).sum(axis=1) > 192).all()


@pytest.mark.parametrize("shape", GRAPH_SHAPES)
@pytest.mark.parametrize("case", GRAPH_JAX_CASES)
def test_graph_walk_matches_jax(case, shape):
    bp, bj, bi, flags = testing.graph_traceback_case(case, 13, *shape)
    emit, done, steps = _graph_plain(bp, bj, bi, flags)
    assert done.tolist() == [1] * shape[0]
    np.testing.assert_array_equal(emit, _jax_graph_emit(bp, bj, bi, flags))
    if shape == GRAPH_SHAPES[0]:
        if case == "deletion_run":
            assert (_largest_drop(emit, bj) > testing.RUN).all()
        elif case == "insertion_run":
            assert (_longest_column(emit) >= testing.RUN).all()
        elif case == "jumps":
            assert (_largest_drop(emit, bj) >= 31).all()
        elif case == "zero_dist":
            assert (_longest_column(emit) >= 2).all()
        elif case == "random":
            assert steps.max() > 400


def test_chain_walk_from_outside_the_plane_by_hand():
    """Every cell a match: reads clamp to the plane's edge cells, emit
    takes the unclamped column, bases past M are not written."""
    bp = np.full((4, 2, 4), 1, np.uint8)                     # (C, B, M)
    bc = np.array([6, -2], np.int32)
    bi = np.array([5, 2], np.int32)
    emit, steps = _chain_plain(bp, bc, bi)
    # (6, 5) -> (5, 4) -> ... each match a resolve and a decide step;
    # bases 3..0 consumed by columns 4..1, base 0 at the edge ends it
    assert emit.tolist() == [[1, 2, 3, 4], [-4, -3, -2, -1]]
    assert steps.tolist() == [12, 6]


def test_graph_walk_from_outside_the_plane_by_hand():
    """Every cell a match one node back, no start node: reads clamp,
    predecessors clamp at node 0, bases past M are not written."""
    bp = np.full((2, 4, 4), 1 | (1 << 2), np.int16)         # (B, N, M)
    bj = np.array([6, -2], np.int32)
    bi = np.array([5, 2], np.int32)
    flags = np.zeros((2, 4), np.uint8)
    emit, done, steps = _graph_plain(bp, bj, bi, flags)
    assert emit.tolist() == [[1, 2, 3, 4], [0, 0, -2, -1]]
    assert done.tolist() == [1, 1]
    assert steps.tolist() == [12, 6]


def _pad_to(a, axis_sizes):
    """Repeat the last index of each given axis out to its new size."""
    for axis, size in axis_sizes.items():
        idx = np.minimum(np.arange(size), a.shape[axis] - 1)
        a = np.take(a, idx, axis=axis)
    return a


@pytest.mark.parametrize("graph", [False, True])
def test_walks_past_the_far_edges_read_the_edge_cells(graph):
    """A start past the last column (node) or position walks as it
    would on the plane padded out to it with copies of the edge cells,
    as long as it ends within its own step cap."""
    B, C, M = 6, 300, 200
    if graph:
        bp, sj, si, flags = testing.graph_traceback_case("random", 5, B, C, M)
    else:
        bp, sj, si = testing.chain_traceback_case("random", 5, B, C, M)
    sj = np.array([C + 9, C, C - 1, C + 40, C - 50, C + 2], np.int32)
    si = np.array([M + 3, M - 1, M + 20, M, M + 1, M - 30], np.int32)
    Cp, Mp = int(sj.max()) + 1, int(si.max()) + 1
    if graph:
        emit, done, steps = _graph_plain(bp, sj, si, flags)
        padded = _pad_to(bp, {1: Cp, 2: Mp})
        pemit, pdone, _ = _graph_plain(padded, sj, si, _pad_to(flags, {1: Cp}))
        assert done.tolist() == pdone.tolist() == [1] * B
    else:
        emit, steps = _chain_plain(bp, sj, si)
        pemit, _ = _chain_plain(_pad_to(bp, {0: Cp, 2: Mp}), sj, si)
    assert (steps < C + 2 * M + 8).all()
    np.testing.assert_array_equal(emit, pemit[:, :M])
    assert (emit >= 0).sum() > 200


def test_chain_walk_stops_at_the_step_cap():
    B, C, M = 2, 300, 40
    bp, bc, bi = testing.chain_traceback_case("step_cap", 1, B, C, M)
    emit, steps = _chain_plain(bp, bc, bi)
    assert steps.tolist() == [C + 2 * M + 8] * B
    # the insertions took bases M-1..1 at the start column; the cap came
    # in the deletion chain along base 1, before the walk reached base 0
    assert emit[:, 1:].tolist() == [[C - 1] * (M - 1)] * B
    assert emit[:, 0].tolist() == [-1] * B


def test_graph_walk_stops_at_the_step_cap():
    B, N, M = 3, 50, 30
    bp, bj, bi, flags = testing.graph_traceback_case("step_cap", 1, B, N, M)
    emit, done, steps = _graph_plain(bp, bj, bi, flags)
    assert done.tolist() == [0] * B
    assert steps.tolist() == [N + 2 * M + 8] * B
    assert (emit == -1).all()
    with pytest.raises(RuntimeError, match="did not finish"):
        gk.check_walks(done)
