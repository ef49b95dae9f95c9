"""The graph (mseq) engine end to end: the JAX CLI (sina_tpu, on the
CPU) and the port's CLI (sina_tpu_torch --device cpu, the plain
PyTorch versions of the graph DP and traceback) on the same generated
reference and queries must write byte-identical aligned FASTA
(--meta-fmt comment) and CSV, apart from the `aligned_slv` stamps.

On the CPU the JAX package runs the XLA graph cores (the windowed core,
and the dense core for --use-subst-matrix); the port runs the graph
kernel's semantics, which equal the windowed core's bit for bit with
the default scheme (tests/test_torch_graph.py)."""

import pytest
import torch

from test_torch_slice import CASES as PROFILE_CASES
from test_torch_slice import run_both_clis

CASES = {
    "graph_verify": dict(PROFILE_CASES["verify"], extra=["--fs-graph"]),
    "graph_full_length": dict(PROFILE_CASES["full_length"], extra=["--fs-graph"]),
    "graph_forbid": dict(PROFILE_CASES["verify"],
                         extra=["--fs-graph", "--insertion", "forbid"]),
    "graph_subst": dict(PROFILE_CASES["verify"], extra=["--use-subst-matrix"]),
    # each query's family graph (mseq_<name>.dot) and alignment path
    # (mesh_<name>.svg) in the working directory
    "graph_debug": dict(PROFILE_CASES["verify"], extra=["--fs-graph", "--debug-graph"]),
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_cli_output_is_byte_identical(case, tmp_path):
    dumps, _ = run_both_clis(CASES[case], tmp_path)
    if "--debug-graph" in CASES[case]["extra"]:
        n = CASES[case]["n"]
        assert sum(f.startswith("mseq_") and f.endswith(".dot") for f in dumps) == n
        assert sum(f.startswith("mesh_") and f.endswith(".svg") for f in dumps) == n
    else:
        assert not dumps
