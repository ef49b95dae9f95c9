"""The port's graft entry (sina_tpu_torch.graft_entry) and its tools
(sina_tpu_torch.tools.*) against the JAX package's __graft_entry__.py
and tools/ scripts, on the CPU at small sizes.

entry()'s top-k and end cells are compared exactly and its raw scores
to rtol 1e-6: the plain dense DP takes the XLA core's f32 steps in its
order (tests/test_torch_graph_dense.py holds them equal unjitted), but
jax.jit over the whole step may fuse the cost set-up's products into
multiply-adds that round once.  The profile entries' results are
compared exactly (the plain DP keeps the Pallas kernel's f32 order, raw
bit for bit), diag_accuracy's printed lines as text.  The JAX side runs the Pallas kernels in interpret mode on the
CPU, as its own tests run them."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from sina_tpu.ops.align_kernel import DpParams as JaxDpParams
from sina_tpu.ops.profile import (
    _build_wire as jax_build_wire,
    _profile_pallas_fn,
    _profile_wire_fn,
    _unpack_log_result,
)
from sina_tpu_torch import graft_entry
from sina_tpu_torch.ops.profile import _pack_fgq, profile_dp_result, profile_dp_wire, unpack_result
from sina_tpu_torch.tools import diag_accuracy, prof_famfinder, prof_profiledp, prof_wire_ab

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    """The JAX package's tools/<name>.py as a module (the scripts are not
    a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax_entry():
    fn, args = graft_entry.entry("cpu")
    got = [t.numpy() for t in fn(*args)]
    jfn, jargs = jax_entry.entry()
    want = [np.asarray(a) for a in jax.jit(jfn)(*jargs)]
    assert [g.shape for g in got] == [(8, 8), (8, 8), (8,), (8,), (8,)]
    for name, g, w in zip(("vals", "ids", "best_j", "best_i"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    assert all(t.device.type == "cpu" for t in args)


def test_graft_entry_main_runs_the_dry_run(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "entry ok: [(8, 8), (8, 8), (8,), (8,), (8,)]"
    assert out[1].startswith("dryrun_multichip ok: mesh dp=1 mp=1")
    assert out[2].startswith("dryrun NR-scale sharded search ok [cpu-scaled shapes")


TOOL_RUNS = {
    "prof_famfinder": (
        prof_famfinder,
        ["--n-refs", "20000", "--batch", "4", "--kmer-l", "32", "--k", "6", "--topk", "16"],
        ["device=cpu n_refs=20000 rows=1025 Sb=2560", "matrix on device in", "packed score:",
         "  -> effective", "TILED score:", "  -> effective", "fused TILED score+grouped_topk:", "torch.topk k=16 over (4, 20480):",
         "top_k_lowest_id k=16 over (4, 20480):", "  -> torch.topk values equal", "argmax:",
         "fused score+topk:"]),
    "prof_profiledp": (
        prof_profiledp,
        ["--c", "40", "--m", "56", "--batch", "3", "--reps", "1"],
        ["device=cpu", "--- C=40 M=56 B=3 (bp plane", "fused fwd DP (bp out):",
         "  -> bp write", "chain traceback (L=160):",
         "full dispatch launch + fetch (device inputs):"]),
    "prof_wire_ab": (
        prof_wire_ab,
        ["--c", "40", "--m", "56", "--b", "16", "--reps", "1"],
        ["device=cpu C=40 M=56 B=16", "direct == wire: results equal",
         "direct (device inputs):", "wire   (device inputs):", "direct (host arrays):",
         "wire   (host arrays):", "host _build_wire:"]),
}


@pytest.mark.parametrize("name", sorted(TOOL_RUNS))
def test_tool_runs_on_the_cpu(name, capsys):
    """Each tool at tiny shapes with --device cpu exits 0 and prints its
    labelled lines in the reference's order."""
    mod, argv, labels = TOOL_RUNS[name]
    assert mod.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(labels), lines
    for line, label in zip(lines, labels):
        assert line.startswith(label), (line, label)


def test_prof_famfinder_refuses_g(capsys):
    with pytest.raises(SystemExit) as e:
        prof_famfinder.main(["--g", "4", "--device", "cpu"])
    assert e.value.code == 2
    assert "csrc/kmer_score.cu has no such parameter" in capsys.readouterr().err


def _evolved(C: int, M: int, B: int, seed: int):
    """Inputs on which the profile DP aligns most bases (the tool's own
    random profiles make every query align one or two): each profile
    a dominant base a column, each query that consensus with a tenth of
    its bases changed, lengths varying by row.  (fg, qmask, lens)."""
    rng = np.random.default_rng(seed)
    cons = rng.integers(0, 4, (B, C))
    freqs = np.full((B, C, 4), 0.05, np.float32)
    np.put_along_axis(freqs, cons[..., None], 0.85, axis=2)
    gapcost = (rng.random((B, C)) * 0.5).astype(np.float32)
    cr = rng.integers(C // 2, C + 1, B).astype(np.int32)
    qlen = np.minimum(rng.integers(M // 2, M - 3, B), cr - 2).astype(np.int32)
    qmask = np.zeros((B, M), np.uint8)
    for b in range(B):
        bases = cons[b, np.sort(rng.choice(cr[b], qlen[b], replace=False))]
        flip = rng.random(qlen[b]) < 0.1
        bases[flip] = rng.integers(0, 4, flip.sum())
        qmask[b, :qlen[b]] = 1 << bases
    fg = _pack_fgq(freqs, gapcost, prof_wire_ab.PARAMS)
    return fg, qmask, np.stack([qlen, cr], axis=1).astype(np.int32)


@pytest.mark.parametrize("inputs", ["tool", "evolved"])
def test_prof_wire_ab_entries_equal_the_jax_package(inputs):
    """The direct and the one-wire entry equal each other and the JAX
    package's _profile_pallas_fn and _profile_wire_fn (interpret mode)
    on the same inputs: the tool's default_rng(3) ones, and evolved
    queries that make the comparison see every row's own alignment."""
    C, M, B = 40, 56, 16
    p = prof_wire_ab.PARAMS
    fg, qmask, lens = (prof_wire_ab.inputs(C, M, B) if inputs == "tool"
                       else _evolved(C, M, B, seed=3))
    wire, segs = prof_wire_ab.build_wire(fg, qmask, lens, torch.device("cpu"))
    direct = profile_dp_result(*(torch.from_numpy(a) for a in (fg, qmask, lens)), p)
    wired = profile_dp_wire(wire, segs, C, M, p)
    assert torch.equal(direct, wired)

    jp = JaxDpParams(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open, gap_ext=p.gap_ext)
    jax_direct = _profile_pallas_fn(C, M, jp, compact=True)(
        *(jnp.asarray(a) for a in (fg, qmask, lens)))
    jwire = jax_build_wire(fg, qmask, lens, None, None, C, M, dedup=False, aspace=False)
    jax_wired = _profile_wire_fn(C, M, jp, B, B, aspace=False, dedup=False, compact=True,
                                 pallas=True)(jnp.asarray(jwire))
    got = unpack_result(direct.numpy())
    for ref in (jax_direct, jax_wired):
        want = _unpack_log_result(np.asarray(ref), M)
        for name, g, w in zip(("emit", "best_c", "best_i"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(got[3].view(np.int32), want[3].view(np.int32))
    if inputs == "evolved":
        assert ((got[0] >= 0).sum(axis=1) > 0.8 * lens[:, 0]).all()


@pytest.mark.parametrize("engine", ["graph", "profile"])
def test_diag_accuracy_prints_the_jax_tools_lines(engine, monkeypatch, capsys):
    argv = ["--engine", engine, "--n-seqs", "60", "--n-core", "200", "--width", "400",
            "--step", "10"]
    assert diag_accuracy.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["diag_accuracy.py", *argv])
    assert _jax_tool("diag_accuracy").main() == 0
    want = capsys.readouterr().out
    assert got.startswith("n=6 avg_sps=")
    assert got == want


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        graft_entry.main([])
    for mod in (prof_famfinder, prof_profiledp, prof_wire_ab, diag_accuracy):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            mod.main([])
