"""The control (the plain reference's DP in bfloat16, in the program's
place, written and read back as a run's output is) comes out not
correct through the harness's own comparison and limits, at a size a
test run holds, where the same reference in float32 comes out correct;
and the plain reference imports nothing of jax, sina_tpu or
sina_tpu_torch, by whole top-level module names."""

import subprocess
import sys

import pytest
import torch

import control
from conftest import ROOT
from tiny import tiny_cell


@pytest.mark.parametrize("config, traffic", [("silva-nr99-profile", "full-length"),
                                             ("silva-nr99-graph", "full-length"),
                                             ("silva-nr99-profile", "v4-amplicon")])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_limits(config, traffic, seed):
    cell = tiny_cell(config, traffic)
    if "amplicon" in cell["traffic"]:
        # the cell's own read length: below 256 lanes bfloat16 still
        # counts the DP's ramps exactly
        cell["traffic"]["amplicon"] = {"length": 250, "max_start": 100}
    ok, lines, nums = control.verdict(cell, seed, "cpu", 12)
    assert not ok, lines
    assert nums["_sampled"] == 12 and nums["records_lost"] == 0
    ok, lines, _ = control.verdict(cell, seed, "cpu", 12, dtype=torch.float32)
    assert ok, lines


@pytest.mark.parametrize("module", ["reference.check", "reference.family",
                                    "reference.profile_dp", "reference.graph_dp",
                                    "reference.nast"])
def test_reference_imports_nothing_of_the_program(module):
    code = ("import sys; sys.path.insert(0, 'benchmark'); import " + module + "; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    top = set(p.stdout.split())
    assert not top & {"jax", "jaxlib", "flax", "sina_tpu", "sina_tpu_torch"}, top


def test_harness_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'benchmark']; import run; "
            "from benchlib import runner, trace, gen, bounds; import sina_tpu_torch.pipeline; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert not set(p.stdout.split()) & {"jax", "jaxlib", "flax", "sina_tpu"}
