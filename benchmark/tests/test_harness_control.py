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
from conftest import HERE, ROOT
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


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_limits_turned(seed):
    """The same with half the reads reverse-complemented and the
    command line turning them: the control's records carry the plain
    turn check's orientation and are judged with turn_differs."""
    cell = tiny_cell(cli=("--turn", "all"), turned=0.5)
    cell["config"]["limits"]["turn_differs"] = 0
    ok, lines, nums = control.verdict(cell, seed, "cpu", 12)
    assert not ok, lines
    assert nums["turn_differs"] == 0 and nums["bases_altered"] == 0
    ok, lines, _ = control.verdict(cell, seed, "cpu", 12, dtype=torch.float32)
    assert ok, lines


PROGRAM = {"jax", "jaxlib", "flax", "sina_tpu", "sina_tpu_torch"}
CHECK_FILES = sorted([*(ROOT / "benchmark" / "reference" / "checks").glob("*.py"),
                      *(HERE / "checks").glob("*.py")])


def _loaded_after(code: str) -> set[str]:
    """The top-level names in sys.modules of a fresh interpreter, with the
    benchmark on its path, once `code` has run."""
    code = ("import sys; sys.path.insert(0, 'benchmark'); " + code + "; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


@pytest.mark.parametrize("module", sorted(f"reference.{p.stem}" for p in
                                          (ROOT / "benchmark" / "reference").glob("*.py")
                                          if p.stem != "__init__"))
def test_reference_imports_nothing_of_the_program(module):
    top = _loaded_after("import " + module)
    assert not top & PROGRAM, top


@pytest.mark.parametrize("path", CHECK_FILES, ids=[p.stem for p in CHECK_FILES])
def test_check_modules_import_nothing_of_the_program(path):
    """Every check module, production and test-only, loaded as a run
    loads it (check.load_checks)."""
    top = _loaded_after(f"from reference import check; "
                        f"check.CHECK_DIRS[:] = [check.Path({str(path.parent)!r})]; "
                        f"check.load_checks([{path.stem!r}])")
    assert not top & PROGRAM, top


def test_harness_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'benchmark']; import run; "
            "from benchlib import runner, trace, gen, bounds; import sina_tpu_torch.pipeline; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert not set(p.stdout.split()) & {"jax", "jaxlib", "flax", "sina_tpu"}
