"""A tiny run on the CPU drives the whole harness (set-up, warm-up, the
window through Pipeline.run, the check) and gives the contract's result
line; without a GPU, run.py prints no result and fails."""

import json
import subprocess
import sys
import time

import pytest
import torch

import run as bench_run
from benchlib import runner
from conftest import ROOT
from tiny import tiny_cell

SEED = 2**33 + 17


CELLS = [("silva-nr99-profile", "full-length"), ("silva-nr99-graph", "full-length"),
         ("silva-nr99-profile", "v4-amplicon")]


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: ".".join(c))
def sound_run(request):
    cell = tiny_cell(*request.param)
    cell["end_to_end"] = [{"name": n, "unit": u} for n, u in
                          (("device_peak_gib", "GiB"), ("setup_s", "s"))]
    run = runner.run_cell(cell, SEED, 1.0, False, "cpu", time.time())
    return cell, run, runner.check(cell, run, SEED, "cpu")


def test_sound_run_is_correct(sound_run):
    cell, run, nums = sound_run
    assert nums["_records"] == run["attempted"] > 0
    assert nums["_sampled"] > 0
    for k, lim in cell["config"]["limits"].items():
        assert nums[k] <= lim, (k, nums[k], lim)


def test_result_line(sound_run):
    cell, run, nums = sound_run
    out, lines = bench_run.result(cell, run, nums, False, "cpu", 1)
    line = json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"device_peak_gib", "setup_s"}
    assert line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "compared"
    assert len(lines) == len(cell["config"]["limits"])


def test_no_gpu_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "silva-nr99-profile.full-length", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_prints_result():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "silva-nr99-profile.full-length", "--seed", "2", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"



def test_host_layer_readers(sound_run):
    """Every per-layer metric read from the host's clocks and the
    program's spans gives a number from the run's context."""
    from test_harness_files import SPEC

    cell, run, nums = sound_run
    host = [m for m in SPEC["per_layer"] if m["source"] != "device_trace"]
    assert any(m["name"] == "pipeline.seq_per_s" for m in host)
    for m in host:
        v = bench_run.read_metric(m["name"], run["ctx"])
        if m["name"] in ("pipeline.seq_per_s", "host.main_cpu_ms_per_seq"):
            assert v > 0, m["name"]
        assert v is None or v >= 0, (m["name"], v)
    assert run["ctx"]["cpu"]["process"] >= run["ctx"]["cpu"]["main"] > 0
