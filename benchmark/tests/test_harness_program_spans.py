"""The per-layer metrics read from the program's own spans and counters
(sina_tpu_torch.timing) on a tiny run of each configuration: each gives
a number, the set-up's parts fit inside the run's set-up, and the
counters' readers give a number or None without raising."""

import time

import pytest

import run as bench_run
from benchlib import runner
from tiny import tiny_cell

SEED = 2**33 + 29
SPANS = ("setup.refdb_open_s", "setup.kmer_index_s", "pipeline.read_ms",
         "pipeline.batch_host_p95_ms", "pipeline.span_coverage_pct")
COUNTERS = ("cache.identity_hit_pct", "graph_dp.global_ring_launches")


@pytest.fixture(scope="module", params=["silva-nr99-profile", "silva-nr99-graph"])
def tiny_run(request):
    cell = tiny_cell(request.param)
    run = runner.run_cell(cell, SEED, 1.0, False, "cpu", time.time())
    values = {m: bench_run.read_metric(m, run["ctx"]) for m in SPANS + COUNTERS}
    return run, values


def test_span_readers_give_numbers(tiny_run):
    run, values = tiny_run
    for m in SPANS:
        assert isinstance(values[m], float) and values[m] >= 0, (m, values[m])
    assert values["setup.kmer_index_s"] > 0
    assert 0 < values["pipeline.span_coverage_pct"] <= 100
    assert values["pipeline.batch_host_p95_ms"] > values["pipeline.read_ms"]


def test_setup_parts_inside_setup_s(tiny_run):
    run, values = tiny_run
    parts = values["setup.refdb_open_s"] + values["setup.kmer_index_s"]
    assert parts < run["metrics_e2e"]["setup_s"]


def test_counter_readers(tiny_run):
    _, values = tiny_run
    assert values["graph_dp.global_ring_launches"] == 0  # no CUDA kernel on the CPU
    v = values["cache.identity_hit_pct"]
    assert v is None or 0 <= v <= 100
