"""Everything BENCHMARK.json names is found by name, and the file keeps
to the contract's shape."""

import importlib.util
import json
import re

import pytest
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_found(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("benchmark/configs/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"]
    for key in conf["reduced"]:
        assert key in data


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_found(cell):
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
    assert any(c["name"] == cell["config"] for c in SPEC["configs"])
    trf = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert trf["name"] == cell["traffic"]
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    path = BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    # the set-up's metrics move setup_s, every other device_peak_gib
    want = "setup_s" if metric["name"].startswith("setup.") else "device_peak_gib"
    assert metric["moves"] == want
    names = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", names)) <= names


def test_every_cell_reports_e2e_and_a_layer():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"device_peak_gib", "setup_s"}
    for cell in SPEC["workloads"]:
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in SPEC["per_layer"])


def test_cli_matches_policy():
    """The family policy the reference applies is the one the command
    line the pipeline is built from gives."""
    from sina_tpu_torch import cli

    for conf in SPEC["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        args = cli.build_parser().parse_args(data["cli"])
        fam = cli.config_from_args(args).famfinder
        for k, v in data["policy"].items():
            assert getattr(fam, k) == v, (conf["name"], k)
        engine = cli.config_from_args(args).aligner.resolved_engine()
        assert engine == data["engine"]
