"""Reads in both orientations and checks found by name, at a tiny size on
the CPU: a classification run (`--turn all -S --lca-fields tax_slv`) on
traffic with half its reads reverse-complemented is correct with
`turn_differs` 0; a wrong orientation or an unturned record fails the
check; a configuration's `checks` are found by name and judged by the
limits of their numbers' names; a limit that names no number stops the
run with a message."""

import time

import numpy as np
import pytest
import torch

import run as bench_run
from benchlib import gen, runner
from conftest import HERE
from reference import check as refcheck, family
from tiny import tiny_cell

SEED = 2**34 + 5
CLASSIFY = ("--turn", "all", "-S", "--lca-fields", "tax_slv")


def _turned_cell():
    cell = tiny_cell(cli=CLASSIFY, turned=0.5)
    cell["config"]["limits"]["turn_differs"] = 0
    return cell


@pytest.fixture
def test_checks(monkeypatch):
    """The test-only check modules under tests/checks/ are found too."""
    monkeypatch.setattr(refcheck, "CHECK_DIRS", [*refcheck.CHECK_DIRS, HERE / "checks"])


@pytest.fixture(scope="module")
def turned_run():
    cell = _turned_cell()
    run = runner.run_cell(cell, SEED, 0.5, False, "cpu", time.time())
    return cell, run, runner.check(cell, run, SEED, "cpu")


def test_turned_run_is_correct(turned_run):
    cell, run, nums = turned_run
    assert refcheck.turn_mode(cell["config"]["cli"]) == "all"
    assert nums["turn_differs"] == 0 and nums["_sampled"] > 0
    ok, lines, shown = bench_run.limits_lines(nums, cell["config"]["limits"])
    assert ok, lines
    turns = [a["turn_slv"] for a in run["records"]["attrs"]]
    # both orientations arrive and both are written back turned
    assert "none" in turns and "reversed and complemented" in turns
    # every attribute of a record's header comment is kept
    assert all("nearest_slv" in a and "lca_tax_slv" in a for a in run["records"]["attrs"])


def _flip_half(monkeypatch):
    """The program's orientation flipped (as is <-> both, reversed <->
    complemented) for every other query of each batch."""
    import sina_tpu_torch.famfinder as ff

    orig, calls = ff._pick_orientation, [0]

    def pick(tops, all4):
        calls[0] += 1
        best = orig(tops, all4)
        return 3 - best if calls[0] % 2 else best
    return lambda pipe: monkeypatch.setattr(ff, "_pick_orientation", pick)


def _unturned(monkeypatch):
    """turn_slv written, the record's bases left as they arrived."""
    import sina_tpu_torch.famfinder as ff

    def turn(query, which):
        query.set_attr("turn_slv", ff.TURN_NAMES[which])
    return lambda pipe: monkeypatch.setattr(ff, "_turn", turn)


@pytest.mark.parametrize("fault, number", [(_flip_half, "turn_differs"),
                                           (_unturned, "bases_altered")],
                         ids=["orientation-flipped-half", "written-unturned"])
def test_turn_fault_is_not_correct(monkeypatch, fault, number):
    cell = _turned_cell()
    cell["traffic"]["check_sample"] = 64
    run = runner.run_cell(cell, 99, 0.5, False, "cpu", time.time(), faults=fault(monkeypatch))
    nums = runner.check(cell, run, 99, "cpu")
    assert nums[number] > cell["config"]["limits"][number], nums
    assert not bench_run.limits_lines(nums, cell["config"]["limits"])[0]


@pytest.mark.parametrize("checks, limits, correct", [
    (["probe_attrs"], {"nearest_missing": 0}, True),
    (["probe_attrs"], {"nearest_missing": -1}, False),
    (["probe_align"], {}, False),
], ids=["number-within", "number-fails", "alignment-replaced"])
def test_named_check_judged(turned_run, test_checks, checks, limits, correct):
    cell, run, _ = turned_run
    cfg = dict(cell["config"], checks=checks, limits=dict(cell["config"]["limits"], **limits))
    nums = runner.check(dict(cell, config=cfg), run, SEED, "cpu")
    ok, lines, shown = bench_run.limits_lines(nums, cfg["limits"])
    assert ok is correct, lines
    assert set(shown) == set(cfg["limits"])
    if "probe_align" in checks:
        assert nums["raw_rel_gap"] == pytest.approx(0.5, rel=1e-3)


@pytest.mark.parametrize("where", ["run", "control"])
def test_align_is_not_given_the_records(turned_run, test_checks, where):
    """A check's align that reads the program's records fails alike in
    a run's check and in the control: it is given ALIGN_KEYS alone."""
    import control

    cell, run, _ = turned_run
    cell = dict(cell, config=dict(cell["config"], checks=["probe_peek"]))
    with pytest.raises(KeyError, match="records"):
        if where == "run":
            runner.check(cell, run, SEED, "cpu")
        else:
            control.verdict(cell, SEED, "cpu", 8)


@pytest.mark.parametrize("source", [
    "import jax\n",
    "from sina_tpu_torch import cli\n",
    "import importlib\nparse = importlib.import_module('sina_tpu_torch.cli').build_parser\n",
], ids=["imports-jax", "imports-the-program", "holds-the-program"])
def test_check_using_the_program_stops_the_run(monkeypatch, tmp_path, source):
    (tmp_path / "probe_bad.py").write_text(source + "\n\ndef numbers(ctx):\n    return {}\n")
    monkeypatch.setattr(refcheck, "CHECK_DIRS", [tmp_path])
    with pytest.raises(SystemExit, match="check probe_bad uses"):
        refcheck.load_checks(["probe_bad"])


@pytest.mark.parametrize("key, name", [("limits", "no_such_number"),
                                       ("checks", "no_such_check"),
                                       ("limits", "turn_differs")],
                         ids=["limit-without-number", "check-without-module",
                              "number-without-limit"])
def test_unknown_name_stops_the_run(turned_run, test_checks, capsys, key, name):
    """A limit with no number, a check with no module, or a number with
    no limit ends the run with a message that names it, and no result
    line."""
    cell, run, nums = turned_run
    cfg = dict(cell["config"])
    if key == "checks":
        cfg["checks"] = [name]
    elif name in cfg["limits"]:
        cfg["limits"] = {k: v for k, v in cfg["limits"].items() if k != name}
    else:
        cfg["limits"] = dict(cfg["limits"], **{name: 0})
    with pytest.raises(SystemExit) as e:
        nums = runner.check(dict(cell, config=cfg), run, SEED, "cpu")
        bench_run.result(dict(cell, config=cfg), run, nums, False, "cpu", 1)
    assert name in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cli", [[], ["--turn"], ["-t"], ["--turn", "all"], ["-t", "all"],
                                 ["--turn=all"], ["-tall"], ["--turn", "revcomp"],
                                 ["--turn", "none"], ["--turn", "-S"], ["--turn", "all", "-S"]])
def test_turn_mode_as_the_program_reads_it(cli):
    from sina_tpu_torch import cli as prog_cli

    args = prog_cli.build_parser().parse_args(cli)
    assert refcheck.turn_mode(cli) == prog_cli.config_from_args(args).famfinder.turn


def test_plain_turn_check():
    """top1 is each query's best exact score (one call for all), and the
    turn check turns a reverse-complemented read back, a reversed one
    back under --turn all, and keeps the earlier orientation on a tie."""
    ref = gen.make_reference(300, 500, 1200, 16, 77, "cpu")
    kmers = family.RefKmers(ref.masks, ref.offsets)
    q = gen.make_queries(ref, 6, 2**33 + 1, 0.7, "uniform", None, "cpu", turned=0.5)
    m, o = q.masks.numpy(), q.offsets.numpy()
    reads = [m[o[i]:o[i + 1]] for i in range(q.n)]
    variants = [family.orient(r, w) for r in reads for w in range(4)]
    tops = kmers.top1([torch.from_numpy(v) for v in variants])
    assert tops.tolist() == [int(kmers.scores(torch.from_numpy(v)).max()) for v in variants]
    want = [3 if t else 0 for t in q.turned.tolist()]
    assert family.turn_check(kmers, reads, True) == want
    assert family.turn_check(kmers, reads, False) == want
    rev = [family.orient(r, 1) for r in reads]
    assert family.turn_check(kmers, rev, True) == [2 if t else 1 for t in q.turned.tolist()]
    poly_a = np.ones(50, dtype=np.uint8)  # 0 in every orientation: the tie keeps "none"
    assert family.turn_check(kmers, [poly_a], True) == [0]
