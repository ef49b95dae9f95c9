"""bench_torch.py, the port's throughput entry point, against bench.py:
the same options, the same workloads byte for byte, records equal to
the JAX package's for the same steps in every mode, the same aligned
and classified counts as `python bench.py --cpu`, the same --curve
children, and a loud failure without a GPU.  All at a tiny size."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench_torch
from sina_tpu import testing as jax_testing
from sina_tpu.io.fasta import FastaWriter as JaxFastaWriter
from sina_tpu_torch.io.fasta import FastaWriter as TorchFastaWriter

REPO = Path(__file__).resolve().parent.parent

TINY = ["--n-refs", "60", "--width", "700", "--n-core", "500", "--fs-max", "10",
        "--n-queries", "24", "--batch-size", "8"]
MODES = {
    "default": [],
    "graph": ["--graph"],
    "amplicon": ["--amplicon"],
    "search": ["--search"],
    "col_trim_min_0": ["--col-trim-min", "0"],
}
_STAMP = re.compile(r"(aligned_slv=)[^\]\n]*")
_COUNT = re.compile(r"\((aligned \d+/\d+|classified \d+)\)")


def _env() -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}


def _bench_py(argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(REPO / "bench.py"), *argv], cwd=REPO,
                            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def bench_py_runs():
    """`python bench.py --cpu` at the tiny size in every mode, started
    together; each test reads its mode's (stdout, stderr)."""
    procs = {m: _bench_py(TINY + ["--cpu"] + extra) for m, extra in MODES.items()}
    try:
        yield {m: p.communicate(timeout=600) + (p.returncode,) for m, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()


@pytest.fixture(scope="module")
def port_runs():
    """bench_torch.run(args, device="cpu") in every mode: (the JSON
    dict, the records, what it printed to stderr, to stdout)."""
    got = {}
    for mode, extra in MODES.items():
        err, out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            line, records = bench_torch.run(bench_torch.parse_args(TINY + ["--cpu"] + extra),
                                            device="cpu")
        got[mode] = line, records, err.getvalue(), out.getvalue()
    return got


def _options(text: str) -> set[str]:
    return set(re.findall(r"(--[a-z][a-z-]*)", text))


def test_help_lists_bench_py_options():
    jax_help = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO, env=_env(),
                              capture_output=True, text=True, timeout=300)
    port_help = subprocess.run([sys.executable, "bench_torch.py", "--help"], cwd=REPO,
                               env=_env(), capture_output=True, text=True, timeout=300)
    assert jax_help.returncode == 0 and port_help.returncode == 0, port_help.stderr
    assert _options(port_help.stdout) == _options(jax_help.stdout)
    assert len(_options(jax_help.stdout)) == 13  # --help and bench.py's twelve


def jax_workload(args):
    """bench.py's workload (bench.py:113-145 and, for --search,
    :186-190), made by the JAX package's generators."""
    if args.n_refs > 5000:
        db = jax_testing.make_reference_large(args.n_refs, n_core=args.n_core,
                                              width=args.width, seed=1234)
    else:
        db = jax_testing.make_reference(n_seqs=args.n_refs, n_core=args.n_core,
                                        width=args.width, seed=1234)
    if args.search:
        return db, jax_testing.make_queries(db, n=args.n_queries, seed=7, branch_len=0.7)
    queries = [jax_testing.unaligned_copy(q)
               for q in jax_testing.make_queries(db, n=args.n_queries, seed=7,
                                                 branch_len=0.7)]
    if args.amplicon:
        for q in queries:
            lo = min(400, max(0, len(q.masks) - 250) // 2)
            q.masks = q.masks[lo:lo + 250]
            q.positions = np.arange(len(q.masks), dtype=np.uint32)
            q.width = len(q.masks)
    return db, queries


def _same_sequences(port, jax) -> None:
    assert len(port) == len(jax)
    for a, b in zip(port, jax):
        assert (a.name, a.width, a.attrs) == (b.name, b.width, b.attrs)
        for field in ("positions", "masks"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (a.name, field)


@pytest.mark.parametrize("n_refs", [60, 5001])
@pytest.mark.parametrize("extra", [[], ["--amplicon"], ["--search"]],
                         ids=["full_length", "amplicon", "search"])
def test_workload_equals_bench_py(n_refs, extra):
    """workload(args) gives the JAX package's reference and queries
    byte for byte, on both sides of the 5,000-reference switch between
    the tree and the block generator."""
    argv = ["--n-refs", str(n_refs), "--width", "700", "--n-core", "500",
            "--n-queries", "12", *extra]
    args = bench_torch.parse_args(argv)
    db, queries = bench_torch.workload(args)
    jdb, jqueries = jax_workload(args)
    assert db.width == jdb.width
    _same_sequences(db.sequences, jdb.sequences)
    _same_sequences(queries, jqueries)
    if extra == ["--amplicon"]:
        assert {len(q.masks) for q in queries} == {250}


def jax_records(args):
    """The records the JAX package's FamFinder, align_dispatch /
    align_finalize and SearchFilter give for bench.py's steps: the
    warm-up batch, then the timed 3-deep pipeline (bench.py:227-332);
    for --search each batch through the filter (:174-225)."""
    from collections import deque

    from sina_tpu.align import AlignerConfig, align_dispatch, align_finalize
    from sina_tpu.famfinder import FamFinder, FamFinderConfig

    db, queries = jax_workload(args)
    bs = args.batch_size
    finder = FamFinder(db, FamFinderConfig(fs_min=args.fs_max, fs_max=args.fs_max,
                                           fs_full_len=min(1400, args.n_core - 100),
                                           fs_req_gaps=1))
    if args.search:
        from sina_tpu.search import SearchConfig, SearchFilter

        searcher = SearchFilter(db, SearchConfig(min_sim=0.5, lca_fields=["tax_slv"],
                                                 kmer_candidates=min(1000, len(db))), finder)
        return [a for i in range(0, len(queries), bs)
                for a in searcher.process_batch(queries[i:i + bs])]
    acfg = AlignerConfig(engine="graph" if args.graph else "auto")
    if args.col_trim_min is not None:
        acfg.col_trim_min_cols = args.col_trim_min
    wbatch = queries[:bs]
    wres = finder.process_batch(wbatch)
    out = align_finalize(align_dispatch(wbatch, [r.family if not r.failed else [] for r in wres],
                                        acfg))
    batches = [queries[i:i + bs] for i in range(bs, len(queries), bs)]
    handles = [finder.submit_batch(batches[0])]
    pending = deque()
    for bi, batch in enumerate(batches):
        if bi + 1 < len(batches):
            handles.append(finder.submit_batch(batches[bi + 1]))
        results = finder.process_batch(batch, handle=handles[bi])
        handles[bi] = None
        pending.append(align_dispatch(batch, [r.family if not r.failed else [] for r in results],
                                      acfg))
        if len(pending) >= 2:
            out += align_finalize(pending.popleft())
    while pending:
        out += align_finalize(pending.popleft())
    return out


def _fasta(writer, records, path: Path) -> str:
    with writer(str(path), meta="comment") as w:
        for r in records:
            w.write(r)
    return _STAMP.sub(r"\1T", path.read_text())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_records_equal_jax_package(mode, port_runs, tmp_path):
    """run(args, device="cpu")'s records, warm-up batch included and in
    query order, write the same FASTA bytes (attributes included, the
    aligned_slv stamps masked) as the JAX package's for the same steps;
    run prints nothing to stdout."""
    line, records, _, stdout = port_runs[mode]
    args = bench_torch.parse_args(TINY + ["--cpu"] + MODES[mode])
    want = jax_records(args)
    assert stdout == ""
    assert len(records) == len(want) == args.n_queries
    assert [r is None for r in records] == [w is None for w in want]
    got_text = _fasta(TorchFastaWriter, [r for r in records if r is not None],
                      tmp_path / "port.fasta")
    want_text = _fasta(JaxFastaWriter, [w for w in want if w is not None],
                       tmp_path / "jax.fasta")
    assert got_text == want_text
    assert got_text.count(">") == sum(r is not None for r in records) > 0
    if mode == "search":
        assert all(r.get_attr("nearest_slv") for r in records)
        assert all(r.get_attr("lca_tax_slv") is not None for r in records)
    assert line["unit"] == "seq/s" and line["value"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_counts_and_line_equal_bench_py(mode, port_runs, bench_py_runs):
    """The "aligned N/M" or "classified N" count of the port's run equals
    `python bench.py --cpu`'s, and its JSON line has bench.py's keys,
    metric and baseline (the ratio of value to vs_baseline) in the same
    form; bench.py's mid-run-compile keys have no counterpart."""
    line, _, err, _ = port_runs[mode]
    jout, jerr, rc = bench_py_runs[mode]
    assert rc == 0, jerr[-2000:]
    jline = json.loads(jout.strip().splitlines()[-1])
    assert _COUNT.findall(err) == _COUNT.findall(jerr) != []
    jline.pop("midrun_compiles", None)
    jline.pop("midrun_compile_s", None)
    assert set(line) == set(jline)
    assert line["metric"] == jline["metric"]
    baseline = 280.0 if mode == "amplicon" else 42.0
    for ln in (line, jline):
        # both rounded to 2 places from the same unrounded rate
        assert abs(ln["vs_baseline"] - ln["value"] / baseline) <= 0.0051
    for key in ("unit", "n_refs", "width"):
        assert line.get(key) == jline.get(key)
    for want in ("# wall coverage:", "# timings Pipeline:") if mode != "search" else ():
        assert want in err and want in jerr
    assert "# launches in the timed window:" in err
    assert "# generation-2 collections in the timed window:" in err


# runs a module's main() with subprocess.run recorded instead of run,
# and prints the argument lists it was given as one JSON line
_RECORD_CHILDREN = """
import json, runpy, subprocess, sys
calls = []
subprocess.run = lambda argv, **kw: calls.append(list(argv))
sys.argv = [sys.argv[1], *sys.argv[2:]]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(json.dumps(calls))
"""


@pytest.mark.parametrize("extra", [[], ["--cpu"], ["--n-queries", "256", "--batch-size", "64"]],
                         ids=["default", "cpu", "sizes"])
def test_curve_spawns_bench_py_children(extra):
    """--curve runs the same three children as bench.py: the script
    itself at 2k x 2,400, 20k x 50k and 100k x 50k, with the same
    arguments."""
    calls = {}
    for script in ("bench.py", "bench_torch.py"):
        res = subprocess.run([sys.executable, "-c", _RECORD_CHILDREN, script, "--curve",
                              *extra], cwd=REPO, env=_env(), capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        calls[script] = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(calls["bench.py"]) == 3
    for port, jax in zip(calls["bench_torch.py"], calls["bench.py"], strict=True):
        assert port[0] == jax[0] == sys.executable
        assert Path(port[1]).name == "bench_torch.py" and Path(jax[1]).name == "bench.py"
        assert port[2:] == jax[2:]
    assert [c[c.index("--n-refs") + 1] for c in calls["bench_torch.py"]] == [
        "2000", "20000", "100000"]


def test_without_gpu_fails_loudly():
    """Without --cpu on a machine with no GPU the script exits non-zero
    with resolve_device's message and prints no JSON line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    res = subprocess.run([sys.executable, "bench_torch.py", *TINY], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA device requested" in res.stderr
    assert res.stdout == ""
