"""The port imports neither jax nor the JAX package, its CLI runs the
options ported since its first slice, and every kernel launch goes
through the one helper that makes the operands' device current."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "sina_tpu_torch",
    "sina_tpu_torch.alphabet",
    "sina_tpu_torch.sequence",
    "sina_tpu_torch.timing",
    "sina_tpu_torch.cache",
    "sina_tpu_torch.progress",
    "sina_tpu_torch.native",
    "sina_tpu_torch.io",
    "sina_tpu_torch.io.fasta",
    "sina_tpu_torch.io.csv",
    "sina_tpu_torch.refdb",
    "sina_tpu_torch.comparator",
    "sina_tpu_torch.stats",
    "sina_tpu_torch.log_stats",
    "sina_tpu_torch.testing",
    "sina_tpu_torch.device",
    "sina_tpu_torch.famfinder",
    "sina_tpu_torch.search",
    "sina_tpu_torch.align",
    "sina_tpu_torch.pipeline",
    "sina_tpu_torch.cli",
    "sina_tpu_torch.ops",
    "sina_tpu_torch.ops.kernels",
    "sina_tpu_torch.ops.kmer",
    "sina_tpu_torch.ops.kmer_kernel",
    "sina_tpu_torch.ops.kmer_index",
    "sina_tpu_torch.ops.colspan",
    "sina_tpu_torch.ops.graph",
    "sina_tpu_torch.ops.align_kernel",
    "sina_tpu_torch.ops.graph_kernel",
    "sina_tpu_torch.ops.profile",
    "sina_tpu_torch.ops.profile_kernel",
    "sina_tpu_torch.ops.transfer",
    "sina_tpu_torch.debug_dump",
    "sina_tpu_torch.parallel",
    "sina_tpu_torch.parallel.sharding",
    "sina_tpu_torch.parallel.multihost",
    "sina_tpu_torch.parallel.dryrun",
    "sina_tpu_torch.graft_entry",
    "sina_tpu_torch.tools",
    "sina_tpu_torch.tools.prof_famfinder",
    "sina_tpu_torch.tools.prof_profiledp",
    "sina_tpu_torch.tools.prof_wire_ab",
    "sina_tpu_torch.tools.diag_accuracy",
]

# installs a sys.meta_path hook that makes every import of jax, jaxlib
# and the JAX package sina_tpu fail
BLOCK_JAX = """
import sys
class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sina_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _BlockJax())
"""

NOTHING_BLOCKED_LOADED = (
    "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'sina_tpu') for k in sys.modules)\n"
)


def _run(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + code],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )


def test_port_modules_are_all_listed():
    pkg = REPO / "sina_tpu_torch"
    found = set()
    for path in pkg.rglob("*.py"):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__main__":
            continue
        found.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert found == set(PORT_MODULES)


def test_port_imports_without_jax():
    code = (
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        + NOTHING_BLOCKED_LOADED +
        "print('ok')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_help_without_jax():
    code = (
        "import runpy\n"
        "sys.argv = ['sina_tpu_torch', '--help']\n"
        "runpy.run_module('sina_tpu_torch', run_name='__main__')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout


def test_port_sources_never_import_jax():
    for path in [*(REPO / "sina_tpu_torch").rglob("*.py"), REPO / "bench_torch.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (
                f"{path}: {line}"
            )


def test_port_sources_never_import_the_jax_package():
    paths = [*(REPO / "sina_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "bench_torch.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            bad = len(words) >= 2 and words[0] in ("import", "from") and (
                words[1] == "sina_tpu" or words[1].startswith("sina_tpu."))
            assert not bad, f"{path}: {line}"


def test_bench_torch_runs_without_jax(tmp_path):
    """A tiny bench_torch.py --cpu run (search + LCA, then alignment)
    with jax and sina_tpu blocked prints its JSON line."""
    code = (
        "import json\n"
        "import bench_torch\n"
        "tiny = ['--cpu', '--n-refs', '40', '--width', '600', '--n-core', '400',\n"
        "        '--fs-max', '10', '--n-queries', '8', '--batch-size', '4']\n"
        "for extra in (['--search'], []):\n"
        "    assert bench_torch.main(tiny + extra) == 0\n"
        + NOTHING_BLOCKED_LOADED +
        "print('ok')\n"
    )
    res = _run(code, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert [json.loads(ln)["unit"] for ln in lines[:-1]] == ["seq/s", "seq/s"]


def test_graft_entry_and_tools_run_without_jax(tmp_path):
    """python -m sina_tpu_torch.graft_entry and each of the port's tools,
    with jax and sina_tpu blocked, run on the CPU at tiny shapes."""
    code = (
        "from sina_tpu_torch import graft_entry\n"
        "from sina_tpu_torch.tools import diag_accuracy, prof_famfinder, prof_profiledp, "
        "prof_wire_ab\n"
        "assert graft_entry.main(['--device', 'cpu']) == 0\n"
        "assert prof_famfinder.main(['--n-refs', '9000', '--batch', '2', '--kmer-l', '16',\n"
        "                            '--k', '5', '--topk', '8', '--device', 'cpu']) == 0\n"
        "assert prof_profiledp.main(['--c', '24', '--m', '32', '--batch', '2', '--reps', '1',\n"
        "                            '--device', 'cpu']) == 0\n"
        "assert prof_wire_ab.main(['--c', '24', '--m', '32', '--b', '16', '--reps', '1',\n"
        "                          '--device', 'cpu']) == 0\n"
        "assert diag_accuracy.main(['--engine', 'profile', '--n-seqs', '40', '--n-core', '200',\n"
        "                           '--width', '400', '--step', '20', '--device', 'cpu']) == 0\n"
        + NOTHING_BLOCKED_LOADED +
        "print('ok')\n"
    )
    res = _run(code, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("entry ok:") and lines[-1] == "ok"
    assert any(ln.startswith("n=2 avg_sps=") for ln in lines)


def test_cli_turn_and_search_without_jax(tmp_path):
    """The port's CLI, with jax and sina_tpu blocked, runs the turn
    check and search + LCA on a small generated fixture."""
    code = (
        "from sina_tpu_torch import cli, testing\n"
        "from sina_tpu_torch.io.fasta import FastaWriter, read_fasta\n"
        "db = testing.make_reference(n_seqs=60, n_core=300, width=500, seed=3)\n"
        "qs = [testing.unaligned_copy(q) for q in testing.make_queries(db, n=4, seed=5, branch_len=0.5)]\n"
        "qs[1].reverse().complement()\n"
        "with FastaWriter('ref.fasta', meta='comment') as w:\n"
        "    [w.write(s) for s in db.sequences]\n"
        "with FastaWriter('q.fasta') as w:\n"
        "    [w.write(q) for q in qs]\n"
        "rc = cli.main(['-i', 'q.fasta', '-r', 'ref.fasta', '-o', 'out.fasta', '--fs-min', '10',\n"
        "               '--fs-max', '10', '--fs-full-len', '300', '--fs-req-gaps', '1',\n"
        "               '--meta-fmt', 'comment', '--device', 'cpu', '-S', '--turn', 'all',\n"
        "               '--lca-fields', 'tax_slv', '-q'])\n"
        "assert rc == 0, rc\n"
        "recs = list(read_fasta('out.fasta'))\n"
        "assert [r.get_attr('turn_slv') for r in recs][:2] == ['none', 'reversed and complemented']\n"
        "assert all(r.get_attr('lca_tax_slv') for r in recs)\n"
        + NOTHING_BLOCKED_LOADED +
        "print('ok')\n"
    )
    res = _run(code, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_every_kernel_launch_goes_through_the_device_helper():
    """Every C entry point of the kernel library that launches a kernel
    is called by a wrapper through kernels.launch (which makes the
    operands' device current and counts the launch), every launch-plan
    query through kernels.plan, and nothing outside kernels.py reads a
    stream or counts a kernel's launch itself."""
    src = (REPO / "sina_tpu_torch" / "ops" / "kernels.py").read_text()
    entries = set(re.findall(r"so\.(sina_\w+)\.argtypes", src)) - {"sina_cuda_error_string"}
    launched, planned = set(), set()
    for path in (REPO / "sina_tpu_torch").rglob("*.py"):
        if path.name == "kernels.py":
            continue
        text = path.read_text()
        assert "cuda_stream" not in text and "stream_ptr" not in text, path
        calls = set(re.findall(r"\.(sina_\w+)\b", text)) & entries
        launched |= set(re.findall(
            r'kernels\.launch\(\s*(?:"\w+"|\w+|"\w+" if [^,]+ else "\w+"),\s*'
            r"kernels\.lib\(\)\.(sina_\w+),", text))
        planned |= set(re.findall(
            r"kernels\.plan\(\s*(?:kernels\.lib\(\)|lib)\.(sina_\w+_plan),", text))
        assert calls <= launched | planned, (path, calls - launched - planned)
        counted = set(re.findall(r'launches\["(\w+)"\]\s*\+=', text))
        assert counted <= {"graph_dense_route", "graph_dp_global_ring"}, (path, counted)
    assert launched == {e for e in entries if not e.endswith("_plan")}
    assert planned == {e for e in entries if e.endswith("_plan")}


@pytest.fixture(scope="module")
def small_fixture(tmp_path_factory):
    from sina_tpu_torch import testing
    from sina_tpu_torch.io.fasta import FastaWriter

    d = tmp_path_factory.mktemp("ported")
    db = testing.make_reference(n_seqs=80, n_core=300, width=500, seed=4)
    qs = [testing.unaligned_copy(q) for q in testing.make_queries(db, n=6, seed=8, branch_len=0.5)]
    qs[2].reverse()
    with FastaWriter(str(d / "ref.fasta"), meta="comment") as w:
        for s in db.sequences:
            w.write(s)
    with FastaWriter(str(d / "q.fasta")) as w:
        for q in qs:
            w.write(q)
    return d


@pytest.mark.parametrize(
    "argv",
    [
        pytest.param(["--turn"], id="argv3"),
        pytest.param(["--turn", "all"], id="argv4"),
        pytest.param(["-S"], id="argv5"),
        pytest.param(["--search"], id="argv6"),
    ],
)
def test_ported_options_run(argv, small_fixture, tmp_path):
    """Options that exited 2 before the turn check and search were
    ported now run on the CPU and set their attributes."""
    from sina_tpu_torch import cli
    from sina_tpu_torch.io.fasta import read_fasta

    d = small_fixture
    out = tmp_path / "out.fasta"
    rc = cli.main(["-i", str(d / "q.fasta"), "-r", str(d / "ref.fasta"), "-o", str(out),
                   "--fs-min", "10", "--fs-max", "10", "--fs-full-len", "300",
                   "--fs-req-gaps", "1", "--meta-fmt", "comment", "--device", "cpu",
                   "-q", *argv])
    assert rc == 0
    recs = list(read_fasta(str(out)))
    assert len(recs) == 6
    if argv[0] == "--turn":
        turns = [r.get_attr("turn_slv") for r in recs]
        assert turns[0] == "none"
        if "all" in argv:
            assert turns[2] == "reversed"
        assert "turn-check disabled" not in turns
    else:
        assert all(r.get_attr("nearest_slv") is not None for r in recs)
        assert any(r.get_attr("nearest_slv") for r in recs)


def _run_cli(d, wd, argv):
    """The port's CLI on the small fixture in working directory `wd`;
    returns its FASTA text with the `aligned_slv` stamps masked."""
    import contextlib
    import re

    from sina_tpu_torch import cli

    wd.mkdir(exist_ok=True)
    out = wd / "out.fasta"
    with contextlib.chdir(wd):
        rc = cli.main(["-i", str(d / "q.fasta"), "-r", str(d / "ref.fasta"), "-o", str(out),
                       "--fs-min", "10", "--fs-max", "10", "--fs-full-len", "300",
                       "--fs-req-gaps", "1", "--meta-fmt", "comment", "--device", "cpu",
                       "-q", *argv])
    assert rc == 0
    return re.sub(r"aligned_slv=[^\]\n]*", "aligned_slv=T", out.read_text())


@pytest.mark.parametrize(
    "argv",
    [
        pytest.param(["--fs-graph", "--debug-lattice", "0:10"], id="argv0"),
        pytest.param(["--fs-no-graph", "--insertion", "forbid"], id="argv1"),
        pytest.param(["--insertion", "forbid"], id="argv2"),
        pytest.param(["--debug-lattice", "0:10"], id="argv8"),
        pytest.param(["--jax-profile-dir", "prof"], id="argv9"),
    ],
)
def test_formerly_refused_options_run(argv, small_fixture, tmp_path):
    """The options that exited 2 until the profile engine's forbid mode,
    --debug-lattice and --jax-profile-dir were ported now run on the
    CPU: every query aligned with its own bases; with --debug-lattice
    one lattice_<name>.dot a query that reached the DP; with
    --jax-profile-dir a torch.profiler trace and the same FASTA as
    without it; forbid mode places no base in a column the reference
    alignment does not have (the width stays the reference's)."""
    from sina_tpu_torch.io.fasta import read_fasta

    d = small_fixture
    text = _run_cli(d, tmp_path / "run", argv)
    recs = list(read_fasta(str(tmp_path / "run" / "out.fasta")))
    assert len(recs) == 6
    queries = {q.name: q for q in read_fasta(str(d / "q.fasta"))}
    for r in recs:
        assert r.width == 500
        assert r.get_bases().upper() == queries[r.name].get_bases().upper()
    if "--debug-lattice" in argv:
        dots = sorted((tmp_path / "run").glob("lattice_*.dot"))
        assert dots and all(p.read_text().startswith("digraph {") for p in dots)
    if "--jax-profile-dir" in argv:
        traces = [p for p in (tmp_path / "run" / "prof").iterdir() if p.stat().st_size]
        assert traces and traces[0].name.endswith(".pt.trace.json")
        assert text == _run_cli(d, tmp_path / "plain", [])


def test_cuda_device_without_gpu_fails_loudly(tmp_path, capsys):
    import torch

    from sina_tpu_torch import cli
    from sina_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    rc = cli.main(["-i", str(tmp_path / "q.fasta"), "-r",
                   str(tmp_path / "ref.fasta"), "--device", "cuda"])
    assert rc == 1
    assert "CUDA device requested" in capsys.readouterr().err
