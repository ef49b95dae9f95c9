"""The port imports without jax, and its CLI refuses what is not ported."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "sina_tpu_torch",
    "sina_tpu_torch.device",
    "sina_tpu_torch.famfinder",
    "sina_tpu_torch.align",
    "sina_tpu_torch.pipeline",
    "sina_tpu_torch.cli",
    "sina_tpu_torch.ops.kernels",
    "sina_tpu_torch.ops.kmer_kernel",
    "sina_tpu_torch.ops.kmer_index",
    "sina_tpu_torch.ops.align_kernel",
    "sina_tpu_torch.ops.profile",
    "sina_tpu_torch.ops.profile_kernel",
]

# installs a sys.meta_path hook that makes every jax/jaxlib import fail
BLOCK_JAX = """
import sys
class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
sys.meta_path.insert(0, _BlockJax())
"""


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + code],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )


def test_port_imports_without_jax():
    code = (
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') for k in sys.modules)\n"
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
    for path in (REPO / "sina_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (
                f"{path}: {line}"
            )


@pytest.mark.parametrize(
    "argv",
    [
        ["--fs-graph", "--debug-lattice", "0:10"],
        ["--fs-no-graph", "--insertion", "forbid"],
        ["--insertion", "forbid"],
        ["--turn"],
        ["--turn", "all"],
        ["-S"],
        ["--search"],
        ["--multihost"],
        ["--debug-lattice", "0:10"],
        ["--jax-profile-dir", "prof"],
    ],
)
def test_unported_options_exit_2(argv, capsys):
    from sina_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["-i", "q.fasta", "-r", "ref.fasta", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported to sina_tpu_torch" in err
    assert "JAX package sina_tpu" in err


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
