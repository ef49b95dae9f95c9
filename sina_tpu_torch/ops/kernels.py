"""Build, load and bind the hand-written CUDA kernels of csrc/.

The kernels compile with nvcc into one shared library with a
plain C interface (no PyTorch headers: a build takes seconds, not
minutes) at first use, into the git-ignored ``sina_tpu_torch/_build``
directory: one nvcc process for each source, all started together
(the build log gives each one's seconds), then one link.  The file name carries a hash of the sources and flags,
so an edited source rebuilds.  The library is loaded with ctypes.

Every wrapper launches its kernel through ``launch``, which makes the
operands' device current for the call (a ``<<<...>>>`` launch, and the
per-device shared-memory opt-ins of csrc/, act on the host thread's
current device, not on the stream's), passes that device's current
stream, raises on a CUDA error and adds one to the kernel's entry of
``launches``: nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("kmer_score.cu", "kmer_dense.cu", "profile_dp.cu",
           "chain_traceback.cu", "graph_dp.cu", "graph_traceback.cu",
           "graph_dense.cu")
# included by the sources (the DPs' block scan, the tracebacks' window, the
# dense graph DP's bounded insertion window)
HEADERS = ("dp_scan.cuh", "traceback_window.cuh", "forbid_window.cuh")
# --fmad=false: the DPs must keep the reference's f32 rounding (no
# mul+add contraction to FMA other than the ones written out) to stay
# bit-equal to their plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {"kmer_score": 0, "kmer_score_dense": 0,
            "profile_dp": 0, "profile_dp_forbid": 0, "chain_traceback": 0,
            "graph_dp": 0, "graph_traceback": 0,
            "graph_dp_dense": 0, "graph_traceback_dense": 0,
            # not kernels: graph buckets that took the dense route (a
            # predecessor 32 or more nodes back, which one family member
            # with an indel of about 32 columns makes; ops/align_kernel
            # graph_dp_dense), and graph_dp launches whose ring did not
            # fit shared memory and took the global-ring route
            # (csrc/graph_dp.cu), counted where chosen
            "graph_dense_route": 0, "graph_dp_global_ring": 0}

_lib = None
build_seconds: float | None = None
build_log = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "sina_tpu_torch/csrc cannot be built"
    )


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsina_kernels-{h.hexdigest()[:16]}.so"


def _timed(cmd: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    return res, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels unless a library of the current sources
    exists; returns its path.  Raises on a failed build."""
    global build_seconds, build_log
    so = _lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}"  # concurrent builds
    objs = [f"{tmp}.{Path(n).stem}.o" for n in SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        runs = list(pool.map(_timed, [
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / n)]
            for n, o in zip(SOURCES, objs)]))
    names = list(SOURCES)
    if all(r.returncode == 0 for r, _ in runs):
        runs.append(_timed([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so", *objs]))
        names.append("link")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(f"== {n} (rc {r.returncode}, {s:.2f}s)\n{r.stdout}{r.stderr}"
                        for n, (r, s) in zip(names, runs))
    (BUILD_DIR / "nvcc.log").write_text(build_log)
    for o in objs:
        Path(o).unlink(missing_ok=True)
    failed = [n for n, (r, _) in zip(names, runs) if r.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(f"{tmp}.so", so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        F = ctypes.c_float
        so.sina_kmer_score.argtypes = [P, P, P, P, P, LL, LL, I, I, P]
        so.sina_kmer_score.restype = I
        so.sina_kmer_score_plan.argtypes = [LL, P, P]
        so.sina_kmer_score_plan.restype = I
        so.sina_kmer_score_dense.argtypes = [P, P, P, LL, LL, I, I, P]
        so.sina_kmer_score_dense.restype = I
        so.sina_profile_dp.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, F, F, F, F, F, F, P,
        ]
        so.sina_profile_dp.restype = I
        so.sina_profile_dp_plan.argtypes = [I, I, P]
        so.sina_profile_dp_plan.restype = I
        so.sina_chain_traceback.argtypes = [P, P, P, P, I, I, I, P]
        so.sina_chain_traceback.restype = I
        so.sina_chain_traceback_plan.argtypes = [P, I, P]
        so.sina_chain_traceback_plan.restype = I
        so.sina_graph_dp.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P]
        so.sina_graph_dp.restype = I
        so.sina_graph_dp_plan.argtypes = [I, I, I, P]
        so.sina_graph_dp_plan.restype = I
        so.sina_graph_traceback.argtypes = [P, P, P, P, P, P, I, I, I, P]
        so.sina_graph_traceback.restype = I
        so.sina_graph_traceback_plan.argtypes = [P, I, P]
        so.sina_graph_traceback_plan.restype = I
        so.sina_graph_dp_dense.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P]
        so.sina_graph_dp_dense.restype = I
        so.sina_graph_dp_dense_plan.argtypes = [I, I, I, P]
        so.sina_graph_dp_dense_plan.restype = I
        so.sina_graph_traceback_dense.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
        so.sina_graph_traceback_dense.restype = I
        so.sina_graph_traceback_dense_plan.argtypes = [P, I, P]
        so.sina_graph_traceback_dense_plan.restype = I
        so.sina_cuda_error_string.argtypes = [I]
        so.sina_cuda_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().sina_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {err} ({msg})")


def plan(fn, *args: int, n: int, device: torch.device | None = None) -> list[int]:
    """Call a C launch-plan function fn(*args, long long out[n]) with
    `device` current (by default the current device) and return out;
    raises on a CUDA error or an unsupported shape."""
    out = (ctypes.c_longlong * n)()
    with torch.cuda.device(device):
        check(fn(*args, out), fn.__name__)
    return list(out)


def device_index(device: torch.device | None) -> int:
    """The index of `device` (a CUDA device; by default the current
    one): the key under which a wrapper caches a launch plan that it
    needs at every launch (none of the plan functions of csrc/
    synchronises; they read function and device attributes)."""
    if device is None or device.index is None:
        return torch.cuda.current_device()
    return device.index


def launch(name: str, fn, *args, device: torch.device) -> None:
    """Launch a kernel through its C entry point fn(*args, stream) on
    `device`, the device of its operands: with that device current and
    its current stream; raises on a CUDA error, then counts the launch
    as `name` in ``launches``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
    launches[name] += 1


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device, ndim: int) -> None:
    """Validate a kernel operand: device, dtype, rank, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
