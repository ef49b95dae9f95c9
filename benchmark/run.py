#!/usr/bin/env python3
"""The benchmark of sina_tpu_torch, the PyTorch/CUDA port of sina-tpu.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the GPUs of this machine: makes the
configuration's reference and the cell's traffic from the seed, drives
sina_tpu_torch.pipeline.Pipeline.run for `--seconds`, checks what it
wrote against the plain reference in benchmark/reference/, and prints
one JSON line (the contract's keys) last on standard output.  With
--trace 0 the metrics are the cell's end-to-end metrics, with --trace 1
its per-layer metrics (benchmark/metrics/<name>.py, found by name).
Exits 1, printing no result, without a usable GPU, or when the port is
not beside the benchmark.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "sina_tpu")


def load_cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix and metric entries, each found by name."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "spec": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in spec["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in spec["per_layer"] if name in m.get("workloads", [name])],
    }


def fix_threads(cfg: dict) -> None:
    """Thread counts from the configuration, before torch loads."""
    th = cfg["threads"]
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(th["omp"])


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    import importlib.util

    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def host_lines() -> None:
    """The host and the card, for reading a run's spread: CPU model, the
    cores this process may use, the load average, the card's name and
    power limit."""
    import subprocess

    info = {}
    for ln in open("/proc/cpuinfo"):
        k, _, v = ln.partition(":")
        info.setdefault(k.strip(), v.strip())
    model = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("CPU implementer", "CPU part") if k in info) or "?"
    try:
        smt = open("/sys/devices/system/cpu/cpu0/topology/thread_siblings_list").read().strip()
    except OSError:
        smt = "?"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not available"
    print(f"# host: {model}; cores {sorted(os.sched_getaffinity(0))} usable, cpu0's "
          f"siblings {smt}; load "
          f"{os.getloadavg()}; card {smi}", file=sys.stderr, flush=True)


def memory_line() -> str:
    """The host's peak resident memory (this process, the largest child)
    beside the machine's."""
    import resource

    gib = 2**20  # ru_maxrss is in KiB
    own = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / gib
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / gib
    total = next((int(ln.split()[1]) / gib for ln in open("/proc/meminfo")
                  if ln.startswith("MemTotal:")), float("nan"))
    return (f"# host memory: peak resident {own:.2f} GiB (this process), {kids:.2f} GiB "
            f"(largest child), of {total:.2f} GiB")


def limits_lines(nums: dict, limits: dict) -> tuple[bool, list, dict]:
    ok, lines, shown = True, [], {}
    for k, lim in limits.items():
        v = nums[k]
        good = v <= lim
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r}{'' if good else '  FAILS'}")
        shown[k] = {"value": v, "limit": lim}
    return ok, lines, shown


def result(cell: dict, run: dict, nums: dict, trace: bool, kind: str, count: int):
    """The result line's object and the stderr lines of the numbers
    compared beside their limits."""
    correct, lines, shown = limits_lines(nums, cell["config"]["limits"])
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], run["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run["metrics_e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": run["attempted"],
           "failed": int(nums["records_lost"]), "metrics": metrics, "device": device}
    tr = run["ctx"]["trace"]
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["compared"] = shown
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    fix_threads(cell["config"])
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch

    need = int(cell["spec"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        import sina_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not beside the benchmark ({e})", file=sys.stderr)
        return 1
    from benchlib import runner

    host_lines()
    run = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 1
    nums = runner.check(cell, run, args.seed, "cuda")
    print(memory_line(), file=sys.stderr, flush=True)
    out, lines = result(cell, run, nums, bool(args.trace), torch.cuda.get_device_name(0), need)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
