"""Micro-profilers and diagnostics of the port, one module for each of
the JAX package's tools/ scripts, with its options, defaults and
printed labels, and --device (cuda by default; cpu runs the kernels'
plain versions):

    python -m sina_tpu_torch.tools.prof_famfinder [--n-refs 100000] ...
    python -m sina_tpu_torch.tools.prof_profiledp [--c 2048] ...
    python -m sina_tpu_torch.tools.prof_wire_ab [--c 2048] ...
    python -m sina_tpu_torch.tools.diag_accuracy [--engine graph] ...

Each module's main(argv=None) returns the exit code.  This module holds
their shared timer.
"""

from __future__ import annotations

import time

import torch


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _one(fn, args, device: torch.device, host: bool) -> float:
    """Seconds of one call fn(*args).  On a CUDA device by CUDA events
    around the call (the device's time from before its first launch to
    after its last), or with `host` by the host clock up to
    torch.cuda.synchronize(), for calls whose host work (staging, an
    upload, a fetch) belongs to the time; on the CPU by the host
    clock."""
    if device.type == "cuda" and not host:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def timeit(label: str, fn, *args, device: torch.device, reps: int = 5,
           host: bool = False, first: bool = False) -> float:
    """Print the median, least and largest of `reps` calls of fn(*args)
    after one untimed call (with `first`, that call's time too), as the
    JAX tools print them; returns the median in seconds."""
    warm = _one(fn, args, device, host)
    ts = sorted(_one(fn, args, device, host) for _ in range(reps))
    med = ts[len(ts) // 2]
    tail = f", first {warm * 1e3:.3f}" if first else ""
    print(f"{label}: median {med * 1e3:.3f} ms "
          f"(min {ts[0] * 1e3:.3f}, max {ts[-1] * 1e3:.3f}{tail})")
    return med
