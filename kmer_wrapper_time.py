"""Host time a call of the bitpacked k-mer scorer's wrapper
(`sina_tpu_torch.ops.kmer_kernel.kmer_scores`) on the card, at the main
path's shape: B = 128 queries of L = 512 ids (360 real), rows of
Sb = 12,544 bytes (100,352 padded references).

    python3 kmer_wrapper_time.py [--root DIR] [--calls N] [--repeats R]

It times the `sina_tpu_torch` package under DIR (default: this
checkout), so that two checkouts of the port can be compared in one run
on one card: run it for each, in turns.  Each repeat issues N calls back
to back without waiting for the card and takes each call's return on
the host clock; N is small enough that the card's queue never fills, so
no call waits for the device.  Prints the median and the mean host
microseconds a call over all repeats, the device ms a call by CUDA
events beside them, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, L, REAL, SB, ROWS = 128, 512, 360, 12_544, 4 ** 9 + 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="checkout whose sina_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=100, help="calls a repeat")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    from sina_tpu_torch.ops import kmer_kernel as kk

    if not torch.cuda.is_available():
        print("kmer_wrapper_time: no CUDA device", file=sys.stderr)
        return 1
    if Path(kk.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {kk.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    P = torch.randint(0, 256, (ROWS, SB), dtype=torch.uint8, device=dev, generator=gen)
    P[-1] = 0
    km = np.full((B, L), ROWS - 1, np.int32)
    km[:, :REAL] = np.random.default_rng(1234).integers(0, ROWS - 1, (B, REAL))
    kmers = torch.from_numpy(km).to(dev)

    for _ in range(3):  # builds the kernels, warms the allocator
        kk.kmer_scores(P, kmers)
    torch.cuda.synchronize()
    host_us = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    device_ms = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.calls):
            t0 = time.perf_counter_ns()
            kk.kmer_scores(P, kmers)
            host_us.append((time.perf_counter_ns() - t0) / 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end) / args.calls)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"kmer_wrapper_time {root.name}: B={B} L={L} ({REAL} real) Sb={SB}; host "
          f"{statistics.median(host_us):.1f} us a call median, "
          f"{statistics.fmean(host_us):.1f} mean ({len(host_us)} calls); device "
          f"{statistics.median(device_ms):.3f} ms a call median by CUDA events; {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
