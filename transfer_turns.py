#!/usr/bin/env python3
"""The port's host<->device copies and fetch waits on the card, for two
checkouts of the port in turns.

    python3 -u transfer_turns.py --parent DIR [--order pccp] [--paths 5,7,18]

Runs one subprocess a turn (by default the checkout under DIR, this
checkout, this checkout, DIR), each importing the `sina_tpu_torch`
package of its checkout, building its kernels and driving the paths of
chip_smoke.py at their sizes through famfinder and the aligner, in the
3-deep batch queue of `sina_tpu_torch.pipeline`:

- 5: the profile path, 100,000 references at width 50,000, 640
  full-length queries (seed 7) in batches of 128;
- 7: the graph path on the same reference, 384 queries (seed 11);
- 18: the long-insertion graph path, 20,000 references at width 50,000
  with a 48-base insertion in one in 20, 384 queries (seed 41), every
  bucket on the dense route.

The first batch of a path warms up.  For each path and turn it prints
the steady seq/s; the host ms a steady batch of the fetch sections
(`Kmer Search` `fetch topk`, `Aligner` `profile dp fetch`, `GraphDP`
`fetch`) and of the profile upload (`ProfileDP` `h2d`); and, from
torch.profiler over a second pass of the steady batches, the device ms
and count of each kind of copy and the device's busy ms (the union of
its activity intervals over all streams) beside the wall ms.  The last
line is the card's name and power limit.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B = 128
PATHS = {
    "5": dict(db="profile", n=640, seed=7, engine="profile"),
    "7": dict(db="profile", n=384, seed=11, engine="graph"),
    "18": dict(db="indel", n=384, seed=41, engine="graph"),
}
FETCHES = (("Kmer Search", "fetch topk"), ("Aligner", "profile dp fetch"),
           ("GraphDP", "fetch"), ("ProfileDP", "h2d"))


def run_batches(finder, batches, acfg, device):
    """The pipeline's 3-deep queue: famfinder N+1 submitted, N fetched
    and dispatched, N-1 finalized."""
    from collections import deque

    from sina_tpu_torch.align import align_dispatch, align_finalize

    out, pending = [], deque()
    handles = [finder.submit_batch(batches[0])]
    for i, batch in enumerate(batches):
        if i + 1 < len(batches):
            handles.append(finder.submit_batch(batches[i + 1]))
        results = finder.process_batch(batch, handle=handles[i])
        handles[i] = None
        pending.append(align_dispatch(
            batch, [r.family if not r.failed else [] for r in results], acfg,
            device=device))
        if len(pending) >= 2:
            out.extend(align_finalize(pending.popleft()))
    while pending:
        out.extend(align_finalize(pending.popleft()))
    return out


def profiled(fn):
    """(busy ms, wall ms, {name: (device ms, count)}) of fn() under
    torch.profiler's device activity; busy is the union of the device
    intervals over all streams."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.self_device_time_total > 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3, wall, per


def worker(root: Path, paths: list[str]) -> int:
    sys.path.insert(0, str(root))
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.timing import get_timer, reset_all

    if Path(kernels.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {kernels.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    dbs = {}
    for key in paths:
        p = PATHS[key]
        t0 = time.perf_counter()
        if p["db"] not in dbs:
            if p["db"] == "profile":
                db = testing.make_reference_large(100_000, n_core=1450, width=50_000, seed=1234)
            else:
                db = testing.with_long_insertion(testing.make_reference_large(
                    20_000, n_core=1450, width=50_000, seed=4321), 48, 20, seed=4321)
            finder = FamFinder(db, FamFinderConfig(fs_min=40, fs_max=40, fs_full_len=1350,
                                                   fs_req_gaps=1), dev)
            finder._matrix()
            dbs[p["db"]] = (db, finder)
        db, finder = dbs[p["db"]]
        queries = [testing.unaligned_copy(q) for q in
                   testing.make_queries(db, n=p["n"], seed=p["seed"], branch_len=0.7)]
        batches = [queries[i:i + B] for i in range(0, p["n"], B)]
        acfg = AlignerConfig(engine=p["engine"])
        setup_s = time.perf_counter() - t0
        run_batches(finder, batches[:1], acfg, dev)
        torch.cuda.synchronize()
        reset_all()
        t0 = time.perf_counter()
        aligned = run_batches(finder, [[q.copy() for q in b] for b in batches[1:]], acfg, dev)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        n = len(batches) - 1
        fetch = {f"{t} {s}": 1e3 * get_timer(t).sections[s] / n for t, s in FETCHES
                 if get_timer(t).counts.get(s)}
        busy, wall, per = profiled(lambda: run_batches(
            finder, [[q.copy() for q in b] for b in batches[1:]], acfg, dev))
        copies = {k: v for k, v in per.items() if k.startswith("Memcpy")}
        print(json.dumps({
            "root": str(root), "path": key, "build_s": round(build_s, 3),
            "setup_s": round(setup_s, 3), "aligned": sum(a is not None for a in aligned),
            "steady_seqs": n * B, "seq_per_s": (n * B) / steady,
            "fetch_host_ms_a_batch": fetch, "copies_device_ms_count": copies,
            "copies_device_ms": sum(ms for ms, _ in copies.values()),
            "busy_ms": busy, "wall_ms": wall,
            "dense_route_buckets": kernels.launches.get("graph_dense_route", 0),
        }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout of the port")
    ap.add_argument("--order", default="pccp", help="turns: p (parent), c (this checkout)")
    ap.add_argument("--paths", default="5,7,18", help="chip_smoke.py phases to drive")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if args.worker:
        return worker(Path(args.worker).resolve(), paths)
    import torch

    if not torch.cuda.is_available():
        print("transfer_turns: no CUDA device", file=sys.stderr)
        return 1
    roots = {"p": Path(args.parent).resolve(), "c": Path(__file__).resolve().parent}
    for turn in args.order:
        res = subprocess.run([sys.executable, "-u", __file__, "--parent", args.parent,
                              "--paths", args.paths, "--worker", str(roots[turn])])
        if res.returncode:
            return res.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
