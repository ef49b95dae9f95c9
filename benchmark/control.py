#!/usr/bin/env python3
"""The control of the check: the plain reference put in the program's
place, its DP computed in the precision below the configuration's
(bfloat16 for float32), at the cell's own sizes.  Its output is written
as the program writes aligned FASTA, read back by the harness's reader
and judged by the harness's own comparison and limits, as a run's
output is; it has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Prints, for each seed, the numbers compared beside their limits on
standard error and one JSON line with the verdict on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]


def write_records(names: list[str], queries: list[np.ndarray], fams: list[list[int]],
                  cols: list[np.ndarray], raws: np.ndarray, width: int) -> bytes:
    """Aligned FASTA as the pipeline writes it with `--meta-fmt comment
    --write-used-rels`: the family, the DP's raw score in align_log_slv,
    and the row with each base at its column."""
    from reference.check import _CHAR

    out = []
    for name, q, fam, c, raw in zip(names, queries, fams, cols, raws):
        row = np.full(width, ord("-"), dtype=np.uint8)
        row[c] = _CHAR[q]
        out.append(f">{name}\n; used_rels={' '.join(f'SEQ{i:06d}' for i in fam)}\n".encode())
        if not np.isnan(raw):
            out.append(f"; align_log_slv=scoring: raw={raw:.6g}, weight=0\n".encode())
        out.append(row.tobytes() + b"\n")
    return b"".join(out)


def verdict(cell: dict, seed: int, device: str, n: int | None = None, dtype=None):
    """(correct, the stderr lines of the numbers beside their limits,
    the numbers) for the reference in `dtype` (bfloat16 by default) in
    the program's place, on the queries a run of `seed` would sample."""
    import torch

    import run as bench_run
    from benchlib import gen, runner, stream
    from reference import check as refcheck

    cfg, trf = cell["config"], cell["traffic"]
    dev = torch.device(device)
    ref = runner.make_reference(cfg, dev)
    n = n or int(trf["check_sample"])
    q = gen.make_queries(ref, n, runner.sub_seed(seed, "pool"), trf["branch_len"],
                         trf["parents"], trf.get("amplicon"), dev)
    m, o = q.masks.cpu().numpy(), q.offsets.cpu().numpy()
    refx = refcheck.Reference(ref, cfg["policy"])
    queries = [m[o[i]:o[i + 1]] for i in range(q.n)]
    names = [gen.record_name(i) for i in range(q.n)]
    fams, cols, raws = refcheck.align_sample(refx, queries, dtype or torch.bfloat16,
                                             cfg["engine"])
    records = stream.parse_records(write_records(names, queries, fams, cols, raws, ref.width))
    nums = refcheck.compare(names, records, m, o, refx, n, runner.sub_seed(seed, "sample"),
                            cfg["engine"])
    ok, lines, _ = bench_run.limits_lines(nums, cfg["limits"])
    return bool(ok), lines, nums


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import run as bench_run

    cell = bench_run.load_cell(args.workload)
    for s in args.seeds:
        t = time.time()
        ok, lines, nums = verdict(cell, s, args.device)
        for line in lines:
            print(line, file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": s, "correct": ok,
                          "compared": {k: float(v) for k, v in nums.items()
                                       if not k.startswith("_")},
                          "seconds": round(time.time() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
