"""Per-query accuracy diagnosis (port of tools/diag_accuracy.py):
realign reference sequences through the port's famfinder and aligner
(align_dispatch / align_finalize with realign=True) and bucket sps/cpm
losses by query; the same summary line, worst eight rows and
differing-columns dump as the reference.  Runs on the card unless
given --device cpu (the reference pins jax to the CPU).

    python -m sina_tpu_torch.tools.diag_accuracy [--engine graph|profile] [--lqo]
        [--n-seqs 300] [--step 25] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import testing
from ..align import AlignerConfig, align_dispatch, align_finalize
from ..comparator import COVER_QUERY, IUPAC_EXACT, IUPAC_OPTIMISTIC, Comparator
from ..device import resolve_device
from ..famfinder import FamFinder, FamFinderConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sina_tpu_torch.tools.diag_accuracy")
    ap.add_argument("--engine", default="graph")
    ap.add_argument("--lqo", action="store_true")
    ap.add_argument("--n-seqs", type=int, default=300)
    ap.add_argument("--n-core", type=int, default=600)
    ap.add_argument("--width", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--step", type=int, default=25)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--dump-worst", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.large:
        db = testing.make_reference_large(
            args.n_seqs, n_core=args.n_core, width=args.width, seed=args.seed)
    else:
        db = testing.make_reference(
            n_seqs=args.n_seqs, n_core=args.n_core, width=args.width, seed=args.seed)
    finder = FamFinder(
        db,
        FamFinderConfig(fs_full_len=400, fs_req_gaps=1, fs_leave_query_out=args.lqo),
        device=dev,
    )
    originals = db.sequences[:: args.step]
    queries = [testing.unaligned_copy(s) for s in originals]
    results = finder.process_batch(queries)
    acfg = AlignerConfig(engine=args.engine, realign=True)
    aligned = align_finalize(align_dispatch(
        queries, [r.family if not r.failed else [] for r in results], acfg, device=dev))
    # exact semantics of Log::printer::show_dist (log.cpp:279-325)
    sps_cmp = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    idty_cmp = Comparator(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False)

    rows = []
    for q0, fam_res, a in zip(originals, results, aligned):
        if a is None:
            rows.append((q0.name, 0.0, 0.0, 0.0, None, fam_res))
            continue
        sps = sps_cmp(q0, a)
        # cpm = idty(orig, closest) - idty(aligned, closest), closest
        # chosen by orig idty over the family (may be the query itself
        # without --fs-leave-query-out, as in the reference)
        closest, best_orig = None, -1.0
        for _, r in fam_res.family:
            v = idty_cmp(q0, r)
            if v > best_orig:
                best_orig, closest = v, r
        cpm = best_orig - idty_cmp(a, closest) if closest is not None else 0.0
        rows.append((q0.name, sps, cpm, best_orig, a, fam_res))

    rows.sort(key=lambda r: r[1])
    spss = [r[1] for r in rows]
    cpms = [r[2] for r in rows]
    print(f"n={len(rows)} avg_sps={np.mean(spss):.5f} "
          f"avg_cpm={np.mean(cpms):.6f} "
          f"min_sps={min(spss):.4f}")
    for name, sps, cpm, bo, a, fr in rows[:8]:
        fam_names = [s.name for _, s in fr.family][:5]
        in_fam = name in [s.name for _, s in fr.family]
        print(f"  {name} sps={sps:.4f} cpm={cpm:.5f} best_orig={bo:.3f}"
              f" fam_n={len(fr.family)} self_in_family={in_fam}"
              f" top={fam_names}")
    # dump the worst alignments vs truth
    for name, sps, cpm, bo, a, fr in rows[: args.dump_worst]:
        if a is None:
            continue
        q0 = next(s for s in originals if s.name == name)
        pos_a = {int(p): int(m) & 0xF for p, m in zip(a.positions, a.masks)}
        pos_t = {int(p): int(m) & 0xF for p, m in zip(q0.positions, q0.masks)}
        diff_cols = sorted(
            set(pos_a) ^ set(pos_t)
            | {c for c in set(pos_a) & set(pos_t) if pos_a[c] != pos_t[c]}
        )
        print(f"-- {name}: {len(diff_cols)} differing cols: {diff_cols[:40]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
