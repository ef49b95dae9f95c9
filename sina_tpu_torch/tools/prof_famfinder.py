"""Micro-profile the famfinder scoring path on the card (port of
tools/prof_famfinder.py).

Separates the per-batch famfinder cost into (a) the bitpacked k-mer
scorer (csrc/kmer_score.cu) over the flat and the tiled layout, (b) the
top-k: one torch.topk over the (B, S) scores (the library call that
computes the same values), the lowest-id key form famfinder ranks with
(ops/kmer_kernel.top_k_lowest_id) and an argmax, (c) the fused
score_topk that famfinder runs.  The index matrix is random bytes made
on the device from a torch.Generator seeded 0, the k-mer ids come from
numpy's default_rng(1), as in the reference.  Times are the device's,
by CUDA events around each call.

    python -m sina_tpu_torch.tools.prof_famfinder [--n-refs 100000] [--batch 128] ...

At --n-refs 450000 the flat index takes 14.76 GB and the tiled copy
15.03 GB more, freed before the top-k lines.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kmer_kernel as kk
from . import device_name, timeit


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m sina_tpu_torch.tools.prof_famfinder")
    ap.add_argument("--n-refs", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=128)
    # fast mode keeps ~1/4 of a 1450nt query's k-mers -> ~360,
    # bucketed to 512 (the production shape at full length)
    ap.add_argument("--kmer-l", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--topk", type=int, default=256)
    ap.add_argument("--g", type=int, default=0,
                    help="the reference's sweep of its Pallas tile constant "
                         "_KMER_G; refused here")
    ap.add_argument("--skip-score", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.g:
        ap.error("--g sweeps the Pallas kernel's tile constant _KMER_G; "
                 "csrc/kmer_score.cu has no such parameter (its launch plan "
                 "is ops/kmer_kernel.kmer_score_plan)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B, L, k = args.batch, args.kmer_l, args.topk

    n_rows = 4 ** (args.k - 1) + 1
    s_pad = -(-args.n_refs // 1024) * 1024
    Sb = s_pad // 8
    print(f"device={device_name(dev)} n_refs={args.n_refs} "
          f"rows={n_rows} Sb={Sb} ({n_rows * Sb / 1e9:.2f} GB)")
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    P = torch.randint(0, 256, (n_rows, Sb), dtype=torch.uint8, device=dev, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"matrix on device in {time.time() - t0:.1f}s")
    kmers = torch.from_numpy(np.random.default_rng(1).integers(
        0, n_rows - 1, (B, L), dtype=np.int32)).to(dev)

    if not args.skip_score:
        sc = timeit("packed score", kk.kmer_scores, P, kmers, device=dev)
        print(f"  -> effective {B * L * Sb / sc / 1e9:.1f} GB/s "
              f"(rows gathered: {B * L})")
        # exact-size tiled layout (KmerIndex.dense_packed_tiled's shape),
        # scored as its flat view, as famfinder scores it
        Sb4 = -(-Sb // 4096) * 4096
        P3 = torch.zeros((n_rows, Sb4), dtype=torch.uint8, device=dev)
        P3[:, :Sb] = P
        P3 = P3.view(n_rows, 32, Sb4 // 32)
        sct = timeit("TILED score", kk.kmer_scores, P3, kmers, device=dev)
        print(f"  -> effective {B * L * Sb4 / sct / 1e9:.1f} GB/s "
              f"(tiled rows: {B * L})")

        def fused_tiled():
            s, gmax = kk.kmer_scores(P3, kmers, gmax=True)
            return torch.cat(kk.grouped_top_k(s, k, gmax), dim=1)

        timeit("fused TILED score+grouped_topk", fused_tiled, device=dev)
        del P3  # both layouts at SILVA scale exceed the headroom beside a resident index

    scores = kk.kmer_scores(P, kmers)
    shape = tuple(scores.shape)
    timeit(f"torch.topk k={k} over {shape}", torch.topk, scores, k, 1, device=dev)
    timeit(f"top_k_lowest_id k={k} over {shape}", kk.top_k_lowest_id, scores, k, device=dev)
    lib_vals, lib_ids = torch.topk(scores, k, dim=1)
    vals, ids = kk.top_k_lowest_id(scores, k)
    if not torch.equal(lib_vals, vals):
        raise AssertionError("torch.topk's values differ from top_k_lowest_id's")
    same = int((lib_ids == ids).sum())
    print(f"  -> torch.topk values equal top_k_lowest_id's; ids equal at {same} of "
          f"{ids.numel()} places (torch.topk promises no order among equal scores)")
    del lib_vals, lib_ids, vals, ids

    # argmax only (what the coarse stage of a two-level scorer needs)
    timeit("argmax", torch.argmax, scores, 1, device=dev)

    # fused, as famfinder's submit runs it
    timeit("fused score+topk", kk.score_topk, P, kmers, k, device=dev)
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
