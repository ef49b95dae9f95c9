"""Micro-profile the profile-DP path on the card (port of
tools/prof_profiledp.py).

Separates the per-call cost into (a) the fused forward DP
(ops/profile_kernel.profile_dp, csrc/profile_dp.cu: writes the (C, B, M)
backpointer plane), (b) the chain traceback (csrc/chain_traceback.cu,
at most C + 2M + 8 steps a walk), (c) the full launch as
ops/profile.profile_dp_dispatch runs it, on one wire buffer staged on
the device before the clock, with the result's fetch to the host (the
counterpart of the JAX package's _profile_pallas_fn).  Profiles and
queries are made on the device from a torch.Generator seeded 0, with
the reference's distributions; the kernel takes quantised profiles, so
they are packed by ops/profile._pack_fgq as the dispatch packs them.
Times are the device's, by CUDA events around each call, but for (c),
which is on the host clock up to the fetch.

    python -m sina_tpu_torch.tools.prof_profiledp [--c 2048 3072] [--m 1536] ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import transfer
from ..ops.align_kernel import DpParams
from ..ops.profile import (
    _build_wire, _bucket_rows, _pack_fgq, _wire_layout, profile_dp_wire,
)
from ..ops.profile_kernel import chain_traceback, profile_dp
from . import device_name, timeit


def inputs(B: int, C: int, M: int, params: DpParams, device: torch.device):
    """(fgq (B, C, 6) uint8, qmask (B, M) uint8, lens (B, 2) int32), on
    the host as numpy: the reference's softmax frequencies x 0.9,
    uniform gap costs x 0.5 and random base masks 1-15, made on
    `device` from a generator seeded 0, quantised by _pack_fgq; query
    lengths M - 7, profile lengths C - 5."""
    gen = torch.Generator(device=device).manual_seed(0)
    freqs = torch.softmax(torch.randn((B, C, 4), generator=gen, device=device), dim=-1) * 0.9
    gapcost = torch.rand((B, C), generator=gen, device=device) * 0.5
    qmask = torch.randint(1, 16, (B, M), dtype=torch.uint8, generator=gen, device=device)
    fgq = _pack_fgq(freqs.cpu().numpy(), gapcost.cpu().numpy(), params)
    lens = np.stack([np.full(B, M - 7), np.full(B, C - 5)], axis=1).astype(np.int32)
    return fgq, qmask.cpu().numpy(), lens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sina_tpu_torch.tools.prof_profiledp")
    ap.add_argument("--c", type=int, nargs="+", default=[2048])
    ap.add_argument("--m", type=int, default=1536)
    ap.add_argument("--batch", type=int, nargs="+", default=[128])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = DpParams(match=-2.0, mismatch=1.0, gap_open=5.0, gap_ext=2.0)
    print(f"device={device_name(dev)}")

    for C in args.c:
        for B in args.batch:
            M = args.m
            fgq, qmask, lens = inputs(B, C, M, params, dev)
            bp_gb = C * B * M / 1e9
            print(f"--- C={C} M={M} B={B} (bp plane {bp_gb:.2f} GB; profiles "
                  f"quantised by _pack_fgq, as profile_dp_dispatch ships them)")
            fg_d, qm_d, lens_d = (torch.from_numpy(a).to(dev) for a in (fgq, qmask, lens))

            t_fwd = timeit("fused fwd DP (bp out)", profile_dp, fg_d, qm_d, lens_d, params,
                           device=dev, reps=args.reps, first=True)
            print(f"  -> bp write {bp_gb / t_fwd:.0f} GB/s")

            bp, bc, bi, _ = profile_dp(fg_d, qm_d, lens_d, params)
            timeit(f"chain traceback (L={C + 2 * M + 8})", chain_traceback, bp, bc, bi,
                   device=dev, reps=args.reps, first=True)
            del bp

            # the full launch as profile_dp_dispatch runs it, its one
            # wire staged on the device before the clock
            B_pad = _bucket_rows(B)
            segs, nbytes = _wire_layout(B_pad, B_pad, C, M, dedup=False, aspace=False)
            wire = np.empty(nbytes, dtype=np.uint8)
            _build_wire(wire, segs, fgq, qmask, lens, None, None)
            wire_d = torch.from_numpy(wire).to(dev)

            def full():
                out = profile_dp_wire(wire_d, segs, C, M, params)
                return transfer.fetch_async(out).result()

            timeit("full dispatch launch + fetch (device inputs)", full, device=dev,
                   reps=args.reps, host=True, first=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
