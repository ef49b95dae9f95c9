"""A/B the one-wire profile-DP entry against the direct multi-array
entry on the card, at given shapes (port of tools/prof_wire_ab.py).

Separates the device's cost (inputs already on the device, CUDA events
around the call) from the host dispatch (host arrays uploaded through
ops/transfer's pinned staging, on the host clock up to
torch.cuda.synchronize()), so that a cost of splitting the wire on the
device shows up on its own; and times the host's _build_wire.  The
direct entry is ops/profile.profile_dp_result on three arrays, the wire
entry ops/profile.profile_dp_wire on one buffer laid out by
_wire_layout, as profile_dp_dispatch ships it.  Inputs come from
numpy's default_rng(3), as in the reference.

    python -m sina_tpu_torch.tools.prof_wire_ab [--c 2048] [--m 1536] [--b 128]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import transfer
from ..ops.align_kernel import DpParams
from ..ops.profile import (
    _build_wire, _pack_fgq, _wire_layout, profile_dp_result, profile_dp_wire,
)
from . import device_name, timeit

PARAMS = DpParams(match=-2.0, mismatch=1.0, gap_open=5.0, gap_ext=2.0)


def inputs(C: int, M: int, B: int, params: DpParams = PARAMS):
    """The reference's inputs from default_rng(3): (fg (B, C, 6) uint8
    quantised profiles, qmask (B, M) uint8, lens (B, 2) int32)."""
    rng = np.random.default_rng(3)
    freqs = rng.random((B, C, 4)).astype(np.float32)
    freqs /= freqs.sum(axis=2, keepdims=True) * 1.25
    gapcost = (rng.random((B, C)) * 2).astype(np.float32)
    qmask = (1 << rng.integers(0, 4, (B, M), dtype=np.uint8)).astype(np.uint8)
    qlen = np.full(B, M - 7, np.int32)
    cr = np.full(B, C - 5, np.int32)
    fg = _pack_fgq(freqs, gapcost, params)
    lens = np.stack([qlen, cr], axis=1).astype(np.int32)
    return fg, qmask, lens


def build_wire(fg, qmask, lens, device: torch.device):
    """(the host wire buffer for `device` (pinned on a CUDA device),
    its segments): one launch's inputs as profile_dp_dispatch lays them
    out, the batch not padded."""
    B, M = qmask.shape
    C = fg.shape[1]
    segs, nbytes = _wire_layout(B, B, C, M, dedup=False, aspace=False)
    wire = transfer.host_buffer(nbytes, device)
    _build_wire(wire.numpy(), segs, fg, qmask, lens, None, None)
    return wire, segs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sina_tpu_torch.tools.prof_wire_ab")
    ap.add_argument("--c", type=int, default=2048)
    ap.add_argument("--m", type=int, default=1536)
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    C, M, B = args.c, args.m, args.b
    print(f"device={device_name(dev)} C={C} M={M} B={B}")

    fg, qmask, lens = inputs(C, M, B)
    wire, segs = build_wire(fg, qmask, lens, dev)

    def direct(fg_d, qm_d, lens_d):
        return profile_dp_result(fg_d, qm_d, lens_d, PARAMS)

    def wired(wire_d):
        return profile_dp_wire(wire_d, segs, C, M, PARAMS)

    # device-side only (inputs pre-staged)
    fg_d, qm_d, lens_d = (torch.from_numpy(a).to(dev) for a in (fg, qmask, lens))
    wire_d = wire.to(dev)
    if not torch.equal(direct(fg_d, qm_d, lens_d), wired(wire_d)):
        raise AssertionError("the wire entry's result differs from the direct entry's")
    print("direct == wire: results equal")
    timeit("direct (device inputs)", direct, fg_d, qm_d, lens_d, device=dev,
           reps=args.reps, first=True)
    timeit("wire   (device inputs)", wired, wire_d, device=dev, reps=args.reps, first=True)

    # host dispatch incl. transfer
    timeit("direct (host arrays)",
           lambda: direct(*(transfer.upload(a, dev) for a in (fg, qmask, lens))),
           device=dev, reps=args.reps, host=True, first=True)
    timeit("wire   (host arrays)", lambda: wired(transfer.upload(wire, dev)),
           device=dev, reps=args.reps, host=True, first=True)
    # and the host wire-build cost itself
    t0 = time.perf_counter()
    for _ in range(5):
        _build_wire(wire.numpy(), segs, fg, qmask, lens, None, None)
    print(f"host _build_wire: {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
