"""The traced run's instruments: torch.profiler over the window (host
and device activity), spans around the pipeline's calls into its
layers, and the shapes of the scorer's and the DPs' launches, which the
roofline readers count work from.  All of it is installed on the one
pipeline object for the window and removed after; nothing of the
program is edited.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

# host spans: (attribute path on the pipeline, span name)
SPANS = (("_dispatch_batch", "align.dispatch"), ("_finalize_batch", "align.finalize"),
         ("finder.submit_batch", "famfinder.submit"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the marker kernel launched at each end of the window (torch.cuda._sleep)
MARKER = "spin_kernel"
MARKS = 3


class Tracer:
    """torch.profiler over the window with device activity only (its host
    op recording slowed the window about threefold), the host spans kept
    on the host clock, and a marker kernel at each end of the window
    that maps device time onto the host clock."""

    def __init__(self, pipe, cuda: bool):
        self.pipe = pipe
        self.cuda = cuda
        self.launches: dict[str, list] = defaultdict(list)
        self.spans: list = []
        self.marks: list = []
        self._undo = []
        self._summary = None

    def _spanned(self, fn, name):
        spans = self.spans

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans.append((t0, time.perf_counter(), name))
        return wrapped

    # -- launch recorders (module attributes the pipeline calls through)
    def _patch(self, module, attr, make):
        orig = getattr(module, attr)
        setattr(module, attr, make(orig))
        self._undo.append(lambda: setattr(module, attr, orig))

    def _install(self):
        from sina_tpu_torch import famfinder
        from sina_tpu_torch.ops import graph_kernel, profile

        for path, name in SPANS:
            obj = self.pipe
            *parents, attr = path.split(".")
            for p in parents:
                obj = getattr(obj, p)
            if obj is None:
                continue
            orig = getattr(obj, attr)
            setattr(obj, attr, self._spanned(orig, name))
            self._undo.append(lambda o=obj, a=attr: o.__dict__.pop(a, None))

        def scorer(orig):
            def rec(P, kmers, k):
                self.launches["kmer_score"].append((int(P.shape[0]), int(P.shape[1]),
                                                    kmers.detach().clone()))
                return orig(P, kmers, k)
            return rec

        def profile_wire(orig):
            def rec(wire_d, segs, C, M, params):
                o, n = segs["lens"]
                lens = wire_d.narrow(0, o, n).view(torch.int32).view(-1, 2).clone()
                U = segs["fgq"][1] // (6 * C)
                self.launches["profile_dp"].append((lens, U, C, M))
                return orig(wire_d, segs, C, M, params)
            return rec

        def graph(orig):
            def rec(pos, mask, weight, predbits, flags, qmask, qlen, col_weights, *a, **k):
                ops = [pos, mask, weight, predbits, flags, qmask, qlen, col_weights, *a]
                nbytes = sum(x.numel() * x.element_size() for x in ops
                             if isinstance(x, torch.Tensor))
                self.launches["graph_dp"].append((predbits.clone(), flags.clone(), qlen.clone(),
                                                  int(qmask.shape[1]), nbytes))
                return orig(pos, mask, weight, predbits, flags, qmask, qlen, col_weights, *a, **k)
            return rec

        self._patch(graph_kernel, "graph_dp", graph)
        self._patch(famfinder, "_score_topk_device", scorer)
        self._patch(profile, "profile_dp_wire", profile_wire)

    def _mark(self) -> None:
        """MARKS marker kernels, each alone on the device, with their
        host launch times; the profiler may miss the first kernels after
        it starts, so the window is taken from the last start marker to
        the first end marker."""
        for _ in range(MARKS):
            if self.cuda:
                torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            if self.cuda:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._install()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self.prof.__exit__(*exc)
        for undo in reversed(self._undo):
            undo()
        if exc[0] is None:
            self._summary = self._reduce()
        return False

    def _reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events, self.launches, self.spans, self.marks)

    def summary(self) -> dict | None:
        return self._summary


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: list, launches: dict, spans: list, marks: list) -> dict:
    """Busy and idle time of the device over the window, device time by
    kernel, the longest idle gaps by the host span they fell in, and the
    recorded launch shapes.  The window is the host clock's from the
    last start marker to the first end marker; device times map onto it
    through those two marker kernels.  Where the profiler kept too few
    markers, busy time is the union of every recorded device interval
    (the profiler ran around the window alone) and no gap is named."""
    h0, h1 = marks[MARKS - 1], marks[MARKS]
    mk = sorted(float(e["ts"]) for e in events
                if e.get("ph") == "X" and MARKER in str(e.get("name", "")))
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and MARKER not in str(e.get("name", ""))]
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = by_kernel[e["name"]]
        k[0] += float(e["dur"]) * 1e-6
        k[1] += 1
    ops = sorted(((n, v[0]) for n, v in by_kernel.items()), key=lambda x: -x[1])
    out = {"window_s": h1 - h0, "kernels": {n: tuple(v) for n, v in by_kernel.items()},
           "device_ops": [[n[:64], s] for n, s in ops[:10]], "launches": launches}
    raw = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    if len(mk) < MARKS + 1:
        print(f"# trace: {len(mk)} marker kernels recorded; busy time unmapped, gaps unnamed",
              file=sys.stderr, flush=True)
        busy = _union([(a, b) for a, b in raw if b > a])
        return dict(out, busy_s=sum(b - a for a, b in busy) * 1e-6, idle_gaps=[])
    # the end markers are the last MARKS; the start marker just before them
    g0, g1 = mk[-MARKS - 1], mk[-MARKS]
    scale = (h1 - h0) / max(g1 - g0, 1e-9)
    iv = [(max(h0, h0 + (a - g0) * scale), min(h1, h0 + (b - g0) * scale)) for a, b in raw]
    busy = _union([(a, b) for a, b in iv if b > a])
    gaps, t = [], h0
    for a, b in busy + [[h1, h1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        name = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "pipeline.other"
        named.append([name, b - a])
    return dict(out, busy_s=sum(b - a for a, b in busy), idle_gaps=named)
