"""One run of one cell: set-up, warm-up, the timed window through
``sina_tpu_torch.pipeline.Pipeline.run``, and the check.

The window streams distinct queries from a pool made in set-up as FASTA
into a FIFO (the piped-input path users take with ``-i -``), and the
pipeline writes aligned FASTA into a second FIFO, which a reader process
takes record by record.  The window runs from the call of ``run()`` to
its return: the feeder stops at the deadline, the pipeline drains what
it holds, and every record written in that time counts.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import gen, stream
from .gen import sub_seed
from .gcwatch import gc_pauses

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the reference bundle ----------------------------------------------

def ref_key(cfg: dict) -> str:
    return (f"ref-n{cfg['n_refs']}-w{cfg['width']}-c{cfg['n_core']}-g{cfg['genus_size']}"
            f"-s{cfg['reference_seed']}")


def ref_digest(ref: gen.RefArrays) -> str:
    """A fingerprint of the generated arrays (every reference's length
    and every 4096th entry), so that a bundle made on another kind of
    device, whose draws differ, is made anew."""
    h = hashlib.sha256()
    for a in (ref.offsets, ref.positions[::4096], ref.masks[::4096]):
        h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ref_lines(ref: gen.RefArrays, policy: dict) -> str:
    """The reference's lengths and internal gaps beside the famfinder
    settings that read them (fs_full_len, fs_req_gaps)."""
    lens = ref.lengths()
    first = ref.positions[ref.offsets[:-1]].long()
    last = ref.positions[ref.offsets[1:] - 1].long()
    gaps = last - first + 1 - lens
    full, req = int(policy["fs_full_len"]), int(policy["fs_req_gaps"])
    return (f"# reference: {ref.n} references of {int(lens.min())}-{int(lens.max())} bases, "
            f"{int((lens < full).sum())} below fs_full_len {full}; internal gaps "
            f"{int(gaps.min())}-{int(gaps.max())}, {int((gaps < req).sum())} below "
            f"fs_req_gaps {req}")


def ensure_bundle(ref: gen.RefArrays, cfg: dict) -> Path:
    """The reference as the port's .sref bundle under benchmark/_data,
    written once per checkout with ReferenceDb.save; returns its path."""
    from sina_tpu_torch.refdb import ReferenceDb

    data = BENCH / "_data"
    path = data / f"{ref_key(cfg)}.sref"
    stamp = path / "benchmark-digest.txt"
    digest = ref_digest(ref)
    if stamp.exists() and stamp.read_text().strip() == digest:
        return path
    t0 = time.time()
    tmp = data / f"{ref_key(cfg)}.partial.sref"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(path, ignore_errors=True)
    tmp.mkdir(parents=True)
    names, attrs = gen.ref_attrs(ref.n, ref.group)
    offsets = ref.offsets.cpu().numpy()
    lens = np.diff(offsets)
    for a, n in zip(attrs, lens.tolist()):
        a["stop"] = str(n)
    db = ReferenceDb.from_arrays(names, offsets, ref.positions.cpu().numpy().astype(np.uint32),
                                 ref.masks.cpu().numpy(), ref.width, attrs)
    db.save(tmp)
    (tmp / "benchmark-digest.txt").write_text(digest + "\n")
    os.rename(tmp, path)
    say(f"# bundle: wrote {path.name} ({ref.n} references) in {time.time() - t0:.1f} s")
    return path


# -- the child processes -----------------------------------------------

class Streams:
    """The feeder and the reader, and the run's two FIFOs."""

    def __init__(self, pool: bytes, offsets: np.ndarray):
        self.dir = Path(tempfile.mkdtemp(prefix="sina-bench-"))
        self.fin = self.dir / "in.fasta"
        self.fout = self.dir / "out.fasta"
        os.mkfifo(self.fin)
        os.mkfifo(self.fout)
        script = str(HERE / "stream.py")
        self.feeder = subprocess.Popen([sys.executable, script, "feed", str(self.fin)],
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.reader = subprocess.Popen([sys.executable, script, "read", str(self.fout)],
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        head = np.array([len(pool), len(offsets) - 1], dtype=np.int64).tobytes()
        self.feeder.stdin.write(head + offsets.astype(np.int64).tobytes() + pool)
        self.feeder.stdin.flush()

    def start(self, feed_cmd: str, keep: bool) -> None:
        self.reader.stdin.write(b"keep\n" if keep else b"count\n")
        self.reader.stdin.flush()
        self.feeder.stdin.write(feed_cmd.encode() + b"\n")
        self.feeder.stdin.flush()

    def results(self) -> tuple[dict, dict]:
        return stream.recv(self.feeder.stdout), stream.recv(self.reader.stdout)

    def close(self) -> None:
        for p in (self.feeder, self.reader):
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in (self.feeder, self.reader):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


# -- the run -----------------------------------------------------------

def host_cpu() -> dict:
    """The host's clocks of this process, in seconds: CPU time (user +
    system) of all its threads, of the main thread alone, and the steal
    time of the machine's cores (NaN where /proc/stat does not give it)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"process": ru.ru_utime + ru.ru_stime, "main": time.thread_time(),
           "steal": float("nan")}
    try:
        cpu = open("/proc/stat").readline().split()
        out["steal"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def timer_snapshot() -> dict:
    from sina_tpu_torch.timing import _registry

    return {name: {k: (v, t.counts[k]) for k, v in t.sections.items()}
            for name, t in _registry.items()}


def timer_delta(before: dict, after: dict) -> dict:
    """{timer: {section: (seconds, count)}} of what happened between two
    snapshots."""
    out = {}
    for name, secs in after.items():
        b = before.get(name, {})
        d = {k: (v - b.get(k, (0.0, 0))[0], c - b.get(k, (0.0, 0))[1])
             for k, (v, c) in secs.items()}
        d = {k: v for k, v in d.items() if v[1] > 0}
        if d:
            out[name] = d
    return out


def make_reference(cfg: dict, dev) -> gen.RefArrays:
    """The configuration's reference alignment, made on `dev`."""
    return gen.make_reference(cfg["n_refs"], cfg["n_core"], cfg["width"], cfg["genus_size"],
                              cfg["reference_seed"], dev)


def pipeline_argv(cell: dict, fin: Path, fout: Path, bundle: Path, device: str) -> list[str]:
    return (list(cell["config"]["cli"]) + list(cell["traffic"]["cli"])
            + ["-i", str(fin), "-o", str(fout), "-r", str(bundle), "--device", device])


def make_pipeline(argv: list[str]):
    """The pipeline as the command line builds it."""
    from sina_tpu_torch import cli
    from sina_tpu_torch.pipeline import Pipeline

    args = cli.build_parser().parse_args(argv)
    cli.setup_logging(args.verbose, args.quiet, args.log_file)
    return Pipeline(cli.config_from_args(args))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str, t0: float,
             faults=None) -> dict:
    """One run: returns the result's fields (metrics, numbers compared,
    device, counts) for run.py to print.  `faults` (tests only) is a
    callable given the pipeline before the window, to break it."""
    cfg, trf = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.set_num_threads(int(cfg["threads"]["torch_intra_op"]))

    t = time.time()
    ref = make_reference(cfg, dev)
    say(ref_lines(ref, cfg["policy"]))
    bundle = ensure_bundle(ref, cfg)
    t_ref = time.time() - t
    batch = int(trf["batch_size"])
    n_warm = int(trf["warmup_batches"]) * batch
    n_pool = int(trf["pool_factor"] * trf["pool_rate"] * seconds) + batch
    law = dict(branch_len=trf["branch_len"], parents=trf["parents"],
               amplicon=trf.get("amplicon"), device=dev, turned=trf.get("turned"))
    wq = gen.make_queries(ref, n_warm, sub_seed(seed, "warmup"), **law)
    pq = gen.make_queries(ref, n_pool, sub_seed(seed, "pool"), **law)
    if pq.turned is not None:
        say(f"# traffic: {int(wq.turned.sum())} of {wq.n} warm-up and "
            f"{int(pq.turned.sum())} of {pq.n} pool queries reverse-complemented")
    masks = torch.cat([wq.masks, pq.masks])
    offsets = torch.cat([wq.offsets, pq.offsets[1:] + wq.offsets[-1]])
    allq = gen.Queries(masks, offsets, torch.cat([wq.parents, pq.parents]))
    fasta, roff = gen.to_fasta(allq)
    pool_masks, pool_offsets = masks.cpu().numpy(), offsets.cpu().numpy()
    del ref, wq, pq, masks, offsets, allq
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_gen = time.time() - t - t_ref

    streams = Streams(fasta, roff)
    del fasta
    try:
        t = time.time()
        pipe = make_pipeline(pipeline_argv(cell, streams.fin, streams.fout, bundle, device))
        t_open = time.time() - t
        # warm-up: the same law under its own seed, so every bucket
        # shape, the caching allocator and the pinned pool are in use
        t = time.time()
        streams.start(f"count {n_warm} 0 {n_warm}", keep=False)
        pipe.run()
        fed, got = streams.results()
        if len(got["names"]) != n_warm:
            raise RuntimeError(f"warm-up wrote {len(got['names'])} of {n_warm} records")
        t_warm = time.time() - t
        from sina_tpu_torch.ops import kernels

        if faults is not None:
            faults(pipe)
        n_all = len(roff) - 1
        gc.collect()
        before = timer_snapshot()
        launches0 = dict(kernels.launches)
        tracer = None
        if trace:
            from . import trace as tracemod

            tracer = tracemod.Tracer(pipe, cuda)
        with tracer if tracer is not None else contextlib.nullcontext():
            t_start = time.time()
            streams.start(f"until {t_start + seconds} {n_warm} {n_all}", keep=True)
            cpu0 = host_cpu()
            with gc_pauses() as gcs:
                pipe.run()
            cpu = {k: v - cpu0[k] for k, v in host_cpu().items()}
            t_end = time.time()
        fed, records = streams.results()
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        timers = timer_delta(before, timer_snapshot())
        launches = {k: v - launches0.get(k, 0) for k, v in kernels.launches.items()
                    if v - launches0.get(k, 0)}
    finally:
        streams.close()
    window = t_end - t_start
    n_rec = len(records["names"])
    say(f"# setup: reference {t_ref:.2f} s, queries {t_gen:.2f} s, pipeline {t_open:.2f} s, "
        f"warm-up {t_warm:.2f} s ({n_warm} queries); setup_s {t_start - t0:.2f}")
    say(f"# window: {n_rec} records in {window:.3f} s; fed {fed['sent']} "
        f"(pool {n_all - n_warm}, restarted {fed['wraps']} times); "
        f"feeder closed {fed['t_close'] - t_start:.3f} s in")
    say(f"# timers: {json.dumps({k: {s: round(v[0], 4) for s, v in d.items()} for k, d in timers.items()})}")
    say(f"# gc in window: {json.dumps({g: [n, round(s, 4)] for g, (n, s) in gcs.items()})}")
    say(f"# host cpu in window: {json.dumps({k: round(v, 4) for k, v in cpu.items()})} s; "
        f"process {cpu['process'] * 1e3 / max(n_rec, 1):.4f} ms a record, main thread "
        f"{cpu['main'] * 1e3 / max(n_rec, 1):.4f}")
    say(f"# launches in window: {launches}")
    st = np.asarray(records["stamps"]) - t_start
    say(f"# window rate by 10 s: {np.bincount((st // 10).astype(int)).tolist() if len(st) else []}")
    if tracer is not None and tracer.summary() is not None:
        kern = tracer.summary()["kernels"]
        for name, key in (("kmer_score", "kmer_score_kernel"), ("profile_dp", "profile_dp_kernel"),
                          ("graph_dp", "graph_dp_kernel")):
            got = sum(v[1] for n, v in kern.items() if key in n)
            say(f"# profiler recorded {got} of {launches.get(name, 0)} {name} launches")
    sent = [gen.record_name(n_warm + (k % (n_all - n_warm))) for k in range(fed["sent"])]
    # what the per-layer metrics' readers read
    ctx = {
        "window_s": window, "timers": timers, "batches": -(-n_rec // batch),
        "records": n_rec, "cpu": cpu,
        "batch_size": batch, "stamps": records["stamps"], "gc": gcs,
        "trace": tracer.summary() if tracer is not None else None,
    }
    out = {
        "attempted": len(sent),
        "metrics_e2e": {
            "device_peak_gib": peak / 2**30,
            "setup_s": t_start - t0,
        },
        "memory_peak_bytes": int(peak),
        "ctx": ctx,
        "sent": sent,
        "records": records,
        "pool": (pool_masks, pool_offsets),
    }
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def check(cell: dict, run: dict, seed: int, device: str) -> dict:
    """The numbers compared, from the plain reference (run after the
    window, the program's state freed)."""
    from reference import check as refcheck

    cfg = cell["config"]
    t = time.time()
    ref = make_reference(cfg, torch.device(device))
    refx = refcheck.Reference(ref, cfg["policy"])
    pm, po = run["pool"]
    nums = refcheck.compare(run["sent"], run["records"], pm, po, refx,
                            int(cell["traffic"]["check_sample"]), sub_seed(seed, "sample"),
                            cfg, cell["traffic"], device)
    say(f"# check: {nums['_records']} records, {nums['_sampled']} sampled "
        f"({nums['_sampled_bases']} bases) in {time.time() - t:.1f} s")
    return nums
