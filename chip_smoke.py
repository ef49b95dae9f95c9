#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sina_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. environment: GPU name and power limit, torch/CUDA versions; fails
     unless the port's native host library (sina_tpu_torch/native,
     built with g++) loaded;
  2. build the CUDA kernels from the seven sources of sina_tpu_torch/csrc
     (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (exact), with both times and the card's bound;
     the packed k-mer scorer also with its group maxima (exact), and
     score_topk at k = 256 and 1,000 split into the kernel and the torch
     top-k stages, beside the same call with stage 1 by amax, in turns,
     with the stages' bound by bytes, the kernel's, the plain
     version's time (its output equal) and one torch.topk over the
     kernel's (B, S) scores (the library call; its values equal);
     the profile DP's bounded-insertion (forbid) mode on the same
     shapes with a budget plane of 0, 1, small values, values above M
     and 10**6, eight rows of it real families and queries of phase
     5's reference (made before this phase), exact with the chain
     traceback's emit on its plane, timed beside the shift mode and
     with one budget in every cell (below 1, 1, 4, 5, 33, 128, 129,
     M - 1 and M; each exact, one budget a row), with its registers;
     the packed scorer, the two DPs and the two tracebacks with their
     launch plans
     (threads, registers, shared memory a block) and their times from
     another run before the redesign beside the new ones; each
     traceback also one launch alone, warm and cold (L2 flushed before
     it), with its longest walk's steps and the time a step; the graph
     DP's global-ring route
     (its ring one slot deeper than shared memory holds) on the same
     bucket;
     the dense int8 scorer on a (4**9+1) x 16,384 {0,1} matrix (the
     dense layout of a 16k-reference index), also against the packed
     kernel on the same matrix bitpacked and timed beside one
     torch.nn.functional.embedding_bag call; the graph DP and
     its traceback on 128 family graphs of 40 references (N = 4096)
     and 128 full-length queries (M = 1536), in the simple, weighted,
     bounded-insertion (aspace) and substitution-matrix modes, and the
     dense route's two kernels (csrc/graph_dense.cu) on the same bucket,
     exact against their plain versions and equal to the graph kernels,
     the dense DP's time beside the graph DP's;
     the dense route's kernels on a bucket that takes the route (128
     families of phase 18's reference, largest predecessor distance 32
     or more, N = 4096, M = 1536) in the simple and forbid modes, timed
     beside their times before the redesign, with their launch plans
     (the rows kept in shared memory and in the global scratch) and
     bounds, and in all five modes at
     B = 32, each exact against the plain versions; and the same
     kernels on 32 queries of 1537-2048 nt (N = 4096, M = 2048: the DP's
     4-lane kernel in 512 threads) in the simple and forbid modes,
     exact;
  4. the CLI (sina_tpu_torch.cli.main --device cuda) on a small
     generated reference: the profile engine, --fs-graph, --fs-graph
     --insertion forbid, --insertion forbid, --fs-no-graph --insertion
     forbid, --use-subst-matrix, --turn, --turn all, -S --lca-fields
     tax_slv, --debug-lattice 0:20 (one lattice_<name>.dot a query) and
     --jax-profile-dir (a torch.profiler trace written, the FASTA equal
     to the run without it);
  5. the profile-engine main path at SILVA NR's scale: 450,000
     references at width 50,000 (the fast 10-mer index (262,145,
     56,320) uint8, 14.8 GB on the card), full-length queries in
     batches of 128 through famfinder, aligner and the FASTA writer,
     with its kernels' launch counts; the set-up's seconds (generate,
     index build, dense_packed fill, upload), the host's RAM and the
     peak device memory; then the packed scorer on the ids of one
     steady batch (scores and group maxima exact), with their distinct
     rows, its bound and its time back to back and one launch alone
     with L2 flushed, and score_topk on them at k = 256 and 1,000 split
     into the kernel and the torch top-k stages;
  6. the first 16 of those queries again with device="cpu" (the
     plain versions): the aligned records must be identical;
  7. the graph engine at the same scale: 384 full-length queries in
     three batches of 128 with AlignerConfig(engine="graph"), with its
     kernels' launch counts, the GraphDP sections and buckets;
  8. the first 16 graph queries again with device="cpu": identical
     records;
  9. the dense scorer's path: the k-mer scores and top-k of 128 queries
     through kmer_kernel.score_topk on the int8 device_matrix
     (packed=False) of the first 16,384 references, equal to the packed
     matrix's, with its launch count;
 10. the turn check and search + LCA at the same scale: 64 full-length
     queries, each given as is, reversed, complemented and reversed and
     complemented (256 queries, 2 batches of 128), with
     FamFinderConfig(turn="all") and a SearchFilter sharing the finder
     (1,000 k-mer candidates, lca_fields tax_slv): every copy reports
     the orientation it was given and yields the as-is copy's aligned
     row, nearest_slv and lca_tax_slv; the search's 1,000 candidates
     come from the grouped top-k (450,560 padded references), whose
     ids must equal the cpu's;
 11. the first 16 of those again with device="cpu": identical records,
     turn_slv, nearest_slv and lca_tax_slv included;
 12. the profile engine with --insertion forbid at the same scale: 384
     full-length queries in three batches of 128 (the first warms up)
     with AlignerConfig(insertion="forbid"), with its kernels' launch
     counts, the device's busy share and the share of the real columns
     in each budget class, from the budget planes the aligner built;
 13. the first 16 of those again with device="cpu": identical records;
 14. the sharded search (sina_tpu_torch/parallel) at scale: phase 5's
     index in the tiled layout (524,288 padded references, 17.2 GB) on
     meshes of the card named 4 times, (dp, mp) = (1, 4) and (2, 2),
     for the k-mer ids of a steady phase-5 batch at k = 256 and 1,000:
     values equal to the unsharded score_topk's, every id reaching its
     value, the first 16 queries' values and ids equal to the same mesh
     on the cpu; the kmer_score launches and the time a call;
 15. famfinder on the (1, 4) mesh: 128 full-length queries through
     famfinder, aligner and the FASTA writer, with its kernels' launch
     counts; the first 16 again on the same mesh shape on the cpu:
     identical records;
 16. --multihost: two processes of python -m sina_tpu_torch --device
     cuda --multihost on the card, on phase 4's reference: their .part
     files hold every query once, each record equal to one process's;
 17. dryrun_multichip over the card named 8 times ((2, 4)): the tiny
     sharded search, the graph DP data-parallel over 8 devices equal to
     one device's, and the sharded search on a zero-filled 17.2 GB
     tiled index at SILVA NR's 450k references;
 18. the graph engine on a reference whose families carry long
     insertions (20,000 references at width 50,000, one in 20 with a
     48-base insertion that its relatives skip, as length-variable
     regions do in real 16S/18S families; made before phase 3): 384
     full-length queries in three batches of 128 with
     AlignerConfig(engine="graph"), every graph bucket on the dense route
     (graph_dense_route and both dense kernels' launches equal to the
     bucket count, no graph_dp launch), the device's busy share and
     device ms by kernel; then the first 8 queries again with
     device="cpu": identical records;
 19. the transfers (sina_tpu_torch/ops/transfer.py) on a batch of 128
     queries of each of phases 5, 12, 7 and 18 (the profile, forbid,
     graph and dense routes): famfinder's submit_batch and
     align_dispatch raise nothing under
     torch.cuda.set_sync_debug_mode("error"), each profile launch makes
     one host-to-device copy (its wire), every buffer of the pinned pool
     is pinned; on the profile and graph routes famfinder's fetch and the
     aligner's finalize return while a sleep kernel queued after each
     still runs, with records equal to the run without it;
 20. the amplicon path (bench.py --amplicon's model) on phase 5's
     reference, index and famfinder: 5,120 queries cut to 250 bases in
     batches of 1,024 (the first warms up) with AlignerConfig() (the
     profile engine, col-trim on from 1,024 occupied columns): steady
     seq/s, launches, the device's busy share, device ms by kernel and
     copy, the profile DP buckets, the rows on a trimmed column window
     and the families built on a window in each batch (at least one
     trimmed row a batch, >= 95% aligned), the host sections and the
     pinned pool; the first 64 again on the cpu (identical records);
     phase 3's checks at these shapes: the packed scorer on one steady
     batch's ids (B = 1,024; with score_topk's stages at k = 256 and
     1,000), the profile DP on the largest bucket's
     launch inputs and the chain traceback on its plane, each exact
     against its plain version, timed beside its bound; then 2,048 of the
     amplicons with AlignerConfig(insertion="forbid") (full builds,
     window-sliced rows budgeted to the next occupied column outside the
     window) with the same lines and the budget classes, 16 on the cpu
     (identical records), and the forbid DP exact on its largest launch;
 21. the accuracy suite through the CUDA kernels: every case of
     tests/test_accuracy.py but the fs-msc-max caps 0.8 and 0.7 (which
     tests/test_torch_accuracy_msc.py holds on the cpu) on the port's
     Pipeline (cuda, show_dist)
     against a 5,000-sequence LTP-like bundle (testing.
     make_reference_ltp), each held to that test's bars, with its
     launches (graph_dense_route included); realign_k8 and
     realign_nofast again on the cpu, whose per-query sps and cpm must
     equal the card's as floats; then the seven cases of
     tests/test_accuracy_multiseed.py (fresh fixture seeds, the profile
     engine's worst case, divergent queries, partial-length reads) on
     the port's famfinder and aligner (cuda) with that file's bars;
 22. bench.py's operating points through bench_torch.py: its default,
     --graph, --amplicon and --search modes through bench_torch.run on
     phase 5's reference, index and famfinder (640 queries in batches
     of 128; 5,120 amplicons in batches of 1,024), each with its JSON
     line, bench_torch's stderr lines (set-up, warm-up breakdown,
     timers, wall coverage, the timed window's launches and
     generation-2 collections), the queries aligned (>= 95%, records
     valid) or classified (>= 95% of the timed ones), the launches of
     its path's kernels and its peak device memory; the --search mode's
     first 16 queries again on the cpu (nearest_slv, lca_tax_slv and
     the records identical); then `python bench_torch.py --curve`
     (2k, 20k and 100k references), `--graph`, `--search` and
     `--amplicon` as child processes at bench.py's default 2,000 x
     2,400, each exiting 0 with its JSON lines alone on its stdout;
     and the port's figure for each row of README.md's performance
     table;
 23. the port of __graft_entry__.entry() (sina_tpu_torch.graft_entry:
     the bitpacked scorer, the lowest-id top-k and the dense graph DP on
     tiny shapes) on the card, equal to its plain run on the cpu (vals,
     ids, best_j, best_i and raw exact), each of its kernels launched
     once; then, as child processes each exiting 0, `python -m
     sina_tpu_torch.graft_entry` (its dry run over the visible cards)
     and the port's tools: prof_famfinder at 450,000 references with
     --batch 128 and 1024, --topk 256 and 1000 (one torch.topk over the
     (B, S) scores among its lines), prof_profiledp at its defaults and
     at the amplicon shape (--c 512 --m 256 --batch 1024), prof_wire_ab
     at its defaults, and diag_accuracy on both engines, whose summary
     line must equal the same command's with --device cpu; with the
     device memory free before the children.

Phases 5, 7, 12, 18 and 20 also print their steady batches' copies (counts,
the host ms a batch of the upload and fetch sections) and, from the
profiled second pass, each kind of copy's device ms; the device's busy
ms there are the union of its activity intervals over the compute and
copy streams.  Phases 5, 7, 10, 12, 14, 15, 18, 19, 20 and 22 print
their peak device memory, the host's available RAM and the process's
peak resident memory, and phases 5, 7, 10, 12, 20 and 22 the garbage
collector's runs in their timed batches; each phase group ends with the seconds
since the start.

The second-to-last line is the kernels' JSON record, the line before
it the card's `nvidia-smi` name and power limit, and the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero without
that line.  Imports nothing of JAX or of the JAX package sina_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from bench_torch import amplicon_cut, gc_pauses

# main-path shapes: batch 128 of ~1,450-nt queries (M bucket 1536)
# against family profiles of up to 2048 occupied columns; phase 3's
# synthetic k-mer index keeps the 100k-reference width (fast 10-mers:
# 4**9 + 1 rows, 100,352 padded references = 12,544 bytes per row), so
# that its times compare with earlier runs'
B_MAIN, C_MAIN, M_MAIN = 128, 2048, 1536
KMER_ROWS, KMER_SB, KMER_L, KMER_REAL = 4 ** 9 + 1, 12_544, 512, 360
# the scale phases' reference: SILVA NR's 450k references at width
# 50,000 (README.md, BENCH_SCALE.md), whose index is (4**9 + 1, 56,320)
# bytes, 450,560 padded references
N_REFS, WIDTH, N_QUERIES = 450_000, 50_000, 640
# graph engine: families of 40 references (N bucket 4096), 384 queries
FAMILY, N_GRAPH, N_GRAPH_QUERIES = 40, 4096, 384
# the dense int8 scorer: the dense layout of a 16,384-reference index
# (4.3 GB; the 450k-reference one would be 118 GB, more than the card
# holds)
DENSE_S = 16_384
# the forbid profile path: 384 queries, one warm-up and two steady batches
N_FORBID_QUERIES = 384
# the dense route's path (phase 18): 20,000 references, one in 20 with a
# 48-base insertion at the alignment's middle column, 384 queries
N_INDEL_REFS, INDEL_LEN, INDEL_EVERY, N_INDEL_QUERIES = 20_000, 48, 20, 384
# its queries again on the cpu (the dense route's plain DP takes about 3 s
# a query there; 8 since the 450k reference's set-up took the time of 16)
INDEL_TWINS = 8
# the graph engine's longer query bucket (queries of 1537-2048 nt; a
# quarter of phase 18's): the dense DP's 4-lane kernel at its most
# threads, 512
M_LONG = 2048
# turn + search: 64 queries, each in the four orientations
N_TURN = 64
TURN_NAMES = ("none", "reversed", "complemented", "reversed and complemented")
# the amplicon path (phase 20, bench.py --amplicon's model): 5,120
# queries cut to 250 bases, in batches of 1,024 (the first warms up),
# then 2,048 of them with --insertion forbid; the first 64 (16 for
# forbid) again on the cpu
N_AMPLICON, B_AMPLICON = 5120, 1024
N_AMPLICON_FORBID, AMPLICON_TWINS, AMPLICON_FORBID_TWINS = 2048, 64, 16
# the accuracy suite (phase 21): tests/test_accuracy.py's bundle
N_LTP = 5000

# the card's peak rates (NVIDIA's H100 SXM data sheet, at 700 W): device
# memory bytes/s, and float32 operations/s outside the tensor cores (a
# multiply-add counts two), the rate the k-mer scorers' adds and the
# tracebacks' steps are counted at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the DPs are counted in instructions of one thread instead: the SMs
# issue at most 128 thread-instructions an SM a clock (4 schedulers, one
# warp instruction each), the rate of the f32 add, min, compare and
# select, half the data sheet's multiply-add-doubled rate; integer
# instructions run on 64 threads an SM a clock (Hopper's INT32 units),
# half that
ISSUE_PER_S = F32_OPS_PER_S / 2
INT32_PER_S = ISSUE_PER_S / 2
# The DPs' instructions, counted from their plain versions (any design
# of the kernels does this work), each add, multiply, min, compare and
# select one, a multiply-add one (the reference rounds it once, as one
# f32 FMA does), the insertion prefix-min one min a cell (the work of a
# serial scan); (all, integer).  ops/profile_kernel.py
# profile_dp_plain, per real column and query position: deletion track
# 5, match 1, U and code 6 (2 integer), insertion candidate 2,
# prefix-min 1, Irow 2, ins_opened 3, take_i, Vrow and code 3 (1
# integer), the bp byte 4 (integer): 27, 7 of them integer.
PROFILE_INSTS_PER_CELL = (27, 7)
# the bounded-insertion (forbid) mode, from the same plain version: the
# insertion track's prefix-min 1 and Irow 2 become Irow 1 (the prefix
# plus the ramp), ins_opened takes 3 more (the 1e-4 add, its compare,
# the or: 1 integer), so 28 a cell, 8 integer; in a column whose budget
# R >= 1 the trailing-window minimum, 3 a cell (van Herk / Gil-Werman:
# a forward and a backward min in segments of R and their combine); and
# once a column the budget test (1, integer) that sends the whole row to
# BIG below 1
FORBID_INSTS_PER_CELL = (28, 8)
FORBID_INSTS_PER_WINDOW_CELL = 3
FORBID_INSTS_PER_COLUMN = (1, 1)
# per real column: the profile's unpack 10, occupancy 3, its deletion
# and mismatch products 3, and for each of the 16 query masks the
# substitution cost (dot 7, sub 4): 192; end candidate 1 (compare,
# value and column selects) 3, 1 integer
PROFILE_INSTS_PER_COLUMN = (16 + 16 * 11 + 3, 1)
# per query position, once a row (end candidate 2, the row argmin at
# the last real column): compare, value and index selects
PROFILE_INSTS_PER_POSITION = (3, 1)
# ops/graph_kernel.py _graph_core_plain, per real node and query
# position: Drow 1, Mc 1, code and U 5 (2 integer), insertion candidate
# 2, prefix-min 2, Irow 1, ins_opened 3, take_i, Vrow and code 3 (1
# integer), the bp word 6 (integer): 24, 9 integer; and for each
# predecessor the node probes (from the bucket's own masks): mdist 2 (1
# integer), vmin 1, deletion open and extend 2, dc 1, upd 1, ddist 1
# (integer), dopen 2 (1 integer), dmin 1: 11, 3 integer
GRAPH_INSTS_PER_CELL = (24, 9)
GRAPH_INSTS_PER_PRED_CELL = (11, 3)
# per real node: its five costs 5, end candidate 1 3 (1 integer); per
# end node and query position: end candidate 2 4 (1 integer)
GRAPH_INSTS_PER_NODE = (8, 1)
GRAPH_INSTS_PER_END_CELL = (4, 1)
# ops/align_kernel.py poa_dp_dense, per real node and query position: as
# the graph DP's cell but the match cost is a rounded product and an add
# (2, not 1): 25, 9 integer; each predecessor slot a real node holds
# costs what a graph predecessor probe does (the same value and argmin
# work: GRAPH_INSTS_PER_PRED_CELL), and the nodes and end cells the same
DENSE_INSTS_PER_CELL = (25, 9)
# the kernels' times before their redesign for this card (PERF.md section
# 6 names the runs; same shapes, an NVIDIA H100 80GB HBM3 at 700 W; the
# graph traceback's in the simple mode; the dense route's on phase 3's
# dense bucket, the walk warm); printed beside this run's, so the ratio
# holds both runs' spread
BEFORE_MS = {"kmer_score": 0.391, "profile_dp": 2.046, "graph_dp simple": 8.926,
             "graph_dp weighted": 8.883, "graph_dp aspace": 11.120,
             "graph_dp matrix": 10.980, "chain_traceback": 0.814,
             "graph_traceback": 0.640, "profile_dp_forbid": 2.561,
             "graph_dp_dense simple": 9.456, "graph_dp_dense forbid": 13.736,
             "graph_traceback_dense": 1.069}
# the launches each DP time is the mean of
DP_REPS = 10
# the forbid mode's budgets timed alone (the same in every cell): below 1,
# then the edges of the lane geometry at 4 lanes a thread (K, K + 1, one
# warp's 32 K lanes and one more), a typical gap of a real family, M - 1
# and M
FORBID_UNIFORM_R = (0, 1, 4, 5, 33, 128, 129, M_MAIN - 1, M_MAIN)
# the launches each traceback time is the mean of, and the bytes written
# before a cold launch, which leave none of its data in the 50 MB L2
TB_REPS = 5
FLUSH_BYTES = 128 << 20

KERNELS = {
    "kmer_score": ("sina_tpu_torch/csrc/kmer_score.cu",
                   "sina_tpu/ops/kmer_kernel.py:173"),
    "kmer_score_dense": ("sina_tpu_torch/csrc/kmer_dense.cu",
                         "sina_tpu/ops/kmer_kernel.py:56"),
    "profile_dp": ("sina_tpu_torch/csrc/profile_dp.cu",
                   "sina_tpu/ops/profile_pallas.py:42"),
    "profile_dp_forbid": ("sina_tpu_torch/csrc/profile_dp.cu",
                          "sina_tpu/ops/profile.py:399"),
    "chain_traceback": ("sina_tpu_torch/csrc/chain_traceback.cu",
                        "sina_tpu/ops/profile_pallas.py:309"),
    "graph_dp": ("sina_tpu_torch/csrc/graph_dp.cu",
                 "sina_tpu/ops/graph_pallas.py:107"),
    "graph_traceback": ("sina_tpu_torch/csrc/graph_traceback.cu",
                        "sina_tpu/ops/graph_pallas.py:333"),
    "graph_dp_dense": ("sina_tpu_torch/csrc/graph_dense.cu",
                       "sina_tpu/ops/align_kernel.py:409"),
    "graph_traceback_dense": ("sina_tpu_torch/csrc/graph_dense.cu",
                              "sina_tpu/ops/align_kernel.py:626"),
}
PROFILE_PATH = ("kmer_score", "profile_dp", "chain_traceback")
FORBID_PATH = ("kmer_score", "profile_dp_forbid", "chain_traceback")
GRAPH_PATH = ("kmer_score", "graph_dp", "graph_traceback")
DENSE_ROUTE_PATH = ("kmer_score", "graph_dp_dense", "graph_traceback_dense")


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def host_memory() -> str:
    """The host's total and available RAM (/proc/meminfo) and this
    process's peak resident memory."""
    import resource

    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, value = line.split(":", 1)
        info[key] = int(value.split()[0]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return (f"host RAM {info['MemTotal'] / 1e9:.1f} GB total, {info['MemAvailable'] / 1e9:.1f} "
            f"GB available; this process's peak resident memory {peak / 1e9:.1f} GB")


def peak_memory(phase: str) -> None:
    """Print the most device memory allocated and reserved since the
    phase began (it calls torch.cuda.reset_peak_memory_stats first), and
    the host's memory."""
    import torch

    say(f"{phase} peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved; "
        f"{host_memory()}")


def bound(nbytes: float, nops: float = 0.0, insts: tuple = (0, 0)) -> dict:
    """The least time the card could take for work that moves `nbytes`
    of device memory (each input read once, each output written once)
    and does `nops` operations at the f32 rate, or `insts` = (all,
    integer) instructions, and which of the two bounds it."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * max(nops / F32_OPS_PER_S, insts[0] / ISSUE_PER_S,
                       insts[1] / INT32_PER_S)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_one(fn) -> tuple:
    """(fn()'s result, its device ms): one call between CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_launch_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one launch of fn(), each of `reps` launches
    timed alone by CUDA events around it, the card kept busy while the
    host enqueues it (so the host's time stays out).  With `flush` (a
    tensor larger than L2), the tensor is written before each launch,
    so the launch reads its data from device memory."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def traceback_walk_times(name: str, fn, warm_ms: float, steps, plan: dict,
                         flush) -> None:
    """Beside a traceback's warm time (the mean over TB_REPS launches on
    one plane, whose path then sits in L2), one launch alone warm and
    cold, the longest walk's steps (counted by the plain version) and
    the time a step."""
    single = time_launch_ms(fn, TB_REPS)
    cold = time_launch_ms(fn, TB_REPS, flush)
    longest = int(np.max(steps))
    say(f"phase 3 {name} walk: warm {warm_ms:.3f} ms ({TB_REPS} launches on one "
        f"plane), one launch alone {single:.3f} ms warm, {cold:.3f} ms cold "
        f"(L2 flushed by writing {FLUSH_BYTES >> 20} MB before each); longest walk "
        f"{longest} steps (plain version), {1e6 * warm_ms / longest:.1f} ns a "
        f"step warm, {1e6 * cold / longest:.1f} cold; launch plan {plan}")


def phase_environment() -> str:
    import torch

    from sina_tpu_torch import native

    smi = gpu_line()
    lib = native.get_lib()
    say(f"phase 1 environment: gpu={smi!r} torch={torch.__version__} "
        f"cuda={torch.version.cuda} native_host_lib={lib is not None}")
    if lib is None:
        # the pure-Python host path would change every host section
        raise AssertionError("the port's native host library did not load "
                             "(sina_tpu_torch/native, g++)")
    return smi


def phase_build() -> None:
    from sina_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    took = time.perf_counter() - t0
    usage = [ln.strip() for ln in kernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    # "== <source> (rc 0, <s>s)": each nvcc's own time, run side by side
    each = {m[1]: float(m[2]) for m in
            re.finditer(r"^== (\S+) \(rc \d+, ([\d.]+)s\)$", kernels.build_log, re.M)}
    say(f"phase 2 build: {took:.2f}s (nvcc {kernels.build_seconds}s wall; "
        f"each process {each}, sum {sum(each.values()):.2f}s)")
    for ln in usage:
        say(f"  ptxas: {ln}")


def synthetic_profiles(rng, B: int, C: int, M: int):
    """Quantised family profiles and queries shaped like the main
    path's: a quarter of the columns sparsely occupied (insertion
    columns of a few members), the rest with a dominant base; queries
    follow the dense columns' consensus with substitutions, deletions,
    insertions and a few ambiguity codes.  Returns fgq (B, C, 6)
    uint8, qmask (B, M) uint8, lens (B, 2) int32; the last 8 rows are
    padding rows with lens (1, 1), as the batch bucketing adds them."""
    from sina_tpu_torch.ops.align_kernel import DpParams
    from sina_tpu_torch.ops.profile import _pack_fgq

    cr = C - rng.integers(0, C // 12, B)
    cons = rng.integers(0, 4, (B, C))
    sparse = rng.random((B, C)) < 0.25
    freqs = (rng.random((B, C, 4)) * 0.1).astype(np.float32)
    np.put_along_axis(freqs, cons[..., None], 0.85, axis=2)
    scale = np.where(sparse, 0.05, rng.uniform(0.6, 1.0, (B, C)))
    freqs *= scale[..., None].astype(np.float32)
    gapcost = (rng.random((B, C)) * 0.3).astype(np.float32)
    fgq = _pack_fgq(freqs, gapcost, DpParams())
    qmask = np.zeros((B, M), np.uint8)
    qlen = np.ones(B, np.int32)
    for b in range(B - 8):
        n = cr[b]
        keep = rng.random(n) < np.where(sparse[b, :n], 0.05, 0.97)
        base = np.where(rng.random(n) < 0.1,
                        rng.integers(0, 4, n), cons[b, :n])[keep]
        ins = rng.random(len(base)) < 0.01
        base = np.insert(base, np.nonzero(ins)[0],
                         rng.integers(0, 4, int(ins.sum())))[:M]
        m = (1 << base).astype(np.uint8)
        m[rng.random(len(m)) < 0.002] = 0b0101
        qmask[b, :len(m)] = m
        qlen[b] = len(m)
    crl = cr.astype(np.int32)
    crl[B - 8:] = 1
    return fgq, qmask, np.stack([qlen, crl], axis=1).astype(np.int32)


def phase_kernels(dev, db) -> dict:
    """Each kernel against its plain version on the card, at the main
    path's shapes; all outputs must match exactly."""
    import torch

    from sina_tpu_torch.ops import kmer_kernel as kk
    from sina_tpu_torch.ops import profile_kernel as pk
    from sina_tpu_torch.ops.align_kernel import DpParams

    rng = np.random.default_rng(1234)
    out = {}

    # kernel 1: k-mer scorer over a random 3.3 GB packed index
    gen = torch.Generator(device=dev).manual_seed(1234)
    P = torch.randint(0, 256, (KMER_ROWS, KMER_SB), dtype=torch.uint8,
                      device=dev, generator=gen)
    P[-1] = 0
    km = np.full((B_MAIN, KMER_L), KMER_ROWS - 1, np.int32)
    km[:, :KMER_REAL] = rng.integers(0, KMER_ROWS - 1, (B_MAIN, KMER_REAL))
    kmers = torch.from_numpy(km).to(dev)
    got = kk.kmer_scores(P, kmers)
    ref = kk.kmer_scores_plain(P, kmers)
    err = int((got - ref).abs().max())
    if err != 0 or not torch.equal(got, ref):
        raise AssertionError(f"kmer_score disagrees with its plain version (max |d|={err})")
    scores, gmax = kk.kmer_scores(P, kmers, gmax=True)
    if not (torch.equal(scores, ref) and torch.equal(gmax, kk.group_max_plain(ref))):
        raise AssertionError("kmer_score with the group maxima disagrees with its plain "
                             "versions")
    del scores, gmax
    ms = time_ms(lambda: kk.kmer_scores(P, kmers), 10)
    plain_ms = time_ms(lambda: kk.kmer_scores_plain(P, kmers), 2)
    b = kmer_bound(kmers, KMER_SB, KMER_ROWS - 1)
    out["kmer_score"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **b, "library_ms": None}
    before = BEFORE_MS["kmer_score"]
    say(f"phase 3 kmer_score: B={B_MAIN} L={KMER_L} ({KMER_REAL} real) Sb={KMER_SB} "
        f"scores and group maxima exact; kernel {ms:.3f} ms (before the redesign, other "
        f"run: {before:.3f} ms, {ms / before:.3f}x), plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}; {kmer_rows(kmers)}); launch plan "
        f"{kk.kmer_score_plan(P)}")
    score_topk_times(P, kmers)
    del P, got, ref
    torch.cuda.empty_cache()

    out["kmer_score_dense"] = phase_dense_kernel(dev, rng)

    # kernels 2 and 3: profile DP and chain traceback
    params = DpParams()
    fgq, qmask, lens = synthetic_profiles(rng, B_MAIN, C_MAIN, M_MAIN)
    fg, qm, ln = (torch.from_numpy(a).to(dev) for a in (fgq, qmask, lens))
    got = pk.profile_dp(fg, qm, ln, params)
    ref = pk.profile_dp_plain(fg, qm, ln, params)
    for n, a, b in zip(("bp", "best_c", "best_i", "raw"), got, ref):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"profile_dp {n} disagrees with its plain version "
                                 f"({bad} cells)")
    dp_err = float((got[3] - ref[3]).abs().max())
    # the dedup gather: 64 unique profiles, two queries each
    fam = torch.arange(B_MAIN, dtype=torch.int32, device=dev) % 64
    gd = pk.profile_dp(fg[:64].contiguous(), qm, ln, params, fam_idx=fam)
    rd = pk.profile_dp_plain(fg[:64].contiguous(), qm, ln, params, fam_idx=fam)
    if not all(torch.equal(a, b) for a, b in zip(gd, rd)):
        raise AssertionError("profile_dp with fam_idx disagrees with its plain version")
    ms = time_ms(lambda: pk.profile_dp(fg, qm, ln, params), DP_REPS)
    plain_ms = time_ms(lambda: pk.profile_dp_plain(fg, qm, ln, params), 1)
    # inputs and the whole bp plane plus the end cells; the instructions
    # of each row's real columns and query length
    ql, cr = lens[:, 0].astype(np.int64), lens[:, 1].astype(np.int64)
    counts = (int((ql * cr).sum()), int(cr.sum()), int(ql.sum()))
    per = (PROFILE_INSTS_PER_CELL, PROFILE_INSTS_PER_COLUMN, PROFILE_INSTS_PER_POSITION)
    insts = tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))
    b = bound(fgq.nbytes + qmask.nbytes + lens.nbytes + B_MAIN * C_MAIN * M_MAIN
              + 12 * B_MAIN, insts=insts)
    out["profile_dp"] = {"max_abs_err": dp_err, "ms": ms, "plain_ms": plain_ms,
                         **b, "library_ms": None}
    say(f"phase 3 profile_dp: B={B_MAIN} C={C_MAIN} M={M_MAIN} bp/best_c/"
        f"best_i/raw exact (also with fam_idx); kernel {ms:.3f} ms (PR 3, "
        f"other run: {BEFORE_MS['profile_dp']:.3f} ms, "
        f"{ms / BEFORE_MS['profile_dp']:.3f}x), plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}; {counts[0]} cells, "
        f"{insts[0]} instructions, {insts[1]} integer); launch plan "
        f"{pk.profile_dp_plan(M_MAIN)}")
    out["profile_dp_forbid"] = phase_forbid_kernel(dev, rng, db, fgq, qmask, lens, ms)

    bp, bc, bi, _ = got
    emit = pk.chain_traceback(bp, bc, bi)
    steps = np.zeros(B_MAIN, np.int64)
    emit_ref = pk.chain_traceback_plain(bp, bc, bi, steps=steps)
    err = int((emit - emit_ref).abs().max())
    if not torch.equal(emit, emit_ref):
        raise AssertionError("chain_traceback disagrees with its plain version")
    aligned = int((emit[: B_MAIN - 8] >= 0).sum(dim=1).min())
    ms = time_ms(lambda: pk.chain_traceback(bp, bc, bi), TB_REPS)
    plain_ms = time_ms(lambda: pk.chain_traceback_plain(bp, bc, bi), 1)
    b = traceback_bound(emit, 1)
    out["chain_traceback"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              **b, "library_ms": None}
    before = BEFORE_MS["chain_traceback"]
    say(f"phase 3 chain_traceback: emit exact (fewest bases emitted in a "
        f"real row: {aligned}); kernel {ms:.3f} ms (before the redesign, other "
        f"run: {before:.3f} ms, {ms / before:.3f}x), plain {plain_ms:.3f} ms, "
        f"bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    traceback_walk_times("chain_traceback", lambda: pk.chain_traceback(bp, bc, bi), ms,
                         steps, pk.chain_traceback_plan(bp), flush)
    return out


def forbid_bucket(rng, db, fgq, qmask, lens):
    """The forbid mode's inputs at the main path's shapes: phase 3's
    synthetic profiles with a (B, C) budget plane mixing 0, 1, small
    values, values above M and 10**6 (rows 8-11 all 0, all 1, small
    and above M), and rows 0-7 replaced by real families of phase 5's
    reference (40 members of a query's ancestor group, profile built as
    the aligner builds it) with real queries, whose budgets are the
    aligner's: the free columns between occupied ones, the last slot
    the gap to the alignment's end.  Returns numpy (fgq, qmask, lens,
    budget)."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops.align_kernel import DpParams
    from sina_tpu_torch.ops.profile import build_profiles_packed_batch

    fgq, qmask, lens = fgq.copy(), qmask.copy(), lens.copy()
    B, C = fgq.shape[:2]
    M = qmask.shape[1]
    choices = np.array([0, 0, 0, 1, 1, 2, 3, 5, 9, 17, 40, 200, M, M + 7, 10**6])
    budget = choices[rng.integers(0, len(choices), (B, C))].astype(np.int32)
    budget[8], budget[9] = 0, 1
    budget[10] = rng.integers(0, 4, C)
    budget[11] = M + 1 + rng.integers(0, 100, C)
    qs = [q for q in testing.make_queries(db, n=32, seed=21, branch_len=0.7)
          if len(q.masks) <= M][:8]
    fams = [db.sequences[int(q.attrs["parent"][3:]) // 64 * 64:][:FAMILY] for q in qs]
    fg, cols = build_profiles_packed_batch(fams, C, DpParams())
    for b, (q, c) in enumerate(zip(qs, cols)):
        fgq[b] = fg[b]
        qmask[b] = 0
        qmask[b, :len(q.masks)] = q.masks
        lens[b] = (len(q.masks), len(c))
        budget[b] = 0
        budget[b, :len(c) - 1] = np.diff(c.astype(np.int64)) - 1
        budget[b, len(c) - 1] = db.width - int(c[-1]) - 1
    return fgq, qmask, lens, budget


def forbid_insts(lens, budget, M: int) -> tuple:
    """The forbid mode's instructions (all, integer), counted from its
    plain version over each row's real columns and query length: the
    per-cell count, the windowed minimum where the budget is >= 1, the
    budget test once a column and the per-column and per-position work
    of the shift mode."""
    ql, cr = lens[:, 0].astype(np.int64), lens[:, 1].astype(np.int64)
    real = np.arange(budget.shape[1])[None, :] < cr[:, None]
    window_cells = int((((budget >= 1) & real).sum(axis=1) * ql).sum())
    cells, cols, pos = int((ql * cr).sum()), int(cr.sum()), int(ql.sum())
    per_col = tuple(a + b for a, b in zip(PROFILE_INSTS_PER_COLUMN, FORBID_INSTS_PER_COLUMN))
    per = (FORBID_INSTS_PER_CELL, per_col, PROFILE_INSTS_PER_POSITION)
    insts = [sum(n * p[k] for n, p in zip((cells, cols, pos), per)) for k in (0, 1)]
    insts[0] += FORBID_INSTS_PER_WINDOW_CELL * window_cells
    return tuple(insts), cells


def phase_forbid_kernel(dev, rng, db, fgq, qmask, lens, shift_ms: float) -> dict:
    """The profile DP's bounded-insertion (forbid) mode against its plain
    version on the card at B = 128, C = 2048, M = 1536: bp, best_c,
    best_i, raw exact, and the chain traceback's emit on the forbid
    plane; its time beside the shift mode's on the same profiles, its
    bound and its launch plan."""
    import torch

    from sina_tpu_torch.ops import profile_kernel as pk
    from sina_tpu_torch.ops.align_kernel import DpParams

    fgq, qmask, lens, budget = forbid_bucket(rng, db, fgq, qmask, lens)
    params = DpParams()
    fg, qm, ln, bud = (torch.from_numpy(a).to(dev) for a in (fgq, qmask, lens, budget))
    got = pk.profile_dp(fg, qm, ln, params, budget=bud)
    ref = pk.profile_dp_plain(fg, qm, ln, params, budget=bud)
    for n, a, b in zip(("bp", "best_c", "best_i", "raw"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"profile_dp_forbid {n} disagrees with its plain version "
                                 f"({int((a != b).sum())} cells)")
    emit = pk.chain_traceback(*got[:3])
    if not torch.equal(emit, pk.chain_traceback_plain(*ref[:3])):
        raise AssertionError("chain_traceback on the forbid plane disagrees with its plain "
                             "version")
    real_aligned = int((emit[:8] >= 0).sum(dim=1).min())
    ins = int(((got[0][:, :8] & 3) == 3).sum())
    ms = time_ms(lambda: pk.profile_dp(fg, qm, ln, params, budget=bud), DP_REPS)
    shift_same = time_ms(lambda: pk.profile_dp(fg, qm, ln, params), DP_REPS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pk.profile_dp_plain(fg, qm, ln, params, budget=bud)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    # the kernel's time by budget, the same budget in every cell: below 1
    # (no window), then the lane geometry's edges at 4 lanes a thread (K,
    # K + 1, one warp's 32 K lanes and one more), a typical gap of a real
    # family, M - 1 and M
    uniform = {}
    for r in FORBID_UNIFORM_R:
        u = torch.full_like(bud, r)
        uniform[r] = round(time_ms(lambda: pk.profile_dp(fg, qm, ln, params, budget=u),
                                   DP_REPS), 3)
    # each of those budgets exact: row b takes the b-th of them (mod their
    # count) in every column, one plain run for all (rows are independent)
    rows_r = torch.tensor(FORBID_UNIFORM_R, dtype=torch.int32, device=dev)
    u = rows_r[torch.arange(B_MAIN, device=dev) % len(FORBID_UNIFORM_R)][:, None].expand_as(bud)
    u = u.contiguous()
    for n, a, b in zip(("bp", "best_c", "best_i", "raw"),
                       pk.profile_dp(fg, qm, ln, params, budget=u),
                       pk.profile_dp_plain(fg, qm, ln, params, budget=u)):
        if not torch.equal(a, b):
            raise AssertionError(f"profile_dp_forbid {n} disagrees with its plain version "
                                 f"at one budget a row ({int((a != b).sum())} cells)")
    insts, cells = forbid_insts(lens, budget, M_MAIN)
    b = bound(fgq.nbytes + qmask.nbytes + lens.nbytes + budget.nbytes
              + B_MAIN * C_MAIN * M_MAIN + 12 * B_MAIN, insts=insts)
    plan = pk.profile_dp_plan(M_MAIN, forbid=True)
    say(f"phase 3 profile_dp_forbid: B={B_MAIN} C={C_MAIN} M={M_MAIN} (rows 0-7 real "
        f"families and queries, {ins} insertion cells there; fewest bases emitted in a "
        f"real row {real_aligned}) bp/best_c/best_i/raw and emit exact; kernel {ms:.3f} ms "
        f"(before the redesign, other run: {BEFORE_MS['profile_dp_forbid']:.3f} ms, "
        f"{ms / BEFORE_MS['profile_dp_forbid']:.3f}x), "
        f"shift mode on the same profiles {shift_same:.3f} ms ({ms / shift_same:.3f}x; "
        f"phase 3's shift profiles {shift_ms:.3f} ms), plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}; {cells} cells, {insts[0]} "
        f"instructions, {insts[1]} integer); launch plan {plan}: {plan['regs']} "
        f"registers a thread (shift mode {pk.profile_dp_plan(M_MAIN)['regs']}); kernel ms "
        f"with one budget R in every cell {uniform} (each exact, one budget a row); "
        f"budgets >= 1 in "
        f"{int((budget >= 1).sum())} of {budget.size} cells")
    return {"max_abs_err": float((got[3] - ref[3]).abs().max()), "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None}


def kmer_bound(kmers, Sb: int, sink: int) -> dict:
    """The bitpacked scorer's bound: the distinct rows of the batch (the
    sink row included) read once, the k-mer ids, the scores written
    once; one add per reference for each distinct row of a query but
    the all-zero sink row `sink` (where famfinder's padding ids point;
    a row a query holds twice is added once, times its count)."""
    import torch

    B, L = kmers.shape
    rows = int(torch.unique(kmers).numel())
    s = kmers.sort(dim=1).values
    distinct = (1 + (s[:, 1:] != s[:, :-1]).sum(dim=1) - (s == sink).any(dim=1).int())
    return bound(rows * Sb + 4 * kmers.numel() + 4 * B * 8 * Sb,
                 int(distinct.sum()) * 8 * Sb)


def kmer_rows(kmers) -> str:
    """The rows a batch of k-mer ids holds: distinct over the batch (what
    device memory must give at least once) and distinct in each query
    summed (what the kernel's runs gather), against the ids."""
    import torch

    batch = int(torch.unique(kmers).numel())
    runs = sum(int(torch.unique(row).numel()) for row in kmers)
    return (f"{batch} distinct rows in the batch, {runs} distinct in each query "
            f"summed, {kmers.numel()} ids")


def topk_stages_bound(B: int, S: int, k: int) -> dict:
    """The bound of score_topk's torch top-k stages as one function of
    the kernel's outputs (grouped_top_k's, from GROUPED_MIN_WIDTH padded
    references): the (B, S/8) int32 group maxima read, the eight scores
    of each of the C = min(max(k, 256), S/8) chosen groups read, the
    (B, 2k) int32 [values | ids] written; below that width (a plain
    top-k) the (B, S) scores read."""
    from sina_tpu_torch.ops import kmer_kernel as kk

    out = 4 * B * 2 * k
    if S < kk.GROUPED_MIN_WIDTH:
        return bound(4 * B * S + out)
    C = min(max(k, 256), S // 8)
    return bound(4 * B * (S // 8) + 4 * B * 8 * C + out)


def score_topk_times(P, kmers, phase: str = "phase 3") -> None:
    """score_topk's device time a call on P at k = 256 and 1,000
    (torch.profiler over 10 calls), split into the kernel (its
    pre-pass included) and the torch top-k stages: stage 1 from the
    group maxima the kernel writes (the port's path), and in turns the
    same call whose stage 1 takes amax over the scores (gmax, amax, amax,
    gmax; means over each route's two turns); beside the stages' bound
    (topk_stages_bound) and the kernel's (kmer_bound), and the plain
    version's time (the plain scorer, then the same stages by amax;
    one call, its output equal), and the library call's: one torch.topk
    over the kernel's (B, S) scores (its values equal)."""
    import torch

    from sina_tpu_torch.ops import kmer_kernel as kk

    def with_amax(k):
        return torch.cat(kk.grouped_top_k(kk.kmer_scores(P, kmers), k), dim=1)

    def plain(k):
        scores = kk.kmer_scores_plain(P, kmers)
        if scores.shape[1] >= kk.GROUPED_MIN_WIDTH:
            return torch.cat(kk.grouped_top_k(scores, k), dim=1)
        return torch.cat(kk.top_k_lowest_id(scores, k), dim=1)

    B, S = kmers.shape[0], 8 * P.shape[1]
    kernel_b = kmer_bound(kmers, P.shape[1], P.shape[0] - 1)
    scores = kk.kmer_scores(P, kmers)
    for k in (256, 1000):
        got = kk.score_topk(P, kmers, k)
        if not torch.equal(got, with_amax(k)):
            raise AssertionError(f"score_topk (k={k}) differs with the kernel's group maxima")
        want, plain_ms = time_one(lambda: plain(k))
        if not torch.equal(got, want):
            raise AssertionError(f"score_topk (k={k}) differs from its plain version")
        lib_vals, lib_ids = torch.topk(scores, k, dim=1)
        if not torch.equal(lib_vals, got[:, :k]):
            raise AssertionError(f"torch.topk (k={k}) values differ from score_topk's")
        same_ids = int((lib_ids == got[:, k:]).sum())
        lib_ms = time_ms(lambda: torch.topk(scores, k, dim=1), 10)
        del got, want, lib_vals, lib_ids
        routes = {"gmax": lambda: kk.score_topk(P, kmers, k), "amax": lambda: with_amax(k)}
        times = {name: [] for name in routes}
        for name in ("gmax", "amax", "amax", "gmax"):
            times[name].append(device_split(routes[name], 10))
        mean = {name: np.mean(t, axis=0) for name, t in times.items()}
        stages_b = topk_stages_bound(B, S, k)
        say(f"{phase} score_topk k={k} B={B} Sb={P.shape[1]} (device ms a "
            f"call): group maxima from the kernel: "
            f"kernel {mean['gmax'][0]:.3f} + torch top-k stages {mean['gmax'][1]:.3f} = "
            f"{mean['gmax'].sum():.3f}; stage 1 by amax: kernel {mean['amax'][0]:.3f} + "
            f"stages {mean['amax'][1]:.3f} = {mean['amax'].sum():.3f} (ids equal); bound: "
            f"stages {stages_b['bound_ms']:.4f} ({stages_b['bound_by']}) + kernel "
            f"{kernel_b['bound_ms']:.3f} ({kernel_b['bound_by']}) = "
            f"{stages_b['bound_ms'] + kernel_b['bound_ms']:.3f}; plain {plain_ms:.3f} "
            f"(CUDA events, one call; output equal); library: one torch.topk over the "
            f"{tuple(scores.shape)} scores {lib_ms:.3f} (CUDA events, mean of 10; values "
            f"equal, ids equal at {same_ids} of {B * k} places)")


def device_split(fn, reps: int) -> tuple[float, float]:
    """Device ms a call of fn(), by torch.profiler over `reps` calls: the
    bitpacked scorer's kernels (kmer_runs_kernel, kmer_score_kernel), and
    everything else."""
    _, _, per = device_busy(lambda: [fn() for _ in range(reps)])
    kernel = sum(ms for ms, _, name in per if "kmer_" in name)
    return kernel / reps, (sum(ms for ms, _, _ in per) - kernel) / reps


def traceback_bound(emit, bp_bytes: int) -> dict:
    """A traceback reads at least one backpointer cell for each base
    it emits, the end cells, and writes emit: one step per cell."""
    steps = int((emit >= 0).sum())
    B, M = emit.shape
    return bound(steps * bp_bytes + 8 * B + 4 * B * M, steps)


def phase_dense_kernel(dev, rng) -> dict:
    """The dense int8 scorer on a random {0,1} (4**9+1) x 16,384 matrix:
    exact against its plain version and against the packed kernel on
    the same matrix bitpacked little-endian (bit b of byte j = column
    8j+b); timed beside one embedding_bag call over the matrix as f32
    (its sums stay below 2**24, so f32 is exact)."""
    import torch
    import torch.nn.functional as F

    from sina_tpu_torch.ops import kmer_kernel as kk

    gen = torch.Generator(device=dev).manual_seed(4321)
    P = torch.randint(0, 2, (KMER_ROWS, DENSE_S), dtype=torch.int8,
                      device=dev, generator=gen)
    P[-1] = 0
    km = np.full((B_MAIN, KMER_L), KMER_ROWS - 1, np.int32)
    km[:, :KMER_REAL] = rng.integers(0, KMER_ROWS - 1, (B_MAIN, KMER_REAL))
    kmers = torch.from_numpy(km).to(dev)
    got = kk.kmer_scores(P, kmers)
    ref = kk.kmer_scores_dense_plain(P, kmers)
    err = int((got - ref).abs().max())
    if err != 0 or not torch.equal(got, ref):
        raise AssertionError(f"kmer_score_dense disagrees with its plain version (max |d|={err})")
    Pp = torch.zeros((KMER_ROWS, DENSE_S // 8), dtype=torch.uint8, device=dev)
    P3 = P.view(KMER_ROWS, DENSE_S // 8, 8)
    for j in range(8):
        Pp |= P3[:, :, j].to(torch.uint8) << j
    if not torch.equal(got, kk.kmer_scores(Pp, kmers)):
        raise AssertionError("kmer_score_dense disagrees with the packed kernel "
                             "on the bitpacked matrix")
    del Pp, P3
    ms = time_ms(lambda: kk.kmer_scores(P, kmers), 10)
    plain_ms = time_ms(lambda: kk.kmer_scores_dense_plain(P, kmers), 2)
    Pf, ids = P.float(), kmers.long()
    lib = F.embedding_bag(ids, Pf, mode="sum")
    if not torch.equal(lib, got.float()):
        raise AssertionError("embedding_bag disagrees with the dense scorer")
    library_ms = time_ms(lambda: F.embedding_bag(ids, Pf, mode="sum"), 5)
    rows = int(torch.unique(kmers).numel())
    b = bound(rows * DENSE_S + 4 * kmers.numel() + 4 * B_MAIN * DENSE_S,
              B_MAIN * KMER_L * DENSE_S)
    say(f"phase 3 kmer_score_dense: B={B_MAIN} L={KMER_L} ({KMER_REAL} real) "
        f"S={DENSE_S}, int8 matrix {P.numel()} bytes; exact vs plain and vs the "
        f"packed kernel; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"embedding_bag (f32) {library_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']}; {rows} distinct rows)")
    del P, Pf, lib, got, ref
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def family_graphs(db, seed: int, B: int = B_MAIN, M: int = M_MAIN) -> dict:
    """B family graphs of 40 references of `db` and B full-length
    queries: each query evolves off a reference (seed `seed`), and its
    family is the first 40 members of that reference's ancestor group
    (the relatives a family search returns).  Only queries of the M
    bucket are kept (longer than 1536 for M = 2048, at most 1536 for
    the main path's M = 1536), so the bucket is N = 4096 x M.
    Returns the dense route's operands as CPU tensors (pos, mask,
    weight, preds, is_start, is_end, qmask, qlen, n_real), the
    insertion budgets, the column-weight width and the largest
    predecessor distance."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.ops.graph import build_graphs_batch, pad_graph

    lo = 0 if M <= M_MAIN else M_MAIN
    pool = testing.make_queries(db, n=4 * B_MAIN, seed=seed, branch_len=0.7)
    qs = [q for q in pool if lo < len(q.masks) <= M][:B]
    if len(qs) < B:
        raise AssertionError(f"{len(qs)} of {len(pool)} queries fall in the M = {M} "
                             f"bucket, fewer than {B}")
    fams = []
    for q in qs:
        g0 = db.index_of(q.attrs["parent"]) // 64 * 64
        fams.append(db.sequences[g0:g0 + FAMILY])
    graphs = build_graphs_batch(fams)
    nr = np.asarray([g.n_nodes for g in graphs], np.int32)
    if nr.max() > N_GRAPH:
        raise AssertionError(f"a family graph has {nr.max()} nodes > {N_GRAPH}")
    graphs = [pad_graph(g, N_GRAPH) for g in graphs]
    qm = np.zeros((B, M), np.uint8)
    ql = np.zeros(B, np.int32)
    for b, q in enumerate(qs):
        qm[b, :len(q.masks)] = q.masks
        ql[b] = len(q.masks)
    preds = np.stack([g.preds for g in graphs]).astype(np.int32)
    maxd = int((np.arange(N_GRAPH)[None, :, None] - preds)[preds >= 0].max())
    t = torch.from_numpy

    def stack(key, dtype):
        return t(np.stack([getattr(g, key) for g in graphs]).astype(dtype))

    ops = dict(pos=stack("pos", np.int32), mask=stack("mask", np.uint8),
               weight=stack("weight", np.float32), preds=t(preds),
               is_start=stack("is_start", bool), is_end=stack("is_end", bool),
               qmask=t(qm), qlen=t(ql), n_real=t(nr))
    budget = t(np.stack([np.clip(g.max_insert, 0, 10**6) for g in graphs]).astype(np.int32))
    say(f"phase 3 graph bucket ({len(db)} references, width {db.width}): {B} graphs "
        f"of {nr.min()}-{nr.max()} nodes padded to {N_GRAPH}, queries of "
        f"{ql.min()}-{ql.max()} nt in M={M}, largest predecessor distance {maxd}")
    return dict(ops=ops, budget=budget, width=graphs[0].width + 2, maxd=maxd)


def graph_bucket():
    """The graph kernels' bucket: family_graphs of a 3,000-reference,
    width-50,000 generated alignment.  Returns the graph kernel's CPU
    tensors (pos, mask, weight, predbits, flags, qmask, qlen), the
    insertion budgets, the ring depth, the column-weight width and the
    dense route's operands (family_graphs')."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import graph_kernel as gk

    db = testing.make_reference_large(3000, n_core=1450, width=WIDTH, seed=1234)
    fg = family_graphs(db, seed=5)
    d = fg["ops"]
    mask_u8, predbits, flags = gk.pack_graph_host(
        d["mask"].numpy(), d["preds"].numpy(), d["is_start"].numpy(),
        d["is_end"].numpy(), d["n_real"].numpy())
    t = torch.from_numpy
    ops = (d["pos"], t(mask_u8), d["weight"], t(predbits), t(flags), d["qmask"], d["qlen"])
    return ops, fg["budget"], gk.pick_k_ring(fg["maxd"]), fg["width"], d


def phase_graph_kernels(dev) -> dict:
    """The graph DP and its traceback against their plain versions on
    the card, at the main path's shapes, in four modes: bp, best_j,
    best_i, raw, emit and the walks' completion must match exactly.
    In the simple mode the dense route's kernels (for buckets with a
    predecessor 32 or more nodes back) run on the same bucket: exact
    against their plain versions, and equal to the graph kernels' in
    emit, best_j, best_i and raw."""
    import torch

    from sina_tpu_torch.ops import graph_kernel as gk
    from sina_tpu_torch.ops.align_kernel import DpParams

    ops, budget, k_ring, width, dense = graph_bucket()
    ops = [a.to(dev) for a in ops]
    dense = {k: a.to(dev) for k, a in dense.items()}
    flags = ops[4]
    rng = np.random.default_rng(99)
    ones = torch.ones((B_MAIN, width), dtype=torch.float32, device=dev)
    rand_cw = torch.from_numpy(
        rng.uniform(0.5, 2.0, (B_MAIN, width)).astype(np.float32)).to(dev)
    subst = torch.from_numpy(
        rng.uniform(-2, 2, (B_MAIN, 4, 4)).astype(np.float32)).to(dev)
    modes = {
        "simple": (ones, None, None),
        "weighted": (rand_cw, None, None),
        "aspace": (ones, budget.to(dev), None),
        "matrix": (rand_cw, None, subst),
    }
    params = DpParams()
    out = {}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for mode, (cw, max_ins, sm) in modes.items():
        def kernel(k=k_ring):
            return gk.graph_dp(*ops, cw, max_ins, sm, params=params, k_ring=k)

        got = kernel()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = gk.graph_dp_plain(*ops, cw, max_ins, sm, params=params, k_ring=k_ring)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        for n, a, b in zip(("bp", "best_j", "best_i", "raw"), got, ref):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"graph_dp ({mode}) {n} disagrees with its "
                                     f"plain version ({bad} cells)")
        emit, done = gk.graph_traceback(*got[:3], flags)
        steps = np.zeros(B_MAIN, np.int64)
        t0 = time.perf_counter()
        emit_ref, done_ref = gk.graph_traceback_plain(*ref[:3], flags, steps=steps)
        tb_plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(emit, emit_ref) and torch.equal(done, done_ref)):
            raise AssertionError(f"graph_traceback ({mode}) disagrees with its plain version")
        if int(done.min()) != 1:
            raise AssertionError(f"graph_traceback ({mode}): a walk did not finish")
        aligned = int((emit >= 0).sum(dim=1).min())
        ms = time_ms(kernel, DP_REPS)
        def walk():
            return gk.graph_traceback(*got[:3], flags)

        tb_ms = time_ms(walk, TB_REPS)
        before = BEFORE_MS[f"graph_dp {mode}"]
        say(f"phase 3 graph_dp {mode}: B={B_MAIN} N={N_GRAPH} M={M_MAIN} "
            f"K={k_ring} bp/best_j/best_i/raw exact; kernel {ms:.3f} ms (PR 3, "
            f"other run: {before:.3f} ms, {ms / before:.3f}x), plain "
            f"{plain_ms:.3f} ms; launch plan "
            f"{gk.graph_dp_plan(M_MAIN, k_ring, max_ins is not None)}")
        tb_before = BEFORE_MS["graph_traceback"]
        say(f"phase 3 graph_traceback {mode}: emit exact (fewest bases "
            f"emitted in a row: {aligned}); kernel {tb_ms:.3f} ms (before the "
            f"redesign, other run, simple: {tb_before:.3f} ms, "
            f"{tb_ms / tb_before:.3f}x), plain (host walk) {tb_plain_ms:.3f} ms")
        traceback_walk_times(f"graph_traceback {mode}", walk, tb_ms, steps,
                             gk.graph_traceback_plan(got[0]), flush)
        if mode == "simple":
            phase_global_ring(kernel, ref, k_ring)
            phase_dense_route(dense, cw, got, emit, params, k_ring - 1, ms)
            # the node and query planes, the column weights, the uint16
            # bp plane and the end cells; the instructions of each
            # query's cells (its graph's real nodes x its length), of
            # the predecessors each node probes, of its real nodes and
            # of its end nodes' cells
            n_real, qlen, predbits = dense["n_real"].long(), ops[6].long(), ops[3]
            cells = int((n_real * qlen).sum())
            real = torch.arange(N_GRAPH, device=dev)[None, :] < n_real[:, None]
            npred = torch.zeros_like(predbits, dtype=torch.int64)
            for d in range(32):
                npred += (predbits >> d) & 1
            pred_cells = int(((npred * real).sum(dim=1) * qlen).sum())
            n_end = (((flags & 6) == 6) & real).sum(dim=1)
            counts = (cells, pred_cells, int(n_real.sum()), int((n_end * qlen).sum()))
            per = (GRAPH_INSTS_PER_CELL, GRAPH_INSTS_PER_PRED_CELL,
                   GRAPH_INSTS_PER_NODE, GRAPH_INSTS_PER_END_CELL)
            insts = tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))
            b = bound(sum(t.numel() * t.element_size() for t in (*ops, cw))
                      + got[0].numel() * got[0].element_size() + 12 * B_MAIN,
                      insts=insts)
            out["graph_dp"] = {"max_abs_err": float((got[3] - ref[3]).abs().max()),
                               "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
            tb = traceback_bound(emit, 2)
            out["graph_traceback"] = {"max_abs_err": int((emit - emit_ref).abs().max()),
                                      "ms": tb_ms, "plain_ms": tb_plain_ms, **tb,
                                      "library_ms": None}
            say(f"phase 3 graph bounds (simple): graph_dp {b['bound_ms']:.3f} ms "
                f"({b['bound_by']}; {cells} cells, {pred_cells} predecessor probes, "
                f"{insts[0]} instructions, {insts[1]} integer), "
                f"graph_traceback {tb['bound_ms']:.5f} ms ({tb['bound_by']})")
        del got, ref, emit, emit_ref
        torch.cuda.empty_cache()
    return out


def phase_global_ring(kernel, ref, k_ring) -> None:
    """The graph DP's global-ring route on the main path's bucket: a
    ring one slot deeper than shared memory holds (any depth above the
    largest predecessor distance gives the same result) puts it in the
    per-query global scratch; it must equal the plain version and be
    counted as that route."""
    import torch

    from sina_tpu_torch.ops import graph_kernel as gk
    from sina_tpu_torch.ops import kernels

    depth = gk.graph_dp_plan(M_MAIN, k_ring, False)["max_shared_ring"] + 1
    if depth > gk.MAX_DIST:
        raise AssertionError(f"a ring of {depth - 1} slots fits shared memory: "
                             "no global-ring route at the main path's bucket")
    before = kernels.launches["graph_dp_global_ring"]
    got = kernel(k=depth)
    if kernels.launches["graph_dp_global_ring"] != before + 1:
        raise AssertionError("graph_dp at a deep ring did not take the global-ring route")
    for n, a, b in zip(("bp", "best_j", "best_i", "raw"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"graph_dp (global ring) {n} disagrees with its plain version")
    del got
    ms = time_ms(lambda: kernel(k=depth), DP_REPS)
    say(f"phase 3 graph_dp global-ring route simple: K={depth} (shared memory "
        f"holds {depth - 1}) exact; kernel {ms:.3f} ms; launch plan "
        f"{gk.graph_dp_plan(M_MAIN, depth, False)}")


def dense_check(name: str, d: dict, cw, max_ins, subst, params, maxd: int,
                timed: bool = False) -> dict:
    """The dense route's DP and walk kernels on the card operands `d`
    against their plain versions (also on the card): bp, best_j,
    best_i, raw, emit and done must be equal, and every walk must end.
    Returns the kernels' outputs (got, emit) and the plain versions'
    ms (one run each); with `timed` also each kernel's ms a launch
    (mean of DP_REPS and TB_REPS launches) and the walk's one launch
    alone after an L2 flush."""
    import torch

    from sina_tpu_torch.ops import align_kernel as ak

    args = (d["pos"], d["mask"], d["weight"], d["preds"], d["is_start"], d["is_end"],
            d["qmask"], d["qlen"], d["n_real"], cw, params)

    def dp():
        return ak.graph_dp_dense(*args, max_insert=max_ins, subst=subst, maxd=maxd)

    got = dp()

    def walk():
        return ak.graph_traceback_dense(*got[:3], d["preds"], d["is_start"])

    emit, done = walk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ak.poa_dp_dense(*args, max_insert=max_ins, subst=subst)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emit_ref, done_ref = ak.traceback_dense(*ref[:3], d["preds"], d["is_start"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for n, a, b in zip(("bp", "best_j", "best_i", "raw", "emit", "done"),
                       (*got, emit, done), (*ref, emit_ref, done_ref)):
        if not torch.equal(a, b):
            raise AssertionError(f"dense route {name}: {n} disagrees with its plain "
                                 f"version ({int((a != b).sum())} cells)")
    if int(done.min()) != 1:
        raise AssertionError(f"dense route {name}: a walk did not finish")
    out = dict(got=got, emit=emit, max_abs_err=float((got[3] - ref[3]).abs().max()),
               emit_err=int((emit - emit_ref).abs().max()),
               plain_dp_ms=1e3 * (t1 - t0), plain_tb_ms=1e3 * (t2 - t1))
    del ref
    if timed:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=cw.device)
        out["dp_ms"] = time_ms(dp, DP_REPS)
        out["tb_ms"] = time_ms(walk, TB_REPS)
        out["tb_cold_ms"] = time_launch_ms(walk, TB_REPS, flush)
    return out


def phase_dense_route(dense, cw, got, emit, params, maxd: int, graph_ms: float) -> None:
    """The dense route's kernels on the graph kernels' bucket (largest
    predecessor distance below 32, so the dispatcher sends it to the
    graph kernels, whose results any core must give): exact against
    their plain versions, and emit, best_j, best_i and raw equal to the
    graph kernels'; the dense DP's time beside graph_dp's from this run
    (`graph_ms`)."""
    import torch

    from sina_tpu_torch.ops import align_kernel as ak

    r = dense_check("on the graph kernels' bucket", dense, cw, None, None, params, maxd,
                    timed=True)
    dgot = r["got"]
    for n, a, b in (("emit", r["emit"], emit), ("best_j", dgot[1].int(), got[1]),
                    ("best_i", dgot[2].int(), got[2]), ("raw", dgot[3], got[3])):
        if not torch.equal(a, b):
            raise AssertionError(f"dense route {n} differs from the graph kernels' "
                                 f"({int((a != b).sum())} cells)")
    say(f"phase 3 graph dense route simple: the graph kernels' bucket (maxd {maxd}), "
        f"bp/best_j/best_i/raw/emit/done exact against the plain versions, "
        f"emit/best_j/best_i/raw equal to the graph kernels'; graph_dp_dense "
        f"{r['dp_ms']:.3f} ms ({r['dp_ms'] / graph_ms:.3f}x graph_dp's {graph_ms:.3f} ms "
        f"in this run), graph_traceback_dense {r['tb_ms']:.3f} ms; plain "
        f"poa_dp_dense {r['plain_dp_ms']:.3f} ms, traceback_dense "
        f"{r['plain_tb_ms']:.3f} ms (one run); launch plan "
        f"{ak.graph_dp_dense_plan(M_MAIN, False, maxd, cw.device)}")


# the dense route's modes (tests/test_torch_graph_dense.py CASES): random
# column weights, insertion budgets, a random substitution matrix
DENSE_MODES = {
    "simple": (False, False, False), "weighted": (True, False, False),
    "forbid": (False, True, False), "subst": (False, False, True),
    "subst_forbid": (True, True, True),
}
# the batch the modes other than simple and forbid run at (their plain
# versions take seconds a mode)
DENSE_SMALL_B = 32


def phase_dense_kernels(dev, ddb) -> dict:
    """The dense route's kernels on a bucket that takes the route: 128
    family graphs of phase 18's reference (one reference in 20 carries
    a 48-base insertion, so each family holds two such members) and 128
    full-length queries, N = 4096, M = 1536: in the simple and forbid
    modes at B = 128, timed, with launch plans and (simple) the bound;
    all five modes at B = 32; each exact against the plain versions."""
    import torch

    from sina_tpu_torch.ops import align_kernel as ak
    from sina_tpu_torch.ops.align_kernel import DpParams

    fg = family_graphs(ddb, seed=37)
    maxd = fg["maxd"]
    if maxd < 32:
        raise AssertionError(f"phase 18's families give a largest predecessor distance "
                             f"of {maxd}: the bucket does not take the dense route")
    d = {k: a.to(dev) for k, a in fg["ops"].items()}
    rng = np.random.default_rng(101)
    width = fg["width"]
    rand_cw = torch.from_numpy(rng.uniform(0.5, 2.0, (B_MAIN, width)).astype(np.float32)).to(dev)
    ones = torch.ones((B_MAIN, width), dtype=torch.float32, device=dev)
    subst = torch.from_numpy(rng.uniform(-2, 2, (B_MAIN, 4, 4)).astype(np.float32)).to(dev)
    budget = fg["budget"].to(dev)

    def inputs(mode: str, B: int):
        weights, forbid, matrix = DENSE_MODES[mode]
        return ((rand_cw if weights else ones)[:B], budget[:B] if forbid else None,
                subst[:B] if matrix else None)

    params = DpParams()
    out = {}
    for mode in ("simple", "forbid"):
        cw, max_ins, sm = inputs(mode, B_MAIN)
        r = dense_check(f"{mode} B={B_MAIN}", d, cw, max_ins, sm, params, maxd, timed=True)
        plan = ak.graph_dp_dense_plan(M_MAIN, max_ins is not None, maxd, dev)
        scratch_mb = B_MAIN * plan["scratch_rows"] * plan["ring_row"] * 4 / 2**20
        aligned = int((r["emit"] >= 0).sum(dim=1).min())
        before = BEFORE_MS[f"graph_dp_dense {mode}"]
        tb_before = BEFORE_MS["graph_traceback_dense"]
        say(f"phase 3 graph_dp_dense {mode}: B={B_MAIN} N={N_GRAPH} M={M_MAIN} maxd={maxd} "
            f"({plan['shared_rows']} rows a query in shared memory, a scratch of "
            f"{plan['scratch_rows']} rows a query, {scratch_mb:.1f} MB) bp/best_j/best_i/raw "
            f"exact; kernel {r['dp_ms']:.3f} ms (before the redesign, other run: "
            f"{before:.3f} ms, {r['dp_ms'] / before:.3f}x), plain {r['plain_dp_ms']:.3f} ms "
            f"(one run); launch plan {plan}")
        say(f"phase 3 graph_traceback_dense {mode}: emit/done exact (fewest bases emitted "
            f"in a row: {aligned}); kernel {r['tb_ms']:.3f} ms warm ({TB_REPS} launches "
            f"on one plane; before the redesign, other run: {tb_before:.3f} ms, "
            f"{r['tb_ms'] / tb_before:.3f}x), {r['tb_cold_ms']:.3f} ms one launch alone "
            f"cold (L2 flushed by writing {FLUSH_BYTES >> 20} MB before it); plain "
            f"{r['plain_tb_ms']:.3f} ms (one run); launch plan "
            f"{ak.graph_traceback_dense_plan(r['got'][0])}")
        if mode != "simple":
            continue
        # the operands, the uint16 bp plane and the end cells (best_j
        # and best_i int64, raw f32); the instructions of each query's
        # cells (its graph's real nodes x its length), of the
        # predecessor slots its real nodes probe, of its real nodes and
        # of its end nodes' cells
        n_real, qlen = d["n_real"].long(), d["qlen"].long()
        real = torch.arange(N_GRAPH, device=dev)[None, :] < n_real[:, None]
        npred = (d["preds"] >= 0).sum(dim=2)
        n_end = (d["is_end"] & real).sum(dim=1)
        counts = (int((n_real * qlen).sum()), int(((npred * real).sum(dim=1) * qlen).sum()),
                  int(n_real.sum()), int((n_end * qlen).sum()))
        per = (DENSE_INSTS_PER_CELL, GRAPH_INSTS_PER_PRED_CELL, GRAPH_INSTS_PER_NODE,
               GRAPH_INSTS_PER_END_CELL)
        insts = tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))
        bp = r["got"][0]
        b = bound(sum(t.numel() * t.element_size() for t in (*d.values(), cw))
                  + bp.numel() * bp.element_size() + 20 * B_MAIN, insts=insts)
        tb = traceback_bound(r["emit"], 2)
        out["graph_dp_dense"] = {"max_abs_err": r["max_abs_err"], "ms": r["dp_ms"],
                                 "plain_ms": r["plain_dp_ms"], **b, "library_ms": None}
        out["graph_traceback_dense"] = {
            "max_abs_err": r["emit_err"], "ms": r["tb_ms"],
            "plain_ms": r["plain_tb_ms"], **tb, "library_ms": None}
        say(f"phase 3 graph dense bounds (simple): graph_dp_dense {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}; {counts[0]} cells, {counts[1]} predecessor probes, "
            f"{insts[0]} instructions, {insts[1]} integer; the bp plane alone "
            f"{1e3 * bp.numel() * 2 / HBM_BYTES_PER_S:.3f} ms), graph_traceback_dense "
            f"{tb['bound_ms']:.5f} ms ({tb['bound_by']})")
        del r, bp
        torch.cuda.empty_cache()
    small = {k: a[:DENSE_SMALL_B] for k, a in d.items()}
    times = []
    for mode in DENSE_MODES:
        r = dense_check(f"{mode} B={DENSE_SMALL_B}", small, *inputs(mode, DENSE_SMALL_B),
                        params, maxd)
        times.append(f"{mode} {r['plain_dp_ms'] + r['plain_tb_ms']:.0f}")
    say(f"phase 3 graph dense route, five modes at B={DENSE_SMALL_B} (N={N_GRAPH}, "
        f"M={M_MAIN}, maxd {maxd}): bp/best_j/best_i/raw/emit/done exact in each; plain "
        f"versions' ms (one run) {', '.join(times)}")
    del d, small
    torch.cuda.empty_cache()
    phase_dense_long(dev, ddb)
    return out


def phase_dense_long(dev, ddb) -> None:
    """The dense route's kernels on the graph engine's longer bucket:
    32 family graphs of phase 18's reference and 32 queries longer than
    1536, N = 4096, M = 2048, in the simple and forbid modes, exact
    against the plain versions.  At M = 2048 the DP runs 4 lanes a
    thread in 512 threads, its largest block, with every warp's slot of
    the block scan and of the end-cell reduction in use."""
    import torch

    from sina_tpu_torch.ops import align_kernel as ak
    from sina_tpu_torch.ops.align_kernel import DpParams

    fg = family_graphs(ddb, seed=43, B=DENSE_SMALL_B, M=M_LONG)
    maxd = fg["maxd"]
    if maxd < 32:
        raise AssertionError(f"the M = {M_LONG} bucket's largest predecessor distance is "
                             f"{maxd}: it does not take the dense route")
    d = {k: a.to(dev) for k, a in fg["ops"].items()}
    cw = torch.ones((DENSE_SMALL_B, fg["width"]), dtype=torch.float32, device=dev)
    params = DpParams()
    times = []
    for mode, max_ins in (("simple", None), ("forbid", fg["budget"].to(dev))):
        plan = ak.graph_dp_dense_plan(M_LONG, max_ins is not None, maxd, dev)
        if (plan["lanes"], plan["threads"]) != (4, 512):
            raise AssertionError(f"graph_dp_dense at M = {M_LONG}: plan {plan}, not 4 lanes "
                                 f"in 512 threads")
        r = dense_check(f"{mode} B={DENSE_SMALL_B} M={M_LONG}", d, cw, max_ins, None, params,
                        maxd, timed=True)
        times.append(f"{mode}: graph_dp_dense {r['dp_ms']:.3f} ms, graph_traceback_dense "
                     f"{r['tb_ms']:.3f} ms, plain {r['plain_dp_ms']:.0f} + "
                     f"{r['plain_tb_ms']:.0f} ms (one run), plan {plan}")
        del r
    say(f"phase 3 graph dense route, the longer bucket: B={DENSE_SMALL_B} N={N_GRAPH} "
        f"M={M_LONG} maxd={maxd}, queries of {int(d['qlen'].min())}-{int(d['qlen'].max())} "
        f"nt; bp/best_j/best_i/raw/emit/done exact in simple and forbid mode; "
        f"{'; '.join(times)}")
    del d
    torch.cuda.empty_cache()


_STAMP = re.compile(r"aligned_slv=\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")


def fasta_text(records, path: Path) -> str:
    """The records as the FASTA writer writes them (--meta-fmt
    comment), with the wall-clock `aligned_slv` stamps masked."""
    from sina_tpu_torch.io.fasta import FastaWriter

    with FastaWriter(str(path), meta="comment") as w:
        for r in records:
            w.write_result(r, [])
    return _STAMP.sub("aligned_slv=T", path.read_text())


def check_records(path: Path, queries, width: int, attrs=()) -> int:
    """Every written record has the reference width, strictly
    increasing columns, exactly its query's bases (in the orientation
    its turn_slv reports) and each of the attributes `attrs`; returns
    the record count."""
    from sina_tpu_torch.io.fasta import read_fasta

    by_name = {q.name: q for q in queries}
    n = 0
    for rec in read_fasta(str(path)):
        q = turned(by_name[rec.name].copy(), rec.get_attr("turn_slv", ""))
        if rec.width != width:
            raise AssertionError(f"{rec.name}: width {rec.width} != {width}")
        if rec.get_bases().upper() != q.get_bases().upper():
            raise AssertionError(f"{rec.name}: query bases not preserved")
        if not np.all(np.diff(rec.positions.astype(np.int64)) > 0):
            raise AssertionError(f"{rec.name}: columns not increasing")
        missing = [a for a in attrs if rec.get_attr(a) is None]
        if missing:
            raise AssertionError(f"{rec.name}: no {missing}")
        n += 1
    return n


def turned(seq, turn_slv: str):
    """`seq` turned as a record's `turn_slv` says the finder turned it."""
    if turn_slv in ("reversed", "reversed and complemented"):
        seq.reverse()
    if turn_slv in ("complemented", "reversed and complemented"):
        seq.complement()
    return seq


def phase_cli(tmp: Path) -> None:
    """The normal entry point on a small generated reference (the
    verify fixture: 150 refs, width 800, 10 queries), in a working
    directory of its own (the --debug-lattice dumps land there)."""
    from sina_tpu_torch import cli, testing
    from sina_tpu_torch.io.fasta import FastaWriter

    db = testing.make_reference(n_seqs=150, n_core=500, width=800, seed=42)
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=10, seed=7, branch_len=0.6)]
    ref, qin, out = tmp / "ref.fasta", tmp / "q.fasta", tmp / "out.fasta"
    with FastaWriter(str(ref), meta="comment") as w:
        for s in db.sequences:
            w.write(s)
    with FastaWriter(str(qin)) as w:
        for q in queries:
            w.write(q)
    wd, trace = tmp / "cli", tmp / "trace"
    wd.mkdir()
    plain_fasta = None
    for extra, attrs in (
            ([], ()), (["--fs-graph"], ()),
            (["--fs-graph", "--insertion", "forbid"], ()),
            (["--insertion", "forbid"], ()),
            (["--fs-no-graph", "--insertion", "forbid"], ()),
            (["--use-subst-matrix"], ()),
            (["--turn"], ("turn_slv",)), (["--turn", "all"], ("turn_slv",)),
            (["-S", "--lca-fields", "tax_slv"], ("nearest_slv", "lca_tax_slv")),
            (["--debug-lattice", "0:20"], ()),
            (["--jax-profile-dir", str(trace)], ())):
        t0 = time.perf_counter()
        with contextlib.chdir(wd):
            rc = cli.main(["-i", str(qin), "-r", str(ref), "-o", str(out),
                           "--fs-min", "10", "--fs-max", "10", "--fs-full-len",
                           "400", "--fs-req-gaps", "1", "--meta-fmt", "comment",
                           "--device", "cuda", "-q", *extra])
        if rc != 0:
            raise AssertionError(f"cli.main {extra} exited {rc}")
        n = check_records(out, queries, db.width, attrs)
        if n != len(queries):
            raise AssertionError(f"cli {extra} wrote {n} of {len(queries)} records")
        note = ""
        text = _STAMP.sub("aligned_slv=T", out.read_text())
        if not extra:
            plain_fasta = text
        elif extra[0] == "--debug-lattice":
            dots = sorted(wd.glob("lattice_*.dot"))
            if len(dots) != len(queries) or not all(
                    d.read_text().startswith("digraph") for d in dots):
                raise AssertionError(f"--debug-lattice wrote {len(dots)} lattice dumps for "
                                     f"{len(queries)} queries")
            note = f"; {len(dots)} lattice_<name>.dot dumps written"
        elif extra[0] == "--jax-profile-dir":
            traces = [f for f in trace.rglob("*") if f.is_file() and f.stat().st_size]
            if not traces:
                raise AssertionError("--jax-profile-dir wrote no trace")
            if text != plain_fasta:
                raise AssertionError("--jax-profile-dir changed the FASTA output")
            note = (f"; trace {traces[0].name} ({traces[0].stat().st_size} bytes), "
                    "FASTA equal to the run without it")
        say(f"phase 4 cli {' '.join(extra) or '(profile engine)'}: rc=0, "
            f"{n}/{len(queries)} records of width {db.width} with their "
            f"query bases{note} ({time.perf_counter() - t0:.2f}s)")


def _run_batches(finder, batches, acfg, device, searcher=None):
    """The 3-deep software pipeline of sina_tpu_torch.pipeline over
    query batches: famfinder scoring for batch N+1 is queued before
    batch N's alignment is dispatched, batch N-1 finalizes after (with
    the turn check, submit_batch returns None and process_batch scores
    eagerly).  With a searcher, each finalized batch is searched, in
    the pipeline's `search` section."""
    from collections import deque

    from sina_tpu_torch.align import align_dispatch, align_finalize
    from sina_tpu_torch.timing import get_timer

    def finalize(state):
        aligned = align_finalize(state)
        if searcher is not None:
            with get_timer("Pipeline").section("search"):
                aligned = searcher.process_batch(aligned)
        return aligned

    out = []
    handles = [finder.submit_batch(batches[0])]
    pending = deque()
    for i, batch in enumerate(batches):
        if i + 1 < len(batches):
            handles.append(finder.submit_batch(batches[i + 1]))
        results = finder.process_batch(batch, handle=handles[i])
        handles[i] = None
        pending.append(align_dispatch(
            batch, [r.family if not r.failed else [] for r in results],
            acfg, device=device))
        if len(pending) >= 2:
            out.extend(finalize(pending.popleft()))
    while pending:
        out.extend(finalize(pending.popleft()))
    return out


def device_busy(fn) -> tuple[float, float, list]:
    """Run fn() under torch.profiler (device activity only): returns
    (device busy ms, wall ms, [(ms, calls, name)] largest first).  The
    busy ms are the union of the device activities' intervals over all
    streams: the copies to the host run on a copy stream beside the
    compute stream's kernels (ops/transfer), so the per-name ms, each a
    name's own sum, may add up to more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if per and not spans:
        raise AssertionError("torch.profiler gave device times but no device intervals")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3, wall, per


def gc_line(phase: str, got: dict) -> None:
    say(f"{phase} garbage collections in the timed batches (runs, host ms): "
        + "; ".join(f"generation {g} {n}, {1e3 * t:.1f}" for g, (n, t) in got.items()))


def report_busy(phase: str, busy: float, wall: float, per: list) -> None:
    """Print a device_busy result: the busy share, the eight largest
    names and the copies (each kind's device ms and count)."""
    if not per:
        say(f"{phase} device busy: not measured (the profiler recorded no device activity)")
        return
    say(f"{phase} device busy: {busy:.3f} ms of {wall:.3f} ms wall "
        f"({100 * busy / wall:.2f}%, torch.profiler, second pass; the union of the "
        f"compute and copy streams' intervals)")
    for ms, _, name in per[:8]:
        say(f"  device {ms:9.3f} ms  {name[:90]}")
    copies = [(ms, n, name) for ms, n, name in per if name.startswith("Memcpy")]
    say(f"{phase} copies (device ms, count): "
        + ("; ".join(f"{name} {ms:.3f} ({n})" for ms, n, name in copies) or "none"))


def report_transfers(phase: str, batches: int) -> None:
    """Print the transfer counts of the steady run just made (counted
    from its start) and the host ms a batch of the upload and fetch
    sections: the profile wire's upload (ProfileDP h2d), famfinder's
    and the aligner's fetches."""
    from sina_tpu_torch.ops import transfer
    from sina_tpu_torch.timing import get_timer

    parts = []
    for timer, section in (("ProfileDP", "h2d"), ("Kmer Search", "fetch topk"),
                           ("Aligner", "profile dp fetch"), ("GraphDP", "fetch")):
        t = get_timer(timer)
        if t.counts.get(section):
            parts.append(f"{timer} {section} {1e3 * t.sections[section] / batches:.3f} ms "
                         f"({t.counts[section]} calls)")
    say(f"{phase} transfers: {transfer.counts['h2d']} host-to-device and "
        f"{transfer.counts['d2h']} device-to-host copies in {batches} steady batches; "
        f"host ms a batch: {'; '.join(parts)}; pinned pool {transfer.pool_bytes()} bytes")


def make_db():
    """Phase 5's reference (450,000 references at width 50,000), made
    once before phase 3 (whose forbid check takes real families from
    it); returns it with the seconds it took."""
    from sina_tpu_torch import testing

    t0 = time.perf_counter()
    db = testing.make_reference_large(N_REFS, n_core=1450, width=WIDTH, seed=1234)
    return db, time.perf_counter() - t0


def phase_main_path(dev, tmp: Path, db, t_db: float) -> tuple[dict, list, list, object, object]:
    """640 full-length queries in five batches of 128 (the first one
    warms up) against phase 5's reference."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig
    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import _registry, reset_all

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=N_QUERIES, seed=7, branch_len=0.7)]
    pristine = [testing.unaligned_copy(q) for q in queries[:16]]
    t_gen = time.perf_counter() - t0 + t_db
    t0 = time.perf_counter()
    finder = FamFinder(db, FamFinderConfig(
        fs_min=40, fs_max=40, fs_full_len=min(1400, 1450 - 100),
        fs_req_gaps=1), dev)
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    finder.index.dense_packed()
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = finder._matrix()
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    t_setup = t_gen + t_index + t_fill + t_upload
    say(f"phase 5 setup: {t_setup:.1f}s: generate {t_gen:.1f}s (the reference {t_db:.1f}s, "
        f"{len(db)} references at width {db.width}), index build {t_index:.1f}s "
        f"({finder.index.seq_kmers.size} postings), dense_packed fill {t_fill:.1f}s, "
        f"upload {t_upload:.1f}s ({P.numel() / t_upload / 1e9:.2f} GB/s, pageable)")
    say(f"phase 5 index: {tuple(P.shape)} uint8 = {P.numel()} bytes on the card "
        f"({8 * P.shape[1]} padded references)")
    say(f"phase 5 {host_memory()}")
    say(f"phase 5 torch.cuda.max_memory_allocated() after the upload: "
        f"{torch.cuda.max_memory_allocated()} bytes")

    acfg = AlignerConfig()
    batches = [queries[i:i + B_MAIN] for i in range(0, N_QUERIES, B_MAIN)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    aligned = _run_batches(finder, batches[:1], acfg, dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    reset_all()
    transfer.reset_counts()
    t0 = time.perf_counter()
    with first_scored_ids() as real_kmers, gc_pauses() as gcs:
        aligned += _run_batches(finder, batches[1:], acfg, dev)
        torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    gc_line("phase 5", gcs)
    report_transfers("phase 5", len(batches) - 1)
    launches = dict(kernels.launches)
    n_steady = N_QUERIES - B_MAIN
    rate = n_steady / t_steady
    for name, t in _registry.items():
        say(f"  timings {name}: {t}")

    out = tmp / "main.fasta"
    fasta_text([a for a in aligned if a is not None], out)
    n_ok = check_records(out, queries, WIDTH)
    if n_ok < 0.95 * N_QUERIES:
        raise AssertionError(f"only {n_ok} of {N_QUERIES} queries aligned")
    missing = [k for k in PROFILE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    say(f"phase 5 main path: {n_ok}/{N_QUERIES} aligned, width {WIDTH}, "
        f"bases preserved; warmup batch {t_warm:.2f}s; steady "
        f"{n_steady} seqs in {t_steady:.3f}s = {rate:.2f} seq/s on "
        f"{gpu_line()}; launches {launches}")
    # the same steady batches again, profiled, for the device's share
    busy, wall, per = device_busy(
        lambda: _run_batches(finder, batches[1:], acfg, dev))
    report_busy("phase 5", busy, wall, per)
    peak_memory("phase 5")
    real_batch_scorer(P, real_kmers[0])
    return launches, aligned[:16], pristine, finder, real_kmers[0]


@contextlib.contextmanager
def first_scored_ids():
    """While open, keeps (in the list it yields) the k-mer ids that
    famfinder passes to its first call of score_topk: those of the
    first batch the main path scores, as the main path built them."""
    from sina_tpu_torch import famfinder

    seen = []
    score_topk = famfinder._score_topk_device

    def recording(P, kmers, k):
        if not seen:
            seen.append(kmers)
        return score_topk(P, kmers, k)

    famfinder._score_topk_device = recording
    try:
        yield seen
    finally:
        famfinder._score_topk_device = score_topk
    if not seen:
        raise AssertionError("the main path never called score_topk")


def real_batch_scorer(P, kmers, phase: str = "phase 5") -> dict:
    """The scorer on the ids of one steady batch of a path: scores and
    group maxima exact against their plain versions, its rows, its bound
    and its time: 10 launches back to back (CUDA events; the wrapper's
    host time shows where it is the longer), their kernels' own device
    time a launch (torch.profiler, over the launches it recorded), and
    one launch alone with L2 flushed before it, as a
    new batch of the path finds it (CUDA events, 10 launches), which the
    bound's rate takes; beside the plain version's time; then
    score_topk's stages on the same ids.  Returns the kernel line's
    numbers (ms: the cold launch)."""
    import torch

    from sina_tpu_torch.ops import kmer_kernel as kk

    got, gmax = kk.kmer_scores(P, kmers, gmax=True)
    want = kk.kmer_scores_plain(P, kmers)
    if not (torch.equal(got, want) and torch.equal(gmax, kk.group_max_plain(want))):
        raise AssertionError(f"{phase}: kmer_score disagrees with its plain versions on a "
                             "real batch")
    del got, gmax, want
    def fn():
        return kk.kmer_scores(P, kmers)

    ms = time_ms(fn, 10)
    # the scoring kernel's own device time a launch, over the launches the
    # profiler recorded (on the card it has recorded fewer than ran)
    _, _, per = device_busy(lambda: [fn() for _ in range(10)])
    seen = [(t, n) for t, n, name in per if "kmer_score_kernel" in name]
    recorded = sum(n for _, n in seen)
    device_ms = sum(t for t, _ in seen) / max(recorded, 1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=P.device)
    cold = time_launch_ms(fn, 10, flush)
    del flush
    plain_ms = time_ms(lambda: kk.kmer_scores_plain(P, kmers), 1)
    sink = P.shape[0] - 1
    b = kmer_bound(kmers, P.shape[1], sink)
    real = float((kmers != sink).sum(dim=1).float().mean())
    say(f"{phase} kmer_score on one steady batch's ids: B={kmers.shape[0]} "
        f"L={kmers.shape[1]} ({real:.1f} real ids a query on average), Sb={P.shape[1]}; "
        f"scores and group maxima exact; {kmer_rows(kmers)}; back to back {ms:.3f} ms a "
        f"launch (the kernel's device time {device_ms:.3f} ms a launch over the "
        f"{recorded} of 10 the profiler recorded), one launch alone cold {cold:.3f} ms; "
        f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}; the "
        f"scores' write alone {1e3 * 4 * 8 * P.shape[1] * kmers.shape[0] / HBM_BYTES_PER_S:.3f} "
        f"ms), {b['bound_ms'] / cold:.3f} of the bound's rate cold; launch plan "
        f"{kk.kmer_score_plan(P)} on {gpu_line()}")
    score_topk_times(P, kmers, phase)
    return {"max_abs_err": 0, "ms": cold, "plain_ms": plain_ms, **b, "library_ms": None}


def phase_cpu_parity(finder, gpu_records, queries, tmp: Path, acfg,
                     phase: str, search_cfg=None) -> None:
    """The given queries (the first 16 or so of a phase) again with
    device="cpu" (the plain
    versions; with `search_cfg`, searched by a SearchFilter sharing the
    CPU finder): the aligned records must equal the GPU run's."""
    import torch

    from sina_tpu_torch.search import SearchFilter

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_finder = finder.on_device(cpu)
    searcher = None
    if search_cfg is not None:
        searcher = SearchFilter(cpu_finder.db, search_cfg, cpu_finder)
    got = _run_batches(cpu_finder, [queries], acfg, cpu, searcher)
    a = fasta_text(gpu_records, tmp / "gpu16.fasta")
    b = fasta_text(got, tmp / "cpu16.fasta")
    if a != b:
        raise AssertionError(f"{phase}: CPU (plain versions) and GPU records differ")
    say(f"{phase} parity: {len(got)} records identical on cpu and gpu "
        f"({time.perf_counter() - t0:.1f}s on the cpu)")


def phase_graph_path(dev, tmp: Path, finder, db) -> tuple[dict, list, list]:
    """The graph engine at the profile path's scale: 384 full-length
    queries in three batches of 128 (the first one warms up) with
    AlignerConfig(engine="graph"), against the same reference and
    famfinder."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import _registry, get_timer, reset_all

    torch.cuda.reset_peak_memory_stats()
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=N_GRAPH_QUERIES, seed=11, branch_len=0.7)]
    pristine = [testing.unaligned_copy(q) for q in queries[:16]]
    batches = [queries[i:i + B_MAIN] for i in range(0, N_GRAPH_QUERIES, B_MAIN)]
    acfg = AlignerConfig(engine="graph")
    kernels.reset_launches()
    t0 = time.perf_counter()
    aligned = _run_batches(finder, batches[:1], acfg, dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    reset_all()
    transfer.reset_counts()
    t0 = time.perf_counter()
    with gc_pauses() as gcs:
        aligned += _run_batches(finder, batches[1:], acfg, dev)
        torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    gc_line("phase 7", gcs)
    report_transfers("phase 7", len(batches) - 1)
    launches = dict(kernels.launches)
    # the (N, M) buckets the dispatcher formed in the steady batches,
    # with their queries
    buckets = {k: n for k, n in get_timer("GraphDP").counts.items()
               if k.startswith("bucket ")}
    n_steady = N_GRAPH_QUERIES - B_MAIN
    for name, t in _registry.items():
        say(f"  timings {name}: {t}")
    out = tmp / "graph.fasta"
    fasta_text([a for a in aligned if a is not None], out)
    n_ok = check_records(out, queries, WIDTH)
    if n_ok < 0.95 * N_GRAPH_QUERIES:
        raise AssertionError(f"graph path: only {n_ok} of {N_GRAPH_QUERIES} queries aligned")
    missing = [k for k in GRAPH_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the graph path: {missing}")
    say(f"phase 7 graph path: {n_ok}/{N_GRAPH_QUERIES} aligned, width {WIDTH}, "
        f"bases preserved; warmup batch {t_warm:.2f}s; steady {n_steady} "
        f"seqs in {t_steady:.3f}s = {n_steady / t_steady:.2f} seq/s on "
        f"{gpu_line()}; steady buckets (N x M: queries) {buckets}; dense-route "
        f"buckets {launches['graph_dense_route']}; launches {launches}")
    busy, wall, per = device_busy(
        lambda: _run_batches(finder, batches[1:], acfg, dev))
    report_busy("phase 7", busy, wall, per)
    peak_memory("phase 7")
    return launches, aligned[:16], pristine


def phase_forbid_path(dev, tmp: Path, finder, db) -> tuple[dict, list, list]:
    """The profile engine with --insertion forbid at the main path's
    scale: 384 full-length queries in three batches of 128 (the first
    one warms up) with AlignerConfig(insertion="forbid"), against the
    same reference and famfinder."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import _registry, reset_all

    torch.cuda.reset_peak_memory_stats()
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=N_FORBID_QUERIES, seed=19, branch_len=0.7)]
    pristine = [testing.unaligned_copy(q) for q in queries[:16]]
    batches = [queries[i:i + B_MAIN] for i in range(0, N_FORBID_QUERIES, B_MAIN)]
    acfg = AlignerConfig(insertion="forbid")
    kernels.reset_launches()
    t0 = time.perf_counter()
    aligned = _run_batches(finder, batches[:1], acfg, dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    reset_all()
    transfer.reset_counts()
    t0 = time.perf_counter()
    with gc_pauses() as gcs:
        aligned += _run_batches(finder, batches[1:], acfg, dev)
        torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    gc_line("phase 12", gcs)
    report_transfers("phase 12", len(batches) - 1)
    launches = dict(kernels.launches)
    n_steady = N_FORBID_QUERIES - B_MAIN
    for name, t in _registry.items():
        say(f"  timings {name}: {t}")
    out = tmp / "forbid.fasta"
    fasta_text([a for a in aligned if a is not None], out)
    n_ok = check_records(out, queries, WIDTH)
    if n_ok < 0.95 * N_FORBID_QUERIES:
        raise AssertionError(f"forbid path: only {n_ok} of {N_FORBID_QUERIES} queries aligned")
    missing = [k for k in FORBID_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the forbid path: {missing}")
    if launches["profile_dp"]:
        raise AssertionError("the forbid path launched the shift-mode profile DP")
    say(f"phase 12 forbid path: {n_ok}/{N_FORBID_QUERIES} aligned, width {WIDTH}, "
        f"bases preserved; warmup batch {t_warm:.2f}s; steady {n_steady} seqs in "
        f"{t_steady:.3f}s = {n_steady / t_steady:.2f} seq/s on {gpu_line()}; "
        f"launches {launches}")
    with recorded_budgets() as planes:
        busy, wall, per = device_busy(
            lambda: _run_batches(finder, batches[1:], acfg, dev))
    say(f"phase 12 budgets of the real columns (second pass, {len(planes)} buckets): "
        f"{budget_classes(planes)}")
    report_busy("phase 12", busy, wall, per)
    peak_memory("phase 12")
    return launches, aligned[:16], pristine


@contextlib.contextmanager
def recorded_budgets():
    """Records the budget plane, real column counts and M of every
    bucket the profile DP dispatch is given while the block runs."""
    from sina_tpu_torch.ops import profile as prof

    planes = []
    dispatch = prof.profile_dp_dispatch

    def recording(fgq, qmask, qlen, c_real, *args, budget=None, **kw):
        if budget is not None:
            planes.append((np.array(budget), np.array(c_real), qmask.shape[1]))
        return dispatch(fgq, qmask, qlen, c_real, *args, budget=budget, **kw)

    prof.profile_dp_dispatch = recording
    try:
        yield planes
    finally:
        prof.profile_dp_dispatch = dispatch


def budget_classes(planes) -> str:
    """The share of the real columns (j < c_real of each query row) in
    each budget class: below 1 (no window), 1-4, 5-128 (with 1-4 the
    windows of one warp's lanes at 4 lanes a thread), 129 to M-1, M or
    more; with the median, the 90th percentile and the maximum."""
    vals, wide = [], 0
    for budget, c_real, M in planes:
        v = budget[np.arange(budget.shape[1])[None, :] < c_real[:, None]]
        vals.append(v)
        wide += int((v >= M).sum())
    v = np.concatenate(vals) if vals else np.zeros(0, np.int32)
    n = max(len(v), 1)
    shares = {"below 1": (v < 1).sum(), "1-4": ((v >= 1) & (v <= 4)).sum(),
              "5-128": ((v >= 5) & (v <= 128)).sum(), "129 to M-1": (v >= 129).sum() - wide,
              "M or more": wide}
    text = ", ".join(f"{k} {100 * int(c) / n:.1f}%" for k, c in shares.items())
    real = v[v >= 1]
    pct = (f"; of those >= 1: median {np.median(real):.0f}, 90th percentile "
           f"{np.percentile(real, 90):.0f}, max {real.max()}" if len(real) else "")
    return f"{len(v)} real columns: {text}{pct}"


def phase_dense_path(dev, db) -> int:
    """The dense scorer's path, the op dispatch through which the JAX
    package reaches its dense kernel: famfinder's scoring + top-k
    (kmer_kernel.score_topk, k = 256) of 128 queries on the int8
    device_matrix(packed=False) of the first 16,384 references, equal
    to the packed matrix's.  Returns the dense kernel's launches."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.ops import kmer_kernel as kk
    from sina_tpu_torch.ops.kmer import query_kmers_padded
    from sina_tpu_torch.ops.kmer_index import KmerIndex, device_matrix
    from sina_tpu_torch.refdb import ReferenceDb

    t0 = time.perf_counter()
    sub = ReferenceDb([s.copy() for s in db.sequences[:DENSE_S]], db.width)
    idx = KmerIndex.build(sub, k=10, fast=True)
    P8 = device_matrix(idx, dev, packed=False)
    Pp = device_matrix(idx, dev)
    queries = testing.make_queries(sub, n=B_MAIN, seed=17, branch_len=0.7)
    kmers, _ = query_kmers_padded([testing.unaligned_copy(q).masks for q in queries],
                                  idx.k, fast=idx.fast)
    km = torch.from_numpy(kmers).to(dev)
    sync(dev)
    t_setup = time.perf_counter() - t0
    kernels.reset_launches()
    got = kk.score_topk(P8, km, 256)
    sync(dev)
    launches = kernels.launches["kmer_score_dense"]
    want = kk.score_topk(Pp, km, 256)
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError("dense path: top-k differs from the packed matrix's")
    if launches == 0:
        raise AssertionError("dense path: kmer_score_dense never launched")
    say(f"phase 9 dense path: {DENSE_S} references, int8 matrix "
        f"{tuple(P8.shape)} on the card (set-up {t_setup:.1f}s); {B_MAIN} "
        f"queries (L={kmers.shape[1]}) scored and top-256 equal to the packed "
        f"matrix's; kmer_score_dense launches {launches}")
    del P8, Pp
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def orientations(base) -> list:
    """Each query as is, reversed, complemented, and reversed and
    complemented, named <name>~<k>, in that order."""
    out = []
    for q in base:
        for k in range(4):
            c = turned(q.copy(), TURN_NAMES[k])
            c.name = f"{q.name}~{k}"
            out.append(c)
    return out


def phase_turn_search(dev, finder, db):
    """The turn check and search + LCA at the main path's scale: 64
    queries in four orientations each, two batches of 128, with
    FamFinderConfig(turn="all") on the shared index and a SearchFilter
    sharing that finder."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.search import SearchConfig, SearchFilter
    from sina_tpu_torch.timing import _registry, reset_all

    torch.cuda.reset_peak_memory_stats()
    base = [testing.unaligned_copy(q) for q in
            testing.make_queries(db, n=N_TURN, seed=13, branch_len=0.7)]
    given = orientations(base)
    pristine = [q.copy() for q in given]
    tf = finder.on_device(dev)
    tf.cfg = dataclasses.replace(finder.cfg, turn="all")
    scfg = SearchConfig(kmer_candidates=1000, max_result=10, min_sim=0.7,
                        lca_fields=["tax_slv"])
    searcher = SearchFilter(db, scfg, tf)
    if searcher.finder is not tf:
        raise AssertionError("the search did not share the finder")
    # set-up, as the index upload is: the comparator's packed copy of
    # every reference, made at the search's first batch
    t0 = time.perf_counter()
    searcher._packed()
    say(f"phase 10 setup: the search's packed arrays of {len(db)} references in "
        f"{time.perf_counter() - t0:.1f}s, before the timed run")
    batches = [given[i:i + B_MAIN] for i in range(0, len(given), B_MAIN)]
    kernels.reset_launches()
    reset_all()
    sync(dev)
    t0 = time.perf_counter()
    with gc_pauses() as gcs:
        out = _run_batches(tf, batches, AlignerConfig(), dev, searcher)
        sync(dev)
    took = time.perf_counter() - t0
    gc_line("phase 10", gcs)
    launches = dict(kernels.launches)
    for name, t in _registry.items():
        say(f"  timings {name}: {t}")
    misses = []
    for g in range(N_TURN):
        recs = out[4 * g:4 * g + 4]
        asis = recs[0]
        for k, r in enumerate(recs):
            bad = []
            if r is None:
                bad.append("not aligned")
            else:
                if r.get_attr("turn_slv") != TURN_NAMES[k]:
                    bad.append(f"turn_slv {r.get_attr('turn_slv')!r}")
                if asis is not None and not (
                        np.array_equal(r.positions, asis.positions)
                        and np.array_equal(r.masks, asis.masks)):
                    bad.append("aligned row differs from the as-is copy's")
                for a in ("nearest_slv", "lca_tax_slv"):
                    if asis is not None and r.get_attr(a) != asis.get_attr(a):
                        bad.append(f"{a} differs from the as-is copy's")
            if bad:
                misses.append((g, k, bad))
    if misses:
        for g, k, bad in misses:
            vals, _ = tf.score_topk([q.masks for q in pristine[4 * g:4 * g + 4]], 1)
            say(f"phase 10 miss: {pristine[4 * g + k].name} ({TURN_NAMES[k]}): "
                f"{'; '.join(bad)}; top-1 k-mer score as is / reversed / "
                f"complemented / reversed and complemented: {vals[:, 0].tolist()}")
        raise AssertionError(f"turn + search: {len(misses)} of {len(given)} copies missed")
    sections = {n: dict(_registry[n].sections) for n in ("Kmer Search", "Pipeline")
                if n in _registry}
    if "search" not in sections.get("Pipeline", {}) or not sections.get("Kmer Search"):
        raise AssertionError(f"turn + search: sections missing ({sections})")
    missing = [k for k in PROFILE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the turn + search path: {missing}")
    # the search's candidates at the index's padded width come from the
    # grouped top-k: the card's ids equal the plain versions' on the cpu
    from sina_tpu_torch.ops import kmer_kernel as kk

    masks = [q.masks for q in pristine[:16]]
    gv, gi = tf.score_topk(masks, scfg.kmer_candidates)
    cv, ci = tf.on_device("cpu").score_topk(masks, scfg.kmer_candidates)
    if not (np.array_equal(gv, cv) and np.array_equal(gi, ci)):
        raise AssertionError("turn + search: top-k ids differ between the card and the cpu")
    padded = 8 * tf._matrix().shape[1]
    if padded < kk.GROUPED_MIN_WIDTH:
        raise AssertionError(f"turn + search: {padded} padded references do not "
                             "reach the grouped top-k")
    say(f"phase 10 top-k: {padded} padded references (grouped top-k from "
        f"{kk.GROUPED_MIN_WIDTH}); top-{scfg.kmer_candidates} values and ids of 16 "
        f"queries equal on the card and on the cpu")
    classified = sum(r.get_attr("lca_tax_slv") != "Unclassified;" for r in out)
    say(f"phase 10 turn + search: {len(given)} queries ({N_TURN} x 4 "
        f"orientations) in {took:.3f}s = {len(given) / took:.2f} seq/s on "
        f"{gpu_line()}; every copy reported its orientation and the as-is "
        f"copy's row, nearest_slv and lca_tax_slv; {classified} classified "
        f"below the root; launches {launches}")
    # the same queries again (fresh copies: the finder turned the first
    # ones in place), profiled, for the device's share
    again = [q.copy() for q in pristine]
    busy, wall, per = device_busy(lambda: _run_batches(
        tf, [again[i:i + B_MAIN] for i in range(0, len(again), B_MAIN)],
        AlignerConfig(), dev, searcher))
    report_busy("phase 10", busy, wall, per)
    peak_memory("phase 10")
    return out[:16], pristine[:16], tf, scfg


def phase_sharded_search(dev, finder, kmers) -> None:
    """Phase 5's 450k-reference index in the tiled layout (524,288
    padded references, 262,145 x 65,536 bytes, 17.2 GB) on meshes of the card
    named 4 times, (1, 4) and (2, 2), searched with the k-mer ids of a
    steady phase-5 batch at k = 256 and 1,000: values equal the
    unsharded score_topk's, every id reaches its value on the unsharded
    matrix, and the first 16 queries' values and ids equal the same
    mesh shape's on the cpu (the plain versions)."""
    import torch

    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.ops import kmer_kernel as kk
    from sina_tpu_torch.parallel.sharding import make_mesh, shard_index_matrix, sharded_search

    torch.cuda.reset_peak_memory_stats()
    cpu = torch.device("cpu")
    smi = gpu_line()
    P = finder._matrix()
    scores = kk.kmer_scores(P, kmers)
    t0 = time.perf_counter()
    P3 = finder.index.dense_packed_tiled(byte_multiple=4096 * 4)
    say(f"phase 14 tiled index: {P3.shape} uint8 = {P3.nbytes} bytes on the host "
        f"({time.perf_counter() - t0:.1f}s), {8 * P3.shape[1] * P3.shape[2]} padded "
        f"references; queries B={kmers.shape[0]} L={kmers.shape[1]}")
    for dp in (1, 2):
        mesh, cmesh = make_mesh([dev] * 4, dp=dp), make_mesh([cpu] * 4, dp=dp)
        shape = f"(dp={dp}, mp={mesh.shape['mp']})"
        t0 = time.perf_counter()
        Pm = shard_index_matrix(mesh, P3)
        torch.cuda.synchronize()
        t_place = time.perf_counter() - t0
        Pc = shard_index_matrix(cmesh, P3)
        shard = Pm.shards[0][0]
        shard_ms = time_ms(lambda: kk.kmer_scores(shard, kmers[:kmers.shape[0] // dp],
                                                  gmax=True), 10)
        for k in (256, 1000):
            fn = sharded_search(mesh, k)
            kernels.reset_launches()
            vals, ids = fn(Pm, kmers)
            torch.cuda.synchronize()
            launches = kernels.launches["kmer_score"]
            if launches != 4:
                raise AssertionError(f"phase 14 {shape}: {launches} kmer_score launches, not 4")
            one = kk.score_topk(P, kmers, k)
            if not torch.equal(vals, one[:, :k]):
                raise AssertionError(f"phase 14 {shape} k={k}: values differ from score_topk's")
            inside = ids < scores.shape[1]
            reached = torch.gather(scores, 1, ids.long().clamp(max=scores.shape[1] - 1))
            if not bool(torch.where(inside, reached == vals, vals == 0).all()):
                raise AssertionError(f"phase 14 {shape} k={k}: an id misses its value")
            cv, ci = sharded_search(cmesh, k)(Pc, kmers[:16].cpu())
            if not (torch.equal(vals[:16].cpu(), cv) and torch.equal(ids[:16].cpu(), ci)):
                raise AssertionError(f"phase 14 {shape} k={k}: card and cpu meshes differ")
            ms = time_ms(lambda: fn(Pm, kmers), 10)
            one_ms = time_ms(lambda: kk.score_topk(P, kmers, k), 10)
            tied = int((ids != one[:, k:]).any(dim=1).sum())
            say(f"phase 14 sharded search {shape} k={k}: {launches} kmer_score launches a "
                f"call, {ms:.3f} ms a call (CUDA events, 10 calls), unsharded score_topk "
                f"{one_ms:.3f} ms, on {smi}; one shard's kernel {shard_ms:.3f} ms on {smi}; "
                f"values equal the unsharded; ids differ from its on ties in {tied} of "
                f"{kmers.shape[0]} queries; 16 queries' values and ids equal on the card and "
                f"the cpu mesh; shards placed in {t_place:.1f}s")
        del Pm, Pc, shard
    peak_memory("phase 14")
    del P3, scores
    torch.cuda.empty_cache()


def phase_mesh_famfinder(dev, tmp: Path, finder, db):
    """128 full-length queries through famfinder on a mesh of the card
    named 4 times (mp = 4: the tiled index in four 4.3 GB shards),
    the aligner and the FASTA writer, its kernels' launch counts."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinder
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.parallel.sharding import make_mesh

    torch.cuda.reset_peak_memory_stats()
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(db, n=B_MAIN, seed=29, branch_len=0.7)]
    pristine = [q.copy() for q in queries[:16]]
    t0 = time.perf_counter()
    mf = FamFinder(db, finder.cfg, dev, mesh=make_mesh([dev] * 4, dp=1))
    Pm = mf._matrix()
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = _run_batches(mf, [queries], AlignerConfig(), dev)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = dict(kernels.launches)
    missing = [k for k in PROFILE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mesh's path: {missing}")
    path = tmp / "mesh.fasta"
    fasta_text([a for a in out if a is not None], path)
    n_ok = check_records(path, queries, WIDTH)
    if n_ok < 0.95 * B_MAIN:
        raise AssertionError(f"mesh famfinder: only {n_ok} of {B_MAIN} queries aligned")
    say(f"phase 15 famfinder on a (dp=1, mp=4) mesh of {dev}: {'tiled' if Pm.tiled else 'flat'} "
        f"index {Pm.shape} built and placed in 4 shards in {t_place:.1f}s; {n_ok}/{B_MAIN} aligned, width {WIDTH}, "
        f"bases preserved, in {took:.3f}s (one batch, cold) on {gpu_line()}; launches "
        f"{launches}")
    peak_memory("phase 15")
    return out[:16], pristine, mf


def phase_multihost(tmp: Path) -> None:
    """Two processes of python -m sina_tpu_torch --device cuda
    --multihost on one card, on phase 4's reference: the .part files
    cover every query once, each record equal to one process's run."""
    import os
    import socket

    from sina_tpu_torch import cli, testing
    from sina_tpu_torch.io.fasta import FastaWriter

    d = tmp / "multihost"
    d.mkdir()
    db = testing.make_reference(n_seqs=150, n_core=500, width=800, seed=42)
    with FastaWriter(str(d / "ref.fasta"), meta="comment") as w:
        for s in db.sequences:
            w.write(s)
    with FastaWriter(str(d / "q.fasta")) as w:
        for q in testing.make_queries(db, n=10, seed=7, branch_len=0.6):
            w.write(testing.unaligned_copy(q))
    args = ["-i", str(d / "q.fasta"), "-r", str(d / "ref.fasta"), "--fs-min", "10",
            "--fs-max", "10", "--fs-full-len", "400", "--fs-req-gaps", "1",
            "--meta-fmt", "comment", "--device", "cuda", "-q"]
    if cli.main([*args, "-o", str(d / "single.fasta")]) != 0:
        raise AssertionError("phase 16: the one-process run failed")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sina_tpu_torch", *args, "-o", str(d / "out.fasta"),
         "--multihost", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)],
        cwd=str(repo), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    took = time.perf_counter() - t0
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 16: process {i} exited {p.returncode}: {err[-2000:]}")

    def records(path: Path) -> dict:
        out = {}
        for line in _STAMP.sub("aligned_slv=T", path.read_text()).splitlines():
            if line.startswith(">"):
                out[line[1:].split()[0]] = []
            out[next(reversed(out))].append(line)
        return out

    parts = [records(d / f"out.fasta.part{i}") for i in range(2)]
    want = records(d / "single.fasta")
    if set(parts[0]) & set(parts[1]) or {**parts[0], **parts[1]} != want or len(want) != 10:
        raise AssertionError("phase 16: the parts do not hold the one-process run's records once each")
    say(f"phase 16 --multihost: 2 processes on one card ({gpu_line()}), parts of "
        f"{len(parts[0])} and {len(parts[1])} records, together every query once, each "
        f"record equal to the one-process cuda run's; {took:.1f}s for both processes")


def phase_dryrun(dev) -> None:
    """dryrun_multichip over the card named 8 times ((dp=2, mp=4)),
    the 17.2 GB NR-scale tiled index included."""
    import torch

    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dryrun_multichip([dev] * 8)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = dict(kernels.launches)
    missing = [k for k in ("kmer_score", "graph_dp", "graph_traceback") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the dry run: {missing}")
    say(f"phase 17 dryrun_multichip over {dev} x 8: {took:.1f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {gpu_line()}; launches "
        f"{launches}")


def make_indel_db():
    """Phase 18's reference: 20,000 references at width 50,000 (seed
    4321), one in 20 carrying a 48-base insertion that the others skip
    (testing.with_long_insertion); made before phase 3, whose dense
    route check takes its families.  Returns it with its seconds."""
    from sina_tpu_torch import testing

    t0 = time.perf_counter()
    db = testing.with_long_insertion(
        testing.make_reference_large(N_INDEL_REFS, n_core=1450, width=WIDTH, seed=4321),
        INDEL_LEN, INDEL_EVERY, seed=4321)
    return db, time.perf_counter() - t0


def phase_indel_path(dev, tmp: Path, ddb, t_ddb: float) -> tuple[dict, list, list, object]:
    """Phase 18: the graph engine on phase 18's reference, whose families
    carry long insertions: 384 full-length queries in three batches of
    128 (the first warms up) through famfinder (as phase 5's) and
    AlignerConfig(engine="graph").  Every graph bucket must take the
    dense route: graph_dense_route and the two dense kernels' launches
    equal the bucket count, and the graph kernels never launch."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig
    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import _registry, counters, get_timer, reset_all

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    queries = [testing.unaligned_copy(q) for q in
               testing.make_queries(ddb, n=N_INDEL_QUERIES, seed=41, branch_len=0.7)]
    pristine = [testing.unaligned_copy(q) for q in queries[:INDEL_TWINS]]
    finder = FamFinder(ddb, FamFinderConfig(
        fs_min=40, fs_max=40, fs_full_len=min(1400, 1450 - 100), fs_req_gaps=1), dev)
    finder._matrix()
    torch.cuda.synchronize()
    say(f"phase 18 setup: {time.perf_counter() - t0 + t_ddb:.1f}s (reference "
        f"{t_ddb:.1f}s): {len(ddb)} references at width {ddb.width}, one in "
        f"{INDEL_EVERY} with a {INDEL_LEN}-base insertion")
    batches = [queries[i:i + B_MAIN] for i in range(0, N_INDEL_QUERIES, B_MAIN)]
    acfg = AlignerConfig(engine="graph")
    kernels.reset_launches()
    reset_all()
    t0 = time.perf_counter()
    aligned = _run_batches(finder, batches[:1], acfg, dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    buckets = get_timer("GraphDP").counts["launch"]
    reset_all()
    transfer.reset_counts()
    counts0 = dict(counters)
    t0 = time.perf_counter()
    aligned += _run_batches(finder, batches[1:], acfg, dev)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    report_transfers("phase 18", len(batches) - 1)
    launches = dict(kernels.launches)
    buckets += get_timer("GraphDP").counts["launch"]
    shapes = {k[len("graph_dp."):]: n - counts0.get(k, 0) for k, n in counters.items()
              if k.startswith("graph_dp.bucket ") and n > counts0.get(k, 0)}
    n_steady = N_INDEL_QUERIES - B_MAIN
    for name, t in _registry.items():
        say(f"  timings {name}: {t}")
    out = tmp / "indel.fasta"
    fasta_text([a for a in aligned if a is not None], out)
    n_ok = check_records(out, queries, ddb.width)
    if n_ok < 0.95 * N_INDEL_QUERIES:
        raise AssertionError(f"phase 18: only {n_ok} of {N_INDEL_QUERIES} queries aligned")
    missing = [k for k in DENSE_ROUTE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dense route's path: {missing}")
    counted = {k: launches[k] for k in ("graph_dense_route", "graph_dp_dense",
                                        "graph_traceback_dense")}
    if set(counted.values()) != {buckets} or launches["graph_dp"] or launches["graph_traceback"]:
        raise AssertionError(f"phase 18: {buckets} graph buckets, but {counted}, graph_dp "
                             f"{launches['graph_dp']}: not every bucket took the dense route")
    say(f"phase 18 long-insertion path: {n_ok}/{N_INDEL_QUERIES} aligned, width "
        f"{ddb.width}, bases preserved; all {buckets} graph buckets on the dense route; "
        f"warmup batch {t_warm:.2f}s; steady {n_steady} seqs in {t_steady:.3f}s = "
        f"{n_steady / t_steady:.2f} seq/s on {gpu_line()}; steady buckets (N x M: "
        f"queries) {shapes}; launches {launches}")
    busy, wall, per = device_busy(lambda: _run_batches(finder, batches[1:], acfg, dev))
    report_busy("phase 18", busy, wall, per)
    peak_memory("phase 18")
    return launches, aligned[:INDEL_TWINS], pristine, finder


# the sleep kernel queued after a fetch in phase 19: longer than a
# batch's finalize on the host (NAST finishing of 128 queries), 2 s or
# more at the card's 1.98 GHz boost clock
SLEEP_CYCLES = 4_000_000_000


def phase_transfers(dev, tmp: Path, finder, db, dfinder, ddb) -> None:
    """Phase 19: the transfers of the dispatch paths on a batch of 128
    queries of each of phases 5, 12, 7 and 18 (made by their generator
    and seeds: the profile, forbid, graph and dense routes).  On each
    route famfinder's submit_batch and align_dispatch raise nothing
    under torch.cuda.set_sync_debug_mode("error"), each profile launch
    makes one host-to-device copy, and every buffer of the pinned pool
    is pinned; on the profile and graph routes famfinder's fetch and
    the aligner's finalize return while a sleep kernel queued after
    each on the compute stream still runs, with records equal to the
    run without the sleep."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig, align_dispatch, align_finalize
    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import get_timer, reset_all

    torch.cuda.reset_peak_memory_stats()
    routes = (("profile", finder, db, 7, AlignerConfig()),
              ("forbid", finder, db, 19, AlignerConfig(insertion="forbid")),
              ("graph", finder, db, 11, AlignerConfig(engine="graph")),
              ("dense", dfinder, ddb, 41, AlignerConfig(engine="graph")))
    for route, ff, rdb, seed, acfg in routes:
        made = testing.make_queries(rdb, n=2 * B_MAIN, seed=seed, branch_len=0.7)
        batch = [testing.unaligned_copy(q) for q in made[B_MAIN:]]

        def copies():
            return [q.copy() for q in batch]

        qw = copies()
        fams = [r.family if not r.failed else [] for r in ff.process_batch(qw)]
        want = align_finalize(align_dispatch(qw, [list(f) for f in fams], acfg, device=dev))
        torch.cuda.synchronize()
        kernels.reset_launches()
        reset_all()
        transfer.reset_counts()
        qs, qd = copies(), copies()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = ff.submit_batch(qs)
            state = align_dispatch(qd, [list(f) for f in fams], acfg, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t_disp = time.perf_counter() - t0
        ff.process_batch(qs, handle=handle)
        align_finalize(state)
        torch.cuda.synchronize()
        launches = get_timer("ProfileDP").counts["launch"]
        wires = get_timer("ProfileDP").counts["h2d"]
        if route in ("profile", "forbid") and not (
                launches and wires == launches and transfer.counts["h2d"] == 1 + launches):
            raise AssertionError(f"phase 19 {route}: {transfer.counts['h2d']} host-to-device "
                                 f"copies for {launches} profile launches and one famfinder "
                                 f"upload, {wires} wires")
        dense = kernels.launches["graph_dense_route"]
        if (route == "dense") != (dense > 0):
            raise AssertionError(f"phase 19 {route}: {dense} buckets on the dense route")
        bufs = transfer.pool_buffers()
        if not bufs or not all(b.is_pinned() for b in bufs):
            raise AssertionError(f"phase 19 {route}: a pool buffer is not pinned")
        say(f"phase 19 {route}: submit_batch and align_dispatch of {len(batch)} queries "
            f"raised nothing under set_sync_debug_mode('error') ({1e3 * t_disp:.3f} ms of "
            f"host time); {transfer.counts['h2d']} host-to-device copies ({launches} profile "
            f"launches, one wire each: {wires}), {transfer.counts['d2h']} device-to-host; "
            f"{dense} dense-route buckets; {len(bufs)} pool buffers, all pinned, "
            f"{transfer.pool_bytes()} bytes")
        if route not in ("profile", "graph"):
            continue
        qs = copies()
        handle = ff.submit_batch(qs)
        start, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        after.record()
        t0 = time.perf_counter()
        results = ff.process_batch(qs, handle=handle)
        t_ff = time.perf_counter() - t0
        ff_running = not after.query()
        torch.cuda.synchronize()
        sleep_ms = start.elapsed_time(after)
        state = align_dispatch(qs, [r.family if not r.failed else [] for r in results],
                               acfg, device=dev)
        torch.cuda._sleep(SLEEP_CYCLES)
        after2 = torch.cuda.Event()
        after2.record()
        t0 = time.perf_counter()
        got = align_finalize(state)
        t_al = time.perf_counter() - t0
        al_running = not after2.query()
        torch.cuda.synchronize()
        if not (ff_running and al_running):
            raise AssertionError(f"phase 19 {route}: a fetch waited for the sleep queued "
                                 f"after it (famfinder {ff_running}, aligner {al_running})")
        if (fasta_text([a for a in got if a is not None], tmp / "t19_got.fasta")
                != fasta_text([a for a in want if a is not None], tmp / "t19_want.fasta")):
            raise AssertionError(f"phase 19 {route}: records differ from the run without the sleep")
        say(f"phase 19 {route} ordering: famfinder's fetch returned after "
            f"{1e3 * t_ff:.3f} ms and the aligner's finalize after {1e3 * t_al:.3f} ms, "
            f"each while a {sleep_ms:.1f} ms sleep kernel queued after it still ran; "
            f"records equal")
    peak_memory("phase 19")


def amplicon_queries(db, n: int) -> list:
    """bench.py --amplicon's queries (bench.py:136-143): make_queries
    (seed 7, branch 0.7) made unaligned, each cut by bench_torch's
    amplicon_cut to the 250 bases from min(400, (len - 250) // 2)."""
    from sina_tpu_torch import testing

    return [amplicon_cut(testing.unaligned_copy(q))
            for q in testing.make_queries(db, n=n, seed=7, branch_len=0.7)]


@contextlib.contextmanager
def recorded_amplicon_path():
    """While open, records for each align_dispatch of the profile engine
    (one a batch) its rows, the rows col-trim gave a column window, and
    the families its profile builds took, whole or on a window; for each
    profile DP launch its bucket (C, M, rows, unique rows under fam_idx,
    the rows whose window fills the bucket); and the device inputs of
    the largest launch (by rows x C x M), as the kernel got them."""
    from sina_tpu_torch import align
    from sina_tpu_torch.ops import profile as prof

    rec = {"batches": [], "buckets": [], "largest": None}
    trim, build = align._trim_windows, prof.build_profiles_packed_batch
    dispatch, launch = prof.profile_dp_dispatch, prof.profile_dp

    def trimming(todo, min_cols=0):
        trim(todo, min_cols)
        rec["batches"].append({"rows": len(todo), "families": 0, "windowed": 0,
                               "trimmed": sum(1 for it in todo if it[8] != 0)})

    def building(fams, C, params, windows=None):
        b = rec["batches"][-1]
        b["families"] += len(fams)
        b["windowed"] += sum(w is not None for w in windows or ())
        return build(fams, C, params, windows=windows)

    def dispatching(fgq, qmask, qlen, c_real, params, device, fam_idx=None, budget=None):
        B, M = qmask.shape
        C = fgq.shape[1]
        rec["buckets"].append((C, M, B, len(np.unique(fam_idx)) if fam_idx is not None else B,
                               int((np.asarray(c_real) == C).sum())))
        return dispatch(fgq, qmask, qlen, c_real, params, device, fam_idx=fam_idx,
                        budget=budget)

    def launching(fg, qm, lens, params, fam_idx=None, budget=None):
        size = qm.shape[0] * fg.shape[1] * qm.shape[1]
        if rec["largest"] is None or size > rec["largest"][0]:
            rec["largest"] = (size, tuple(None if t is None else t.clone()
                                          for t in (fg, qm, lens, fam_idx, budget)))
        return launch(fg, qm, lens, params, fam_idx, budget)

    align._trim_windows, prof.build_profiles_packed_batch = trimming, building
    prof.profile_dp_dispatch, prof.profile_dp = dispatching, launching
    try:
        yield rec
    finally:
        align._trim_windows, prof.build_profiles_packed_batch = trim, build
        prof.profile_dp_dispatch, prof.profile_dp = dispatch, launch


def report_amplicon_path(phase: str, rec: dict, batches: int) -> None:
    """Print what recorded_amplicon_path saw over `batches` steady
    batches, the host sections of the amplicon path a batch and the
    pinned pool; fail unless every batch held a row on a trimmed
    window."""
    from collections import Counter

    from sina_tpu_torch.ops import transfer
    from sina_tpu_torch.timing import get_timer

    seen = rec["batches"]
    if len(seen) != batches or not all(b["trimmed"] for b in seen):
        raise AssertionError(f"{phase}: a steady batch without a row on a trimmed window "
                             f"({seen})")
    say(f"{phase} col trim: rows on a trimmed window a batch "
        f"{[b['trimmed'] for b in seen]} of {[b['rows'] for b in seen]}; profile builds "
        f"on a window {[b['windowed'] for b in seen]} of {[b['families'] for b in seen]} "
        f"families")
    launches, rows, unique, full = Counter(), Counter(), Counter(), Counter()
    for C, M, B, U, f in rec["buckets"]:
        launches[C, M] += 1
        rows[C, M] += B
        unique[C, M] += U
        full[C, M] += f
    say(f"{phase} profile DP buckets (C x M: launches, rows, unique rows under fam_idx, "
        f"rows whose window fills C): " + "; ".join(
            f"{C}x{M}: {launches[C, M]}, {rows[C, M]}, {unique[C, M]}, {full[C, M]}"
            for C, M in sorted(launches)))
    parts = []
    for timer, section in (("Aligner", "col trim"), ("Aligner", "window calc"),
                           ("Aligner", "build profile"), ("Aligner", "finish"),
                           ("Kmer Search", "policy"), ("Kmer Search", "fetch topk")):
        parts.append(f"{timer} {section} "
                     f"{1e3 * get_timer(timer).sections[section] / batches:.1f}")
    say(f"{phase} host ms a batch: {'; '.join(parts)}; pinned pool "
        f"{transfer.pool_bytes()} bytes")


def amplicon_run(phase: str, dev, tmp: Path, finder, queries, acfg, warm: bool):
    """`queries` through _run_batches in batches of B_AMPLICON: with
    `warm`, the first batch warms up and the rest are the steady run,
    else all are.  Prints the rate, launches, host sections and device
    busy share (a profiled second pass over the steady batches); fails
    unless 95% aligned with valid records, every steady batch held a
    trimmed row and every kernel of `path` launched.  Returns (records,
    launches, recorded path, the first steady batch's k-mer ids)."""
    import torch

    from sina_tpu_torch.ops import kernels, transfer
    from sina_tpu_torch.timing import reset_all

    batches = [queries[i:i + B_AMPLICON] for i in range(0, len(queries), B_AMPLICON)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    aligned = _run_batches(finder, batches[:1], acfg, dev) if warm else []
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    steady = batches[1:] if warm else batches
    reset_all()
    transfer.reset_counts()
    t0 = time.perf_counter()
    with recorded_amplicon_path() as rec, first_scored_ids() as kmers, gc_pauses() as gcs:
        aligned += _run_batches(finder, steady, acfg, dev)
        torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    gc_line(phase, gcs)
    launches = dict(kernels.launches)
    n_steady = sum(len(b) for b in steady)
    report_transfers(phase, len(steady))
    report_amplicon_path(phase, rec, len(steady))
    out = tmp / f"{phase.replace(' ', '_')}.fasta"
    fasta_text([a for a in aligned if a is not None], out)
    n_ok = check_records(out, queries, WIDTH)
    if n_ok < 0.95 * len(queries):
        raise AssertionError(f"{phase}: only {n_ok} of {len(queries)} amplicons aligned")
    path = FORBID_PATH if acfg.insertion == "forbid" else PROFILE_PATH
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched: {missing}")
    say(f"{phase} amplicons: {n_ok}/{len(queries)} aligned, width {WIDTH}, bases "
        f"preserved, columns increasing; "
        + (f"warmup batch {t_warm:.2f}s; " if warm else "")
        + f"{'steady ' if warm else ''}{n_steady} seqs in {len(steady)} batches of "
        f"{B_AMPLICON} in {t_steady:.3f}s = {n_steady / t_steady:.2f} seq/s on "
        f"{gpu_line()}; launches {launches}")
    busy, wall, per = device_busy(lambda: _run_batches(finder, steady, acfg, dev))
    report_busy(phase, busy, wall, per)
    return aligned, launches, rec, kmers[0]


def phase_amplicon_path(dev, tmp: Path, finder, db) -> dict:
    """The reference's amplicon operating point (bench.py --amplicon) on
    phase 5's reference, index and famfinder: 5,120 250-nt amplicons in
    batches of 1,024 with AlignerConfig() (col-trim on, the 1,024-column
    gate), the first 64 again on the cpu; then 2,048 of them with
    AlignerConfig(insertion="forbid") (two steady batches, the trimmed
    windows' last slot budgeted to the next occupied column outside),
    the first 16 again on the cpu; then phase 3's checks on the inputs
    the shift run gave its kernels.  Returns the amplicon kernel rows."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    queries = amplicon_queries(db, N_AMPLICON)
    twins = [testing.unaligned_copy(q) for q in queries[:AMPLICON_TWINS]]
    forbid = [testing.unaligned_copy(q) for q in queries[:N_AMPLICON_FORBID]]
    forbid_twins = [testing.unaligned_copy(q) for q in forbid[:AMPLICON_FORBID_TWINS]]
    lens = [len(q.masks) for q in queries]
    say(f"phase 20 setup: {N_AMPLICON} amplicons of {min(lens)}-{max(lens)} nt in "
        f"{time.perf_counter() - t0:.1f}s")
    acfg = AlignerConfig()
    aligned, _, rec, kmers = amplicon_run("phase 20", dev, tmp, finder, queries, acfg,
                                          warm=True)
    phase_cpu_parity(finder, aligned[:AMPLICON_TWINS], twins, tmp, acfg, "phase 20")
    rows = phase_amplicon_kernels(finder._matrix(), kmers, rec["largest"][1])
    facfg = AlignerConfig(insertion="forbid")
    with recorded_budgets() as planes:
        faligned, _, frec, _ = amplicon_run("phase 20 forbid", dev, tmp, finder, forbid,
                                            facfg, warm=False)
    say(f"phase 20 forbid budgets of the real columns (both passes, {len(planes)} "
        f"buckets): {budget_classes(planes)}")
    phase_cpu_parity(finder, faligned[:AMPLICON_FORBID_TWINS], forbid_twins, tmp, facfg,
                     "phase 20 forbid")
    rows.update(amplicon_dp_check("phase 20 forbid", frec["largest"][1]))
    say(f"phase 20 amplicon kernel rows: {json.dumps(rows)}")
    peak_memory("phase 20")
    return rows


def amplicon_dp_check(phase: str, inputs) -> dict:
    """The profile DP (its forbid mode where the launch had budgets) and
    the chain traceback on one real amplicon launch's device inputs:
    exact against their plain versions, timed by CUDA events beside
    their bounds, counted as phase 3 counts them."""
    import torch

    from sina_tpu_torch.ops import profile_kernel as pk
    from sina_tpu_torch.ops.align_kernel import DpParams

    fg, qm, ln, fi, bud = inputs
    params = DpParams()
    name = "profile_dp" if bud is None else "profile_dp_forbid"
    got = pk.profile_dp(fg, qm, ln, params, fam_idx=fi, budget=bud)
    ref = pk.profile_dp_plain(fg, qm, ln, params, fam_idx=fi, budget=bud)
    for n, a, b in zip(("bp", "best_c", "best_i", "raw"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{phase}: {name} {n} disagrees with its plain version "
                                 f"on a real amplicon bucket ({int((a != b).sum())} cells)")
    ms = time_ms(lambda: pk.profile_dp(fg, qm, ln, params, fam_idx=fi, budget=bud), DP_REPS)
    plain_ms = time_ms(lambda: pk.profile_dp_plain(fg, qm, ln, params, fam_idx=fi,
                                                   budget=bud), 1)
    lens = ln.cpu().numpy()
    B, M = qm.shape
    U, C = fg.shape[:2]
    nbytes = (fg.numel() + qm.numel() + 4 * ln.numel() + B * C * M + 12 * B
              + (0 if fi is None else 4 * fi.numel()) + (0 if bud is None else 4 * bud.numel()))
    if bud is None:
        ql, cr = lens[:, 0].astype(np.int64), lens[:, 1].astype(np.int64)
        counts = (int((ql * cr).sum()), int(cr.sum()), int(ql.sum()))
        per = (PROFILE_INSTS_PER_CELL, PROFILE_INSTS_PER_COLUMN, PROFILE_INSTS_PER_POSITION)
        insts = tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))
        cells = counts[0]
    else:
        insts, cells = forbid_insts(lens, bud.cpu().numpy(), M)
    b = bound(nbytes, insts=insts)
    real = int((lens[:, 0] > 0).sum())
    say(f"{phase} {name} on the largest amplicon bucket's launch: B={B} ({real} real rows) "
        f"U={U} C={C} M={M}; bp/best_c/best_i/raw exact; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {cells} cells, "
        f"{insts[0]} instructions, {insts[1]} integer), {b['bound_ms'] / ms:.3f} of the "
        f"bound's rate; launch plan {pk.profile_dp_plan(M, forbid=bud is not None)}")
    row = {"max_abs_err": float((got[3] - ref[3]).abs().max()), "ms": ms,
           "plain_ms": plain_ms, **b, "library_ms": None}
    if bud is not None:
        return {name: row}
    bp, bc, bi, _ = got
    emit = pk.chain_traceback(bp, bc, bi)
    steps = np.zeros(B, np.int64)
    if not torch.equal(emit, pk.chain_traceback_plain(bp, bc, bi, steps=steps)):
        raise AssertionError(f"{phase}: chain_traceback disagrees with its plain version on "
                             "a real amplicon plane")
    tb_ms = time_ms(lambda: pk.chain_traceback(bp, bc, bi), TB_REPS)
    tb_plain = time_ms(lambda: pk.chain_traceback_plain(bp, bc, bi), 1)
    tb = traceback_bound(emit, 1)
    say(f"{phase} chain_traceback on that plane: emit exact; kernel {tb_ms:.3f} ms, plain "
        f"{tb_plain:.3f} ms, bound {tb['bound_ms']:.5f} ms ({tb['bound_by']}); longest "
        f"walk {int(steps.max())} steps; launch plan {pk.chain_traceback_plan(bp)}")
    return {name: row, "chain_traceback": {"max_abs_err": 0, "ms": tb_ms,
                                           "plain_ms": tb_plain, **tb, "library_ms": None}}


def phase_amplicon_kernels(P, kmers, inputs) -> dict:
    """Phase 3's checks at the amplicon path's shapes, on phase 20's
    inputs: the packed scorer on the ids of its first steady batch (B =
    1,024), the profile DP on its largest bucket's launch and the chain
    traceback on that plane, each exact against its plain version and
    timed beside its bound."""
    rows = {"kmer_score": real_batch_scorer(P, kmers, "phase 20 (phase 3 at amplicon shapes)")}
    rows.update(amplicon_dp_check("phase 20 (phase 3 at amplicon shapes)", inputs))
    return rows


# tests/test_accuracy.py:65-149, each case's configuration and bars: a
# bar is (metric, op, value), op one of "==", ">", "<", "~" (within
# 1e-6 of the value, as pytest.approx; "~idty" within 1e-6 absolute)
# and "in" (value a pair, strictly between)
ACCURACY_CASES = [
    ("prealigned", dict(prealigned=True),
     [("n_aligned", "==", 48), ("avg_sps", "~", 1.0), ("avg_cpm", "~", 0.0)]),
    ("align_copy", dict(step=1000),
     [("n_aligned", "==", 5), ("avg_sps", "~", 1.0), ("avg_idty", "~idty", 1.0)]),
    ("realign", dict(realign=True, engine="graph"),
     [("n_aligned", "==", 48), ("avg_sps", ">", 0.996), ("avg_cpm", "<", 0.0002),
      ("avg_idty", ">", 0.96)]),
    ("realign_leave_query_out", dict(realign=True, fs_leave_query_out=True, engine="graph"),
     [("avg_sps", ">", 0.996), ("avg_cpm", "<", 0.00025), ("avg_idty", ">", 0.96)]),
    ("realign_profile_engine", dict(realign=True, engine="profile"),
     [("avg_sps", ">", 0.996), ("avg_cpm", "<", 0.0005), ("avg_idty", ">", 0.96)]),
    ("realign_k8", dict(realign=True, fs_leave_query_out=True, fs_kmer_len=8,
                        engine="graph"),
     [("avg_sps", ">", 0.996), ("avg_cpm", "<", 0.0002), ("avg_idty", ">", 0.96)]),
    ("realign_nofast", dict(realign=True, fs_leave_query_out=True, fs_no_fast=True,
                            engine="graph"),
     [("avg_sps", ">", 0.996), ("avg_cpm", "<", 0.00015), ("avg_idty", ">", 0.96)]),
] + [
    (f"realign_msc_capped[{cap}]", dict(realign=True, fs_leave_query_out=True,
                                        fs_msc_max=cap, engine="graph"),
     [("n_aligned", "==", 48), ("avg_sps", ">", sps_min), ("avg_cpm", "<", cpm_max),
      ("avg_idty", "in", (idty_lo, idty_hi))])
    # test_accuracy.py MSC_BARS: cap, sps_min, cpm_max, idty window; the
    # first cap only, since the 450k reference's set-up took the time of
    # the caps 0.8 and 0.7 (9 and 41 s on the card), which
    # tests/test_torch_accuracy_msc.py holds on the plain versions
    for cap, sps_min, cpm_max, idty_lo, idty_hi in ((0.9, 0.99, 0.001, 0.88, 0.90),)
]
# the cases whose per-query sps and cpm must be equal on the card and on
# the cpu
ACCURACY_TWINS = ("realign_k8", "realign_nofast")


def holds(value, op: str, want) -> bool:
    if op == "==":
        return value == want
    if op == ">":
        return value > want
    if op == ">=":
        return value >= want
    if op == "<":
        return value < want
    if op == "~":
        return abs(value - want) <= max(1e-6 * abs(want), 1e-12)
    if op == "~idty":
        return abs(value - want) <= 1e-6
    return want[0] < value < want[1]


def check_bars(case: str, got: dict, bars) -> str:
    """Each bar of `bars` held by `got` (a name to value map); returns
    every value of `got` printed, each beside its bars; fails naming the
    first bar that does not hold."""
    for metric, op, want in bars:
        if not holds(got[metric], op, want):
            raise AssertionError(f"phase 21 {case}: {metric} = {got[metric]!r} misses its "
                                 f"bar {op} {want}")
    return ", ".join(
        f"{metric} {v!r}" + "".join(f" ({op} {want})" for m, op, want in bars if m == metric)
        for metric, v in got.items())


@contextlib.contextmanager
def per_query_dist():
    """While open, keeps each query's sps and cpm as the stats printer
    computes them (the floats its show_dist log records carry, as
    `{"sps": [...], "cpm": [...]}`); the records go nowhere else."""
    import logging

    got = {"sps": [], "cpm": []}
    keys = {"orig_idty: %.6f": "sps", "cpm: %.6f": "cpm"}

    class Keep(logging.Handler):
        def emit(self, record):
            if record.msg in keys:
                got[keys[record.msg]].append(record.args[0])

    log = logging.getLogger("sina.stats")
    handler, level, propagate = Keep(logging.INFO), log.level, log.propagate
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    try:
        yield got
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
        log.propagate = propagate


def accuracy_run(bundle: str, device: str, step: int = 104, **kw) -> tuple[dict, dict]:
    """tests/test_accuracy.py's run() on the port's Pipeline on `device`:
    show_dist, every `step`-th sequence of the bundle realigned against
    it in batches of 48; returns the run's summary and the per-query sps
    and cpm."""
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinderConfig
    from sina_tpu_torch.pipeline import Pipeline, PipelineConfig

    fam = FamFinderConfig(fs_full_len=1200, fs_req_gaps=1,
                          fs_kmer_len=kw.pop("fs_kmer_len", 10),
                          fs_no_fast=kw.pop("fs_no_fast", False),
                          fs_leave_query_out=kw.pop("fs_leave_query_out", False),
                          fs_msc_max=kw.pop("fs_msc_max", 2.0))
    ali = AlignerConfig(realign=kw.pop("realign", False), engine=kw.pop("engine", "auto"))
    cfg = PipelineConfig(in_path=bundle, db=bundle, outputs=[], show_dist=True,
                         select_step=step, famfinder=fam, aligner=ali, batch_size=48,
                         device=device, **kw)
    with per_query_dist() as per:
        summary = Pipeline(cfg).run()
    return summary, per


# tests/test_accuracy_multiseed.py's cases: (name, fixture, metric, bars)
MULTISEED_CASES = [
    *[(f"fresh_seed[{seed}]", ("ltp", seed), ("realign", "graph"),
       [("n", ">=", 40), ("mean sps", ">", 0.996), ("mean cpm", "<", 0.0003),
        ("min sps", ">", 0.99), ("max cpm", "<", 0.003)]) for seed in (777, 2024)],
    ("worst_case_profile_engine", ("ltp", 777), ("realign", "profile"),
     [("mean sps", ">", 0.996), ("min sps", ">", 0.985), ("max cpm", "<", 0.005)]),
    *[(f"divergent[{seed}]", ("small", seed), ("divergent", "graph"),
       [("mean sps", ">", 0.975), ("min sps", ">", 0.95)]) for seed in (11, 12)],
    *[(f"partial_length[{seed}]", ("small", seed), ("partial", "graph"),
       [("mean sps", ">", 0.97), ("min sps", ">", 0.90)]) for seed in (11, 12)],
]


def multiseed_metrics(db, kind: str, engine: str, seed: int, device) -> dict:
    """One multiseed case's per-query metrics on `device`, summarised as
    its bars read them."""
    from sina_tpu_torch import testing

    cpm = None
    if kind == "realign":
        sps, cpm = testing.realign_metrics(db, engine=engine, device=device)
    elif kind == "divergent":
        truths = testing.make_queries(db, n=40, seed=seed + 1, branch_len=1.4)
        sps = testing.align_vs_truth(db, [testing.unaligned_copy(q) for q in truths],
                                     truths, engine, device)
    else:
        reads, truths = testing.partial_reads(db, seed)
        sps = testing.align_vs_truth(db, reads, truths, engine, device)
    got = {"n": len(sps), "mean sps": float(sps.mean()), "min sps": float(sps.min())}
    if cpm is not None:
        got.update({"mean cpm": float(cpm.mean()), "max cpm": float(cpm.max())})
    return got


def phase_accuracy(dev, tmp: Path) -> None:
    """The JAX package's accuracy suite through the CUDA kernels: every
    case of tests/test_accuracy.py in ACCURACY_CASES (all but two of the
    fs-msc-max caps) on the port's Pipeline (cuda) against
    the generated LTP-like bundle, each with its own bars, and
    realign_k8 and realign_nofast again on the cpu, whose per-query sps
    and cpm must equal the card's; then the seven cases of
    tests/test_accuracy_multiseed.py on the port's famfinder and aligner
    (cuda) with that file's bars, per-query floors included."""
    import torch

    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import kernels

    t_phase = t0 = time.perf_counter()
    bundle = str(tmp / "ltp.sref")
    testing.make_reference_ltp(N_LTP, seed=1234).save(bundle)
    say(f"phase 21 setup: {N_LTP}-sequence LTP-like bundle in "
        f"{time.perf_counter() - t0:.1f}s")
    for case, kw, bars in ACCURACY_CASES:
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary, per = accuracy_run(bundle, str(dev), **dict(kw))
        torch.cuda.synchronize()
        got = {k: summary[k] for k in ("n_aligned", "avg_sps", "avg_cpm", "avg_idty")}
        took = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items()
                    if v or k == "graph_dense_route"}
        say(f"phase 21 {case}: {check_bars(case, got, bars)}; launches {launches}; "
            f"{took:.1f}s")
        if case in ACCURACY_TWINS:
            t0 = time.perf_counter()
            _, cper = accuracy_run(bundle, "cpu", **dict(kw))
            if cper != per or not per["sps"]:
                raise AssertionError(f"phase 21 {case}: per-query sps/cpm differ between "
                                     f"the card and the cpu")
            say(f"phase 21 {case} parity: {len(per['sps'])} queries' sps and "
                f"{len(per['cpm'])} cpm equal on cpu and gpu, as floats "
                f"({time.perf_counter() - t0:.1f}s on the cpu)")
    dbs = {}
    for case, (fixture, seed), (kind, engine), bars in MULTISEED_CASES:
        if (fixture, seed) not in dbs:
            dbs[fixture, seed] = (testing.make_reference_ltp(3000, seed=seed)
                                  if fixture == "ltp" else
                                  testing.make_reference(n_seqs=1000, n_core=1200,
                                                         width=2000, seed=seed))
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = multiseed_metrics(dbs[fixture, seed], kind, engine, seed, dev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items()
                    if v or k == "graph_dense_route"}
        say(f"phase 21 multiseed {case}: {check_bars(case, got, bars)}; launches "
            f"{launches}; {time.perf_counter() - t0:.1f}s")
    say(f"phase 21 accuracy: {len(ACCURACY_CASES)} cases of tests/test_accuracy.py and "
        f"{len(MULTISEED_CASES)} of tests/test_accuracy_multiseed.py held their bars on "
        f"the card in {time.perf_counter() - t_phase:.1f}s")


# phase 22: bench.py's operating points through bench_torch.py.  In the
# process, on phase 5's reference, index and famfinder: each mode's
# arguments and the kernels its timed window must launch
BENCH_MODES = {
    "default": ([], PROFILE_PATH),
    "graph": (["--graph"], GRAPH_PATH),
    "amplicon": (["--amplicon"], PROFILE_PATH),
    "search": (["--search"], ("kmer_score",)),
}
# the --search mode's first 16 queries again on the cpu, in batches of 8
BENCH_SEARCH_TWINS = 16
# the commands a user types, each a child process at bench.py's default
# 2,000 references x width 2,400 (--curve: 2k, 20k and 100k), with the
# JSON lines each must print
BENCH_CHILDREN = ((["--curve"], 3), (["--graph"], 1), (["--search"], 1), (["--amplicon"], 1))
BENCH_CHILD_TIMEOUT = 600
# the least share of its queries that each run must align (the warm-up
# batch included) or, with --search, classify (of its timed queries:
# nearest_slv set).  The search's share rests on the cpu runs: 24 of 24
# classified at 60 references (tests/test_torch_bench.py) and 128 of 128
# at 2,000 (bench_torch.py --cpu --search --n-queries 256)
BENCH_MIN_SHARE = 0.95
_BENCH_SUMMARY = re.compile(
    r"timed (\d+)(?: seqs)? in [\d.]+s \((?:aligned (\d+)/(\d+)|classified (\d+))\)")
# README.md's performance rows (README.md:63-75), each with the runs of
# phase 22 that give the port's figure: (mode, n_refs)
README_ROWS = (
    ("full-length rRNA (~1450nt), 2k refs", (("default", 2000),)),
    ("full-length, SILVA scale (100k refs, width 50k)", (("default", 100000),)),
    ("full-length, FULL SILVA NR scale (450k refs), one chip", (("default", 450000),)),
    ("V4 amplicons (~250nt)", (("amplicon", 2000), ("amplicon", 450000))),
    ("search + LCA classification", (("search", 2000), ("search", 450000))),
    ("graph (mseq-faithful) engine", (("graph", 2000), ("graph", 450000))),
)


def bench_shares(text: str) -> list[tuple[int, int]]:
    """(done, of) from each summary line bench_torch printed: aligned
    N/M, or classified N of the timed queries; fails unless each share
    reaches BENCH_MIN_SHARE."""
    got = []
    for m in _BENCH_SUMMARY.finditer(text):
        timed, aligned, total, classified = m.groups()
        got.append((int(aligned), int(total)) if aligned else (int(classified), int(timed)))
    for done, of in got:
        if done < BENCH_MIN_SHARE * of:
            raise AssertionError(f"phase 22: only {done} of {of} queries aligned or classified")
    return got


def bench_echo(prefix: str, text: str) -> None:
    """Print bench_torch's stderr lines (each begins with "# ")."""
    for line in text.splitlines():
        if line.startswith("# "):
            say(f"{prefix} {line[2:]}")


@contextlib.contextmanager
def kept_queries():
    """While open, keeps (in the list it yields) the queries of each
    bench_torch.workload call."""
    import bench_torch

    kept = []
    workload = bench_torch.workload

    def keeping(args, db=None):
        db, queries = workload(args, db)
        kept.append(queries)
        return db, queries

    bench_torch.workload = keeping
    try:
        yield kept
    finally:
        bench_torch.workload = workload


def bench_in_process(dev, tmp: Path, finder, db) -> dict:
    """Each of BENCH_MODES through bench_torch.run on phase 5's
    reference and famfinder; the --search mode's first queries again on
    the cpu.  Returns {mode: the JSON line's dict}."""
    import io

    import torch

    import bench_torch
    from sina_tpu_torch.ops import kernels

    lines = {}
    for mode, (extra, path) in BENCH_MODES.items():
        args = bench_torch.parse_args(["--n-refs", str(len(db)), "--width", str(db.width),
                                       *extra])
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        err = io.StringIO()
        t0 = time.perf_counter()
        with kept_queries() as kept, contextlib.redirect_stderr(err):
            out, records = bench_torch.run(args, db=db, finder=finder, device=dev)
        took = time.perf_counter() - t0
        launches = dict(kernels.launches)
        text = err.getvalue()
        bench_echo(f"phase 22 {mode} |", text)
        (done, of), = bench_shares(text)
        missing = [k for k in path if launches[k] == 0]
        if missing:
            raise AssertionError(f"phase 22 {mode}: kernels never launched: {missing}")
        if len(records) != args.n_queries:
            raise AssertionError(f"phase 22 {mode}: {len(records)} records of "
                                 f"{args.n_queries}")
        if mode == "search":
            classified = sum(1 for r in records[args.batch_size:]
                             if r is not None and r.get_attr("nearest_slv"))
            if classified != done:
                raise AssertionError(f"phase 22 search: {classified} records carry "
                                     f"nearest_slv, the summary says {done}")
            search_twins(tmp, finder, db, records[:BENCH_SEARCH_TWINS])
        else:
            fa = tmp / f"bench_{mode}.fasta"
            fasta_text([r for r in records if r is not None], fa)
            if check_records(fa, kept[0], db.width) != done:
                raise AssertionError(f"phase 22 {mode}: the records and the summary's "
                                     f"count differ")
        say(f"phase 22 {mode}: {json.dumps(out)}")
        say(f"phase 22 {mode}: {'classified' if mode == 'search' else 'aligned'} {done} of "
            f"{of}; {args.n_queries} queries in batches of {args.batch_size} at "
            f"{len(db)} references x width {db.width}; the call took {took:.1f}s; timed "
            f"window launches {launches} on {gpu_line()}")
        peak_memory(f"phase 22 {mode}")
        lines[mode] = out
    return lines


def search_twins(tmp: Path, finder, db, gpu_records) -> None:
    """bench_torch.run --search on the cpu for the first
    BENCH_SEARCH_TWINS queries (batches of half that): nearest_slv,
    lca_tax_slv and the records equal the card's."""
    import io

    import torch

    import bench_torch

    args = bench_torch.parse_args(["--n-refs", str(len(db)), "--width", str(db.width),
                                   "--search", "--n-queries", str(BENCH_SEARCH_TWINS),
                                   "--batch-size", str(BENCH_SEARCH_TWINS // 2)])
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        _, cpu_records = bench_torch.run(args, db=db, finder=finder, device=torch.device("cpu"))
    for field in ("nearest_slv", "lca_tax_slv"):
        got = [r.get_attr(field) for r in cpu_records]
        if got != [r.get_attr(field) for r in gpu_records]:
            raise AssertionError(f"phase 22 search: {field} differs between the card and "
                                 f"the cpu")
    if (fasta_text(gpu_records, tmp / "bench_gpu16.fasta")
            != fasta_text(cpu_records, tmp / "bench_cpu16.fasta")):
        raise AssertionError("phase 22 search: records differ between the card and the cpu")
    say(f"phase 22 search parity: {len(cpu_records)} records, their nearest_slv and "
        f"lca_tax_slv identical on cpu and gpu ({time.perf_counter() - t0:.1f}s on the cpu)")


def bench_children() -> list[dict]:
    """Each of BENCH_CHILDREN as the command a user types: `python
    bench_torch.py ARGS` in a child process, which must exit 0 and
    print its JSON lines (and nothing else) on stdout; returns them,
    each with its mode and reference count."""
    import gc

    import bench_torch

    gc.collect()
    say(f"phase 22 before the child processes: {host_memory()}")
    root = Path(__file__).resolve().parent
    lines = []
    for extra, n_lines in BENCH_CHILDREN:
        name = " ".join(extra)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(root / "bench_torch.py"), *extra], cwd=root,
                             capture_output=True, text=True, timeout=BENCH_CHILD_TIMEOUT)
        took = time.perf_counter() - t0
        bench_echo(f"phase 22 child {name} |", res.stderr)
        if res.returncode != 0:
            raise AssertionError(f"phase 22: bench_torch.py {name} exited {res.returncode}:\n"
                                 f"{res.stderr[-3000:]}")
        got = [json.loads(line) for line in res.stdout.strip().splitlines()]
        if len(got) != n_lines or len(bench_shares(res.stderr)) != n_lines:
            raise AssertionError(f"phase 22: bench_torch.py {name} printed {len(got)} JSON "
                                 f"lines, not {n_lines}:\n{res.stdout[-2000:]}")
        for line in got:
            say(f"phase 22 child {name}: {json.dumps(line)}")
        say(f"phase 22 child {name}: exit 0, {n_lines} JSON line(s), the last line of its "
            f"stdout one, in {took:.1f}s")
        mode = "default" if extra == ["--curve"] else extra[0][2:]
        n_refs = bench_torch.parse_args(extra).n_refs
        lines += [dict(line, mode=mode, n_refs=line.get("n_refs", n_refs)) for line in got]
    return lines


def phase_bench(dev, tmp: Path, finder, db) -> None:
    """bench.py's operating points through bench_torch.py: its four
    modes in this process at phase 5's scale, then the commands a user
    types as child processes; prints the port's figure for each of
    README.md's performance rows."""
    t0 = time.perf_counter()
    inproc = bench_in_process(dev, tmp, finder, db)
    got = {(mode, len(db)): line for mode, line in inproc.items()}
    for line in bench_children():
        got[line["mode"], line["n_refs"]] = line
    for row, runs in README_ROWS:
        say(f"phase 22 README row '{row}': " + "; ".join(
            f"{got[m, n]['value']} seq/s at {n} references ({m})" for m, n in runs))
    say(f"phase 22 on {gpu_line()}: {time.perf_counter() - t0:.1f}s")


# phase 23: the port of __graft_entry__.entry() in this process, then the
# port's graft entry and tools as the commands a user types, each a
# child process: (module, arguments).  prof_famfinder at phase 5's and
# phase 20's batches over a random 450k-reference index (14.76 GB flat,
# 15.03 GB tiled, beside this process's 14.76 GB index); prof_profiledp
# at its defaults and at the amplicon shape; diag_accuracy on both
# engines, whose summary line must equal the same command's with
# --device cpu
TOOL_CHILDREN = (
    ("sina_tpu_torch.graft_entry", []),
    *(("sina_tpu_torch.tools.prof_famfinder",
       ["--n-refs", str(N_REFS), "--batch", str(b), "--topk", str(k)])
      for b in (B_MAIN, B_AMPLICON) for k in (256, 1000)),
    ("sina_tpu_torch.tools.prof_profiledp", []),
    ("sina_tpu_torch.tools.prof_profiledp",
     ["--c", "512", "--m", "256", "--batch", str(B_AMPLICON)]),
    ("sina_tpu_torch.tools.prof_wire_ab", []),
    ("sina_tpu_torch.tools.diag_accuracy", ["--engine", "graph"]),
    ("sina_tpu_torch.tools.diag_accuracy", ["--engine", "profile"]),
)
TOOL_CHILD_TIMEOUT = 300


def tool_start(module: str, args: list) -> tuple:
    """Start `python -m module args` in a child process from the repo's
    root; tool_wait collects it."""
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, module, args, time.perf_counter()


def tool_wait(child: tuple, tag: str) -> str:
    """Wait for a tool_start child, which must exit 0 within
    TOOL_CHILD_TIMEOUT seconds; prints its stdout lines after `tag` and
    returns them."""
    proc, module, args, t0 = child
    try:
        out, err = proc.communicate(timeout=TOOL_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    name = " ".join([module.rsplit(".", 1)[-1], *args])
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: python -m {module} {' '.join(args)} exited "
                             f"{proc.returncode}:\n{out[-2000:]}\n{err[-3000:]}")
    for line in out.splitlines():
        say(f"{tag} {name} | {line}")
    say(f"{tag} {name}: exit 0 in {time.perf_counter() - t0:.1f}s")
    return out


def phase_entry_and_tools(dev) -> None:
    """graft_entry.entry() on the card against its plain run on the cpu
    (vals, ids, best_j, best_i and raw equal), its kernels launched;
    then TOOL_CHILDREN, each exiting 0, diag_accuracy's summary line
    equal to its cpu run's."""
    import torch

    from sina_tpu_torch import graft_entry
    from sina_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fn, args = graft_entry.entry(dev)
    kernels.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launched = {k: kernels.launches[k] for k in ("kmer_score", "graph_dp_dense")}
    cfn, cargs = graft_entry.entry("cpu")
    want = cfn(*cargs)
    for name, a, b in zip(("vals", "ids", "best_j", "best_i", "raw"), got, want):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"phase 23 entry(): {name} differs from the cpu's")
    if launched != {"kmer_score": 1, "graph_dp_dense": 1}:
        raise AssertionError(f"phase 23 entry(): launches {launched}")
    say(f"phase 23 entry() on {dev}: {[tuple(t.shape) for t in got]}, equal to the cpu's "
        f"(vals, ids, best_j, best_i, raw exact); launches {launched}")
    peak_memory("phase 23 (entry)")
    del got, want, args
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"phase 23 before the child processes: {free / 1e9:.2f} of {total / 1e9:.2f} GB of "
        f"device memory free")
    timed = [c for c in TOOL_CHILDREN if not c[0].endswith("diag_accuracy")]
    for module, extra in timed:
        tool_wait(tool_start(module, extra), "phase 23")
    # diag_accuracy times nothing: its cpu runs go beside its card runs
    diag = [c for c in TOOL_CHILDREN if c not in timed]
    cpu = [tool_start(module, extra + ["--device", "cpu"]) for module, extra in diag]
    try:
        for (module, extra), twin in zip(diag, cpu):
            card = tool_wait(tool_start(module, extra), "phase 23").splitlines()[0]
            plain = tool_wait(twin, "phase 23 cpu").splitlines()[0]
            if card != plain:
                raise AssertionError(f"phase 23 diag_accuracy {extra}: summary {card!r} "
                                     f"differs from the cpu's {plain!r}")
    finally:
        for proc, *_ in cpu:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    say(f"phase 23 on {gpu_line()}: {time.perf_counter() - t0:.1f}s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    from sina_tpu_torch.align import AlignerConfig

    start = time.perf_counter()

    def lap(phases: str) -> None:
        say(f"-- phases {phases} done: {time.perf_counter() - start:.1f}s since the start")

    smi = phase_environment()
    phase_build()
    lap("1-2")
    db, t_db = make_db()
    ddb, t_ddb = make_indel_db()
    lap("5's and 18's references")
    timing = phase_kernels(dev, db)
    timing.update(phase_graph_kernels(dev))
    timing.update(phase_dense_kernels(dev, ddb))
    lap("3")
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        phase_cli(tmp)
        lap("4")
        launches, gpu16, queries16, finder, kmers = phase_main_path(dev, tmp, db, t_db)
        phase_cpu_parity(finder, gpu16, queries16, tmp, AlignerConfig(),
                         "phase 6")
        lap("5-6")
        glaunches, ggpu16, gqueries16 = phase_graph_path(dev, tmp, finder, db)
        phase_cpu_parity(finder, ggpu16, gqueries16, tmp,
                         AlignerConfig(engine="graph"), "phase 8")
        lap("7-8")
        dense_launches = phase_dense_path(dev, db)
        lap("9")
        tgpu16, tqueries16, tfinder, scfg = phase_turn_search(dev, finder, db)
        phase_cpu_parity(tfinder, tgpu16, tqueries16, tmp, AlignerConfig(),
                         "phase 11", scfg)
        lap("10-11")
        flaunches, fgpu16, fqueries16 = phase_forbid_path(dev, tmp, finder, db)
        phase_cpu_parity(finder, fgpu16, fqueries16, tmp,
                         AlignerConfig(insertion="forbid"), "phase 13")
        lap("12-13")
        phase_sharded_search(dev, finder, kmers)
        lap("14")
        mgpu16, mqueries16, mfinder = phase_mesh_famfinder(dev, tmp, finder, db)
        phase_cpu_parity(mfinder, mgpu16, mqueries16, tmp, AlignerConfig(), "phase 15")
        del mfinder
        lap("15")
        phase_multihost(tmp)
        phase_dryrun(dev)
        lap("16-17")
        dlaunches, dgpu16, dqueries16, dfinder = phase_indel_path(dev, tmp, ddb, t_ddb)
        phase_cpu_parity(dfinder, dgpu16, dqueries16, tmp, AlignerConfig(engine="graph"),
                         "phase 18")
        lap("18")
        phase_transfers(dev, tmp, finder, db, dfinder, ddb)
        lap("19")
        del dfinder, ddb
        phase_amplicon_path(dev, tmp, finder, db)
        lap("20")
        phase_accuracy(dev, tmp)
        lap("21")
        phase_bench(dev, tmp, finder, db)
        lap("22")
        phase_entry_and_tools(dev)
        lap("23")
    # each kernel's launches from the path that runs it
    launches.update({k: glaunches[k] for k in ("graph_dp", "graph_traceback")})
    launches.update({k: dlaunches[k] for k in ("graph_dp_dense", "graph_traceback_dense")})
    launches["kmer_score_dense"] = dense_launches
    launches["profile_dp_forbid"] = flaunches["profile_dp_forbid"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **timing[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
