"""The graph engine's dense route (sina_tpu_torch/csrc/graph_dense.cu: the
dense POA DP and its walk) in its build variants, timed in turns on one
NVIDIA GPU at the main path's shapes.

    python3 -u dense_variants.py [--parent DIR] [--reps N] [--variants a,b]

Each variant is a graph_dense.cu built by its own nvcc (all started
together, with the port's flags) into a library of its own under
sina_tpu_torch/_build/variants:

  design     the kernels as they ship;
  parent     with --parent DIR: DIR/sina_tpu_torch/csrc/graph_dense.cu, the
             kernels' first design (for instance the previous commit
             unpacked by `git archive`), whose C interface takes the ring
             depth maxd + 1 and a global ring of that many rows a query;
  VARIANTS   the design's source with one step taken out or done another
             way (the edits listed in VARIANTS), each exact.

Buckets (chip_smoke.py's): phase 3's dense bucket, 128 family graphs of
phase 18's reference (one reference in 20 with a 48-base insertion) and
128 full-length queries, N = 4096, M = 1536, in the simple and the forbid
mode; and the graph kernels' bucket (largest predecessor distance 11),
simple, with graph_dp.cu (the package's own build) in the same turns. The
walk on the design's plane of the dense bucket, warm (launched again and
again on one plane) and cold (L2 flushed before each launch). Every variant
is held bit-exact to the design on each bucket (bp and the end cells; the
walk's emit and done), the design to the plain PyTorch versions on the
dense bucket in both modes. Each time is the mean of REPS launches by CUDA
events, the variants visited in the order design, parent, VARIANTS and
back, twice. Also printed: the design's launch plans, each plane's real
nodes, ptxas's registers and spills for each instantiation.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# node j+1's first two deep rows (d > max(S, 1)) loaded a node ahead, between
# node j's probe and its scan: the form step 3 of the redesign first took
_PROBE_DEEP = """            int gs = gcur - d;
            if (gs < 0) gs += K;
            load_row<L>(scratch + (long long)gs * stride, Mp, i0, t, Vp, Dp, vl);
"""
_REPEAT_IF = """    // a repeated node (no predecessors, the previous node's record) stores
    // the kept rows and backpointers again
    if (!(flags & kFlagRepeat)) {
"""
_DEEP_SLOTS = """      const int pn[kSlots] = {n2.x, n2.y, n2.z, n2.w, n3.x, n3.y, n3.z, n3.w};
      int np = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int d = j + 1 - pn[s];
        if (pn[s] >= 0 && d > 1 && d > S && d <= maxd && np < kPf) {
          int gs = gcur + 1 - d;
          if (gs < 0) gs += K;
"""
_AFTER_PROBE = ("      }\n\n      float U[L], cand[L], ugio[L];",
                "      }\n      prefetch();\n\n      float U[L], cand[L], ugio[L];")
_COMMON = [("constexpr int kRecChunk = 32;\n", "constexpr int kRecChunk = 32;\nconstexpr int kPf = 2;\n"),
           ("      bool seen = false;\n", "      bool seen = false;\n      int nd = 0;\n"),
           _AFTER_PROBE]
# the design with one step taken out, or done another way; each is exact:
#   no_repeat           repeated padding nodes computed
#   records_global      node records read from device memory a node ahead
#                       (not staged in shared memory)
#   no_shared_ring      no shared ring: every row past distance 1 from the
#                       scratch
#   prefetch_registers  the next node's first two deep rows loaded into
#                       registers a node ahead
#   prefetch_cp_async   the same rows staged by cp.async into two shared rows
#                       a buffer, two buffers by node parity (fewer ring rows)
VARIANTS = {
    "no_repeat": [("    if (!(flags & kFlagRepeat)) {\n", "    if (true) {\n")],
    "records_global": [
        ("      const int4* nx = s_rec[((j + 1) / kRecChunk) & 1][(j + 1) % kRecChunk];\n",
         "      const int4* nx = tab + 4LL * (j + 1);\n")],
    "no_shared_ring": [("  p->S = (int)(room / row < maxd ? room / row : maxd);\n",
                        "  p->S = 0;\n")],
    "prefetch_registers": _COMMON + [
        ("  float vleft = kBig;\n",
         "  float vleft = kBig;\n  float pfV[kPf][L], pfD[kPf][L], pfl[kPf];\n"),
        (_REPEAT_IF, "    auto prefetch = [&]() {\n      if (j + 1 >= N || K == 0) return;\n"
         + _DEEP_SLOTS + """          const float* row = scratch + (long long)gs * stride;
          if (np == 0) {
            load_row<L>(row, Mp, i0, t, pfV[0], pfD[0], pfl[0]);
          } else {
            load_row<L>(row, Mp, i0, t, pfV[1], pfD[1], pfl[1]);
          }
          ++np;
        }
      }
    };
    if (flags & kFlagRepeat) prefetch();
    if (!(flags & kFlagRepeat)) {
"""),
        (_PROBE_DEEP, """            if (nd == 0) {
              copy_row<L>(Vp, Dp, vl, pfV[0], pfD[0], pfl[0]);
            } else if (nd == 1) {
              copy_row<L>(Vp, Dp, vl, pfV[1], pfD[1], pfl[1]);
            } else {
""" + _PROBE_DEEP + """            }
            ++nd;
""")],
    "prefetch_cp_async": _COMMON + [
        ("__device__ __forceinline__ void cp_async_wait_all() {",
         """__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {"""),
        ("template <int L>\n__device__ __forceinline__ void copy_row(",
         """template <int L>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int Mp, int i0, int t) {
#pragma unroll
  for (int k = 0; k < L; k += 4) {
    cp_async16(dst + i0 + k, src + i0 + k);
    cp_async16(dst + Mp + i0 + k, src + Mp + i0 + k);
  }
  cp_async4(dst + 2 * Mp + t, src + 2 * Mp + t);
}
template <int L>
__device__ __forceinline__ void copy_row("""),
        ("  float* s_fb = s_dyn + S * stride;                       // forbid's S rows",
         "  float* s_pf = s_dyn + S * stride;\n"
         "  float* s_fb = s_pf + (K > 0 ? 2 * kPf * stride : 0);"),
        (_REPEAT_IF, "    auto prefetch = [&]() {\n      if (j + 1 >= N || K == 0) return;\n"
         + _DEEP_SLOTS + """          stage_row<L>(s_pf + (((j + 1) & 1) * kPf + np) * stride,
                       scratch + (long long)gs * stride, Mp, i0, t);
          ++np;
        }
      }
      asm volatile("cp.async.commit_group;\\n" ::: "memory");
    };
    if (flags & kFlagRepeat) prefetch();
    if (!(flags & kFlagRepeat)) {
"""),
        (_PROBE_DEEP, """            if (nd < kPf) {
              if (nd == 0) cp_async_wait_all();
              load_row<L>(s_pf + ((j & 1) * kPf + nd) * stride, Mp, i0, t, Vp, Dp, vl);
            } else {
""" + _PROBE_DEEP + """            }
            ++nd;
"""),
        ("  p->dyn_smem = (int)(p->S * row + forbid);",
         """  const long long pf = p->K ? 2LL * kPf * row : 0;
  if (p->K) {
    if (room - pf < 0) return cudaErrorInvalidValue;
    p->S = (int)((room - pf) / row);
  }
  p->dyn_smem = (int)(p->S * row + pf + forbid);""")],
}
HEADERS = ("dp_scan.cuh", "forbid_window.cuh", "traceback_window.cuh")


def build(variants: dict) -> dict:
    """nvcc each variant's graph_dense.cu into its own library; returns
    {name: (library path, ptxas log)}; raises on a failed build."""
    from sina_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()

    def one(item):
        name, src = item
        so = out_dir / f"libgraph_dense_{name}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-o", str(so),
               str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
        return name, (so, res.stdout + res.stderr)

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def ptxas_regs(log: str) -> dict:
    """{instantiation: (registers, spill stores)} from nvcc -Xptxas -v:
    dp L (and forbid), walk V."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(graph_dense(_traceback)?_kernel)"
                      r"(?:ILi(\d+)E(?:Lb([01])E)?)?", line)
        if m:
            kind = "walk" if m.group(2) else "dp"
            key = f"{kind} {m.group(3) or ''}{' forbid' if m.group(4) == '1' else ''}".strip()
        m = re.search(r"(\d+) bytes spill stores", line)
        if key and m:
            out.setdefault(key, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out.setdefault(key, [None, 0])[0] = int(m.group(1))
            key = None
    return {k: tuple(v) for k, v in out.items()}


class Variant:
    """One build's C entry points. `abi` "design" is this checkout's
    interface (the plan takes maxd; a scratch only where the plan asks
    for one), "parent" the first design's (the plan takes no depth; a
    ring of maxd + 1 rows a query always)."""

    def __init__(self, so: Path, abi: str):
        lib = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sina_graph_dp_dense.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P]
        lib.sina_graph_dp_dense.restype = I
        lib.sina_graph_dp_dense_plan.argtypes = [I, I, I, P] if abi == "design" else [I, I, P]
        lib.sina_graph_dp_dense_plan.restype = I
        lib.sina_graph_traceback_dense.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
        lib.sina_graph_traceback_dense.restype = I
        self.lib, self.abi = lib, abi

    def plan(self, M: int, aspace: bool, maxd: int) -> dict:
        if self.abi == "design":
            out = (ctypes.c_longlong * 8)()
            err = self.lib.sina_graph_dp_dense_plan(M, int(aspace), maxd, out)
            keys = ("lanes", "threads", "ring_row", "dyn_smem", "static_smem", "regs",
                    "shared_rows", "scratch_rows")
        else:
            out = (ctypes.c_longlong * 6)()
            err = self.lib.sina_graph_dp_dense_plan(M, int(aspace), out)
            keys = ("lanes", "threads", "ring_row", "dyn_smem", "static_smem", "regs")
        if err:
            raise RuntimeError(f"sina_graph_dp_dense_plan: CUDA error {err}")
        return dict(zip(keys, out))

    def dp(self, d: dict, cw, max_ins, maxd: int):
        """A function that launches the DP on the bucket `d` into fixed
        outputs, and the outputs (bp, best)."""
        import torch

        from sina_tpu_torch.ops import align_kernel as ak
        from sina_tpu_torch.ops.align_kernel import DpParams

        params = DpParams()
        B, N = d["pos"].shape
        M = d["qmask"].shape[1]
        dev = cw.device
        plan = self.plan(M, max_ins is not None, maxd)
        design = self.abi == "design"
        rows = plan["scratch_rows"] if design else maxd + 1
        chip = max(plan["shared_rows"], 1) if design and rows else None
        table = ak.dense_node_table(d["pos"], d["mask"], d["weight"], d["preds"],
                                    d["is_start"], d["is_end"], d["n_real"], cw, params,
                                    max_ins, M=M, chip_depth=chip)
        smat = torch.zeros((B, 16), dtype=torch.float32, device=dev)
        bp = torch.empty((B, N, M), dtype=torch.int16, device=dev)
        best = torch.empty((B, 8), dtype=torch.float32, device=dev)
        ring = (torch.empty((B, rows * plan["ring_row"]), dtype=torch.float32, device=dev)
                if rows else None)
        args = (table.data_ptr(), d["qmask"].data_ptr(), d["qlen"].data_ptr(), smat.data_ptr(),
                bp.data_ptr(), best.data_ptr(), None if ring is None else ring.data_ptr(),
                B, N, M, maxd if design else maxd + 1, int(max_ins is not None), 0,
                params.match, params.mismatch)

        def go():
            err = self.lib.sina_graph_dp_dense(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sina_graph_dp_dense: CUDA error {err}")

        go.keep = (table, smat, bp, best, ring)  # the launch's memory, while go lives
        go()
        return go, (bp, best)

    def walk(self, bp, bj, bi, preds, start):
        """A function that launches the walk into fixed outputs, and the
        outputs (emit, done)."""
        import torch

        B, N, M = bp.shape
        emit = torch.empty((B, M), dtype=torch.int32, device=bp.device)
        done = torch.empty(B, dtype=torch.int32, device=bp.device)
        args = (bp.data_ptr(), bj.data_ptr(), bi.data_ptr(), preds.data_ptr(),
                start.data_ptr(), emit.data_ptr(), done.data_ptr(), B, N, M, preds.shape[2])

        def go():
            err = self.lib.sina_graph_traceback_dense(*args,
                                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sina_graph_traceback_dense: CUDA error {err}")

        go.keep = (bp, bj, bi, preds, start, emit, done)
        go()
        return go, (emit, done)


def decode(best, qlen):
    """best_j, best_i, raw from the DP's (B, 8) end cells, as
    ops/align_kernel.graph_dp_dense decodes them."""
    import torch

    v1, j1, v2, j2, i2 = (best[:, k] for k in range(5))
    use2 = v2 < v1
    return (torch.where(use2, j2, j1).long(), torch.where(use2, i2.long(), qlen.long() - 1),
            torch.where(use2, v2, v1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose graph_dense.cu is timed beside")
    ap.add_argument("--reps", type=int, default=10, help="launches a timing")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build and time (default all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from sina_tpu_torch.ops import align_kernel as ak
    from sina_tpu_torch.ops import graph_kernel as gk
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.ops.align_kernel import DpParams

    if not torch.cuda.is_available():
        print("dense_variants: no CUDA device", file=sys.stderr)
        return 1
    src = kernels.CSRC / "graph_dense.cu"
    variants = {"design": src}
    if args.parent:
        variants["parent"] = Path(args.parent) / "sina_tpu_torch/csrc/graph_dense.cu"
    text = src.read_text()
    for name in [a for a in args.variants.split(",") if a]:
        cut_text = text
        for old, new in VARIANTS[name]:
            if cut_text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in graph_dense.cu once")
            cut_text = cut_text.replace(old, new)
        cut = kernels.BUILD_DIR / "variants" / name / "graph_dense.cu"
        cut.parent.mkdir(parents=True, exist_ok=True)
        cut.write_text(cut_text)
        for h in HEADERS:
            (cut.parent / h).write_text((kernels.CSRC / h).read_text())
        variants[name] = cut
    built = build(variants)
    libs = {n: Variant(so, "parent" if n == "parent" else "design")
            for n, (so, _) in built.items()}
    for n, (_, log) in built.items():
        print(f"dense_variants {n}: ptxas (registers, spill stores) {ptxas_regs(log)}")

    dev = torch.device("cuda")
    gpu = cs.gpu_line()
    order = list(libs)
    visits = " ".join(order + order[::-1])

    def time_ms(fn) -> float:
        return cs.time_ms(fn, args.reps)

    def turns(fns: dict) -> dict:
        times = {n: [] for n in fns}
        for _ in range(2):
            for n in list(fns) + list(fns)[::-1]:
                times[n].append(time_ms(fns[n]))
        return {n: float(np.mean(t)) for n, t in times.items()}

    def say(label: str, res: dict) -> None:
        print(f"dense_variants {label} ({gpu}; ms a launch, mean of {args.reps}, visits "
              f"{' '.join(list(res) + list(res)[::-1])}, twice): "
              + ", ".join(f"{n} {t:.3f}" for n, t in res.items()), flush=True)

    def check(name, got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} disagrees with the design ({what}, "
                                     f"{int((a != b).sum())} cells)")

    params = DpParams()
    ddb, _ = cs.make_indel_db()
    fg = cs.family_graphs(ddb, seed=37)
    maxd = fg["maxd"]
    d = {k: a.to(dev) for k, a in fg["ops"].items()}
    width = fg["width"]
    ones = torch.ones((cs.B_MAIN, width), dtype=torch.float32, device=dev)
    real = int(d["n_real"].sum())
    print(f"dense_variants dense bucket: B={cs.B_MAIN} N={cs.N_GRAPH} M={cs.M_MAIN} "
          f"maxd={maxd}, {real} real nodes of {cs.B_MAIN * cs.N_GRAPH} "
          f"({100 * real / (cs.B_MAIN * cs.N_GRAPH):.1f}%); visits {visits}")
    walk_plane = None
    for mode, max_ins in (("simple", None), ("forbid", fg["budget"].to(dev))):
        print(f"dense_variants design plan ({mode}): "
              f"{libs['design'].plan(cs.M_MAIN, max_ins is not None, maxd)}")
        fns, want = {}, None
        for n, v in libs.items():
            fns[n], out = v.dp(d, ones, max_ins, maxd)
            if want is None:
                want = out
                ref = ak.poa_dp_dense(d["pos"], d["mask"], d["weight"], d["preds"],
                                      d["is_start"], d["is_end"], d["qmask"], d["qlen"],
                                      d["n_real"], ones, params, max_ins)
                got = (want[0], *decode(want[1], d["qlen"]))
                check("the plain version", got, ref, f"dense {mode}")
                del ref
            else:
                check(n, out, want, f"dense {mode}")
                del out
        say(f"graph_dp_dense {mode}, dense bucket", turns(fns))
        # the design's launch alone, through its wrapper (which also builds
        # the node table and allocates the outputs), and the table alone
        nodes = (d["pos"], d["mask"], d["weight"], d["preds"], d["is_start"], d["is_end"])
        say(f"graph_dp_dense {mode}, dense bucket, the wrapper's share", turns({
            "launch": fns["design"],
            "wrapper": lambda: ak.graph_dp_dense(*nodes, d["qmask"], d["qlen"], d["n_real"],
                                                 ones, params, max_ins, maxd=maxd),
            "table": lambda: ak.dense_node_table(*nodes, d["n_real"], ones, params, max_ins,
                                                 M=cs.M_MAIN, chip_depth=16)}))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ak.dense_node_table(*nodes, d["n_real"], ones, params, max_ins, M=cs.M_MAIN,
                                chip_depth=16)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"dense_variants node table ({mode}): {len(ev)} device operations, "
              f"{sum(e.time_range.elapsed_us() for e in ev) / 1e3:.3f} ms of device time", flush=True)
        if mode == "simple":
            bj, bi, _ = decode(want[1], d["qlen"])
            walk_plane = (want[0], bj.int(), bi.int(), d["preds"], d["is_start"])
        else:
            del want
        del fns
        torch.cuda.empty_cache()

    bp = walk_plane[0]
    emit_ref, done_ref = ak.traceback_dense(bp, walk_plane[1], walk_plane[2], *walk_plane[3:])
    print(f"dense_variants walk plan: {ak.graph_traceback_dense_plan(bp)}")
    fns, want = {}, None
    for n, v in libs.items():
        fns[n], out = v.walk(*walk_plane)
        check(n if want is not None else "the plain version", out,
              want if want is not None else (emit_ref, done_ref), "walk")
        want = want or out
    say("graph_traceback_dense warm, dense bucket", turns(fns))
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cold = {n: [] for n in fns}
    for _ in range(2):
        for n in order + order[::-1]:
            cold[n].append(cs.time_launch_ms(fns[n], args.reps, flush))
    print(f"dense_variants graph_traceback_dense cold, dense bucket ({gpu}; ms one launch "
          f"alone after an L2 flush, mean of {args.reps}): "
          + ", ".join(f"{n} {np.mean(t):.3f}" for n, t in cold.items()), flush=True)
    del walk_plane, bp, fns, want, d, flush
    torch.cuda.empty_cache()

    ops, _, k_ring, width, dense = cs.graph_bucket()
    ops = [a.to(dev) for a in ops]
    dense = {k: a.to(dev) for k, a in dense.items()}
    ones = torch.ones((cs.B_MAIN, width), dtype=torch.float32, device=dev)
    maxd = k_ring - 1
    print(f"dense_variants graph kernels' bucket: maxd={maxd}; design plan "
          f"{libs['design'].plan(cs.M_MAIN, False, maxd)}")
    fns, want = {}, None
    for n, v in libs.items():
        fns[n], out = v.dp(dense, ones, None, maxd)
        if want is None:
            want = out
        else:
            check(n, out, want, "graph kernels' bucket")
    gref = gk.graph_dp(*ops, ones, None, None, params=params, k_ring=k_ring)
    got = decode(want[1], dense["qlen"])
    for a, b in zip(got, (gref[1].long(), gref[2].long(), gref[3])):
        if not torch.equal(a, b):
            raise AssertionError("the dense design's end cells differ from graph_dp's")
    fns["graph_dp.cu"] = lambda: gk.graph_dp(*ops, ones, None, None, params=params,
                                             k_ring=k_ring)
    say("graph_dp_dense simple, graph kernels' bucket (graph_dp.cu beside)", turns(fns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
