"""The profile DP's bounded-insertion (forbid) kernel in its build
variants, timed in turns on one NVIDIA GPU at the main path's shape
(B = 128 query rows, C = 2048 columns, M = 1536 positions).

    python3 forbid_variants.py [--parent DIR] [--other NAME=DIR ...] [--reps N] [--sass DIR]

Each variant is sina_tpu_torch/csrc/profile_dp.cu built by its own nvcc
(all started together, with the port's flags) into a library of its own
under sina_tpu_torch/_build/variants:

  design     the kernel as it ships;
  parent     with --parent DIR: DIR/sina_tpu_torch/csrc/profile_dp.cu (for
             instance the previous commit unpacked by `git archive`);
  NAME       with --other NAME=DIR, another checkout's, the same way;
  ABLATIONS  the design with its source changed, timed (and, where exact,
             held to the design).

Budget planes: one budget in every cell for each of chip_smoke.py's
FORBID_UNIFORM_R, phase 3's synthetic mix (chip_smoke.forbid_bucket's
random plane), and 128 rows of real families and queries of a
4,096-reference cut of phase 5's reference, whose budgets the aligner's
rule gives (their class shares are printed).  Every variant but the
inexact ablations is held bit-exact to the design on every plane, and
the design to the plain PyTorch version on the real plane.  Each
plane's times are the mean of REPS launches by CUDA events, the
variants visited in the order design, parent, the others, the
ablations and back, twice.  Also printed: the shift mode of the design
and the parent in the same turns, ptxas's registers and spills for each
instantiation, each instantiation's SASS instruction count, and whether
the shift mode's SASS equals the parent's (cuobjdump).
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
B, C, M = 128, 2048, 1536
# the design with a change to its source: (exact, [(text, replacement)]).
# Exact: the wide-window carries at every R >= 1 (no R <= 32 K class); the
# wide-window carries inlined into the column loop; 8 lanes a thread in the
# forbid mode at every M (half the threads, 256 lanes a warp); the warp
# scans' five rounds run whole, their skip tests taking the round bound (no
# branch a round). Not exact, for where the time goes: the warp scans'
# shuffle rounds, the S-row reads after the barrier (R <= 32 K: each window
# becomes P[x]), the barrier, the wide-window path's code (R > 32 K taking
# the R <= 32 K carries).
ABLATIONS = {
    "general": (True, [("  if (R <= W) {\n", "  if (false) {\n")]),
    "no_warp_scan": (False, [("      if (off >= reach) break;\n", "      break;\n")]),
    "no_window_read": (False, [("      win[i] = fminf(s, take ? fminf(px[i], cw) : px[i]);\n",
                                "      win[i] = take ? fminf(px[i], cw) : px[i];\n")]),
    "no_barrier": (False, [("  __syncthreads();\n  stage();\n", "  stage();\n")]),
    "no_wide": (False, [("  if (R <= W) {\n", "  if (true) {\n")]),
    "inline_wide": (True, [("__device__ __noinline__ WideCarries wide_carries(",
                            "__device__ __forceinline__ WideCarries wide_carries(")]),
    "lanes8": (True, [
        ("  const int K = lanes_for(M);\n  const int threads = threads_for(M, K);\n"
         "  if (threads > SINA_PROFILE_MAX_THREADS(K)) return (int)cudaErrorInvalidValue;\n"
         "  const bool forbid = budget != nullptr;\n",
         "  const bool forbid = budget != nullptr;\n"
         "  const int K = forbid && lanes_for(M) < 8 ? 8 : lanes_for(M);\n"
         "  const int threads = threads_for(M, K);\n"
         "  if (threads > SINA_PROFILE_MAX_THREADS(K)) return (int)cudaErrorInvalidValue;\n")]),
    "fixed_rounds": (True, [
        ("      if (off >= reach) break;\n", ""),
        ("      if (lane0 + K - 1 - off * K >= s_last) fi",
         "      if (off < reach && lane0 + K - 1 - off * K >= s_last) fi"),
        ("      if (lane0 + off * K <= e_first) bi",
         "      if (off < reach && lane0 + off * K <= e_first) bi")]),
}


def build(variants: dict) -> dict:
    """nvcc each (source, defines) into its own library; returns
    {name: (library path, ptxas log)}; raises on a failed build."""
    from sina_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()

    def one(item):
        name, (src, defs) = item
        so = out_dir / f"libprofile_dp_{name}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, *defs, "-shared", "-I", str(src.parent),
               "-o", str(so), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
        return name, (so, res.stdout + res.stderr)

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def ptxas_regs(log: str) -> dict:
    """{(K, forbid): (registers, spill stores)} from nvcc -Xptxas -v."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*profile_dp_kernelILi(\d+)ELb([01])E", line)
        if m:
            key = (int(m.group(1)), m.group(2) == "1")
        m = re.search(r"(\d+) bytes spill stores", line)
        if key and m:
            out.setdefault(key, [None, int(m.group(1))])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out.setdefault(key, [None, 0])[0] = int(m.group(1))
            key = None
    return {k: tuple(v) for k, v in out.items()}


def sass(so: Path) -> dict:
    """{(K, forbid): SASS lines} of each instantiation in `so`: each
    instruction with both words of its encoding (the second holds the
    scheduling controls), spaces collapsed; the function's name, whose
    anonymous-namespace hash follows the source's path, left out."""
    from sina_tpu_torch.ops import kernels

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        lines = part.splitlines()
        m = re.match(r".*profile_dp_kernelILi(\d+)ELb([01])E", lines[0])
        if m:
            out[int(m.group(1)), m.group(2) == "1"] = [
                " ".join(ln.split()) for ln in lines[1:] if "/*" in ln]
    return out


def count(lines: list) -> int:
    """Instructions in sass()'s lines (those with an address)."""
    return sum(bool(re.match(r"/\*[0-9a-f]{4}\*/", ln)) for ln in lines)


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sina_profile_dp.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, F, F, F, F, F, F, P]
    lib.sina_profile_dp.restype = I
    lib.sina_profile_dp_plan.argtypes = [I, I, P]
    lib.sina_profile_dp_plan.restype = I
    return lib


def real_bucket(rng, fgq, qmask, lens):
    """Every row a real family of 40 references with a real query, its
    budgets the aligner's (chip_smoke.forbid_bucket's rule, for all B
    rows), on a 4,096-reference cut of phase 5's reference."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops.align_kernel import DpParams
    from sina_tpu_torch.ops.profile import build_profiles_packed_batch

    import chip_smoke as cs

    db = testing.make_reference_large(4096, n_core=1450, width=cs.WIDTH, seed=1234)
    fgq, qmask, lens = fgq.copy(), qmask.copy(), lens.copy()
    qs = [q for q in testing.make_queries(db, n=4 * B, seed=21, branch_len=0.7)
          if len(q.masks) <= M][:B]
    fams = [db.sequences[int(q.attrs["parent"][3:]) // 64 * 64:][:cs.FAMILY] for q in qs]
    fg, cols = build_profiles_packed_batch(fams, C, DpParams())
    budget = np.zeros((B, C), np.int32)
    for b, (q, c) in enumerate(zip(qs, cols)):
        fgq[b] = fg[b]
        qmask[b] = 0
        qmask[b, :len(q.masks)] = q.masks
        lens[b] = (len(q.masks), len(c))
        budget[b, :len(c) - 1] = np.diff(c.astype(np.int64)) - 1
        budget[b, len(c) - 1] = db.width - int(c[-1]) - 1
    real = budget[np.arange(C)[None, :] < lens[:, 1:2]]
    shares = {"below 1": (real < 1).mean(), "1-4": ((real >= 1) & (real <= 4)).mean(),
              "5-128": ((real >= 5) & (real <= 128)).mean(),
              "129 to M-1": ((real >= 129) & (real < M)).mean(), "M or more": (real >= M).mean()}
    print("forbid_variants real plane: " + ", ".join(
        f"{k} {100 * v:.1f}%" for k, v in shares.items()) + f" of {real.size} real columns")
    return fgq, qmask, lens, budget


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose profile_dp.cu is timed beside")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout whose profile_dp.cu is timed beside, as NAME")
    ap.add_argument("--reps", type=int, default=5, help="launches a timing")
    ap.add_argument("--sass", help="a directory to write each variant's 4-lane SASS to")
    ap.add_argument("--ablations", default=",".join(ABLATIONS),
                    help="comma-separated names of ABLATIONS to build and time (default all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from sina_tpu_torch.ops import kernels
    from sina_tpu_torch.ops import profile_kernel as pk
    from sina_tpu_torch.ops.align_kernel import DpParams

    if not torch.cuda.is_available():
        print("forbid_variants: no CUDA device", file=sys.stderr)
        return 1
    src = kernels.CSRC / "profile_dp.cu"
    variants = {"design": (src, [])}
    if args.parent:
        variants["parent"] = (Path(args.parent) / "sina_tpu_torch/csrc/profile_dp.cu", [])
    for other in args.other:
        name, _, where = other.partition("=")
        variants[name] = (Path(where) / "sina_tpu_torch/csrc/profile_dp.cu", [])
    # timing only (not exact): the design with a part taken out
    text = src.read_text()
    chosen = [a for a in args.ablations.split(",") if a]
    for name in chosen:
        _, edits = ABLATIONS[name]
        cut_text = text
        for old, new in edits:
            if cut_text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in profile_dp.cu once")
            cut_text = cut_text.replace(old, new)
        cut = kernels.BUILD_DIR / "variants" / name / "profile_dp.cu"
        cut.parent.mkdir(parents=True, exist_ok=True)
        cut.write_text(cut_text)
        (cut.parent / "dp_scan.cuh").write_text((kernels.CSRC / "dp_scan.cuh").read_text())
        variants[name] = (cut, [])
    built = build(variants)
    libs = {n: load(so) for n, (so, _) in built.items()}
    for n, (_, log) in built.items():
        plan = (ctypes.c_longlong * 5)()
        kernels.check(libs[n].sina_profile_dp_plan(M, 1, plan), "profile_dp_plan")
        print(f"forbid_variants {n}: ptxas (K, forbid): (registers, spill stores) "
              f"{ptxas_regs(log)}; forbid plan at M={M}: {list(plan)}")
    code = {n: sass(so) for n, (so, _) in built.items()}
    print("forbid_variants SASS instructions (K, forbid): " + "; ".join(
        f"{n} " + ", ".join(f"{k}: {count(v)}" for k, v in sorted(c.items()))
        for n, c in code.items()))
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for n, c in code.items():
            for forbid, tag in ((True, "forbid"), (False, "shift")):
                (Path(args.sass) / f"{n}_k4_{tag}.sass").write_text("\n".join(c[4, forbid]) + "\n")
    if "parent" in built:
        print("forbid_variants shift-mode SASS equal to the parent's: " + ", ".join(
            f"K={k} {code['design'][k, False] == code['parent'].get((k, False))}"
            for k in (4, 8, 16)))

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    params = DpParams()
    s = pk._scalars(params)
    fgq, qmask, lens = cs.synthetic_profiles(rng, B, C, M)
    planes = {}
    for r in cs.FORBID_UNIFORM_R:
        planes[f"R={r}"] = (fgq, qmask, lens, np.full((B, C), r, np.int32))
    choices = np.array([0, 0, 0, 1, 1, 2, 3, 5, 9, 17, 40, 200, M, M + 7, 10**6])
    planes["mix"] = (fgq, qmask, lens,
                     choices[rng.integers(0, len(choices), (B, C))].astype(np.int32))
    planes["real"] = real_bucket(rng, fgq, qmask, lens)

    def run(lib, tensors, budget):
        fg, qm, ln = tensors
        bp = torch.empty((C, B, M), dtype=torch.uint8, device=dev)
        bc = torch.empty(B, dtype=torch.int32, device=dev)
        bi = torch.empty(B, dtype=torch.int32, device=dev)
        raw = torch.empty(B, dtype=torch.float32, device=dev)
        kernels.check(lib.sina_profile_dp(
            fg.data_ptr(), None, qm.data_ptr(), ln.data_ptr(),
            budget.data_ptr() if budget is not None else None, bp.data_ptr(),
            bc.data_ptr(), bi.data_ptr(), raw.data_ptr(), B, C, M, s["go"], s["ge"],
            s["m_minus_mm"], s["mm"], s["inv255"], s["inv_gap_scale"],
            torch.cuda.current_stream().cuda_stream), "profile_dp")
        return bp, bc, bi, raw

    def time_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    order = list(libs)
    print(f"forbid_variants on {cs.gpu_line()}: B={B} C={C} M={M}, ms a launch "
          f"(mean of {args.reps}, visits {' '.join(order + order[::-1])}, twice)")
    for name, (fg_np, qm_np, ln_np, bud_np) in planes.items():
        tensors = tuple(torch.from_numpy(a).to(dev) for a in (fg_np, qm_np, ln_np))
        bud = torch.from_numpy(bud_np).to(dev)
        want = run(libs["design"], tensors, bud)
        if name == "real":
            ref = pk.profile_dp_plain(*tensors, params, budget=bud)
            if not all(torch.equal(a, b) for a, b in zip(want, ref)):
                raise AssertionError("design disagrees with the plain version on the real plane")
        for n, lib in libs.items():
            if n in ABLATIONS and not ABLATIONS[n][0]:
                continue
            if not all(torch.equal(a, b) for a, b in zip(run(lib, tensors, bud), want)):
                raise AssertionError(f"{n} disagrees with design on plane {name}")
        times = {n: [] for n in order}
        for _ in range(2):
            for n in order + order[::-1]:
                times[n].append(time_ms(lambda: run(libs[n], tensors, bud)))
        print(f"forbid_variants plane {name}: " + ", ".join(
            f"{n} {np.mean(t):.3f}" for n, t in times.items()), flush=True)
        if name == "mix":
            shift = {n: [] for n in order if n in ("design", "parent")}
            for _ in range(2):
                for n in list(shift) + list(shift)[::-1]:
                    shift[n].append(time_ms(lambda: run(libs[n], tensors, None)))
            print("forbid_variants shift mode, the same profiles: " + ", ".join(
                f"{n} {np.mean(t):.3f}" for n, t in shift.items()), flush=True)
        del tensors, bud, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
