"""The comparison that decides `correct`: what the timed window wrote
against the plain reference, worked again from the benchmark's own
generated arrays (the reference alignment and the queries it sent).

Numbers compared, each against its limit from the configuration:

- records_lost: queries sent in the window with no record at their
  place in the output (order preserved, nothing dropped);
- bases_altered: records whose bases are not the query's, in order;
- family_differs: sampled records whose family (used_rels) is not the
  reference's famfinder policy's;
- columns_differ_pct: sampled query bases that the record places in
  another alignment column than the reference's DP (the
  configuration's engine: profile or graph), traceback and finish place
  them, in % of the sampled bases;
- raw_rel_gap: the widest relative gap between a sampled record's DP
  score (raw, in its align_log_slv) and the reference's.

Where the configuration's command line turns reads (`--turn`), each
record's bases are compared with the query in the orientation its
turn_slv names; the sample is aligned in the orientation the plain turn
check picks, and one more number counts what it disagrees on:

- turn_differs: sampled records whose turn_slv is not the plain turn
  check's choice.

A configuration's `checks` name further modules, checks/<name>.py
(found by name in CHECK_DIRS, as the metrics are): each may give
further numbers and may replace the reference's alignment of the
sample.  Every number is judged by the limit of its name.

Plain PyTorch and NumPy; imports nothing of the program.
"""

from __future__ import annotations

import ast
import importlib.util
import types
from pathlib import Path

import numpy as np
import torch

from . import family, graph_dp, nast, profile_dp

# where a configuration's `checks` are looked for, in order
CHECK_DIRS = [Path(__file__).resolve().parent / "checks"]
# what a check module may not use, by whole top-level module name: JAX,
# the JAX package, and the program, whose answers the checks judge
CHECK_FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "sina_tpu", "sina_tpu_torch"))
# all a check's align(ctx) is given: the sample and the reference, none
# of the program's output (the control, which has no run, gives the same)
ALIGN_KEYS = ("queries", "turns", "refx", "config", "traffic", "device", "dtype")

_CHAR = np.zeros(256, dtype=np.uint8)
for _m, _c in zip((1, 2, 4, 8), b"AGCU"):
    _CHAR[_m] = _c


def sample_indices(n_rec: int, lengths: np.ndarray, n_sample: int, seed: int) -> np.ndarray:
    """`n_sample` record indices drawn from the seed, the record of the
    longest query among them."""
    if n_rec == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.default_rng(seed)
    pick = rng.choice(n_rec, size=min(n_sample, n_rec), replace=False)
    longest = int(np.argmax(lengths[:n_rec]))
    if longest not in pick:
        pick[0] = longest
    return np.sort(pick)


class Reference:
    """The reference alignment's arrays and k-mer sets on one device,
    with the family policy of the configuration."""

    def __init__(self, ref, policy: dict):
        self.ref = ref
        self.policy = policy
        self.kmers = family.RefKmers(ref.masks, ref.offsets)
        lens = ref.lengths()
        self.lengths = lens.cpu().numpy()
        nz = lens > 0
        first = torch.zeros_like(lens)
        last = torch.full_like(lens, -1)
        first[nz] = ref.positions[ref.offsets[:-1][nz]].long()
        last[nz] = ref.positions[(ref.offsets[1:] - 1)[nz]].long()
        self.first = first.cpu().numpy()
        self.last = last.cpu().numpy()

    def family_of(self, qmasks: np.ndarray) -> list[int]:
        q = torch.from_numpy(qmasks).to(self.ref.masks.device)
        scores = self.kmers.scores(q)
        order = family.ranking(scores)
        return family.select_family(order, scores, self.lengths, self.first, self.last,
                                    self.policy)

    def members(self, ids: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
        off = self.ref.offsets
        out = []
        for i in ids:
            lo, hi = int(off[i]), int(off[i + 1])
            out.append((self.ref.positions[lo:hi].cpu().numpy().astype(np.int64),
                        self.ref.masks[lo:hi].cpu().numpy()))
        return out


def _contained(q: np.ndarray, members) -> np.ndarray | None:
    """The aligner's copy path (align.cpp:328-389): the columns of the
    first member (of equal length, else in family order) that holds the
    query's bases verbatim, or None."""
    qb = (q & 0xF).tobytes()
    hits = []
    for pos, msk in members:
        at = (msk & 0xF).tobytes().find(qb)
        if at >= 0:
            hits.append((pos, at, len(msk)))
    if not hits:
        return None
    exact = [h for h in hits if h[2] == len(q)]
    pos, at, _ = exact[0] if exact else hits[0]
    return pos[at:at + len(q)]


def align_sample(refx: Reference, queries: list[np.ndarray], dtype=torch.float32,
                 engine: str = "profile"):
    """The reference's (family ids, columns, raw) for each query, with
    the configuration's engine."""
    dev = refx.ref.masks.device
    width = refx.ref.width
    fams = [refx.family_of(q) for q in queries]
    rows, copied = [], {}
    for b, (q, fam) in enumerate(zip(queries, fams)):
        mem = refx.members(fam)
        hit = _contained(q, mem)
        if hit is not None:
            copied[b] = hit
        elif engine == "graph":
            rows.append((b, graph_dp.build_graph(mem), q))
        else:
            rows.append((b, *profile_dp.build_profile(mem), q))
    cols_out: list = [None] * len(queries)
    raw_out = np.full(len(queries), np.nan)
    for b, hit in copied.items():
        cols_out[b] = hit.astype(np.int64)
    if rows and engine == "graph":
        bp, bj, bi, raw = graph_dp.graph_dp([r[1] for r in rows], [r[2] for r in rows], dev,
                                            dtype)
        bp, bj, bi = bp.cpu().numpy(), bj.cpu().numpy(), bi.cpu().numpy()
        raw = raw.float().cpu().numpy()
        for k, (b, g, q) in enumerate(rows):
            emit = graph_dp.traceback(bp[k], g["start"], int(bj[k]), int(bi[k]))
            cols_out[b] = nast.finish_columns(emit, len(q), int(bj[k]), int(bi[k]), g["pos"],
                                              width)
            raw_out[b] = raw[k]
    elif rows:
        C = max(len(r[2]) for r in rows)
        M = max(len(r[3]) for r in rows)
        fg = np.zeros((len(rows), C, 6), dtype=np.uint8)
        qm = np.zeros((len(rows), M), dtype=np.uint8)
        ql = np.zeros(len(rows), dtype=np.int64)
        cr = np.zeros(len(rows), dtype=np.int64)
        for k, (_, fgq, cols, q) in enumerate(rows):
            fg[k, :len(cols)] = fgq
            qm[k, :len(q)] = q
            ql[k], cr[k] = len(q), len(cols)
        t = [torch.from_numpy(a).to(dev) for a in (fg, qm, ql, cr)]
        bp, bc, bi, raw = profile_dp.chain_dp(*t, dtype=dtype)
        bp, bc, bi = bp.cpu().numpy(), bc.cpu().numpy(), bi.cpu().numpy()
        raw = raw.float().cpu().numpy()
        for k, (b, _, cols, q) in enumerate(rows):
            emit = profile_dp.traceback(bp[:, k, :], int(bc[k]), int(bi[k]))
            cols_out[b] = nast.finish_columns(emit, len(q), int(bc[k]), int(bi[k]), cols, width)
            raw_out[b] = raw[k]
    return fams, cols_out, raw_out


def turn_mode(cli: list[str]) -> str:
    """What `-t`/`--turn` in a command line asks for: "none", "revcomp"
    (the option alone) or "all", as the program's argparse reads it."""
    mode = "none"
    for j, a in enumerate(cli):
        if a in ("-t", "--turn"):
            nxt = cli[j + 1] if j + 1 < len(cli) else ""
            mode = nxt if nxt in ("none", "revcomp", "all") else "revcomp"
        elif a.startswith("--turn="):
            mode = a.split("=", 1)[1]
        elif a.startswith("-t") and not a.startswith("--") and len(a) > 2:
            mode = a[2:].lstrip("=")
    return mode


def turn_sample(refx: Reference, queries: list[np.ndarray], cli: list[str]):
    """(the plain turn check's orientation of each query, the queries
    turned to it) where the command line turns reads, else (None, the
    queries)."""
    mode = turn_mode(cli)
    if mode == "none":
        return None, queries
    turns = family.turn_check(refx.kmers, queries, mode == "all")
    return turns, [family.orient(q, w) for q, w in zip(queries, turns)]


def _top(name: str | None) -> str:
    return (name or "").split(".")[0]


def _forbidden_uses(path: Path, mod=None) -> set[str]:
    """The forbidden top-level modules that the source at `path` imports,
    or that the loaded `mod` holds a module or an object of."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found |= {_top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(_top(node.module))
    for v in vars(mod).values() if mod is not None else ():
        found.add(_top(v.__name__ if isinstance(v, types.ModuleType) else
                       getattr(v, "__module__", None)))
    return found & CHECK_FORBIDDEN


def load_checks(names: list[str]) -> list:
    """The modules a configuration's `checks` name, each checks/<name>.py
    in the first of CHECK_DIRS that holds it.  One that imports or holds
    anything of CHECK_FORBIDDEN stops the run."""
    mods = []
    for name in names:
        path = next((d / f"{name}.py" for d in CHECK_DIRS if (d / f"{name}.py").is_file()),
                    None)
        if path is None:
            raise SystemExit(f"benchmark: no check module {name}.py in "
                             f"{[str(d) for d in CHECK_DIRS]}")
        bad = _forbidden_uses(path)
        if not bad:
            spec = importlib.util.spec_from_file_location(f"check_{name.replace('.', '_')}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            bad = _forbidden_uses(path, mod)
        if bad:
            raise SystemExit(f"benchmark: check {name} uses {sorted(bad)}, which a check "
                             f"may not")
        if not (hasattr(mod, "numbers") or hasattr(mod, "align")):
            raise SystemExit(f"benchmark: check {name} has neither numbers() nor align()")
        mods.append(mod)
    return mods


def reference_alignment(ctx: dict, checks: list):
    """(families, columns, raws) of the sample's queries: a check's
    align, given ctx's ALIGN_KEYS alone, where one gives it, else
    align_sample in ctx's dtype and the configuration's engine."""
    own = [m for m in checks if hasattr(m, "align")]
    if len(own) > 1:
        raise SystemExit("benchmark: more than one check replaces the alignment")
    if own:
        return own[0].align({k: ctx[k] for k in ALIGN_KEYS})
    return align_sample(ctx["refx"], ctx["queries"], ctx["dtype"], ctx["config"]["engine"])


def compare(sent: list[str], records: dict, pool_masks: np.ndarray, pool_offsets: np.ndarray,
            refx: Reference, n_sample: int, seed: int, config: dict, traffic: dict | None = None,
            device: str = "cpu", dtype=torch.float32) -> dict:
    """The numbers compared for one window.  `sent` are the names of the
    queries sent, in order (name q<index> is pool query <index>);
    `records` the reader's keep-mode output; `config` and `traffic`
    the cell's (the engine, the command line, the checks)."""
    names = records["names"]
    n_ok = 0
    for a, b in zip(sent, names):
        if a != b:
            break
        n_ok += 1
    lost = len(sent) - n_ok + max(0, len(names) - len(sent))
    idx = np.array([int(s[1:]) for s in sent[:n_ok]], dtype=np.int64)
    qlens = pool_offsets[idx + 1] - pool_offsets[idx]
    turn = turn_mode(config["cli"])
    attrs = records.get("attrs")
    altered = 0
    for k in range(n_ok):
        lo = pool_offsets[idx[k]]
        q = pool_masks[lo:lo + qlens[k]]
        if turn != "none":
            name = attrs[k].get("turn_slv")
            if name not in family.TURN_NAMES:
                altered += 1
                continue
            q = family.orient(q, family.TURN_NAMES.index(name))
        want = _CHAR[q]
        got = records["bases"][k]
        if len(got) != len(want) or not np.array_equal(got, want):
            altered += 1
    pick = sample_indices(n_ok, qlens, n_sample, seed)
    queries = [pool_masks[pool_offsets[idx[k]]:pool_offsets[idx[k] + 1]] for k in pick]
    turns, queries = turn_sample(refx, queries, config["cli"])
    checks = load_checks(config.get("checks", []))
    ctx = {"sent": sent, "records": records, "n_ok": n_ok, "pool_idx": idx,
           "pool_masks": pool_masks, "pool_offsets": pool_offsets, "pick": pick,
           "queries": queries, "turns": turns, "refx": refx, "config": config,
           "traffic": traffic, "device": device, "dtype": dtype}
    fams, cols, raws = reference_alignment(ctx, checks)
    ctx.update(fams=fams, cols=cols, raws=raws)
    fam_diff, col_diff, n_bases, gap, turn_diff = 0, 0, 0, 0.0, 0
    for j, k in enumerate(pick):
        if turns is not None and attrs[k].get("turn_slv") != family.TURN_NAMES[turns[j]]:
            turn_diff += 1
        want_rels = " ".join(f"SEQ{i:06d}" for i in fams[j])
        if records["used_rels"][k] != want_rels:
            fam_diff += 1
        got = records["cols"][k].astype(np.int64)
        want = cols[j]
        n_bases += len(want)
        if len(got) != len(want):
            col_diff += len(want)
        else:
            col_diff += int((got != want).sum())
        if not np.isnan(raws[j]):
            r = float(records["raw"][k])
            gap = max(gap, abs(r - raws[j]) / max(abs(raws[j]), 1e-30)
                      if np.isfinite(r) else float("inf"))
    nums = {
        "records_lost": lost,
        "bases_altered": altered,
        "family_differs": fam_diff,
        "columns_differ_pct": 100.0 * col_diff / max(n_bases, 1),
        "raw_rel_gap": gap,
    }
    if turns is not None:
        nums["turn_differs"] = turn_diff
    for mod in checks:
        if not hasattr(mod, "numbers"):
            continue
        more = mod.numbers(ctx)
        clash = sorted(set(more) & set(nums))
        if clash:
            raise SystemExit(f"benchmark: check {mod.__name__} gives numbers already given: "
                             f"{clash}")
        nums.update(more)
    nums.update(_sampled=len(pick), _sampled_bases=n_bases, _records=n_ok)
    return nums
