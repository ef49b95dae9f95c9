"""Command-line interface of the PyTorch/CUDA port.

The option surface of sina_tpu/cli.py (the reference's CLI contract,
sina.cpp:379-440), plus --device {cuda,cpu}.  --jax-profile-dir keeps
the reference's name and writes a torch.profiler trace; --multihost
joins a torch.distributed (gloo) process group.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from . import __version__
from .align import AlignerConfig
from .famfinder import FamFinderConfig
from .parallel import multihost
from .pipeline import Pipeline, PipelineConfig
from .search import SearchConfig


def _profiled(trace_dir: str, device):
    """A torch.profiler context that writes its trace (a Chrome trace
    JSON, readable by TensorBoard's profiler plugin or Perfetto) into
    `trace_dir`: the counterpart of the reference's jax.profiler.trace
    (sina_tpu/cli.py:567-573)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # record_shapes: the program's spans carry their batch ids as inputs
    return profile(activities=activities, record_shapes=True,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def _split_fields(s: str) -> list[str]:
    return [f for f in s.replace(":", ",").split(",") if f]


def detect_type(path: str, explicit: str = "auto") -> str:
    if explicit != "auto":
        return explicit
    p = Path(path)
    suffixes = p.suffixes
    if p.suffix == ".arb":
        return "arb"
    if p.suffix in (".csv", ".tsv") or (
        p.suffix == ".gz"
        and len(suffixes) > 1
        and suffixes[-2] in (".csv", ".tsv")
    ):
        return "csv"
    return "fasta"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sina_tpu_torch",
        description=(
            "sina-tpu, PyTorch/CUDA port: reference-based sequence "
            "alignment (reimplementation of SINA)"
        ),
    )
    p.add_argument("--version", "-V", action="version",
                   version=f"sina-tpu (torch port) {__version__}")
    p.add_argument("--help-all", action="help",
                   help="show help for all options (the reference "
                   "hides advanced options behind this; here they "
                   "are one listing)")
    p.add_argument("--has-cli-vers", default=None, metavar="VERS",
                   help="verify support of cli version")
    p.add_argument("-i", "--in", dest="in_path", default="-",
                   help="input file (fasta[.gz])")
    p.add_argument("-o", "--out", dest="out", action="append",
                   default=[], help="output file (fasta or csv), "
                   "may be given multiple times")
    p.add_argument("--intype", default="auto",
                   choices=["auto", "none", "arb", "fasta", "csv"])
    p.add_argument("--outtype", action="append", default=[],
                   choices=["auto", "none", "arb", "fasta", "csv"])
    p.add_argument("-r", "--db", dest="db", help="reference database "
                   "(.sref bundle or aligned fasta)")
    p.add_argument("-t", "--turn", nargs="?", const="revcomp",
                   default="none", choices=["none", "revcomp", "all"],
                   help="check/fix read orientation")
    p.add_argument("-P", "--prealigned", action="store_true",
                   help="skip alignment stage")
    p.add_argument("--no-align", action="store_true",
                   help="disable alignment stage (same as prealigned)")
    p.add_argument("-S", "--search", action="store_true",
                   help="enable search stage")
    p.add_argument("--add-relatives", type=int, default=0)
    p.add_argument("-f", "--fields", default="")
    p.add_argument("--min-idty", type=float, default=0.0)
    p.add_argument("-p", "--threads", type=int, default=0,
                   help="(compatibility; batching is automatic)")
    p.add_argument("--num-pts", type=int, default=0,
                   help="(compatibility; no PT servers here)")
    p.add_argument("--preserve-order", action="store_true",
                   help="(always true in this implementation)")
    p.add_argument("--max-in-flight", type=int, default=0,
                   help="(compatibility)")
    p.add_argument("--batch-size", type=int, default=128,
                   help="queries per device batch")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; the CUDA kernels) "
                   "or cpu (their plain PyTorch versions)")
    p.add_argument("--show-conf", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    p.add_argument("--log-file", default="")
    p.add_argument("--jax-profile-dir", default="",
                   help="write a torch.profiler trace of the run (CPU "
                   "activity, and CUDA activity on the card) to this "
                   "directory (the option keeps the reference's name)")
    p.add_argument("--show-dist", action="store_true")
    p.add_argument("--show-diff", action="store_true")
    p.add_argument("--colors", action="store_true",
                   help="distinguish printed bases using colors")
    p.add_argument("--orig-db", default="")
    p.add_argument("--select-step", type=int, default=1,
                   help="read every Nth input sequence")
    p.add_argument("--select-skip", type=int, default=0,
                   help="skip the first N input sequences")
    p.add_argument("--select-file", default="",
                   help="file with names of sequences to process")

    g = p.add_argument_group("Aligner")
    g.add_argument("--realign", action="store_true")
    g.add_argument("--overhang", default="attach",
                   choices=["attach", "remove", "edge"])
    g.add_argument("--lowercase", default="none",
                   choices=["none", "original", "unaligned"])
    g.add_argument("--insertion", default="shift",
                   choices=["shift", "forbid", "remove"])
    g.add_argument("--fs-no-graph", action="store_true",
                   help="use profile vector instead of DAG as template"
                   " (the default here; see --fs-graph)")
    g.add_argument("--fs-graph", action="store_true",
                   help="force the reference-faithful DAG aligner")
    g.add_argument("--fs-weight", type=float, default=1.0)
    g.add_argument("--match-score", type=float, default=2.0)
    g.add_argument("--mismatch-score", type=float, default=-1.0)
    g.add_argument("--pen-gap", type=float, default=5.0)
    g.add_argument("--pen-gapext", type=float, default=2.0)
    g.add_argument("--write-used-rels", action="store_true")
    g.add_argument("--calc-idty", action="store_true")
    g.add_argument("--use-subst-matrix", action="store_true",
                   help="use experimental scoring system (graph engine "
                   "only)")
    g.add_argument("--no-col-trim", action="store_true",
                   help="disable trimming the profile-DP lattice to "
                   "each query's anchored column window (a speedup for "
                   "short reads; trimming is conservative "
                   "and falls back to the full lattice when k-mer "
                   "anchoring is weak)")
    g.add_argument("--col-trim-min-cols", type=int, default=4096,
                   help="only trim when the family's occupied-column "
                   "count is at least this (host-side anchoring has a "
                   "cost; narrow lattices are cheaper untrimmed)")
    g.add_argument("--debug-graph", action="store_true",
                   help="dump reference graphs to .dot files "
                   "(graph engine)")
    g.add_argument("--debug-lattice", metavar="FROM:TO", default="",
                   help="dump the DP lattice region of alignment "
                   "columns [FROM, TO) per query to "
                   "lattice_<name>.dot (cell values, gap tracks, "
                   "backpointer edges; small regions only)")

    g = p.add_argument_group("Reference Selection")
    g.add_argument("--fs-engine", default="internal",
                   choices=["internal", "pt-server"])
    g.add_argument("--ptdb", default="",
                   help="(compatibility; PT server not used)")
    g.add_argument("--ptport", default="",
                   help="(compatibility; PT server not used)")
    g.add_argument("--fs-kmer-len", type=int, default=10)
    g.add_argument("--fs-req", type=int, default=1)
    g.add_argument("--fs-min", type=int, default=40)
    g.add_argument("--fs-max", type=int, default=40)
    g.add_argument("--fs-msc", type=float, default=0.7)
    g.add_argument("--fs-msc-max", type=float, default=2.0)
    g.add_argument("--fs-leave-query-out", action="store_true")
    g.add_argument("--fs-req-full", type=int, default=1)
    g.add_argument("--fs-full-len", type=int, default=1400)
    g.add_argument("--fs-req-gaps", type=int, default=10)
    g.add_argument("--fs-min-len", type=int, default=150)
    g.add_argument("--fs-cover-gene", type=int, default=0)
    g.add_argument("--fs-kmer-no-fast", action="store_true")
    g.add_argument("--fs-kmer-mm", type=int, default=0,
                   help="(compatibility; mismatching k-mers not "
                   "supported by the internal engine, as in the "
                   "reference)")
    g.add_argument("--fs-kmer-norel", action="store_true")
    g.add_argument("--fs-oldmatch", action="store_true",
                   help="legacy family composition (pt-server only "
                   "in the reference; not supported here)")
    g.add_argument("--gene-start", type=int, default=0)
    g.add_argument("--gene-end", type=int, default=0)
    g.add_argument("--filter", dest="posvar_filter", default="")
    g.add_argument("--auto-filter-field", default="")
    g.add_argument("--auto-filter-threshold", type=float, default=0.8)

    g = p.add_argument_group("Search & Classify")
    g.add_argument("--search-db", default="")
    g.add_argument("--search-engine", default="internal",
                   choices=["internal", "pt-server"])
    g.add_argument("--search-min-sim", type=float, default=0.7)
    g.add_argument("--search-max-result", type=int, default=10)
    g.add_argument("--search-all", action="store_true")
    g.add_argument("--search-no-fast", action="store_true")
    g.add_argument("--search-kmer-candidates", type=int, default=1000)
    g.add_argument("--search-kmer-len", type=int, default=10)
    g.add_argument("--search-kmer-mm", type=int, default=0,
                   help="(compatibility; pt-server only in the "
                   "reference)")
    g.add_argument("--search-kmer-norel", action="store_true",
                   help="(compatibility; pt-server only in the "
                   "reference)")
    g.add_argument("--search-port", default="",
                   help="(compatibility; PT server not used)")
    g.add_argument("--search-ignore-super", action="store_true")
    g.add_argument("--search-copy-fields", default="")
    g.add_argument("--lca-fields", default="")
    g.add_argument("--lca-quorum", type=float, default=0.7)
    g.add_argument("--search-iupac", default="optimistic",
                   choices=["optimistic", "pessimistic", "exact"])
    g.add_argument("--search-correction", default="none",
                   choices=["none", "jc"])
    g.add_argument("--search-cover", default="query",
                   choices=["abs", "query", "target", "overlap", "all",
                            "average", "min", "max", "nogap"])
    g.add_argument("--search-filter-lowercase", action="store_true")

    g = p.add_argument_group("FASTA I/O")
    g.add_argument("--meta-fmt", default="none",
                   choices=["none", "header", "comment", "csv"])
    g.add_argument("--line-length", type=int, default=0)
    g.add_argument("--fasta-write-dots", action="store_true")
    g.add_argument("--fasta-write-dna", action="store_true")
    g.add_argument("--fasta-block", type=int, default=0)
    g.add_argument("--fasta-idx", type=int, default=0)

    g = p.add_argument_group("Multi-host")
    g.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed (gloo) process "
                   "group; each process reads its own --fasta-block "
                   "shard of the input and writes <out>.part<idx> (the "
                   "batched psina, rw_fasta.cpp:209-242)")
    g.add_argument("--coordinator", default="",
                   help="coordinator address host:port of process 0 "
                   "(multihost; default: MASTER_ADDR/MASTER_PORT from "
                   "the environment, as torchrun sets them)")
    g.add_argument("--num-processes", type=int, default=0,
                   help="process count (multihost; default: WORLD_SIZE "
                   "from the environment)")
    g.add_argument("--process-id", type=int, default=-1,
                   help="this process's id (multihost; default: RANK "
                   "from the environment)")

    g = p.add_argument_group("CSV I/O")
    g.add_argument("--csv-crlf", action="store_true")
    g.add_argument("--csv-id", default="name")
    g.add_argument("--csv-sep", default="",
                   help="overrides field separator; default ',' or "
                   "TAB if the output file ends in .tsv")

    g = p.add_argument_group("ARB I/O (compatibility)")
    g.add_argument("--arb-list-fields", action="store_true",
                   help="list metadata fields of the reference "
                   "bundle and exit")
    g.add_argument("--build-refdb", default="", metavar="DIR.sref",
                   help="build a reference bundle from the aligned "
                   "input FASTA (-i; the reference's arb2fasta "
                   "export) plus optional --refdb-metadata CSV, "
                   "write it to DIR.sref and exit.  Field names "
                   "follow doc/source/fields.rst (acc, start, stop, "
                   "tax_slv, ...); the CSV's first/'name' column "
                   "keys rows by sequence name")
    g.add_argument("--refdb-metadata", default="", metavar="CSV",
                   help="per-sequence metadata CSV for --build-refdb")
    g.add_argument("--markaligned", action="store_true",
                   help="(compatibility; ARB output unsupported)")
    g.add_argument("--markcopied", action="store_true",
                   help="(compatibility; ARB output unsupported)")
    g.add_argument("--prot-level", type=int, default=4,
                   help="(compatibility; ARB output unsupported)")
    return p


def config_from_args(args) -> PipelineConfig:
    outputs = []
    outtypes = list(args.outtype)
    outs = list(args.out)
    if not outs:
        outputs.append(("fasta", "-"))
    for i, o in enumerate(outs):
        t = outtypes[i] if i < len(outtypes) else "auto"
        # "none" is a null sink, not a file (sina.cpp:125-126 maps
        # TYPE_NONE to a no-op writer); /dev/null likewise.  Loud,
        # because a computed output name that happens to be "none"
        # would otherwise be discarded silently (use ./none for a
        # literal file of that name).
        if str(o).lower() == "none" or str(o) == "/dev/null":
            logging.getLogger("sina").info(
                "output '%s' is the null sink — results for this "
                "output are discarded (use ./none for a literal "
                "file)", o,
            )
            continue
        t = detect_type(o, t)
        if t == "none":
            continue
        if t == "arb":
            raise SystemExit(
                "sina-tpu: ARB container output is not supported; "
                "use fasta or csv"
            )
        outputs.append((t, o))

    intype = detect_type(args.in_path, args.intype)
    if intype == "arb":
        raise SystemExit(
            "sina-tpu: ARB container input is not supported; convert "
            "the reference with arb2fasta and build a .sref bundle"
        )
    if intype == "csv":
        raise SystemExit(
            "Input type CSV invalid - can't parse sequences from that"
        )
    if args.fs_oldmatch:
        raise SystemExit(
            "Legacy family composition only available for pt-server "
            "engine"
        )
    if args.fs_engine == "pt-server" or args.search_engine == "pt-server":
        logging.getLogger("sina").warning(
            "pt-server engine not available; using internal engine"
        )
    # accepted-for-compatibility flags the internal engine cannot
    # honour (the reference's pt-server engine reads them; its own
    # internal engine ignores them too, kmer_search.cpp:330-360) —
    # warn loudly instead of silently scoring differently
    _inert = []
    if args.fs_kmer_mm > 0:
        _inert.append(
            ("--fs-kmer-mm", "mismatching k-mers are a pt-server "
             "feature; the internal engine matches exactly")
        )
    if args.fs_kmer_norel:
        _inert.append(
            ("--fs-kmer-norel", "the internal engine always scores "
             "absolute k-mer counts (norel is already its behavior "
             "for ranking; relative scoring is not implemented)")
        )
    if args.search_kmer_mm > 0:
        _inert.append(
            ("--search-kmer-mm", "mismatching k-mers are a pt-server "
             "feature; the internal engine matches exactly")
        )
    if args.search_kmer_norel:
        _inert.append(
            ("--search-kmer-norel", "the internal engine always "
             "scores absolute k-mer counts")
        )
    for flag, why in _inert:
        logging.getLogger("sina").warning(
            "%s has no effect with the internal engine (%s); "
            "results may differ from a pt-server run", flag, why,
        )

    prealigned = args.prealigned or args.no_align
    fam = FamFinderConfig(
        turn=args.turn,
        fs_kmer_len=args.fs_kmer_len,
        fs_no_fast=args.fs_kmer_no_fast,
        fs_min=args.fs_min,
        fs_max=args.fs_max,
        fs_msc=args.fs_msc,
        fs_msc_max=args.fs_msc_max,
        fs_leave_query_out=args.fs_leave_query_out,
        fs_req=args.fs_req,
        fs_req_full=args.fs_req_full,
        fs_full_len=args.fs_full_len,
        fs_req_gaps=args.fs_req_gaps,
        fs_min_len=args.fs_min_len,
        fs_cover_gene=args.fs_cover_gene,
        gene_start=args.gene_start,
        gene_end=args.gene_end,
        posvar_filter=args.posvar_filter,
        posvar_autofilter_field=args.auto_filter_field,
        posvar_autofilter_thres=args.auto_filter_threshold,
    )
    ali = AlignerConfig(
        realign=args.realign,
        overhang=args.overhang,
        lowercase=args.lowercase,
        insertion=args.insertion,
        fs_weight=args.fs_weight,
        match_score=args.match_score,
        mismatch_score=args.mismatch_score,
        gap_penalty=args.pen_gap,
        gap_ext_penalty=args.pen_gapext,
        calc_idty=args.calc_idty,
        write_used_rels=args.write_used_rels,
        fs_no_graph=args.fs_no_graph,
        use_subst_matrix=args.use_subst_matrix,
        debug_graph=args.debug_graph,
        debug_lattice=args.debug_lattice,
        engine="graph" if args.fs_graph else "auto",
        col_trim=not args.no_col_trim,
        col_trim_min_cols=args.col_trim_min_cols,
    )
    srch = SearchConfig(
        min_sim=args.search_min_sim,
        max_result=args.search_max_result,
        kmer_candidates=args.search_kmer_candidates,
        search_all=args.search_all,
        ignore_super=args.search_ignore_super,
        lca_fields=_split_fields(args.lca_fields),
        lca_quorum=args.lca_quorum,
        copy_fields=_split_fields(args.search_copy_fields),
        kmer_len=args.search_kmer_len,
        no_fast=args.search_no_fast,
        iupac=args.search_iupac,
        correction=args.search_correction,
        cover=args.search_cover,
        filter_lowercase=args.search_filter_lowercase,
    )
    return PipelineConfig(
        in_path=args.in_path,
        outputs=outputs,
        db=args.db,
        search_db=args.search_db or None,
        prealigned=prealigned,
        do_search=args.search,
        add_relatives=args.add_relatives,
        fields=_split_fields(args.fields),
        batch_size=args.batch_size,
        show_dist=args.show_dist,
        show_diff=args.show_diff,
        orig_db=args.orig_db or None,
        famfinder=fam,
        aligner=ali,
        search=srch,
        meta_fmt=args.meta_fmt,
        line_length=args.line_length,
        out_dots=args.fasta_write_dots,
        out_dna=args.fasta_write_dna,
        min_idty=args.min_idty,
        fasta_block=args.fasta_block,
        fasta_idx=args.fasta_idx,
        csv_crlf=args.csv_crlf,
        csv_id=args.csv_id,
        csv_sep=args.csv_sep,
        colors=args.colors,
        select_step=args.select_step,
        select_skip=args.select_skip,
        select_file=args.select_file,
        multihost=args.multihost,
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=args.device,
    )


def setup_logging(verbose: int, quiet: int, log_file: str = "") -> None:
    from .progress import attach_terminal_sink

    level = logging.WARNING + 10 * quiet - 10 * verbose
    handlers = [attach_terminal_sink(logging.StreamHandler(sys.stderr))]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=max(level, logging.DEBUG),
        format="%(levelname)s [%(name)s] %(message)s",
        handlers=handlers,
        force=True,
    )


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.has_cli_vers is not None:
        # CLI-version handshake for ARB integration (sina.cpp:272-284)
        print(
            f"** SINA (SILVA Incremental Aligner) {__version__} "
            "present",
            file=sys.stderr,
        )
        if args.has_cli_vers in ("1", "2", "ARB5.99"):
            return 0
        print(
            "** Error: requested CLI version not supported!",
            file=sys.stderr,
        )
        return 1
    setup_logging(args.verbose, args.quiet, args.log_file)
    log = logging.getLogger("sina")
    log.warning("This is sina-tpu %s (torch port).", __version__)
    if args.arb_list_fields:
        # list the bundle's metadata fields (rw_arb.cpp:120-156)
        from .refdb import ReferenceDb

        path = args.db or args.in_path
        if not path or path == "-":
            print("--arb-list-fields needs a database (-r/-i)",
                  file=sys.stderr)
            return 1
        try:
            db = ReferenceDb.open(path)
        except (ValueError, FileNotFoundError, OSError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        keys = sorted({k for s in db.sequences for k in s.attrs})
        for k in keys:
            print(k)
        return 0
    if args.build_refdb:
        # arb2fasta-style aligned FASTA (+ metadata CSV) -> .sref bundle
        from .refdb import ReferenceDb

        if not args.in_path or args.in_path == "-":
            print("--build-refdb needs an input FASTA (-i)",
                  file=sys.stderr)
            return 1
        try:
            db = ReferenceDb.from_fasta(
                args.in_path,
                metadata_csv=args.refdb_metadata or None,
            )
            db.save(args.build_refdb)
        except (ValueError, FileNotFoundError, OSError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        log.warning(
            "wrote %s (%d sequences, width %d)",
            args.build_refdb, len(db), db.width,
        )
        return 0
    try:
        cfg = config_from_args(args)
    except (ValueError, FileNotFoundError) as e:
        print(f"Configuration error:\n{e}", file=sys.stderr)
        return 1
    if args.show_conf:
        # effective per-module config (sina.cpp:191-202 prints the
        # validated module options, not the raw argv)
        print("Effective parameters:", file=sys.stderr)
        import dataclasses

        def dump(title, obj):
            print(f"[{title}]", file=sys.stderr)
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    continue
                print(f"  {f.name} = {v}", file=sys.stderr)

        dump("pipeline", cfg)
        dump("famfinder", cfg.famfinder)
        dump("aligner", cfg.aligner)
        dump("search", cfg.search)
    try:
        return _run(cfg, args)
    finally:
        multihost.shutdown()


def _run(cfg: PipelineConfig, args) -> int:
    try:
        pipe = Pipeline(cfg)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"Configuration error:\n{e}", file=sys.stderr)
        return 1
    try:
        if args.jax_profile_dir:
            with _profiled(args.jax_profile_dir, pipe.device):
                summary = pipe.run()
        else:
            summary = pipe.run()
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0 if summary["n_in"] == 0 or summary["n_aligned"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
