"""Pipeline orchestrator: reader -> famfinder -> aligner -> search ->
writers -> stats.

Port of sina_tpu/pipeline.py.  The pipeline pulls *batches* of queries
so the two device stages (k-mer scoring and the alignment DP) run
wide, in a 3-deep software pipeline over batches: famfinder scoring
for batch N+1 is queued while batch N's DP runs and the host finishes
batch N-1, whose results were copied to the host as they came
(ops/transfer) (with the turn check, famfinder scores eagerly instead: its
orientations are scored, then the reoriented queries rescored).  Order
is preserved by construction.  A multi-host run (``multihost``) joins a
torch.distributed process group; each process reads its own
--fasta-block shard of the input and writes <out>.part<idx>.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from .align import AlignerConfig, align_dispatch, align_finalize
from .device import resolve_device
from .famfinder import FamFinder, FamFinderConfig, FamilyResult
from .io.csv import CsvWriter
from .io.fasta import FastaWriter, read_fasta
from .log_stats import StatsPrinter
from .progress import Progress
from .refdb import ReferenceDb
from .search import SearchConfig, SearchFilter
from .sequence import Sequence
from .timing import get_timer

logger = logging.getLogger("sina.pipeline")


@dataclass
class PipelineConfig:
    in_path: str = "-"
    outputs: list[tuple[str, str]] = field(default_factory=list)
    db: str | None = None
    search_db: str | None = None
    prealigned: bool = False
    do_search: bool = False
    add_relatives: int = 0
    fields: list[str] = field(default_factory=list)
    batch_size: int = 128
    show_dist: bool = False
    show_diff: bool = False
    orig_db: str | None = None
    device: str = "cuda"  # torch device: cuda, cuda:N or cpu

    famfinder: FamFinderConfig = field(default_factory=FamFinderConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)
    search: SearchConfig = field(default_factory=SearchConfig)

    # fasta writer options
    meta_fmt: str = "none"
    line_length: int = 0
    out_dots: bool = False
    out_dna: bool = False
    min_idty: float = 0.0
    fasta_block: int = 0
    fasta_idx: int = 0
    # csv writer options
    csv_crlf: bool = False
    csv_id: str = "name"
    csv_sep: str = ""
    colors: bool = False
    # input striding (rw_arb.cpp:184-284 --select-* semantics)
    select_step: int = 1
    select_skip: int = 0
    select_file: str = ""
    # multi-host (torch.distributed): each process reads its own
    # --fasta-block shard and writes <out>.part<idx>
    multihost: bool = False
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1


class Pipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.db: ReferenceDb | None = None
        self.finder: FamFinder | None = None
        self.searcher: SearchFilter | None = None

        if cfg.multihost:
            from .parallel import multihost

            multihost.initialize(
                coordinator=cfg.coordinator or None,
                num_processes=cfg.num_processes or None,
                process_id=(
                    cfg.process_id if cfg.process_id >= 0 else None
                ),
            )
            if (
                multihost.process_count() > 1
                and cfg.fasta_block == 0
                and cfg.in_path not in ("-",)
                and Path(cfg.in_path).is_file()
            ):
                shard = multihost.host_input_shard(cfg.in_path)
                cfg.fasta_block = shard["fasta_block"]
                cfg.fasta_idx = shard["fasta_idx"]
            if multihost.process_count() > 1:
                idx = multihost.process_index()
                cfg.outputs = [
                    (
                        kind,
                        path if path == "-" else f"{path}.part{idx}",
                    )
                    for kind, path in cfg.outputs
                ]

        if not cfg.prealigned:
            if not cfg.db:
                raise ValueError(
                    "Family Finder: Must have reference database "
                    "(--db/-r)"
                )
            self.db = ReferenceDb.open(cfg.db)
            self.finder = FamFinder(self.db, cfg.famfinder, self.device)
        if cfg.do_search:
            sdb_path = cfg.search_db or cfg.db
            if not sdb_path:
                raise ValueError("need search-db to search")
            if self.db is not None and (
                cfg.search_db in (None, cfg.db)
            ):
                sdb = self.db
            else:
                sdb = ReferenceDb.open(sdb_path)
            self.searcher = SearchFilter(
                sdb, cfg.search, self.finder, self.device
            )

        self.stats = StatsPrinter(
            show_dist=cfg.show_dist, show_diff=cfg.show_diff,
            colors=cfg.colors,
        )
        if cfg.orig_db:
            self.stats.orig_db = ReferenceDb.open(cfg.orig_db)
        ref_for_pairs = self.db or (
            self.searcher.db if self.searcher else None
        )
        if ref_for_pairs is not None and len(ref_for_pairs.pairs):
            self.stats.helix_pairs = ref_for_pairs.pairs

    # -- writers ------------------------------------------------------

    def _open_writers(self):
        writers = []
        for outtype, path in self.cfg.outputs:
            if outtype == "fasta":
                writers.append(
                    (
                        "fasta",
                        FastaWriter(
                            path,
                            meta=self.cfg.meta_fmt,
                            line_length=self.cfg.line_length,
                            dots=self.cfg.out_dots,
                            dna=self.cfg.out_dna,
                            min_idty=self.cfg.min_idty,
                            copy_relatives=self.cfg.add_relatives,
                        ),
                    )
                )
            elif outtype == "csv":
                writers.append(
                    (
                        "csv",
                        CsvWriter(
                            path,
                            fields=self.cfg.fields or None,
                            crlf=self.cfg.csv_crlf,
                            id_name=self.cfg.csv_id,
                            sep=self.cfg.csv_sep,
                        ),
                    )
                )
            elif outtype == "none":
                continue
            else:
                raise ValueError(f"unsupported output type {outtype}")
        return writers

    # -- batch processing ---------------------------------------------

    def _dispatch_batch(self, batch: list[Sequence], handle=None):
        """Stage A of the per-batch software pipeline: famfinder
        post-processing, copy path, profile or graph build and DP
        dispatch.
        Returns an entry for _finalize_batch; the DP is in flight on
        the device when this returns."""
        cfg = self.cfg
        if cfg.prealigned:
            aligned = [q.copy() for q in batch]
            for a in aligned:
                a.set_attr("align_quality_slv", 100)
            return (batch, [[] for _ in batch], None, aligned)

        with get_timer("Pipeline").section("famfinder"):
            results: list[FamilyResult] = self.finder.process_batch(
                batch, handle=handle
            )
        # align_dispatch updates this list in place when the aligner
        # filters the family (realign / containment)
        families = [
            r.family if not r.failed else [] for r in results
        ]
        state = align_dispatch(
            batch,
            families,
            cfg.aligner,
            [r.astats_weights for r in results],
            [r.astats_name for r in results],
            device=self.device,
        )
        return (batch, families, state, None)

    def _finalize_batch(
        self, entry
    ) -> list[tuple[Sequence, Sequence | None, list]]:
        """Stage B: fetch DP results, finish alignments (NAST,
        overhang, attrs), run the search stage.  A searched record's
        relatives (--add-relatives) are its search results."""
        batch, families, state, aligned = entry
        if state is not None:
            with get_timer("Pipeline").section("align finalize"):
                aligned = align_finalize(state)
        if self.searcher is not None:
            with get_timer("Pipeline").section("search"):
                aligned = self.searcher.process_batch(aligned)
        out = []
        for q, a, fam in zip(batch, aligned, families):
            rel = fam
            if a is not None:
                rel = getattr(a, "search_result", None) or fam
            out.append((q, a, rel))
        return out

    def _read_input(self):
        """Yield input sequences: FASTA(.gz) files, or a .sref bundle.
        --select-step/skip/file stride or filter by name
        (rw_arb.cpp:184-284; sina_tpu/pipeline.py:253-295)."""
        cfg = self.cfg
        p = Path(cfg.in_path) if cfg.in_path != "-" else None
        if p is not None and p.is_dir() and (p / "meta.json").exists():
            if self.db is not None and str(
                Path(cfg.db).resolve()
            ) == str(p.resolve()):
                src_db = self.db
            else:
                src_db = ReferenceDb.open(p)
            seqs = (s.copy() for s in src_db.sequences)
        else:
            seqs = read_fasta(
                cfg.in_path,
                block_size=cfg.fasta_block,
                block_idx=cfg.fasta_idx,
            )
        # reference semantics (rw_arb.cpp:193-260): the selection list
        # is the select-file's names (in file order) or the input
        # order; skip the first `select_skip` entries, then take the
        # LAST of every `select_step` names (first yield is entry
        # skip+step-1)
        step, skip = cfg.select_step, cfg.select_skip
        if cfg.select_file:
            names = Path(cfg.select_file).read_text().split()
            by_name = {}
            wanted = set(names)
            for seq in seqs:
                if seq.name in wanted and seq.name not in by_name:
                    by_name[seq.name] = seq
            for name in names[skip:][step - 1 :: step]:
                if name in by_name:
                    yield by_name[name]
            return
        for i, seq in enumerate(seqs):
            if i < skip:
                continue
            if (i - skip) % step == step - 1:
                yield seq

    def run(self) -> dict:
        cfg = self.cfg
        writers = self._open_writers()
        t0 = time.time()
        n_in = 0
        n_aligned = 0
        seqno = 0
        batch: list[Sequence] = []
        progress = Progress("Processing")
        _wt = get_timer("Pipeline")

        def flush(entry):
            nonlocal n_aligned, seqno
            rows = self._finalize_batch(entry)
            with _wt.section("write+stats"):
                for q, a, rel in rows:
                    seqno += 1
                    self.stats(q, a, rel or [], seqno)
                    rel_seqs = [s for _, s in rel] if rel else []
                    for kind, w in writers:
                        if kind == "fasta":
                            w.write_result(a, rel_seqs)
                        else:
                            w.write(a)
                    if a is not None:
                        n_aligned += 1
                    progress.update()

        # 3-stage software pipeline over batches (the batched analog
        # of the reference's TBB flow-graph overlap, sina.cpp:452-586;
        # sina_tpu/pipeline.py:343-374): submit famfinder N+1, fetch
        # famfinder N, dispatch N's DP, then finalize N-1.  Every fetch
        # waits for its own copy only (ops/transfer: the copy starts on
        # a copy stream at launch), so N-1's finish runs on the host
        # while N's DP and N+1's scoring run on the card
        def submit(b):
            return (
                b,
                None
                if cfg.prealigned
                else self.finder.submit_batch(b),
            )

        ff_q: deque = deque()   # famfinder dispatched
        al_q: deque = deque()   # DP dispatched
        for seq in self._read_input():
            batch.append(seq)
            n_in += 1
            if len(batch) >= cfg.batch_size:
                ff_q.append(submit(batch))
                batch = []
                if len(ff_q) >= 2:
                    al_q.append(
                        self._dispatch_batch(*ff_q.popleft())
                    )
                if len(al_q) >= 2:
                    flush(al_q.popleft())
        if batch:
            ff_q.append(submit(batch))
        while ff_q:
            al_q.append(self._dispatch_batch(*ff_q.popleft()))
            if len(al_q) >= 2:
                flush(al_q.popleft())
        while al_q:
            flush(al_q.popleft())

        for _, w in writers:
            w.close()
        progress.close()
        self.stats.log_summary()
        elapsed = time.time() - t0
        rate = n_in / elapsed if elapsed > 0 else 0.0
        logger.warning(
            "Took %.1fs to align %d of %d sequences (%.1f seq/s)",
            elapsed, n_aligned, n_in, rate,
        )
        summary = self.stats.summary()
        summary.update(
            n_in=n_in, n_aligned=n_aligned,
            elapsed=elapsed, seq_per_s=rate,
        )
        return summary
