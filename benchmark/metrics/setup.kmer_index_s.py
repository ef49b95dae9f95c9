"""Seconds of set-up spent on the k-mer index: the program's
`setup.kmer_index_load` spans (KmerIndex.build: its .sidx cache, or the
build) inside the last `setup.pipeline` span opened before the window,
the last `pipeline.run` span, and its `setup.kmer_index_upload` spans
(the first FamFinder._matrix(): dense packing and upload, in warm-up's
first batch) between that span's start and the window's.  None where
the program records no spans."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    run = next((s for s in reversed(spans) if s.name == "pipeline.run"), None)
    setup = next((s for s in reversed(spans) if s.name == "setup.pipeline"
                  and run is not None and s.t1 <= run.t0), None)
    if setup is None:
        return None
    load = sum(s.t1 - s.t0 for s in spans if s.name == "setup.kmer_index_load"
               and setup.t0 <= s.t0 and s.t1 <= setup.t1)
    upload = sum(s.t1 - s.t0 for s in spans if s.name == "setup.kmer_index_upload"
                 and setup.t0 <= s.t0 and s.t1 <= run.t0)
    return 1e-9 * (load + upload)
