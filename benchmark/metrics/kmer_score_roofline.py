"""The bitpacked k-mer scorer's share of its roofline, in %: the least
time its window's launches need (benchlib.bounds.kmer_bound over each
launch's k-mer ids: the distinct rows read once, the scores written
once, an add per reference for each distinct row of a query) over the
device time of its kernels (the run pre-pass and the scorer) in the
trace."""

from benchlib import bounds


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ks = [v for n, v in tr["kernels"].items() if "kmer_score_kernel" in n or "kmer_runs_kernel" in n]
    launches = tr["launches"].get("kmer_score", [])
    t = sum(v[0] for v in ks)
    if not launches or t <= 0:
        return None
    need = sum(bounds.kmer_bound(k, Sb, R - 1)["bound_s"] for R, Sb, k in launches)
    return 100.0 * need / t
