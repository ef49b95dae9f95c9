"""The slice end to end: the JAX CLI (sina_tpu, on the CPU) and the
port's CLI (sina_tpu_torch --device cpu, the plain PyTorch versions of
its kernels) in one process, on the same generated reference and
queries, must write byte-identical aligned FASTA (--meta-fmt comment)
and CSV.  The one attribute allowed to differ is `aligned_slv`, the
wall-clock time each run stamps on every aligned record."""

import contextlib
import re

import numpy as np
import pytest

from sina_tpu import cli as jax_cli
from sina_tpu import testing
from sina_tpu.io.fasta import FastaWriter, read_fasta
from sina_tpu_torch import cli as torch_cli
from sina_tpu_torch.testing import with_long_insertion

_STAMP = re.compile(r"(aligned_slv=|,)\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")


def _amplicon(q, lo: int, n: int):
    q.positions = q.positions[lo : lo + n]
    q.masks = q.masks[lo : lo + n]
    return q


def _as_given(q, i: int, c: dict):
    """Query `q` as the case writes it to the input: aligned for -P,
    else unaligned; with "turn", queries 1, 2 and 3 of every four
    reversed, complemented, and reversed and complemented."""
    if c.get("prealigned"):
        return q
    u = testing.unaligned_copy(q)
    if c.get("turn"):
        if i % 4 in (1, 3):
            u.reverse()
        if i % 4 in (2, 3):
            u.complement()
    return u


def _turned(seq, turn_slv: str):
    """`seq` turned as a record's `turn_slv` says the aligner turned it."""
    if turn_slv in ("reversed", "reversed and complemented"):
        seq.reverse()
    if turn_slv in ("complemented", "reversed and complemented"):
        seq.complement()
    return seq


CASES = {
    # the fixture of .claude/skills/verify/SKILL.md
    "verify": dict(
        ref=dict(n_seqs=150, n_core=500, width=800, seed=42),
        n=10, full_len=400, extra=[],
    ),
    # full-length queries: the 1536/2048 shape buckets
    "full_length": dict(
        ref=dict(n_seqs=300, n_core=1450, width=2400, seed=42),
        n=24, full_len=1300, extra=[],
    ),
    # 250-nt amplicons with col-trim forced on: windowed profile
    # builds and window-sliced DP rows
    "amplicon_col_trim": dict(
        ref=dict(n_seqs=300, n_core=1450, width=2400, seed=42),
        n=24, full_len=1300, amplicon=250,
        extra=["--col-trim-min-cols", "0", "--fs-min-len", "100"],
    ),
    # the same with --insertion forbid: full profile builds, window-
    # sliced rows whose last slot is budgeted to the next occupied
    # column outside the window (tests/test_col_trim.py:66)
    "amplicon_col_trim_forbid": dict(
        ref=dict(n_seqs=300, n_core=1450, width=2400, seed=42),
        n=24, full_len=1300, amplicon=250,
        extra=["--col-trim-min-cols", "0", "--fs-min-len", "100",
               "--insertion", "forbid"],
    ),
}


def run_both_clis(c: dict, tmp_path) -> tuple[dict[str, str], list]:
    """Write case `c`'s reference and queries, run the JAX CLI and the
    port's CLI (--device cpu) on them, each in a working directory of
    its own, and assert the FASTA and CSV outputs are identical apart
    from the `aligned_slv` stamps, that any other file a run wrote
    there (the --debug-graph dumps) is identical too, and that the
    port's records are real alignments of the queries, in the queries'
    own orientation.  With "search_db" every other reference is also
    written as a second database for --search-db, and with
    "long_insertion" the reference gets sina_tpu_torch.testing
    with_long_insertion's columns (its keyword arguments).  Returns the
    port's other files, by name, and its FASTA records."""
    db = testing.make_reference(**c["ref"])
    if "long_insertion" in c:
        db = with_long_insertion(db, **c["long_insertion"])
    queries = testing.make_queries(db, n=c["n"], seed=7, branch_len=0.6)
    if "amplicon" in c:
        for q in queries:
            _amplicon(q, min(400, max(0, len(q.masks) - c["amplicon"]) // 2), c["amplicon"])
    ref, qin = tmp_path / "ref.fasta", tmp_path / "queries.fasta"
    with FastaWriter(str(ref), meta="comment") as w:
        for s in db.sequences:
            w.write(s)
    given = [_as_given(q, i, c) for i, q in enumerate(queries)]
    with FastaWriter(str(qin)) as w:
        for u in given:
            w.write(u)
    common = [
        "-i", str(qin), "-r", str(ref), "--fs-min", "10", "--fs-max", "10",
        "--fs-full-len", str(c["full_len"]), "--fs-req-gaps", "1",
        "--calc-idty", "--meta-fmt", "comment", *c["extra"],
    ]
    if c.get("search_db"):
        sdb = tmp_path / "search.fasta"
        with FastaWriter(str(sdb), meta="comment") as w:
            for s in db.sequences[::2]:
                w.write(s)
        common += ["--search-db", str(sdb)]
    outs, dumps = {}, {}
    for name, main, more in (
        ("jax", jax_cli.main, []),
        ("torch", torch_cli.main, ["--device", "cpu"]),
    ):
        wd = tmp_path / name
        wd.mkdir()
        fa, csv = wd / "out.fasta", wd / "out.csv"
        with contextlib.chdir(wd):
            assert main(common + ["-o", str(fa), "-o", str(csv)] + more) == 0
        outs[name] = fa, csv
        dumps[name] = {p.name: p.read_text() for p in wd.iterdir() if p not in (fa, csv)}
    assert dumps["jax"] == dumps["torch"]
    for jax_out, torch_out in zip(outs["jax"], outs["torch"]):
        a, b = jax_out.read_text(), torch_out.read_text()
        assert len(_STAMP.findall(a)) == (0 if c.get("prealigned") else c["n"])
        assert _STAMP.sub(r"\1T", a) == _STAMP.sub(r"\1T", b)
    # and the port's records are real alignments of the queries
    got = list(read_fasta(str(outs["torch"][0])))
    assert len(got) == c["n"]
    for rec, u in zip(got, given):
        assert rec.width == db.width
        want = _turned(u.copy(), rec.get_attr("turn_slv", ""))
        assert rec.get_bases().upper() == want.get_bases().upper()
        assert np.all(np.diff(rec.positions.astype(np.int64)) > 0)
    return dumps["torch"], got


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_output_is_byte_identical(case, tmp_path):
    run_both_clis(CASES[case], tmp_path)
