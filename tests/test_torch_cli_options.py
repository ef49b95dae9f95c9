"""The behavioural cases of tests/test_cli_options.py and
tests/test_cli_surface.py on the port's CLI.

Each case runs the JAX CLI (sina_tpu, on the CPU) and the port's CLI
(sina_tpu_torch --device cpu) with the same options, each in a working
directory of its own, and holds the files the port writes there to the
JAX CLI's, byte for byte apart from the wall-clock `aligned_slv` stamps
(gzip output compared decompressed: its header carries a time), beside
the original test's own assertions: gz output, --lowercase original,
the --meta-fmt csv sidecar, --select-file, --csv-sep, the colour code,
--build-refdb and aligning against the result, --show-conf, /dev/null
and none outputs, .arb output refused, the inert compatibility flags'
warning and --fasta-block shards."""

import contextlib
import gzip
import logging
import re

import pytest

from sina_tpu import cli as jax_cli
from sina_tpu import testing
from sina_tpu.io.fasta import FastaWriter, read_fasta
from sina_tpu_torch import cli as torch_cli

_STAMP = re.compile(r"(aligned_slv=|[,;|\t])\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
FAMILY = ["--fs-min", "8", "--fs-max", "8", "--fs-full-len", "150", "--fs-req-gaps", "1"]


@pytest.fixture(scope="module")
def small_env(tmp_path_factory):
    """tests/test_cli_options.py's fixture: 60 references at width 400
    as a bundle, 4 unaligned queries."""
    d = tmp_path_factory.mktemp("cliopt")
    db = testing.make_reference(n_seqs=60, n_core=250, width=400, seed=33)
    dbp = d / "ref.sref"
    db.save(dbp)
    qf = d / "q.fasta"
    with FastaWriter(qf) as w:
        for q in testing.make_queries(db, n=4, seed=2):
            w.write(testing.unaligned_copy(q))
    return d, dbp, qf


def _text(path) -> str:
    data = path.read_bytes()
    if path.suffix == ".gz":
        data = gzip.decompress(data)
    return _STAMP.sub(r"\1T", data.decode())


def both(tmp_path, argv: list[str]) -> tuple[int, dict]:
    """`argv` through both CLIs, each in tmp_path/<jax|torch>; asserts
    equal exit codes and equal files written there; returns the port's
    exit code and {file name: text}."""
    got = {}
    for name, main, more in (("jax", jax_cli.main, []),
                             ("torch", torch_cli.main, ["--device", "cpu"])):
        wd = tmp_path / name
        wd.mkdir()
        with contextlib.chdir(wd):
            rc = main(argv + more)
        got[name] = rc, {p.name: _text(p) for p in sorted(wd.iterdir()) if p.is_file()}
    assert got["jax"] == got["torch"]
    return got["torch"]


def aligned(small_env, tmp_path, qf=None, extra=(), out="o.fasta"):
    _, dbp, q = small_env
    return both(tmp_path, ["-i", str(qf or q), "-o", out, "-r", str(dbp), *FAMILY, *extra])


def test_gz_output_roundtrip(small_env, tmp_path):
    rc, files = aligned(small_env, tmp_path, out="o.fasta.gz")
    assert rc == 0
    assert len(list(read_fasta(tmp_path / "torch" / "o.fasta.gz"))) == 4


def test_lowercase_original(small_env, tmp_path):
    _, _, qf = small_env
    seq = next(iter(read_fasta(qf)))
    qlow = tmp_path / "qlow.fasta"
    qlow.write_text(f">{seq.name}\n{seq.get_bases().lower()}\n")
    rc, _ = aligned(small_env, tmp_path, qf=qlow, extra=["--lowercase", "original"])
    assert rc == 0
    assert next(iter(read_fasta(tmp_path / "torch" / "o.fasta"))).get_bases().islower()


def test_meta_csv_sidecar(small_env, tmp_path):
    rc, files = aligned(small_env, tmp_path, extra=["--meta-fmt", "csv"])
    assert rc == 0
    assert "align_quality_slv" in files["o.csv"].splitlines()[0]


def test_select_file(small_env, tmp_path):
    _, _, qf = small_env
    names = [s.name for s in read_fasta(qf)]
    sel = tmp_path / "names.txt"
    sel.write_text("\n".join(names[:2]))
    rc, _ = aligned(small_env, tmp_path, extra=["--select-file", str(sel)])
    assert rc == 0
    assert [s.name for s in read_fasta(tmp_path / "torch" / "o.fasta")] == names[:2]


@pytest.mark.parametrize("sep", ["|", ";"])
def test_csv_sep(small_env, tmp_path, sep):
    rc, files = aligned(small_env, tmp_path, out="o.csv", extra=["--csv-sep", sep])
    assert rc == 0
    assert files["o.csv"].splitlines()[0].startswith(f"name{sep}")


def test_color_code():
    from sina_tpu.log_stats import color_code as jax_color_code
    from sina_tpu_torch.log_stats import color_code

    for text in ("AGCU-N", "acgt..--NNRY", ""):
        assert color_code(text) == jax_color_code(text)
        assert re.sub(r"\033\[[0-9]*m", "", color_code(text)) == text
    assert "\033[34m" in color_code("AGCU-N")


def test_build_refdb_workflow(tmp_path):
    """tests/test_cli_surface.py:112-165: an arb2fasta-style export and a
    metadata CSV become a bundle; searching against it copies the
    fields into the CSV output."""
    from sina_tpu_torch.refdb import ReferenceDb

    db = testing.make_reference(n_seqs=40, n_core=200, width=400, seed=31)
    fasta = tmp_path / "export.fasta"
    with FastaWriter(str(fasta)) as w:
        for s in db.sequences:
            w.write(s)
    csv = tmp_path / "meta.csv"
    rows = ["name,tax_slv,strain"] + [f"{s.name},Bacteria;Firmicutes;,ST{i}"
                                     for i, s in enumerate(db.sequences)]
    csv.write_text("\n".join(rows) + "\n")
    built = {}
    for name, main, more in (("jax", jax_cli.main, []),
                             ("torch", torch_cli.main, ["--device", "cpu"])):
        built[name] = tmp_path / f"{name}.sref"
        assert main(["-i", str(fasta), "--build-refdb", str(built[name]),
                     "--refdb-metadata", str(csv), *more]) == 0
    port, ref = (ReferenceDb.load(built[k]) for k in ("torch", "jax"))
    assert port.width == ref.width and len(port) == len(ref) == 40
    for a, b in zip(port.sequences, ref.sequences):
        assert (a.name, a.attrs, a.get_aligned()) == (b.name, b.attrs, b.get_aligned())
    assert port.sequences[3].attrs["strain"] == "ST3"
    qfasta = tmp_path / "q.fasta"
    with FastaWriter(str(qfasta)) as w:
        for q in testing.make_queries(db, n=3, seed=9, branch_len=0.4):
            w.write(testing.unaligned_copy(q))
    (tmp_path / "search").mkdir()
    rc, files = both(tmp_path / "search", [
        "-i", str(qfasta), "-o", "out.csv", "-r", str(built["jax"]),
        "--fs-min", "5", "--fs-max", "5", "--fs-full-len", "150", "--fs-req-gaps", "1",
        "-S", "--search-copy-fields", "strain", "--search-min-sim", "0.3",
        "--lca-fields", "tax_slv"])
    assert rc == 0
    assert "strain" in files["out.csv"].splitlines()[0]
    assert "ST" in files["out.csv"]


def _sections(err: str) -> dict:
    """--show-conf's [famfinder], [aligner] and [search] sections."""
    out, name = {}, None
    for line in err.splitlines():
        if re.fullmatch(r"\[\w+\]", line):
            name = line
            out[name] = []
        elif name and line.startswith("  "):
            out[name].append(line)
        else:
            name = None
    return {k: v for k, v in out.items() if k in ("[famfinder]", "[aligner]", "[search]")}


def test_show_conf_effective_modules(tmp_path, capsys):
    """tests/test_cli_surface.py:168-186: the effective modules' sections,
    and -o none creates no file."""
    db = testing.make_reference(n_seqs=20, n_core=150, width=300, seed=32)
    db.save(tmp_path / "db.sref")
    argv = ["-i", str(tmp_path / "db.sref"), "-o", "none", "-r", str(tmp_path / "db.sref"),
            "--show-conf", "--fs-min", "5", "--fs-max", "5", "--fs-full-len", "100",
            "--fs-req-gaps", "1", "--select-step", "20"]
    sections = {}
    for name, main, more in (("jax", jax_cli.main, []),
                             ("torch", torch_cli.main, ["--device", "cpu"])):
        wd = tmp_path / name
        wd.mkdir()
        with contextlib.chdir(wd):
            assert main(argv + more) == 0
        assert not any(wd.iterdir())
        sections[name] = _sections(capsys.readouterr().err)
    assert sections["torch"] == sections["jax"]
    assert set(sections["torch"]) == {"[famfinder]", "[aligner]", "[search]"}
    assert "  fs_max = 5" in sections["torch"]["[famfinder]"]


def parse_both(argv):
    return (jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv)),
            torch_cli.config_from_args(torch_cli.build_parser().parse_args(argv)))


@pytest.mark.parametrize("argv", [
    ["-o", "/dev/null"], ["-o", "none"], ["-o", "NONE"],
    ["-o", "out.fa", "--outtype", "none"],
])
def test_null_outputs(argv, tmp_path, monkeypatch):
    """tests/test_cli_options.py:56-74: /dev/null and none outputs map
    to no writer, never a file named "none"."""
    monkeypatch.chdir(tmp_path)
    ref, port = parse_both(["-i", "x", "-r", "y", *argv])
    assert port.outputs == ref.outputs == []
    assert not (tmp_path / "none").exists()


def test_arb_output_rejected():
    for cli in (jax_cli, torch_cli):
        with pytest.raises(SystemExit):
            cli.config_from_args(cli.build_parser().parse_args(
                ["-i", "x", "-r", "y", "-o", "out.arb"]))


def test_inert_compat_flags_warn(caplog):
    """tests/test_cli_options.py:77-95: the pt-server knobs accepted for
    compatibility warn that they have no effect, in the same words."""
    flags = ("--fs-kmer-mm", "--fs-kmer-norel", "--search-kmer-mm", "--search-kmer-norel")
    argv = ["-i", "x", "-r", "y", "--fs-kmer-mm", "2", "--fs-kmer-norel",
            "--search-kmer-mm", "1", "--search-kmer-norel"]
    said = []
    for cli in (jax_cli, torch_cli):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="sina"):
            cli.config_from_args(cli.build_parser().parse_args(argv))
        said.append([r.getMessage() for r in caplog.records])
        for flag in flags:
            assert flag in caplog.text, flag
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="sina"):
            cli.config_from_args(cli.build_parser().parse_args(["-i", "x", "-r", "y"]))
        assert "no effect" not in caplog.text
    assert said[0] == said[1]


def test_fasta_block_shards(small_env, tmp_path):
    """--fasta-block/--fasta-idx: each of three shards of a third of the
    input writes the JAX CLI's records, and together they hold every
    query once."""
    _, _, qf = small_env
    block = str(qf.stat().st_size // 3 + 1)
    names = []
    for shard in range(3):
        wd = tmp_path / str(shard)
        wd.mkdir()
        rc, _ = aligned(small_env, wd, extra=["--fasta-block", block, "--fasta-idx", str(shard)])
        assert rc == 0
        names += [s.name for s in read_fasta(wd / "torch" / "o.fasta")]
    assert sorted(names) == sorted(s.name for s in read_fasta(qf))
