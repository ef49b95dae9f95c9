"""The port's multi-host runs on the CPU: real torch.distributed (gloo)
process groups of two processes on 127.0.0.1.

1. Two processes, each with a mesh over the CPU named 4 times, so that
   dp spans the processes: both see the same merged top-k, equal to one
   process's search on the same mp, and host_input_shard partitions the
   input file.
2. The CLI with --multihost in two processes (the fixture of
   tests/test_multihost.py: 80 references, 12 queries): the parts cover
   every query once, each record byte-equal to the one-process run's.
3. The CLI with --multihost in one process: out.fasta, no .part suffix,
   byte-equal to the run without the flag.

The worker of test 1 is this file run as a script.  Every subprocess
has its own timeout, so a hung rendezvous fails its test, not the run.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_all(cmds, cwd) -> None:
    """Run the commands side by side; each must exit 0 within TIMEOUT."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              cwd=str(cwd), env=_env()) for c in cmds]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append("TIMEOUT")
        if p.returncode != 0:
            errs.append(err.decode(errors="replace")[-2000:])
    assert not errs, errs


def _search_problem():
    """tests/mh_worker.py's problem, from the port's own testing: 64
    references, k = 8, every 8th reference as a query."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops.kmer import query_kmers_padded
    from sina_tpu_torch.ops.kmer_index import KmerIndex

    db = testing.make_reference(n_seqs=64, n_core=300, width=500, seed=77)
    P = KmerIndex.build(db, k=8, fast=True).dense_packed()
    queries = [testing.unaligned_copy(s) for s in db.sequences[::8]]
    kmers, _ = query_kmers_padded([q.masks for q in queries], 8, fast=True)
    return P, kmers


def _search(mesh, P, kmers):
    """The sharded top-8 on `mesh`: the matrix padded to whole shards,
    the batch to a dp multiple with the sink row."""
    from sina_tpu_torch.parallel.sharding import shard_index_matrix, sharded_search

    mp, dp = mesh.shape["mp"], mesh.shape["dp"]
    P = np.pad(P, ((0, 0), (0, -P.shape[1] % mp)))
    B = kmers.shape[0]
    kmers = np.pad(kmers, ((0, -B % dp), (0, 0)), constant_values=P.shape[0] - 1)
    vals, ids = sharded_search(mesh, 8)(shard_index_matrix(mesh, P), kmers)
    return vals[:B].tolist(), ids[:B].tolist()


def worker(pid: int, nproc: int, port: int, out_path: str, fasta_path: str) -> None:
    """One process of test 1: join the group, search on a mesh whose dp
    spans the processes, write what it saw."""
    import torch

    from sina_tpu_torch.parallel import multihost
    from sina_tpu_torch.parallel.sharding import make_mesh

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    try:
        mesh = make_mesh([torch.device("cpu")] * 4)
        P, kmers = _search_problem()
        vals, ids = _search(mesh, P, kmers)
        Path(out_path).write_text(json.dumps({
            "nproc": multihost.process_count(), "rank": multihost.process_index(),
            "mesh": mesh.shape, "rows": list(mesh.rows), "vals": vals, "ids": ids,
            "shard": multihost.host_input_shard(fasta_path)}))
    finally:
        multihost.shutdown()


def test_two_process_search(tmp_path):
    import torch

    from sina_tpu_torch.parallel.sharding import make_mesh

    port = _free_port()
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(f">S{i}\nACGTACGTAC\n" for i in range(32)))
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    _run_all([[sys.executable, __file__, "worker", str(i), "2", str(port), str(outs[i]),
               str(fasta)] for i in range(2)], REPO)
    results = [json.loads(o.read_text()) for o in outs]
    for i, r in enumerate(results):
        assert (r["nproc"], r["rank"], r["rows"]) == (2, i, [i])
        assert r["mesh"] == {"dp": 2, "mp": 4}
    # both processes see the same merged top-k of the whole batch ...
    assert results[0]["vals"] == results[1]["vals"]
    assert results[0]["ids"] == results[1]["ids"]
    # ... equal to one process's search on the same mp
    P, kmers = _search_problem()
    vals, ids = _search(make_mesh([torch.device("cpu")] * 4, dp=1), P, kmers)
    assert len(vals) == kmers.shape[0] == 8
    assert results[0]["vals"] == vals and results[0]["ids"] == ids
    # the per-process input shards partition the file
    shards = [r["shard"] for r in results]
    assert [s["fasta_idx"] for s in shards] == [0, 1]
    assert shards[0]["fasta_block"] == shards[1]["fasta_block"]
    assert shards[0]["fasta_block"] * 2 >= fasta.stat().st_size


def _cli_fixture(d: Path) -> None:
    """tests/test_multihost.py:112-125's fixture, from the port's own
    testing (the same seeds give the same data)."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.io.fasta import FastaWriter

    db = testing.make_reference(n_seqs=80, n_core=400, width=700, seed=5)
    with FastaWriter(str(d / "ref.fasta")) as w:
        for s in db.sequences:
            w.write(s)
    with FastaWriter(str(d / "q.fasta")) as w:
        for q in testing.make_queries(db, n=12, seed=3, branch_len=0.5):
            w.write(testing.unaligned_copy(q))


def _cli(d: Path, out: Path, *extra) -> list:
    return [sys.executable, "-m", "sina_tpu_torch", "-i", str(d / "q.fasta"), "-o", str(out),
            "-r", str(d / "ref.fasta"), "--fs-min", "8", "--fs-max", "8", "--fs-full-len",
            "300", "--fs-req-gaps", "1", "--meta-fmt", "comment", "--device", "cpu", "-q",
            *extra]


def _records(path: Path) -> dict:
    """name -> the record's lines, the aligned_slv stamp masked."""
    out = {}
    for line in re.sub(r"aligned_slv=[^\]\n]*", "aligned_slv=T", path.read_text()).splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            assert name not in out
            out[name] = []
        out[name].append(line)
    return out


def test_multihost_cli_two_processes(tmp_path):
    _cli_fixture(tmp_path)
    port = _free_port()
    out = tmp_path / "out.fasta"
    _run_all([_cli(tmp_path, out, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)) for i in range(2)],
             tmp_path)
    assert not out.exists()
    parts = [_records(tmp_path / f"out.fasta.part{i}") for i in range(2)]
    assert all(parts) and not set(parts[0]) & set(parts[1])
    single = tmp_path / "single.fasta"
    _run_all([_cli(tmp_path, single)], tmp_path)
    want = _records(single)
    assert sorted(want) == [f"QRY{i:04d}" for i in range(12)]
    assert {**parts[0], **parts[1]} == want


def test_multihost_cli_one_process(tmp_path):
    _cli_fixture(tmp_path)
    port = _free_port()
    out, plain = tmp_path / "out.fasta", tmp_path / "plain.fasta"
    _run_all([_cli(tmp_path, out, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "1", "--process-id", "0"),
              _cli(tmp_path, plain)], tmp_path)
    assert not list(tmp_path.glob("*.part*"))
    assert _records(out) == _records(plain) and len(_records(out)) == 12


if __name__ == "__main__":
    if sys.argv[1] != "worker":
        sys.exit(f"usage: {sys.argv[0]} worker PID NPROC PORT OUT.json INPUT.fasta")
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
