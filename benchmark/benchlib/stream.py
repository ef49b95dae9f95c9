"""The two child processes of a run: the feeder, which streams the query
pool as FASTA into the pipeline's input FIFO, and the reader, which
takes the aligned FASTA from its output FIFO, stamps each record's
arrival and keeps what the check needs.  They are processes, not
threads, so they take no time from the pipeline's interpreter.

    python3 stream.py feed <fifo>   # pool on stdin, then commands
    python3 stream.py read <fifo>   # commands on stdin

Both take one command line on stdin per pipeline run and answer each
with one length-prefixed pickle on stdout.  Imports numpy only.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import struct
import sys
import time

import numpy as np

GAP = (ord("-"), ord("."))
# records written per os.write call (whole records only)
FEED_RECORDS = 16
PIPE_BYTES = 1 << 20


def _send(obj) -> None:
    blob = pickle.dumps(obj, protocol=5)
    sys.stdout.buffer.write(struct.pack("<q", len(blob)) + blob)
    sys.stdout.buffer.flush()


def recv(stream):
    """Read one _send() answer from a child's stdout."""
    head = stream.read(8)
    if len(head) < 8:
        raise EOFError("the child ended without an answer")
    (n,) = struct.unpack("<q", head)
    return pickle.loads(stream.read(n))


def _read_exact(f, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        got = f.read(n - len(buf))
        if not got:
            raise EOFError("short pool on stdin")
        buf += got
    return bytes(buf)


def feed(fifo: str) -> None:
    """Stream the pool: `count N LO HI` writes records LO, LO+1, ...
    (N of them, restarting at LO after HI-1), `until T LO HI` writes
    them until the wall clock passes T (whole records only).  Answers
    (records sent, times the range was restarted, wall time of the
    close)."""
    inp = sys.stdin.buffer
    (nb, nrec) = struct.unpack("<qq", _read_exact(inp, 16))
    offs = np.frombuffer(_read_exact(inp, 8 * (nrec + 1)), dtype=np.int64)
    pool = memoryview(_read_exact(inp, nb))
    for line in sys.stdin:
        cmd, arg, lo, hi = line.split()
        lo, hi = int(lo), min(int(hi), nrec)
        limit = int(arg) if cmd == "count" else None
        deadline = float(arg) if cmd == "until" else None
        sent = wraps = 0
        fd = os.open(fifo, os.O_WRONLY)
        try:
            i = lo
            while True:
                if limit is not None and sent >= limit:
                    break
                if deadline is not None and time.time() >= deadline:
                    break
                k = FEED_RECORDS if limit is None else min(FEED_RECORDS, limit - sent)
                k = min(k, hi - i)
                chunk = pool[offs[i]:offs[i + k]]
                while chunk:
                    w = os.write(fd, chunk)
                    chunk = chunk[w:]
                sent += k
                i += k
                if i == hi:
                    i, wraps = lo, wraps + 1
        finally:
            os.close(fd)
        _send({"sent": sent, "wraps": wraps, "t_close": time.time()})


def _parse_raw(log: str) -> float:
    # "... scoring: raw=<v>, weight=..." in align_log_slv
    at = log.find("raw=")
    if at < 0:
        return float("nan")
    return float(log[at + 4:log.index(",", at)])


def _big_pipe(fd: int) -> None:
    """A 1 MiB buffer on the output FIFO, so that the pipeline's writes
    seldom wait for this process's scheduling.  (The input FIFO keeps
    the default 64 KiB: the feeder stays a few dozen queries ahead.)"""
    try:
        fcntl.fcntl(fd, getattr(fcntl, "F_SETPIPE_SZ", 1031), PIPE_BYTES)
    except OSError:
        pass


def _parse(data: bytes, ends: np.ndarray, stamps: np.ndarray, keep: bool) -> dict:
    """Records of one run's output: names, arrival stamps (of the chunk
    that held each record's last byte) and, with `keep`, columns, bases,
    used_rels and the DP's raw score."""
    names, at, raws, rels, cols, bases = [], [], [], [], [], []
    off = 0
    attrs: dict = {}
    for line in data.split(b"\n"):
        end = off + len(line)
        if line.startswith(b">"):
            name = line[1:].split(None, 1)[0].decode()
            attrs = {}
        elif line.startswith(b";"):
            if keep:
                k, _, v = line[1:].decode().partition("=")
                attrs[k.strip()] = v.strip()
        elif line:
            names.append(name)
            at.append(end)
            if keep:
                a = np.frombuffer(line, dtype=np.uint8)
                nz = np.flatnonzero((a != GAP[0]) & (a != GAP[1]))
                cols.append(nz.astype(np.int32))
                bases.append(a[nz])
                rels.append(attrs.get("used_rels", ""))
                raws.append(_parse_raw(attrs.get("align_log_slv", "")))
        off = end + 1
    idx = np.searchsorted(ends, np.asarray(at, dtype=np.int64), side="right")
    out = {"names": names, "stamps": stamps[np.minimum(idx, len(stamps) - 1)]
           if len(stamps) else np.zeros(0)}
    if keep:
        out.update(cols=cols, bases=bases, used_rels=rels, raw=np.asarray(raws))
    return out


def parse_records(data: bytes) -> dict:
    """Every record of an aligned FASTA text, as the reader keeps them
    (arrival stamps 0)."""
    return _parse(data, np.array([len(data)], dtype=np.int64), np.zeros(1), True)


def read(fifo: str) -> None:
    """Take one run's output as it comes, in raw chunks stamped on
    arrival, and parse it once the writer has closed: `keep` keeps
    every record (name, arrival, aligned columns, bases, used_rels, the
    DP's raw score), `count` only names and arrivals."""
    for line in sys.stdin:
        keep = line.strip() == "keep"
        chunks, stamps = [], []
        fd = os.open(fifo, os.O_RDONLY)
        try:
            _big_pipe(fd)
            while True:
                b = os.read(fd, PIPE_BYTES)
                if not b:
                    break
                chunks.append(b)
                stamps.append(time.time())
        finally:
            os.close(fd)
        ends = np.cumsum([len(c) for c in chunks], dtype=np.int64)
        _send(_parse(b"".join(chunks), ends, np.asarray(stamps), keep))


if __name__ == "__main__":
    {"feed": feed, "read": read}[sys.argv[1]](sys.argv[2])
