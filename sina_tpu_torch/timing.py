"""Named-section wall timers (semantics of the reference's timer_mt,
SINA src/timer.h:120-202): modules accumulate per-section
times and log them at teardown ("Timings for Kmer Search: ..."),
beside the counters (``count``).

Every section is also a span: its name (``<timer>/<section>``), its
start and end on ``time.perf_counter_ns`` (the clock the section's
seconds come from), the innermost span open on the same thread when it
opened (its parent) and the id of the batch it worked on (given, or
its parent's).  ``span`` opens spans that are not sections.  Closed
spans go to ``store``: per-batch ones into a ring of
``SPAN_CAPACITY`` that drops the oldest when full (counted as
``timing.spans_dropped``), set-up and run spans (``keep=True``) into a
list kept whole.  ``run_span`` opens a run's root span: it snapshots
every counter at its start and end, and for its duration records each
generation-2 collection of the garbage collector as a ``gc.gen2``
span.  While a ``torch.profiler`` session records, every span also
opens a ``record_function`` range of its name with its batch id as the
range's input, so that the profiler's trace carries the program's
spans beside the kernels (the id shows where it records shapes).
"""

from __future__ import annotations

import atexit
import gc
import itertools
import logging
import threading
import time
from collections import defaultdict, deque

import torch.autograd
import torch.autograd.profiler as _profiler

logger = logging.getLogger("sina.timing")

_registry: dict[str, "Timer"] = {}

SPAN_CAPACITY = 1 << 16

counters: dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    counters[name] += n


class Span:
    """One timed interval of the program (times in perf_counter_ns)."""

    __slots__ = ("id", "name", "parent", "batch", "thread", "keep",
                 "t0", "t1", "counters", "_range")

    def __init__(self, id: int, name: str, parent: int | None,
                 batch: int | None, thread: int, keep: bool):
        self.id = id
        self.name = name
        self.parent = parent
        self.batch = batch
        self.thread = thread
        self.keep = keep
        self.t0 = self.t1 = 0
        # a run span's counters at its start and its end
        self.counters: tuple[dict, dict] | None = None
        self._range = None

    def __repr__(self) -> str:
        return (f"Span({self.id}, {self.name!r}, parent={self.parent}, "
                f"batch={self.batch}, {(self.t1 - self.t0) * 1e-6:.3f} ms)")


class SpanStore:
    """Closed spans: per-batch ones in a ring of `capacity`, the oldest
    dropped (and counted) when it is full; kept ones whole."""

    def __init__(self, capacity: int):
        self.ring: deque[Span] = deque(maxlen=capacity)
        self.kept: list[Span] = []

    def add(self, s: Span) -> None:
        if s.keep:
            self.kept.append(s)
            return
        if len(self.ring) == self.ring.maxlen:
            counters["timing.spans_dropped"] += 1
        self.ring.append(s)

    def spans(self) -> list[Span]:
        return sorted([*self.kept, *self.ring], key=lambda s: s.t0)


store = SpanStore(SPAN_CAPACITY)
_ids = itertools.count(1)
_batch_ids = itertools.count()
_local = threading.local()


def next_batch() -> int:
    """A new batch id, unique in the process."""
    return next(_batch_ids)


def spans() -> list[Span]:
    """Every closed span the store holds, by start."""
    return store.spans()


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.thread = threading.get_ident()
        return _local.stack


def _open(name: str, batch: int | None, keep: bool) -> Span:
    stack = _stack()
    parent = stack[-1] if stack else None
    if batch is None and parent is not None:
        batch = parent.batch
    s = Span(next(_ids), name, parent.id if parent is not None else None,
             batch, _local.thread, keep)
    if _profiler._is_profiler_enabled:
        s._range = torch.autograd._record_function_with_args_enter(
            name, *(() if batch is None else (batch,)))
    stack.append(s)
    s.t0 = time.perf_counter_ns()
    return s


def _close(s: Span) -> None:
    s.t1 = time.perf_counter_ns()
    stack = _local.stack
    if stack[-1] is s:
        stack.pop()
    else:
        stack.remove(s)
    if s._range is not None:
        torch.autograd._record_function_with_args_exit(s._range)
        s._range = None
    store.add(s)


class _SpanContext:
    __slots__ = ("name", "batch", "keep", "span")

    def __init__(self, name: str, batch: int | None, keep: bool):
        self.name = name
        self.batch = batch
        self.keep = keep

    def __enter__(self) -> Span:
        self.span = _open(self.name, self.batch, self.keep)
        return self.span

    def __exit__(self, *exc) -> None:
        _close(self.span)


def span(name: str, batch: int | None = None, keep: bool = False) -> _SpanContext:
    """A context that records a span `name` of batch `batch` (by
    default its parent's); `keep` keeps it outside the ring (set-up)."""
    return _SpanContext(name, batch, keep)


def _gc_span(phase: str, info: dict) -> None:
    if info["generation"] != 2:
        return
    if phase == "start":
        _local.gc = _open("gc.gen2", None, False)
    else:
        s = getattr(_local, "gc", None)
        if s is not None:
            _local.gc = None
            _close(s)


class _RunContext:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        start = dict(counters)
        self.span = _open(self.name, None, True)
        self.span.counters = (start, start)
        gc.callbacks.append(_gc_span)
        return self.span

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(_gc_span)
        _close(self.span)
        self.span.counters = (self.span.counters[0], dict(counters))


def run_span(name: str) -> _RunContext:
    """A context that records a run's root span `name`, kept whole,
    with every counter at its start and end, and a ``gc.gen2`` span
    for each generation-2 collection while it is open."""
    return _RunContext(name)


class Timer:
    def __init__(self, name: str):
        self.name = name
        self.sections: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    class _Section:
        __slots__ = ("timer", "name", "batch", "span")

        def __init__(self, timer: "Timer", name: str, batch: int | None):
            self.timer = timer
            self.name = name
            self.batch = batch

        def __enter__(self):
            self.span = _open(f"{self.timer.name}/{self.name}", self.batch, False)
            return self

        def __exit__(self, *exc):
            s = self.span
            _close(s)
            self.timer.sections[self.name] += (s.t1 - s.t0) * 1e-9
            self.timer.counts[self.name] += 1

    def section(self, name: str, batch: int | None = None) -> "Timer._Section":
        return Timer._Section(self, name, batch)

    def __str__(self) -> str:
        parts = [
            f"{k}: {v:.2f}s/{self.counts[k]}"
            for k, v in sorted(
                self.sections.items(), key=lambda kv: -kv[1]
            )
        ]
        return ", ".join(parts) or "(no sections)"


def get_timer(name: str) -> Timer:
    if name not in _registry:
        _registry[name] = Timer(name)
    return _registry[name]


def log_timers() -> None:
    for name, t in _registry.items():
        if t.sections:
            logger.info("Timings for %s: %s", name, t)
    if counters:
        logger.info("Counters: %s", ", ".join(
            f"{k}: {v}" for k, v in sorted(counters.items())))


atexit.register(log_timers)


def reset_all() -> None:
    """Zero every timer's accumulated sections (bench.py calls this
    after warmup so tail timings attribute the steady state only)."""
    for t in _registry.values():
        t.sections.clear()
        t.counts.clear()
