"""Named-section wall timers (semantics of the reference's timer_mt,
SINA src/timer.h:120-202): modules accumulate per-section
times and log them at teardown ("Timings for Kmer Search: ...")."""

from __future__ import annotations

import atexit
import logging
import time
from collections import defaultdict

logger = logging.getLogger("sina.timing")

_registry: dict[str, "Timer"] = {}


class Timer:
    def __init__(self, name: str):
        self.name = name
        self.sections: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, section: str) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.sections[section] += now - self._t0
            self.counts[section] += 1
        self._t0 = now

    class _Section:
        def __init__(self, timer: "Timer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self._t = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.sections[self.name] += (
                time.perf_counter() - self._t
            )
            self.timer.counts[self.name] += 1

    def section(self, name: str) -> "Timer._Section":
        return Timer._Section(self, name)

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


atexit.register(log_timers)


def reset_all() -> None:
    """Zero every timer's accumulated sections (bench.py calls this
    after warmup so tail timings attribute the steady state only)."""
    for t in _registry.values():
        t.sections.clear()
        t.counts.clear()
