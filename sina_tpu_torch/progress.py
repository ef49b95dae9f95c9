"""Terminal progress bars (semantics of SINA src/progress.h:
56-205): rate-limited repainting on stderr with count/total, unicode
block bar, rate and ETA; silent when stderr is not a terminal.

Log interleaving: the reference's terminal_sink (progress.h:402-480)
keeps bars as sticky status lines below the scrolling log.  Here the
same effect comes from TerminalSinkHandler — a logging handler that
erases the bar line before each log record and repaints the active
bars after it (install via attach_terminal_sink; cli.setup_logging
does when stderr is a tty)."""

from __future__ import annotations

import logging
import sys
import threading
import time

_BLOCKS = " ▏▎▍▌▋▊▉█"

_active_lock = threading.Lock()
_active_bars: list["Progress"] = []


class TerminalSinkHandler(logging.StreamHandler):
    """Stream handler that interleaves scrolling log lines with the
    sticky progress-bar status line (terminal_sink semantics,
    SINA src/progress.h:402-480)."""

    def emit(self, record: logging.LogRecord) -> None:
        with _active_lock:
            bars = [
                b for b in _active_bars
                if b._enabled and b.out is self.stream
            ]
            if bars:
                try:
                    self.stream.write("\r\x1b[K")
                except Exception:  # pragma: no cover - stream gone
                    pass
        super().emit(record)
        with _active_lock:
            for b in bars:
                b._paint(force=True)


def attach_terminal_sink(handler: logging.Handler) -> logging.Handler:
    """Upgrade a plain StreamHandler config to the interleaving sink
    when its stream is a terminal; returns the handler to install."""
    stream = getattr(handler, "stream", None)
    if (
        isinstance(handler, logging.StreamHandler)
        and hasattr(stream, "isatty")
        and stream.isatty()
    ):
        new = TerminalSinkHandler(stream)
        new.setFormatter(handler.formatter)
        new.setLevel(handler.level)
        return new
    return handler


class Progress:
    def __init__(
        self,
        desc: str,
        total: int | None = None,
        out=None,
        min_interval: float = 0.1,
        ascii_only: bool = False,
    ):
        self.desc = desc
        self.total = total
        self.count = 0
        self.out = out if out is not None else sys.stderr
        self.min_interval = min_interval
        self.ascii = ascii_only
        self._t0 = time.time()
        self._last = 0.0
        self._enabled = hasattr(self.out, "isatty") and self.out.isatty()
        self._width = 30
        self._closed = False
        if self._enabled:
            with _active_lock:
                _active_bars.append(self)

    def set_total(self, total: int) -> None:
        self.total = total

    def update(self, n: int = 1) -> None:
        self.count += n
        now = time.time()
        if self._enabled and now - self._last >= self.min_interval:
            self._last = now
            self._paint()

    def __iadd__(self, n: int) -> "Progress":
        self.update(n)
        return self

    def _bar(self, frac: float) -> str:
        if self.ascii:
            filled = int(frac * self._width)
            return "#" * filled + "-" * (self._width - filled)
        cells = frac * self._width
        full = int(cells)
        part = int((cells - full) * 8)
        bar = "█" * full
        if full < self._width and part:
            bar += _BLOCKS[part]
        return bar.ljust(self._width)

    def _paint(self, force: bool = False) -> None:
        if self._closed and not force:
            return
        elapsed = time.time() - self._t0
        rate = self.count / elapsed if elapsed > 0 else 0.0
        if self.total:
            frac = min(1.0, self.count / self.total)
            eta = (self.total - self.count) / rate if rate > 0 else 0
            line = (
                f"{self.desc}: {frac*100:3.0f}%|{self._bar(frac)}| "
                f"{self.count}/{self.total} "
                f"[{elapsed:.0f}s<{eta:.0f}s, {rate:.1f}/s]"
            )
        else:
            line = (
                f"{self.desc}: {self.count} "
                f"[{elapsed:.0f}s, {rate:.1f}/s]"
            )
        self.out.write("\r\x1b[K" + line)
        self.out.flush()

    def close(self) -> None:
        if self._enabled:
            self._paint()
            self.out.write("\n")
            self.out.flush()
            with _active_lock:
                if self in _active_bars:
                    _active_bars.remove(self)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
