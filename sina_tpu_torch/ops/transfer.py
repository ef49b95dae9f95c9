"""Host<->device copies of the dispatch paths: pinned staging buffers,
uploads that do not block the host, and fetches that start at launch
and wait only for their own copy.

The counterpart of what JAX's runtime gives the JAX package: one
``device_put`` of a pinned buffer, and ``copy_to_host_async`` right
after a launch (sina_tpu/ops/profile.py:978-1012,
sina_tpu/align.py:1106-1110), so that a later ``np.asarray`` waits for
that buffer alone.

- ``upload(a, device)``: a numpy array (through a pinned staging
  buffer) or a pinned host tensor, copied with ``non_blocking=True``
  on the device's current (compute) stream;
- ``fetch_async(t)``: records an event on the compute stream, makes the
  device's copy stream wait for it and copies ``t`` into pinned host
  memory there; the handle's ``result()`` waits for that copy's event
  only, not for kernels queued after it, and gives numpy;
- ``host_buffer(nbytes, device)``: a pinned buffer for the caller to
  fill (the profile wire, the graph bucket's planes), lent until
  ``release``.

Pinned buffers come from one pool, reused by size class (powers of two,
from 64 KiB).  A buffer goes back to the pool guarded by an event on
the stream that reads it, and is handed out again only once that event
has completed.  The pool holds at most ``POOL_CAP_BYTES``: past it,
idle buffers are dropped (to PyTorch's pinned-memory cache, which
reuses a block of the same size), then guarded ones are waited for and
dropped; when every byte is lent, ``host_buffer`` raises.  The pool
counts its buffers lent again, made anew and dropped
(``pinned_pool.reused`` / ``.new`` / ``.dropped``, ``timing.count``).  Pinning
never falls back to pageable memory: a failure to pin raises.

On a CPU device nothing is pinned and nothing is copied: the caller
asked for the CPU, so ``upload`` wraps the array and ``fetch_async``
returns the tensor's values.  ``counts`` counts the copies made on a
CUDA device (``h2d``, ``d2h``), as ``kernels.launches`` counts kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import timing

POOL_CAP_BYTES = 4 << 30
_MIN_CLASS = 1 << 16

counts = {"h2d": 0, "d2h": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _size_class(nbytes: int) -> int:
    return max(_MIN_CLASS, 1 << max(int(nbytes) - 1, 0).bit_length())


class _Slot:
    """One pinned buffer of the pool: lent to a caller, or free once
    its guard event (the last copy that reads or writes it) is done."""

    __slots__ = ("host", "event", "lent")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.event: torch.cuda.Event | None = None
        self.lent = False

    def idle(self) -> bool:
        return not self.lent and (self.event is None or self.event.query())


def _pinned(size: int) -> torch.Tensor:
    host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError(f"could not pin a host buffer of {size} bytes")
    return host


class _Pool:
    """Buffers from `alloc(size)` (pinned ones), reused by size class,
    at most `cap` bytes of them."""

    def __init__(self, alloc=_pinned, cap: int = POOL_CAP_BYTES):
        self.alloc = alloc
        self.cap = cap
        self.slots: dict[int, list[_Slot]] = {}   # size class -> slots
        self.by_ptr: dict[int, _Slot] = {}        # buffer address -> slot
        self.nbytes = 0

    def lend(self, nbytes: int) -> _Slot:
        size = _size_class(nbytes)
        for s in self.slots.get(size, ()):
            if s.idle():
                s.lent, s.event = True, None
                timing.count("pinned_pool.reused")
                return s
        self._make_room(size)
        timing.count("pinned_pool.new")
        s = _Slot(self.alloc(size))
        s.lent = True
        self.slots.setdefault(size, []).append(s)
        self.by_ptr[s.host.data_ptr()] = s
        self.nbytes += size
        return s

    def _drop(self, s: _Slot) -> None:
        timing.count("pinned_pool.dropped")
        self.slots[s.host.numel()].remove(s)
        del self.by_ptr[s.host.data_ptr()]
        self.nbytes -= s.host.numel()

    def _make_room(self, size: int) -> None:
        for s in [s for ss in self.slots.values() for s in ss if s.idle()]:
            if self.nbytes + size <= self.cap:
                return
            self._drop(s)
        guarded = [s for ss in self.slots.values() for s in ss if not s.lent]
        while self.nbytes + size > self.cap and guarded:
            s = guarded.pop(0)
            s.event.synchronize()
            self._drop(s)
        if self.nbytes + size > self.cap:
            raise RuntimeError(
                f"pinned pool: {self.nbytes} bytes lent, {size} more would pass "
                f"its cap of {self.cap} bytes")

    def give_back(self, buf: torch.Tensor, event: torch.cuda.Event | None) -> None:
        s = self.by_ptr.get(buf.untyped_storage().data_ptr())
        if s is None or not s.lent:
            raise ValueError("release of a buffer the pinned pool did not lend")
        s.lent, s.event = False, event


_pool = _Pool()
_copy_streams: dict[int, torch.cuda.Stream] = {}


def pool_bytes() -> int:
    """Bytes of pinned memory the pool holds, lent or free."""
    return _pool.nbytes


def pool_buffers() -> list[torch.Tensor]:
    """Every buffer of the pool (for checks: each must be pinned)."""
    return [s.host for ss in _pool.slots.values() for s in ss]


def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's copy stream, made at first use."""
    s = _copy_streams.get(device.index)
    if s is None:
        s = _copy_streams[device.index] = torch.cuda.Stream(device=device)
    return s


def host_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 host buffer of nbytes for data bound for `device`: on a
    CUDA device pinned and lent by the pool until ``release``; on the
    CPU a plain tensor."""
    if device.type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    return _pool.lend(nbytes).host[:nbytes]


def release(buf: torch.Tensor, device: torch.device) -> None:
    """Give a ``host_buffer`` back.  On a CUDA device it is guarded by
    an event recorded now on the device's current stream, so it is not
    handed out again before the copies queued from it have run."""
    if device.type != "cuda":
        return
    with torch.cuda.device(device):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
    _pool.give_back(buf, ev)


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def upload(a, device: torch.device) -> torch.Tensor:
    """`a` (a numpy array, or a pinned host tensor the caller keeps
    until the copy has run) on `device`: on a CUDA device copied with
    ``non_blocking=True`` on its current stream, a numpy array through
    a pinned staging buffer first; on the CPU the array itself."""
    if device.type != "cuda":
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a))
    staged = None
    if isinstance(a, torch.Tensor):
        if not a.is_pinned():
            raise ValueError("upload of a host tensor that is not pinned")
        src = a
    else:
        a = np.ascontiguousarray(a)
        staged = host_buffer(a.nbytes, device)
        src = staged.view(torch_dtype(a.dtype)).view(a.shape)
        src.numpy()[...] = a
    with torch.cuda.device(device):
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
        out.copy_(src, non_blocking=True)
    if staged is not None:
        release(staged, device)
    counts["h2d"] += 1
    return out


class Fetch:
    """A device-to-host copy in flight; ``result()`` gives its numpy
    array (computed at once for a CPU tensor)."""

    def __init__(self, value: np.ndarray | None = None, host=None,
                 done: torch.cuda.Event | None = None):
        self._value = value
        self._host = host
        self._done = done

    def result(self) -> np.ndarray:
        """Wait for this copy alone and return its values."""
        if self._value is None:
            self._done.synchronize()
            self._value = self._host.numpy().copy()
            _pool.give_back(self._host, None)
            self._host = None
        return self._value

    def __del__(self):
        # dropped before result(): the buffer is free once the copy ran
        if self._host is not None:
            _pool.give_back(self._host, self._done)


def fetch_async(t: torch.Tensor) -> Fetch:
    """Start copying `t` to the host: on a CUDA device into a pinned
    buffer on the device's copy stream, after the work queued so far on
    its current stream (``t.record_stream`` keeps the allocator from
    reusing t before the copy has read it)."""
    if t.device.type != "cuda":
        return Fetch(value=t.numpy())
    dev = t.device
    with torch.cuda.device(dev):
        t = t.contiguous()
        compute, copy = torch.cuda.current_stream(dev), copy_stream(dev)
        ready = torch.cuda.Event()
        ready.record(compute)
        copy.wait_event(ready)
        host = _pool.lend(t.nbytes).host[: t.nbytes].view(t.dtype).view(t.shape)
        with torch.cuda.stream(copy):
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        t.record_stream(copy)
    counts["d2h"] += 1
    return Fetch(host=host, done=done)
