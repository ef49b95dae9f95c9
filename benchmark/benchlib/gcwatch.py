"""The garbage collector's runs and their host time, by generation.
Frozen copy of bench_torch.py:140 ``gc_pauses``."""

from __future__ import annotations

import contextlib
import gc
import time


@contextlib.contextmanager
def gc_pauses():
    """While open, counts the garbage collector's runs and their host
    time by generation (gc.callbacks); yields {generation: [runs, s]}."""
    got = {g: [0, 0.0] for g in range(3)}
    start = [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            got[info["generation"]][0] += 1
            got[info["generation"]][1] += time.perf_counter() - start[0]

    gc.callbacks.append(note)
    try:
        yield got
    finally:
        gc.callbacks.remove(note)
