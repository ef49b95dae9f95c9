"""The check fails a run whose timed path is broken underneath: half
of each batch left out, an answer altered where it is produced, and an
aligner that hands its input back unaligned.  (One chip: no exchange
between chips to leave out; no training state to leave unchanged.)"""

import time

import numpy as np
import pytest

from benchlib import runner
from tiny import tiny_cell


def _drop_half(pipe):
    orig = pipe._finalize_batch

    def fin(entry):
        rows = orig(entry)
        return rows[: (len(rows) + 1) // 2]
    pipe._finalize_batch = fin


def _shift_one(pipe):
    orig = pipe._finalize_batch

    def fin(entry):
        rows = orig(entry)
        q, a, rel = rows[0]
        if a is not None and len(a.positions) > 2 and a.positions[-1] + 1 < a.width:
            a.positions = a.positions.copy()
            a.positions[-1] += 1
        return rows
    pipe._finalize_batch = fin


def _unaligned(pipe):
    orig = pipe._finalize_batch

    def fin(entry):
        rows = orig(entry)
        for q, a, rel in rows:
            if a is not None:
                a.positions = np.arange(len(a.positions), dtype=np.uint32)
        return rows
    pipe._finalize_batch = fin


@pytest.mark.parametrize("fault", [_drop_half, _shift_one, _unaligned],
                         ids=["half-batch-left-out", "answer-altered", "input-unchanged"])
def test_fault_is_not_correct(fault):
    cell = tiny_cell()
    cell["traffic"]["check_sample"] = 64
    run = runner.run_cell(cell, 99, 1.0, False, "cpu", time.time(), faults=fault)
    nums = runner.check(cell, run, 99, "cpu")
    fails = [k for k, lim in cell["config"]["limits"].items() if nums[k] > lim]
    assert fails, nums
