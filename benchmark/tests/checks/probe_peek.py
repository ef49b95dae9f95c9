"""A check module for the harness's tests whose align reads the
program's records, which a check's align is not given: a run or a
control that names it stops with a KeyError."""

from reference import check


def align(ctx: dict):
    ctx["records"]
    return check.align_sample(ctx["refx"], ctx["queries"], ctx["dtype"],
                              ctx["config"]["engine"])
