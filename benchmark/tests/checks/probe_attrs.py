"""A check module for the harness's tests: sampled records that carry no
`nearest_slv` (the search's attribute), from the reader's attributes."""


def numbers(ctx: dict) -> dict:
    attrs = ctx["records"]["attrs"]
    return {"nearest_missing": sum("nearest_slv" not in attrs[k] for k in ctx["pick"])}
