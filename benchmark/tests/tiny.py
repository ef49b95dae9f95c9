"""A cell at a size the CPU runs in seconds (the port's plain kernels):
the profile configuration's law and check, scaled down."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

# the family options the tiny reference needs, each with its value
TINY_FLAGS = {"--fs-full-len": "400", "--fs-min": "10", "--fs-max": "10"}


def tiny_cli(cli: list[str]) -> list[str]:
    """A configuration's command line with the tiny family options in
    place of its own; every other flag stays."""
    out, skip = [], False
    for a in cli:
        if not skip and a not in TINY_FLAGS:
            out.append(a)
        skip = a in TINY_FLAGS
    return out + [x for kv in TINY_FLAGS.items() for x in kv]


def tiny_cell(config: str = "silva-nr99-profile", traffic: str = "full-length",
              cli: tuple = (), **traffic_keys) -> dict:
    """The cell at the tiny size; `cli` adds flags to the configuration's
    command line and `traffic_keys` set keys of the traffic mix (say,
    `turned`), as a later configuration's or traffic's file would."""
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    trf = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    cfg.update(n_refs=300, width=1200, n_core=500, genus_size=16, reference_seed=77)
    cfg["threads"] = {"torch_intra_op": 1, "omp": 1}
    cfg["cli"] = tiny_cli(list(cfg["cli"]) + list(cli))
    cfg["policy"].update(fs_full_len=400, fs_min=10, fs_max=10)
    trf = dict(trf, batch_size=8, warmup_batches=2, pool_rate=2, pool_factor=2, check_sample=6,
               cli=["--batch-size", "8"], **traffic_keys)
    if "amplicon" in trf:
        trf["amplicon"] = {"length": 120, "max_start": 100}
    return {"spec": {"name": f"{config}.{traffic}", "chips": 1}, "config": cfg, "traffic": trf}
