"""A cell at a size the CPU runs in seconds (the port's plain kernels):
the profile configuration's law and check, scaled down."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def tiny_cell(config: str = "silva-nr99-profile", traffic: str = "full-length") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    trf = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    cfg.update(n_refs=300, width=1200, n_core=500, genus_size=16, reference_seed=77)
    cfg["threads"] = {"torch_intra_op": 1, "omp": 1}
    full = ["--fs-full-len", "400", "--fs-min", "10", "--fs-max", "10"]
    cfg["cli"] = ["--meta-fmt", "comment", "--write-used-rels"] + \
        (["--fs-graph"] if cfg["engine"] == "graph" else []) + full
    cfg["policy"].update(fs_full_len=400, fs_min=10, fs_max=10)
    trf = dict(trf, batch_size=8, warmup_batches=2, pool_rate=2, pool_factor=2, check_sample=6,
               cli=["--batch-size", "8"])
    if "amplicon" in trf:
        trf["amplicon"] = {"length": 120, "max_start": 100}
    return {"spec": {"name": f"{config}.{traffic}", "chips": 1}, "config": cfg, "traffic": trf}
