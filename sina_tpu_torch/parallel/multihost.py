"""Multi-host scale-out helpers.

Port of sina_tpu/parallel/multihost.py.  The reference scales to
multiple machines by running N independent processes over byte-range
shards of one FASTA (--fasta-block / --fasta-idx, rw_fasta.cpp:209-242);
each process here reads its own shard and writes its own output part.
The JAX package joins the processes with jax.distributed; the port
joins them in a torch.distributed process group on the gloo backend.
The group only coordinates processes (the counterpart of JAX's
coordination service): famfinder's mesh is host-local, so the CLI path
runs no device collective across processes, and gloo lets two
processes share one GPU, which NCCL refuses.  A mesh whose dp axis
spans the processes (parallel/sharding.make_mesh with more than one
process) all-gathers its merged top-k over the group as host tensors.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("sina.multihost")


def process_count() -> int:
    """Processes in the group (1 before initialize or without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group of a multi-host run.

    `coordinator` is host:port of process 0's rendezvous
    (``tcp://host:port``); without it the group comes from the
    environment as torchrun sets it (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK: ``env://``), the counterpart of the JAX package's
    autodetection.  A count or id left out is read from the environment
    too.  Call before building the pipeline; ``shutdown`` leaves the
    group."""
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
    )
    # this process's devices (its CUDA devices, else the CPU), summed
    # over the group: one small collective, which also shows the group
    # works
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    n = torch.tensor([local], dtype=torch.int64)
    dist.all_reduce(n)
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        process_index(), process_count(), local, int(n),
    )


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_input_shard(path, n_bytes: int | None = None) -> dict:
    """Per-host --fasta-block parameters: split the input file evenly
    over the group's processes (reference: manual --fasta-block /
    --fasta-idx per process)."""
    size = n_bytes if n_bytes is not None else os.path.getsize(path)
    return {"fasta_block": size // process_count() + 1,
            "fasta_idx": process_index()}
