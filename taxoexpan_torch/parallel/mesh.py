"""The data-parallel group of a run (the port's counterpart of
`taxoexpan_tpu/parallel/mesh.py`).

The JAX package declares parallelism as a `jax.sharding.Mesh` with a 'dp'
(batch) axis and an 'mp' (attention-head tensor-parallel) axis. The port
has the 'dp' axis: one process a rank, the group batch split by rank, one
gradient all-reduce a step. Head tensor parallelism over 'mp' is not ported
yet and raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from . import distributed


@dataclass(frozen=True)
class DataParallel:
    """size ranks, this process's rank, the process group (None: the
    default group) and its backend ("nccl" or "gloo")."""
    size: int
    rank: int
    backend: str
    group: object = None


def data_parallel(dp: int | None = None,
                  mp: int = 1) -> DataParallel | None:
    """The data-parallel group of this process's run, from the config's
    `parallel.dp` / `parallel.mp`: every process of the run is one rank
    (dp, when given, must equal their number). None for a single-process
    run."""
    if mp > 1:
        raise ValueError(f"parallel.mp={mp}: head tensor parallelism over "
                         "'mp' is not ported yet; the port runs "
                         "data-parallel only (mp = 1)")
    world = distributed.world_size()
    if dp is not None and dp != world:
        raise ValueError(f"parallel.dp={dp}, but the run has {world} "
                         "process(es): the port runs one rank a process "
                         "(--num_processes)")
    if world == 1:
        return None
    return DataParallel(size=world, rank=distributed.rank(),
                        backend=dist.get_backend())
