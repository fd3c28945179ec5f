"""The process layout of a run (the port's counterpart of
`taxoexpan_tpu/parallel/mesh.py`).

The JAX package declares parallelism as a `jax.sharding.Mesh` with a 'dp'
(batch) axis and an 'mp' (attention-head tensor-parallel) axis, its devices
in row-major order (`make_mesh({"dp": dp, "mp": mp})`). The port runs one
process a device: process r of dp x mp has dp index r // mp and mp index
r % mp. The world holds every process; a dp group the ranks with the same
mp index (they split the group batch and sum the gradients); an mp group
the ranks with the same dp index (they hold the same share of the batch
and split the GAT layers' heads, models/propagation.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from . import distributed


@dataclass(frozen=True)
class DataParallel:
    """One process group: size ranks, this process's rank in it, the
    backend ("nccl" or "gloo") and the torch.distributed handle (None: the
    default group, the world)."""
    size: int
    rank: int
    backend: str
    group: object = None


@dataclass(frozen=True)
class Layout:
    """dp x mp processes: the world, this process's dp group and its mp
    group (None when mp == 1: no head tensor parallelism)."""
    world: DataParallel
    dp: DataParallel
    mp: DataParallel | None = None

    @property
    def mp_size(self) -> int:
        return 1 if self.mp is None else self.mp.size

    @property
    def mp_index(self) -> int:
        return 0 if self.mp is None else self.mp.rank

    @classmethod
    def data_parallel(cls, dp: DataParallel) -> "Layout":
        """The layout of a data-parallel group alone (mp = 1)."""
        return cls(world=dp, dp=dp)


def layout(dp: int | None = None, mp: int = 1) -> Layout | None:
    """The layout of this process's run from the config's `parallel.dp` /
    `parallel.mp` (train.py settles mp first): every process of the run is
    one rank, dp defaults to processes // mp and, when given, dp x mp must
    equal the number of processes. The subgroups come from
    `torch.distributed.new_group`, which every rank calls for every group
    in the same order. None for a single-process run."""
    world = distributed.world_size()
    if mp < 1 or world % mp:
        raise ValueError(f"parallel.mp={mp} does not divide the run's "
                         f"{world} process(es)")
    if dp is None:
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"parallel.dp={dp} x mp={mp} != the run's {world} "
                         "process(es): the port runs one rank a process "
                         "(--num_processes)")
    if world == 1:
        return None
    rank, backend = distributed.rank(), dist.get_backend()
    world_group = DataParallel(size=world, rank=rank, backend=backend)
    if mp == 1:
        return Layout.data_parallel(world_group)
    mine = {}
    for m in range(mp):           # dp groups: ranks with mp index m
        ranks = list(range(m, world, mp))
        handle = dist.new_group(ranks)
        if rank in ranks:
            mine["dp"] = DataParallel(size=dp, rank=ranks.index(rank),
                                      backend=backend, group=handle)
    for d in range(dp):           # mp groups: ranks with dp index d
        ranks = list(range(d * mp, (d + 1) * mp))
        handle = dist.new_group(ranks)
        if rank in ranks:
            mine["mp"] = DataParallel(size=mp, rank=ranks.index(rank),
                                      backend=backend, group=handle)
    return Layout(world=world_group, **mine)
