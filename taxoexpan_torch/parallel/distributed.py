"""Multi-process data parallelism on torch.distributed (port of
`taxoexpan_tpu/parallel/distributed.py`).

Every process runs the same program on one device: rank r on card
r % device_count of its host (two ranks may share a card), or on the CPU.
`maybe_initialize` wires `torch.distributed.init_process_group` from
explicit arguments or the TAXOEXPAN_COORDINATOR / TAXOEXPAN_NUM_PROCESSES /
TAXOEXPAN_PROCESS_ID environment variables, as the JAX package wires
`jax.distributed.initialize`; the coordinator is `host:port`, the rendezvous
is `tcp://host:port`.

Batches: every rank builds the same host-global batch from the same seeded
sampler and keeps its own contiguous share of groups (`rank_share`, the
counterpart of `put_global`): bit-exact global batches with no data
service, as in the JAX package.

Backend: NCCL when every rank has a card of its own (the host has at least
as many cards as there are ranks); gloo on the CPU and when ranks share a
card, since NCCL refuses two ranks on one device. gloo runs its
collectives on host memory (its CUDA code paths copy device tensors
through host buffers), so under gloo this module stages every collective
it issues through the host itself, explicitly: `all_reduce_sum`,
`all_gather_cat` and `all_to_all` copy a CUDA tensor to the host, run the
collective on the CPU copy and copy the result back; `all_gather_object`
and `barrier` carry no tensors of the caller. Under NCCL the tensors stay
on the card.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ..data.egobatch import EgoBatch, GroupBatch
from ..device import resolve_device

logger = logging.getLogger(__name__)


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device = "cuda") -> bool:
    """Initialise the process group if a multi-process run is requested
    (explicit arguments or the TAXOEXPAN_* environment variables) and
    select this rank's card. Returns True iff running multi-process.
    `device` is the run's device type ("cuda" or "cpu"): it sets the
    backend (see the module docstring)."""
    coordinator = coordinator or os.environ.get("TAXOEXPAN_COORDINATOR")
    if num_processes is None and "TAXOEXPAN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TAXOEXPAN_NUM_PROCESSES"])
    if process_id is None and "TAXOEXPAN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TAXOEXPAN_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "(host:port), the number of processes and this "
                         "process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    if torch.device(device).type == "cuda":
        resolve_device("cuda")          # raises where there is no card
        count = torch.cuda.device_count()
        torch.cuda.set_device(process_id % count)
        backend = "nccl" if count >= num_processes else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    logger.info("process group up: rank %d of %d, backend %s", process_id,
                num_processes, backend)
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def world_size() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: `device` itself on the CPU or with an explicit
    card index, else card rank % device_count (the card maybe_initialize
    selected)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_multiprocess():
        dev = torch.device("cuda", rank() % torch.cuda.device_count())
    return resolve_device(dev)


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_share(batch: GroupBatch, rank: int, size: int) -> GroupBatch:
    """Rank `rank`'s contiguous share of a host-global batch: groups
    [rank * G/size, (rank + 1) * G/size) and their egonet rows."""
    g, c = batch.labels.shape
    if g % size:
        raise ValueError(f"{g} groups a batch do not split over {size} "
                         "ranks; make the batch size a multiple of the "
                         "data-parallel size")
    gs = g // size
    rows = slice(rank * gs * c, (rank + 1) * gs * c)
    groups = slice(rank * gs, (rank + 1) * gs)

    def part(a, sl):
        return None if a is None else np.ascontiguousarray(a[sl])
    ego = batch.ego
    return GroupBatch(ego=EgoBatch(node_ids=part(ego.node_ids, rows),
                                   ngp=part(ego.ngp, rows),
                                   nsib=part(ego.nsib, rows)),
                      query_ids=part(batch.query_ids, groups),
                      query_feats=part(batch.query_feats, groups),
                      labels=part(batch.labels, groups),
                      cand_mask=part(batch.cand_mask, groups))


# ------------------------------------------------------------ collectives

def _staged(t: torch.Tensor, dp) -> bool:
    return dp.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(t: torch.Tensor, dp) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor on t's device)."""
    if _staged(t, dp):
        host = t.cpu()
        dist.all_reduce(host, group=dp.group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=dp.group)
    return out


def all_gather_cat(t: torch.Tensor, dp) -> torch.Tensor:
    """Every rank's `t` (equal shapes), concatenated along dim 0 in rank
    order."""
    src = t.contiguous()
    if _staged(t, dp):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dp.size)]
    dist.all_gather(parts, src, group=dp.group)
    return torch.cat(parts).to(t.device)


def all_to_all(t: torch.Tensor, dp) -> torch.Tensor:
    """out[j] = rank j's t[this rank]: dim 0 of `t` holds one equal part a
    rank."""
    src = t.contiguous()
    if _staged(t, dp):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=dp.group)
    return out.to(t.device)


def all_gather_object(obj, dp) -> list:
    out = [None] * dp.size
    dist.all_gather_object(out, obj, group=dp.group)
    return out


def barrier(dp) -> None:
    dist.barrier(group=dp.group)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (the default group)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
