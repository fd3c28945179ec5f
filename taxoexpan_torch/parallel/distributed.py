"""Multi-process runs on torch.distributed (port of
`taxoexpan_tpu/parallel/distributed.py`): data parallelism over the dp
groups and head tensor parallelism over the mp groups of
`parallel/mesh.py`'s layout.

Every process runs the same program on one device: the rank with local
index l among the ranks of its host runs on card l % device_count of that
host (two ranks may share a card), or on the CPU. The local index and the
host's rank count come from LOCAL_RANK / LOCAL_WORLD_SIZE where a launcher
sets them, else from the hostnames every rank posts to a TCPStore at the
coordinator before the process group is built.
`maybe_initialize` wires `torch.distributed.init_process_group` from
explicit arguments or the TAXOEXPAN_COORDINATOR / TAXOEXPAN_NUM_PROCESSES /
TAXOEXPAN_PROCESS_ID environment variables, as the JAX package wires
`jax.distributed.initialize`; the coordinator is `host:port`, the rendezvous
is `tcp://host:port`.

Batches: every rank builds the same host-global batch from the same seeded
sampler and keeps its dp index's contiguous share of groups (`rank_share`,
the counterpart of `put_global`): bit-exact global batches with no data
service, as in the JAX package.

Head tensor parallelism: `mp_gather_last`, `mp_sum` and `mp_sum_grads`
are autograd Functions over an mp group (the per-slot output's gather,
the pooled output's psum, the psum of a replicated input's grad, as
shard_map's transpose makes it); their sums add every rank's copy in rank
order (`sum_in_rank_order`), so every rank holds the same bits.

Backend: NCCL when every rank has a card of its own (no host runs more
ranks than it has cards); gloo on the CPU and when ranks share a card, since NCCL refuses two ranks on one device. gloo runs its
collectives on host memory (its CUDA code paths copy device tensors
through host buffers), so under gloo this module stages every collective
it issues through the host itself, explicitly: `all_reduce_sum`,
`all_gather_cat`, `all_to_all` and the mp group's gathers copy a CUDA
tensor to the host, run the collective on the CPU copy and copy the
result back; `all_gather_object`
and `barrier` carry no tensors of the caller. Under NCCL the tensors stay
on the card.
"""
from __future__ import annotations

import logging
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..data.egobatch import EgoBatch, GroupBatch
from ..device import resolve_device

logger = logging.getLogger(__name__)


def add_multiprocess_args(ap) -> None:
    """The evaluation CLIs' -m / --mesh and the flags `maybe_initialize`
    takes, as the JAX CLIs have them (test_fast.py:130-143,
    infer.py:112-128)."""
    ap.add_argument("-m", "--mesh", action="store_true",
                    help="shard anchor encoding over all processes "
                         "(data-parallel evaluation)")
    ap.add_argument("--coordinator", default=None, type=str,
                    help="process-group rendezvous address host:port")
    ap.add_argument("--num_processes", default=None, type=int,
                    help="total process count")
    ap.add_argument("--process_id", default=None, type=int,
                    help="this process's rank in [0, num_processes)")


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
    init = {"init_method": f"tcp://{coordinator}"}
    if torch.device(device).type == "cuda":
        resolve_device("cuda")          # raises where there is no card
        local, init = local_ranks(coordinator, num_processes, process_id)
        count = torch.cuda.device_count()
        global _LOCAL_RANK
        _LOCAL_RANK = local[0]
        torch.cuda.set_device(local[0] % count)
        backend = "nccl" if local[1] <= count else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, world_size=num_processes,
                            rank=process_id, **init)
    logger.info("process group up: rank %d of %d, backend %s", process_id,
                num_processes, backend)
    return True


_LOCAL_RANK: int | None = None   # this rank's index on its host


def local_ranks(coordinator: str, num_processes: int,
                process_id: int) -> tuple[tuple[int, int], dict]:
    """((this rank's index among the ranks of its host, their number),
    the rendezvous arguments of init_process_group). LOCAL_RANK /
    LOCAL_WORLD_SIZE where set; otherwise every rank posts its hostname to
    a TCPStore at the coordinator (rank 0 serves it), which then also
    serves the process group's rendezvous."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return ((int(os.environ["LOCAL_RANK"]),
                 int(os.environ["LOCAL_WORLD_SIZE"])),
                {"init_method": f"tcp://{coordinator}"})
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0)
    store.set(f"taxoexpan/host/{process_id}", socket.gethostname())
    hosts = [store.get(f"taxoexpan/host/{r}").decode()
             for r in range(num_processes)]
    mine = hosts[process_id]
    return ((hosts[:process_id].count(mine), hosts.count(mine)),
            {"store": store})


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def world_size() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: `device` itself on the CPU or with an explicit
    card index, else card (local rank) % device_count (the card
    maybe_initialize selected)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_multiprocess():
        local = rank() if _LOCAL_RANK is None else _LOCAL_RANK
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_share(batch: GroupBatch, rank: int, size: int) -> GroupBatch:
    """The contiguous share of a host-global batch of dp index `rank` among
    `size` dp ranks: groups [rank * G/size, (rank + 1) * G/size) and their
    egonet rows. Every mp rank of one dp group gets the same share (the
    JAX batch spec P("dp"))."""
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


def _gather_parts(t: torch.Tensor, grp) -> list:
    """Every rank's `t` (equal shapes) of group `grp`, in rank order, on
    t's device; staged through the host under gloo."""
    src = t.contiguous()
    if _staged(src, grp):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(grp.size)]
    dist.all_gather(parts, src, group=grp.group)
    return [part.to(t.device) for part in parts]


def sum_in_rank_order(t: torch.Tensor, grp) -> torch.Tensor:
    """The sum of `t` over the ranks of `grp`, added in rank order from
    every rank's copy: the same bits on every rank, under any backend."""
    parts = _gather_parts(t, grp)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


class _GatherLast(torch.autograd.Function):
    """Forward: every mp rank's `t` concatenated along the last axis in rank
    order. Backward: this rank's columns of the incoming grad, which every
    mp rank holds equal (what follows the gather is replicated over mp)."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp, ctx.width = grp, t.shape[-1]
        return torch.cat(_gather_parts(t, grp), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.grp.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum of the mp ranks' partial `t`. Backward: the grad
    unchanged, every mp rank's partial entered the sum once."""

    @staticmethod
    def forward(ctx, t, grp):
        return sum_in_rank_order(t, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """Forward: `t` unchanged (a replicated input of a head-sharded layer).
    Backward: the sum of the mp ranks' partial grads, each rank's heads'
    share."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_in_rank_order(g, ctx.grp), None


def mp_gather_last(t: torch.Tensor, grp) -> torch.Tensor:
    """A head-sharded layer's per-slot output gathered over the mp group
    along its feature axis, in head-major order (differentiable)."""
    return _GatherLast.apply(t, grp)


def mp_sum(t: torch.Tensor, grp) -> torch.Tensor:
    """The sum over the mp group of the ranks' partial outputs
    (differentiable; the JAX package's psum over 'mp')."""
    return _SumReplicated.apply(t, grp)


def mp_sum_grads(t: torch.Tensor, grp) -> torch.Tensor:
    """`t` itself, its grad summed over the mp group (differentiable; the
    psum shard_map's transpose makes of a cotangent replicated over
    'mp')."""
    return _SumGrads.apply(t, grp)


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
