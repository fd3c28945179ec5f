"""The ring halo exchange (TAXOEXPAN_HALO=ring): K6 reading the peers'
shards through CUDA IPC mappings (port of `taxoexpan_tpu/parallel/halo.py`
:ring_exchange).

Set-up, once a run: each rank copies its shard into an allocation of its
own (`halo_kernels.alloc_shard`), exports the allocation's IPC handle, and
the ranks exchange the handles through the process group. That exchange
is also the barrier after placement: every shard is in place before any
rank maps it. Each rank then opens its peers' handles (a handle cannot be
opened in the process that made it; for its own shard a rank uses its own
pointer) and keeps a device table of the P shard base pointers, which
every K6 launch reads through. The table is static during training, so
no launch waits on a peer.

Tear-down (`close`): the rank waits for its own launches, closes its
mappings, and only after a barrier, when every peer has closed its
mappings, frees its shard.

It takes two ranks or more: with one process the trainer gathers from the
replicated table (the JAX package's halo.py:205 launches no kernel for
P == 1 either). Mappings reach ranks of one host only (between processes
on one card, or between cards over NVLink); ranks on several hosts raise.
"""
from __future__ import annotations

import socket

import torch

from ..ops import halo_kernels
from . import distributed


class RingExchange:
    def __init__(self, shard: torch.Tensor, dp, device: torch.device):
        if device.type != "cuda":
            raise ValueError("TAXOEXPAN_HALO=ring reads the peers' shards "
                             "through CUDA IPC and runs on the card only; "
                             "use TAXOEXPAN_HALO=all_to_all on the CPU")
        if dp is None or dp.size == 1:
            raise ValueError("TAXOEXPAN_HALO=ring exchanges between two "
                             "ranks or more; one process gathers from the "
                             "replicated table")
        self.dp = dp
        self.device = device
        self.dtype = shard.dtype
        self._own = None
        self._peers: list[int] = []
        self.shards = None
        rows, d = shard.shape
        self._own = halo_kernels.alloc_shard(shard, device)
        info = distributed.all_gather_object(
            (socket.gethostname(), halo_kernels.ipc_handle(self._own,
                                                           device)), dp)
        hosts = sorted({host for host, _ in info})
        if len(hosts) > 1:
            self.close()
            raise ValueError(f"TAXOEXPAN_HALO=ring maps the peers' shards "
                             f"through CUDA IPC, which reaches the ranks of "
                             f"one host only (ranks on {hosts}); use "
                             f"TAXOEXPAN_HALO=all_to_all")
        ptrs = []
        for j, (_host, handle) in enumerate(info):
            if j == dp.rank:
                ptrs.append(self._own)
            else:
                self._peers.append(halo_kernels.ipc_open(handle, device))
                ptrs.append(self._peers[-1])
        self.shards = halo_kernels.pointer_table(ptrs, rows, d, shard.dtype,
                                                 device)

    def __call__(self, req: torch.Tensor) -> torch.Tensor:
        """ans [P, cap, D] in the shard's dtype for the request [P, cap]."""
        return halo_kernels.halo_gather(self.shards, req).to(self.dtype)

    def close(self) -> None:
        """Unmap the peers' shards and free this rank's, behind a barrier
        (every rank calls it)."""
        if self._own is None:
            return
        torch.cuda.synchronize(self.device)
        for ptr in self._peers:
            halo_kernels.ipc_close(ptr, self.device)
        self._peers = []
        self.shards = None
        distributed.barrier(self.dp)
        halo_kernels.free(self._own, self.device)
        self._own = None
