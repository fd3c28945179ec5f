"""Row-partitioned feature table with a halo exchange (port of
`taxoexpan_tpu/parallel/partition.py`).

Each rank of a data-parallel run owns an interleaved shard of the node
rows, rank k the rows {i : i % P == k} at local slot i // P (round-robin
ownership keeps request buckets balanced whatever the taxonomy's layout),
and every ego-batch gather becomes an exchange between the ranks:

    1. each rank deduplicates its requested ids, buckets the distinct ones
       by owner into [P, cap] local-slot requests (`plan_requests`);
    2. the exchange answers them: ans [P, cap, D], ans[j] = owner j's rows
       for bucket j;
    3. the rank un-buckets the answers into request order (`unbucket`).

The exchange is a callable req -> ans, chosen by TAXOEXPAN_HALO as in the
JAX package: "all_to_all" (default), two `all_to_all_single` hops with the
owner's local gather between them (`AllToAllExchange`), or "ring", K6 on
the card reading the peers' shards through CUDA IPC mappings
(`parallel/halo.py:RingExchange`). Factored so, the CPU tests run all P
ranks' local halves in one process with the K6 plain version standing in
for the exchange.

Buckets hold `capacity_factor` x n / P requests (`bucket_capacity`). A
bucket overflow (pathologically skewed distinct ids) poisons the overflowed
rows with NaN, so the loss turns NaN at once instead of training on wrong
features; the count of overflowed requests accumulates on the device in an
optional counter, which the trainer reads back and reports once an epoch,
with no per-step host sync (without a counter the call checks and warns at
once).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import distributed

logger = logging.getLogger(__name__)

HALO_IMPLS = ("all_to_all", "ring")


def pad_table(features: np.ndarray, num_shards: int) -> np.ndarray:
    """Pad the node axis so every shard holds the same number of rows."""
    v = features.shape[0]
    rows = -(-v // num_shards) * num_shards
    if rows != v:
        features = np.pad(features, ((0, rows - v), (0, 0)))
    return features


def shard_table(features: np.ndarray, num_shards: int) -> np.ndarray:
    """Round-robin partition of the node rows: [P, V/P, D], shard k holding
    the global rows {i : i % P == k} at local slots i // P (the JAX
    package's owner-major layout, partition.py:39)."""
    feats = pad_table(np.asarray(features), num_shards)
    v, d = feats.shape
    return np.ascontiguousarray(
        feats.reshape(v // num_shards, num_shards, d).transpose(1, 0, 2))


def bucket_capacity(n: int, p: int, factor: float = 2.0) -> int:
    """Per-owner request-bucket size: `factor` x the balanced load n/p,
    rounded up to a multiple of 8, clamped to n."""
    if p <= 1:
        return n
    cap = -(-int(n * factor) // p)
    return min(-(-cap // 8) * 8, n)


def halo_impl(impl: str | None = None) -> str:
    """The exchange to run: `impl`, else TAXOEXPAN_HALO, else
    "all_to_all"; any other value raises."""
    if impl is None:
        impl = os.environ.get("TAXOEXPAN_HALO", "all_to_all")
    if impl not in HALO_IMPLS:
        raise ValueError(f"unknown halo impl {impl!r}; TAXOEXPAN_HALO is "
                         f"one of {HALO_IMPLS}")
    return impl


@dataclass
class RequestPlan:
    """One rank's requests of one gather, bucketed by owner."""
    req: torch.Tensor             # [P, cap] int32 local slots
    sorted_owner: torch.Tensor    # [n] owner of each dedup slot, by owner
    rank_in_bucket: torch.Tensor  # [n] its position in its bucket
    sort_idx: torch.Tensor        # [n] dedup slot of each sorted position
    uslot: torch.Tensor           # [n] dedup slot of each request
    overflowed: torch.Tensor      # [n] bool, by sorted position
    real_overflow: torch.Tensor   # () int64: real requests that overflowed
    cap: int


def plan_requests(ids: torch.Tensor, p: int,
                  capacity_factor: float = 2.0) -> RequestPlan:
    """Deduplicate the global ids `ids` (any shape), route each distinct id
    to its owner id % P at local slot id // P, and bucket them into
    [P, cap] (partition.py:115-155). Unused dedup slots are routed by
    position (exactly even padding load); their local slots run past the
    shard and the exchange answers them with rows that are dropped."""
    flat_ids = ids.reshape(-1).long()
    n = flat_ids.numel()
    dev = flat_ids.device
    order = torch.argsort(flat_ids, stable=True)
    sid = flat_ids[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sid[1:] != sid[:-1]
    uslot_sorted = torch.cumsum(first, 0) - 1
    num_unique = uslot_sorted[-1:] + 1
    uslot = torch.empty_like(uslot_sorted)
    uslot[order] = uslot_sorted
    pos = torch.arange(n, device=dev)
    # representative id per unique slot (duplicates write the same value)
    uid = torch.zeros(n, dtype=torch.int64, device=dev)
    uid[uslot_sorted] = sid
    flat = torch.where(pos >= num_unique, pos, uid)
    owner = flat % p
    local_slot = flat // p

    cap = bucket_capacity(n, p, capacity_factor)
    sort_idx = torch.argsort(owner, stable=True)
    sorted_owner = owner[sort_idx]
    bucket_start = torch.searchsorted(sorted_owner,
                                      torch.arange(p, device=dev))
    rank_in_bucket = pos - bucket_start[sorted_owner]
    overflowed = rank_in_bucket >= cap
    # an overflowed request lands in a scratch slot that is cut off; its
    # output row is poisoned by unbucket
    dest = torch.where(overflowed, p * cap, sorted_owner * cap
                       + rank_in_bucket)
    req = torch.zeros(p * cap + 1, dtype=torch.int32, device=dev)
    req[dest] = local_slot[sort_idx].to(torch.int32)
    # overflow of an unused dedup slot is harmless: nothing maps back to it
    real = (overflowed & (sort_idx < num_unique)).sum()
    return RequestPlan(req[:p * cap].reshape(p, cap), sorted_owner,
                       rank_in_bucket, sort_idx, uslot, overflowed, real, cap)


def unbucket(returned: torch.Tensor, plan: RequestPlan) -> torch.Tensor:
    """Answers [P, cap, D] -> rows [n, D] in request order, overflowed
    requests NaN."""
    cap = plan.cap
    out_sorted = returned[plan.sorted_owner,
                          plan.rank_in_bucket.clamp(max=cap - 1)]
    if cap < out_sorted.shape[0]:
        out_sorted = torch.where(plan.overflowed[:, None],
                                 torch.full_like(out_sorted, float("nan")),
                                 out_sorted)
    rows = torch.empty_like(out_sorted)
    rows[plan.sort_idx] = out_sorted
    return rows[plan.uslot]


def partitioned_gather(ids: torch.Tensor, exchange, p: int,
                       capacity_factor: float = 2.0,
                       overflow: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Rows of the row-partitioned table for the global ids `ids` [...]:
    [..., D] in the shard's dtype. `exchange` answers a [P, cap] request
    (`make_exchange`). `overflow`: an int64 device scalar that accumulates
    the count of overflowed requests; None checks and warns at once (a host
    sync)."""
    if ids.numel() == 0:
        raise ValueError("partitioned_gather needs at least one id")
    plan = plan_requests(ids, p, capacity_factor)
    returned = exchange(plan.req)
    if not returned.dtype.is_floating_point:
        raise TypeError(f"partitioned_gather requires a floating-point "
                        f"table (got {returned.dtype}): bucket-overflow "
                        "poisoning relies on NaN")
    out = unbucket(returned, plan)
    if overflow is not None:
        overflow += plan.real_overflow
    elif int(plan.real_overflow):
        logger.warning("partitioned_gather: request bucket overflow "
                       "(cap=%d); raise capacity_factor", plan.cap)
    return out.reshape(*ids.shape, out.shape[-1])


class AllToAllExchange:
    """Two all-to-all hops: the request buckets to their owners, the
    owner's local gather, the answers back (partition.py:163-173).
    Out-of-range (padding) slots read the shard's last row, as XLA's
    gather clamps; the caller drops them."""

    def __init__(self, shard: torch.Tensor, dp):
        self.shard = shard
        self.dp = dp

    def __call__(self, req: torch.Tensor) -> torch.Tensor:
        incoming = distributed.all_to_all(req, self.dp)
        slots = incoming.long().clamp(0, self.shard.shape[0] - 1)
        return distributed.all_to_all(self.shard[slots], self.dp)

    def close(self) -> None:
        pass


def make_exchange(shard: torch.Tensor, dp, device: torch.device,
                  impl: str | None = None):
    """The exchange over this rank's shard (a CPU tensor [V/P, D]) for the
    impl that `halo_impl` selects. Close it when done (the ring holds IPC
    mappings)."""
    impl = halo_impl(impl)
    if impl == "ring":
        from .halo import RingExchange
        return RingExchange(shard, dp, device)
    if device.type == "cuda" and dp.backend != "nccl":
        raise ValueError(
            "TAXOEXPAN_HALO=all_to_all on ranks that share a card: NCCL "
            "refuses two ranks on one device, so the run's backend is gloo "
            "and both hops would cross the host; use TAXOEXPAN_HALO=ring, "
            "which reads the peers' shards on the card")
    return AllToAllExchange(shard.to(device), dp)
