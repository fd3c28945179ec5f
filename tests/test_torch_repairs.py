"""Two faults of the port's data-parallel path, held on the CPU:

- the process group's backend and each rank's card follow the ranks of the
  rank's own host (LOCAL_RANK / LOCAL_WORLD_SIZE, or the hostnames posted to
  a TCPStore at the coordinator), not the run's world size against this
  host's card count;
- a halo overflow during the sampled validation is reported for the epoch
  in which it happened, as the reference reports it at the gather
  (taxoexpan_tpu/parallel/partition.py:186-190).

The card count, the store, the hostnames and the collectives are stubbed:
nothing here needs a card or a second process."""
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from taxoexpan_torch.parallel import distributed
from taxoexpan_torch.parallel.mesh import DataParallel, Layout
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer


class _Store:
    """A TCPStore stand-in holding every rank's hostname in advance."""

    def __init__(self, hosts):
        self.data = {f"taxoexpan/host/{r}": h.encode()
                     for r, h in enumerate(hosts)}

    def set(self, key, value):
        assert self.data[key] == value.encode()

    def get(self, key):
        return self.data[key]


@pytest.fixture()
def group(monkeypatch):
    """Stub the card count, the card choice and the group's creation;
    returns the record of what maybe_initialize asked for."""
    seen = {"cards": []}
    monkeypatch.setattr(distributed, "_LOCAL_RANK", None, raising=False)
    monkeypatch.setattr(distributed, "resolve_device", lambda d: d)
    monkeypatch.setattr(torch.cuda, "set_device", seen["cards"].append)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return seen


def _start(monkeypatch, cards, hosts, rank, env=None):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(distributed.socket, "gethostname",
                        lambda: hosts[rank])
    monkeypatch.setattr(distributed.dist, "TCPStore",
                        lambda *a, **kw: _Store(hosts))
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    assert distributed.maybe_initialize("10.0.0.1:29500", len(hosts), rank)
    monkeypatch.setattr(distributed, "is_multiprocess", lambda: True)
    monkeypatch.setattr(distributed, "rank", lambda: rank)


@pytest.mark.parametrize("how", ["hostnames", "launcher"])
def test_two_hosts_of_eight_cards_run_nccl_on_the_local_card(
        group, monkeypatch, how):
    """16 ranks on 2 hosts x 8 cards: every rank has a card of its own, so
    NCCL; global rank 11 is the fourth rank of host b, so card 3."""
    hosts = ["a"] * 8 + ["b"] * 8
    env = {"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "8"} \
        if how == "launcher" else None
    _start(monkeypatch, 8, hosts, 11, env)
    assert group["backend"] == "nccl"
    assert group["cards"] == [3]
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    # the hostnames' store also serves the group's rendezvous
    assert ("store" in group) == (how == "hostnames")


def test_two_ranks_on_one_card_keep_gloo(group, monkeypatch):
    """Two ranks of one host sharing its one card: gloo, card 0."""
    _start(monkeypatch, 1, ["a", "a"], 1)
    assert group["backend"] == "gloo"
    assert group["cards"] == [0]
    assert distributed.rank_device("cuda") == torch.device("cuda", 0)


def test_validation_overflow_is_reported_in_its_epoch(monkeypatch, tmp_path,
                                                      caplog):
    """Requests that overflow their halo buckets during epoch 1's sampled
    validation are counted in epoch 1's log and warned about there, not
    carried into epoch 2's training count."""
    monkeypatch.setattr(distributed, "all_reduce_sum",
                        lambda t, dp: t.clone())
    opt = toptim.Optimizer(lr=1e-2)
    trainer = Trainer(SimpleNamespace(propagate=SimpleNamespace()), {}, opt,
                      opt.init({}), loss_name="info_nce_loss",
                      metric_names=["macro_mr"],
                      feature_table=np.zeros((8, 2), np.float32),
                      train_loader=[], valid_loader=[], save_dir=tmp_path,
                      device="cpu",
                      layout=Layout.data_parallel(
                          DataParallel(size=1, rank=0, backend="gloo")),
                      feature_mode="partitioned")

    def validation(epoch):           # its gathers overflow in epoch 1
        if epoch == 1:
            trainer._overflow += 3
        return {"val_metrics": [0.0]}
    monkeypatch.setattr(trainer, "_valid_epoch", validation)
    with caplog.at_level(logging.WARNING, logger="trainer"):
        logs = [trainer._train_epoch(epoch) for epoch in (1, 2)]
    assert [log["halo_overflow"] for log in logs] == [
        {"train": 0, "valid": 3}, {"train": 0, "valid": 0}]
    assert [r.getMessage() for r in caplog.records] == [
        "partitioned_gather: 3 requests overflowed their halo buckets in "
        "epoch 1's validation and were poisoned with NaN; raise "
        "capacity_factor"]
