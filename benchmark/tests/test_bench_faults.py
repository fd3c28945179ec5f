"""A run at a tiny size on the CPU, past the harness's look for a chip,
with the timed path broken underneath: each fault a cell can have must
make `correct` false. (One chip: no exchange between chips to leave out.)
"""
from __future__ import annotations

import pytest
import torch

from benchmark.run import execute

SEED = 2 ** 31 + 7


def _run(cell):
    return execute(cell, SEED, 0.5, False, torch.device("cpu"))


def test_sound_runs_are_correct(tiny):
    for name in ("pgat_mag.train", "pgat_mag.serve_refresh",
                 "pgcn_mag.serve_refresh", "pgat_mag.serve_cached"):
        res = _run(tiny(name))
        assert res["correct"], (name, res["checks"])


def test_train_state_unchanged(tiny, monkeypatch):
    from taxoexpan_torch.training.optim import Optimizer
    monkeypatch.setattr(Optimizer, "update",
                        lambda self, grads, state, params: (params, state))
    res = _run(tiny("pgat_mag.train"))
    assert not res["correct"]
    assert res["checks"]["update_median_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch(tiny, monkeypatch):
    from taxoexpan_torch.losses import info_nce_loss
    from taxoexpan_torch.training import trainer

    def half(scores, labels, mask):
        g = scores.shape[0] // 2
        return 2.0 * info_nce_loss(scores[:g], labels[:g], mask[:g])
    monkeypatch.setattr(trainer, "get_loss", lambda name: half)
    assert not _run(tiny("pgat_mag.train"))["correct"]


@pytest.mark.parametrize("name", ["pgat_mag.train", "pgcn_mag.serve_refresh"])
def test_score_altered(tiny, monkeypatch, name):
    """One matcher score raised where the model produces it (training), or
    one anchor's embedding moved (serving)."""
    from taxoexpan_torch.models.taxoexpan import TaxoExpan
    if name.endswith("train"):
        orig = TaxoExpan.match

        def match(self, params, hg, qf):
            s = orig(self, params, hg, qf)
            return s + torch.nn.functional.one_hot(
                torch.tensor(0), s.numel()).reshape(s.shape)
        monkeypatch.setattr(TaxoExpan, "match", match)
    else:
        orig = TaxoExpan.encode

        def encode(self, params, feats, ngp, nsib, **kw):
            hg = orig(self, params, feats, ngp, nsib, **kw)
            return hg + torch.nn.functional.one_hot(
                torch.tensor(0), hg.shape[0])[:, None] * 0.5
        monkeypatch.setattr(TaxoExpan, "encode", encode)
    assert not _run(tiny(name))["correct"]


@pytest.mark.parametrize("name", ["pgat_mag.serve_refresh",
                                  "pgat_mag.serve_cached"])
def test_answer_altered(tiny, monkeypatch, name):
    """Every request's first answer replaced by the last candidate."""
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    orig = TaxonomyRanker.predict_parents

    def predict(self, *a, **kw):
        out = orig(self, *a, **kw)
        if out:
            out[0] = [self.candidates[-1]] + out[0][1:]
        return out
    monkeypatch.setattr(TaxonomyRanker, "predict_parents", predict)
    assert not _run(tiny(name))["correct"]


def _write_into(old, new):
    """`new`'s values written into `old`'s tensors; `old` returned."""
    if isinstance(old, dict):
        return {k: _write_into(old[k], new[k]) for k in new}
    if isinstance(old, list):
        return [_write_into(o, n) for o, n in zip(old, new)]
    if isinstance(old, torch.Tensor):
        return old.copy_(new)
    return new


def test_an_in_place_optimizer_is_judged_on_its_first_steps(tiny,
                                                             monkeypatch):
    """A sound optimizer that updates the params and moments in place (a
    fused one) reads correct: the check keeps copies of the state the
    first steps left, not the live tensors the window goes on changing."""
    from taxoexpan_torch.training.optim import Optimizer
    real = Optimizer.update

    def in_place(self, grads, state, params):
        new_p, new_s = real(self, grads, state, params)
        return (_write_into(params, new_p),
                {k: (_write_into(state[k], v) if k in ("mu", "nu", "nu_max")
                     else v) for k, v in new_s.items()})
    monkeypatch.setattr(Optimizer, "update", in_place)
    res = _run(tiny("pgat_mag.train"))
    assert res["attempted"] > 5
    assert res["correct"], res["checks"]
