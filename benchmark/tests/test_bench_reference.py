"""The plain reference (`benchmark/reference/`) against the port's plain
CPU path at a tiny size: the eval encode, the train forward with dropout
and its gradients, and AMSGrad's update. The comparison lives here and not
in the reference, which imports nothing of the program."""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.frozen import dropout_hash as dh
from benchmark.reference import model as ref
from benchmark.weights import make_params, same_layout


def _arch(kind: str) -> dict:
    arch = copy.deepcopy(spec.resolve(f"{kind}_mag.serve_refresh"
                                      ).config["arch"])
    arch["args"].update(in_dim=12, hidden_dim=6, out_dim=5, pos_dim=3)
    return arch


def _egonets(b=9, p=2, s=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    ngp = torch.randint(0, p + 1, (b,), generator=g, dtype=torch.int32)
    nsib = torch.randint(0, s + 1, (b,), generator=g, dtype=torch.int32)
    return ngp, nsib


@pytest.mark.parametrize("kind", ["pgat", "pgcn"])
def test_layout_matches_the_programs_init(kind):
    from taxoexpan_torch import builders
    arch = _arch(kind)
    model = builders.build_model(arch, max_parents=2, expand_factor=5)
    theirs = model.init(torch.Generator().manual_seed(0))
    assert same_layout(make_params(arch, 1, "cpu"), theirs) == []


@pytest.mark.parametrize("kind", ["pgat", "pgcn"])
@pytest.mark.parametrize("train", [False, True])
def test_encode_and_grads_match_the_port(kind, train):
    from taxoexpan_torch import builders
    arch = _arch(kind)
    p, s = 2, 5
    n = p + 1 + s
    model = builders.build_model(arch, max_parents=p, expand_factor=s)
    params = make_params(arch, 3, "cpu")
    ngp, nsib = _egonets(p=p, s=s)
    _, _, valid = ref.slot_masks(ngp, nsib, p, n)
    feats = torch.randn(9, n, 12, generator=torch.Generator().manual_seed(5))
    feats = feats * valid[..., None].float()
    seeds = dh.layer_seeds(77, 4, 2) if train else None

    def leaves_of(tree):
        flat = ref.flatten(tree)
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in flat.items()}

    ours_l = leaves_of(params)
    ours = ref.encode(ref.unflatten(ours_l, params), arch, feats, ngp, nsib,
                      p, seeds=seeds)
    theirs_l = leaves_of(params)
    gen = None
    if train:
        from taxoexpan_torch.training.trainer import step_generator
        gen = step_generator(77, 4)
    with torch.enable_grad():
        theirs = model.encode(ref.unflatten(theirs_l, params), feats, ngp,
                              nsib, gen=gen, train=train)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-6)
    w = torch.randn_like(ours)
    g_ours = torch.autograd.grad((ours * w).sum(), list(ours_l.values()),
                                 allow_unused=True)
    g_theirs = torch.autograd.grad((theirs * w).sum(),
                                   list(theirs_l.values()),
                                   allow_unused=True)
    for k, a, b in zip(ours_l, g_ours, g_theirs):
        a = torch.zeros_like(ours_l[k]) if a is None else a
        b = torch.zeros_like(ours_l[k]) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=k)


def test_amsgrad_matches_the_port():
    from taxoexpan_torch.training.optim import Optimizer
    opt = Optimizer("Adam", lr=1e-3, amsgrad=True)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(5,
                                                                   generator=g)}
    st_t = opt.init(params)
    st_o = {"count": 0, **{m: {k: torch.zeros_like(v) for k, v in
                               params.items()} for m in ("mu", "nu",
                                                         "nu_max")}}
    p_t, p_o = dict(params), dict(params)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in
                 params.items()}
        p_t, st_t = opt.update(grads, st_t, p_t)
        p_o, st_o = ref.amsgrad_step(p_o, grads, st_o, 1e-3)
    for k in params:
        assert torch.equal(p_t[k], p_o[k])


def test_info_nce_and_bilinear_match_the_port():
    from taxoexpan_torch.losses import info_nce_loss
    g = torch.Generator().manual_seed(1)
    scores = torch.randn(4, 6, generator=g)
    mask = torch.rand(4, 6, generator=g) > 0.3
    mask[:, 0] = True
    mask[3] = False
    labels = torch.zeros(4, 6)
    labels[:, 0] = 1
    torch.testing.assert_close(ref.info_nce(scores, mask),
                               info_nce_loss(scores, labels, mask))
    from taxoexpan_torch.models.matching import Matcher
    m = Matcher("BIM", 5, 7, 3)
    params = {"match": m.init(g)}
    hg, qf = torch.randn(6, 5, generator=g), torch.randn(6, 7, generator=g)
    torch.testing.assert_close(ref.bilinear(params, hg, qf),
                               m.apply(params["match"], hg, qf))
    torch.testing.assert_close(ref.all_pairs(params, hg, qf[:2]),
                               m.apply_all(params["match"], hg, qf[:2]))


def test_configs_are_the_published_file_but_what_reduced_lists():
    bench = spec.load_benchmark()
    published = json.loads((spec.ROOT / "configs" / "config.mag.json"
                            ).read_text())
    for c in bench["configs"]:
        mine = json.loads((spec.ROOT / c["file"]).read_text())
        changed = {k for k in set(mine) | set(published)
                   if mine.get(k) != published.get(k)}
        assert changed <= set(c["reduced"]) | {"name"}, (c["name"], changed)
        for k in ("in_dim", "hidden_dim", "out_dim", "pos_dim", "heads",
                  "num_layers"):
            assert mine["arch"]["args"][k] == published["arch"]["args"][k]


def test_reference_data_builds_the_samplers_egonets():
    """The reference's own egonets equal the program's test-mode anchor
    egonets on a small generated taxonomy."""
    from benchmark.frozen import synthetic
    from benchmark.reference.data import WorkingGraph
    from benchmark.workloads.common import program_taxonomy
    from taxoexpan_torch import builders
    tax = synthetic.synthetic_taxonomy_v2(num_nodes=600, dim=8,
                                          max_children=9, seed=4)
    sampler = builders.build_sampler(
        program_taxonomy(tax), {"sampling_mode": 0, "expand_factor": 12},
        "test")
    graph = WorkingGraph(tax, "test")
    assert graph.max_parents == sampler.max_parents
    ego = sampler.anchor_ego_batch(graph.candidates)
    ids, ngp, nsib = graph.ego_arrays(graph.candidates, 12)
    assert np.array_equal(ego.ngp, ngp) and np.array_equal(ego.nsib, nsib)
    for r in range(len(ids)):
        assert sorted(ids[r].tolist()) == sorted(ego.node_ids[r].tolist())
