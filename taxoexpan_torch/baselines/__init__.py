"""Standalone baselines of the port (the JAX package's `baselines/`,
capability parity with the reference's), each `python -m
taxoexpan_torch.baselines.<name> --data <pickle>`:

- simple_parent: rank candidates by query<->candidate cosine distance
- simple_structure: parent distance + aggregated sibling distance
- simple_mlp: MLP / DeepSetMLP / DeepAPGMLP edge scorers (PyTorch; on CUDA
  unless `-d cpu`)
- xgb_features: NegativeQueue + 39 hand-crafted distance features
  (+ gradient-boosting trainer gated on xgboost availability)
"""
