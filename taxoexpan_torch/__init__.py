"""TaxoExpan in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `taxoexpan_tpu` (JAX/Pallas). It imports torch and numpy, never
JAX or the JAX package. Ported so far, for the `configs/config.mag.json`
model: the serving path (PGAT encode, WMR readout, BIM all-pairs ranking)
behind `python -m taxoexpan_torch.test_fast` and `python -m
taxoexpan_torch.infer`, and the training path (PGAT with dropout, InfoNCE,
AMSGrad, the trainer) behind `python -m taxoexpan_torch.train`, also as
several data-parallel processes with the row-partitioned feature table
(`parallel/`), on hand-written CUDA kernels for the GAT and GCN layers'
forwards and backwards and for the halo gather; the loader's native C++
sampler (`native/`), the dataset tools (`generate_dataset_binary`,
`tools/`) and the baselines (`baselines/`).
Entry points run on CUDA unless the caller asks for the CPU.
"""
