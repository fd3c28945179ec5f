"""TaxoExpan in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `taxoexpan_tpu` (JAX/Pallas). It imports torch and numpy, never
JAX or the JAX package. Ported so far: the serving path of the
`configs/config.mag.json` model (PGAT encode with two hand-written CUDA
kernels, WMR readout, BIM all-pairs ranking) behind the
`python -m taxoexpan_torch.test_fast` and `python -m taxoexpan_torch.infer`
entry points. Entry points run on CUDA unless the caller asks for the CPU.
"""
