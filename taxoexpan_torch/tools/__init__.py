"""Dataset and host-side tools of the port, each `python -m
taxoexpan_torch.tools.<name>`: make_synthetic_dataset, preprocess_mag,
preprocess_semeval (the dataset makers of the JAX package's scripts/) and
sampler_bench (the loader backends' batches per second)."""
