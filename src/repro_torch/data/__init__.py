"""Data of the port: the deterministic token pipeline
(``repro_torch.data.pipeline``, a copy of the JAX package's)."""
