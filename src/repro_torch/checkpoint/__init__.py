"""Checkpoints of the port (``repro_torch.checkpoint.checkpoint``), in
the JAX package's on-disk format."""
