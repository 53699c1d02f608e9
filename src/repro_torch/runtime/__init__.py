"""Runtime support of the port: the serving tier's chaos harness
(``repro_torch.runtime.fault``, a copy of the JAX package's
``repro.runtime.fault`` without its training loop)."""
