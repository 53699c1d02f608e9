"""Training and serving steps (port of the JAX package's
``repro.training``): so far the serving steps of ``train_step.py``."""
