"""Runtime support of the port (copies of the JAX package's
``repro.runtime``): ``fault`` (the serving tier's chaos harness and the
training loop's checkpoint/restart, ``run_loop``) and ``elastic``
(checkpoints moved between placements; one device for now)."""
