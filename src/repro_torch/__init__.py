"""PyTorch/CUDA port of the WBPR max-flow solver.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  The single-instance
solve (``repro_torch.api.Solver``) runs on the CUDA card by default, with
hand-written CUDA kernels (``repro_torch/kernels/csrc``) for the
min-height neighbour search and the BCSR reverse-arc search; ``"cpu"``
runs each kernel's plain PyTorch version.
"""
