"""PyTorch/CUDA port of the WBPR max-flow solver.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  The solve
(``repro_torch.api.Solver``, one instance or a padded batch) runs on the
CUDA card by default, with hand-written CUDA kernels
(``repro_torch/kernels/csrc``) for the min-height neighbour search, the
BCSR reverse-arc search and the fused K-cycle discharge; ``"cpu"`` runs
each kernel's plain PyTorch version.
"""
