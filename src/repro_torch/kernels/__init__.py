"""Hand-written CUDA kernels (``csrc/*.cu``), their wrappers and their
plain PyTorch versions."""
