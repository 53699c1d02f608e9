"""Mixtral-8x7B [arXiv:2401.04088]: MoE 8 experts top-2, GQA, SWA 4096."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, window=4096,
    n_experts=8, top_k=2,
    block_pattern=("attn+moe",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, n_experts=4, window=32)
