"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attention 1:7 interleave,
MoE 16 experts top-2 on every other layer.  72L = 9 x (8-layer block, one
attention layer per block).  Expert-parallel (16e == model axis)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

_BLOCK = ("mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe",
          "mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, expert_parallel=True,
    block_pattern=_BLOCK,
    d_state=16, d_conv=4, ssm_expand=2,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, name="jamba-1.5-large-398b-smoke", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256, n_experts=4,
    expert_parallel=False)
