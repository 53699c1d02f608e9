"""Qwen2.5-14B [hf:Qwen/Qwen2.5 family]: dense GQA, QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=13824, vocab=152064, qkv_bias=True,
    block_pattern=("attn+mlp",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
