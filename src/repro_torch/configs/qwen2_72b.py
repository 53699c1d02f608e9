"""Qwen2-72B [arXiv:2407.10671]: dense GQA decoder, QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064, qkv_bias=True,
    block_pattern=("attn+mlp",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-72b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
