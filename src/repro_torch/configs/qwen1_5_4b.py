"""Qwen1.5-4B [hf:Qwen/Qwen1.5 family]: dense MHA (kv == heads), QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_head=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
    block_pattern=("attn+mlp",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen1.5-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256)
