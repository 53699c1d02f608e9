"""Qwen3-4B [hf:Qwen/Qwen3 family]: dense GQA with qk-norm, no QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True,
    block_pattern=("attn+mlp",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
