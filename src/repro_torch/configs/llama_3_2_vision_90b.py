"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-*-Vision]: text decoder with
interleaved image cross-attention layers (100L = 20 x (4 self + 1 cross)).

The vision tower is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (B, img_tokens, d_model)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab=128256,
    block_pattern=("attn+mlp", "attn+mlp", "attn+mlp", "attn+mlp",
                   "cross+mlp"),
    img_tokens=1600,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-3.2-vision-90b-smoke", n_layers=10, d_model=64,
    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256, img_tokens=16)
