"""Grok-1 314B [hf:xai-org/grok-1]: MoE 8 experts top-2, GQA.

Adafactor optimizer states (full AdamW fp32 states exceed per-chip HBM at
this scale — DESIGN.md §4)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
    block_pattern=("attn+moe",),
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, n_experts=4)
