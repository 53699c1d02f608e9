"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay time-mix + channel-mix."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=7168, vocab=65536,
    block_pattern=("rwkv",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="rwkv6-1.6b-smoke", n_layers=2, d_model=64, d_ff=128,
    vocab=256)
