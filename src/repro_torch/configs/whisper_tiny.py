"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder audio backbone.

The conv frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings (B, enc_len, d_model).  4 encoder + 4 decoder layers, MHA."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536, vocab=51865,
    block_pattern=("attn_cross+mlp",),
    is_encoder_decoder=True, n_enc_layers=4, enc_len=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-tiny-smoke", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
    enc_len=32)
