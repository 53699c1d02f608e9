"""Model/config schema shared by all assigned architectures (port of the
JAX package's ``repro.configs.base``: every field, in the same order, with
the same defaults; ``dtype`` is a ``torch.dtype``).

A model is a stack of ``n_layers`` layers organised as ``n_blocks`` repeats
of a ``block_pattern`` (weights stacked ``(n_blocks, ...)``; the JAX
package scans the repeat, the port loops over it).  Pattern entries name
the (mixer, ffn) pair of one layer:

    "attn+mlp"   GQA attention + SwiGLU MLP          (qwen family, llama)
    "attn+moe"   GQA attention + top-k MoE           (mixtral, grok)
    "mamba+mlp"  Mamba selective SSM + MLP           (jamba)
    "mamba+moe"  Mamba + MoE                         (jamba)
    "rwkv"       RWKV6 time-mix + channel-mix        (rwkv6)
    "cross+mlp"  cross-attention (image kv) + MLP    (llama-3.2-vision)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm | graph
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn+mlp",)

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 1e6

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_parallel: bool = False
    router_aux_coef: float = 0.01

    # SSM (mamba / rwkv6)
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500  # stub conv frontend output length for smoke tests

    # vlm
    img_tokens: int = 0  # stub patch-embedding count (>0 enables cross-attn)

    # execution
    scan_layers: bool = True
    remat: bool = True
    # perf knobs of the multi-device path (no-ops on one device)
    shard_activations: bool = False  # pin activations batch-sharded
    attn_seq_shard: bool = False     # context parallelism over 'model'
    pin_grads: bool = False          # grads -> param shardings (RS not AR)
    bf16_reduce: bool = False        # TP partial-sum combines in bf16
    dtype: torch.dtype = torch.bfloat16
    optimizer: str = "adamw"  # adamw | adafactor
    attn_chunk: int = 1024  # blockwise-attention kv chunk
    ssm_chunk: int = 64

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, self.block_pattern)

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attn_out_dim(self) -> int:
        return self.n_heads * self.d_head

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model FLOPs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d  # tied embedding
        for kind in self.block_pattern:
            mixer, _, ffn = kind.partition("+")
            c = 0
            if mixer == "attn" or mixer == "cross":
                c += d * self.n_heads * self.d_head  # q
                c += 2 * d * self.n_kv_heads * self.d_head  # kv
                c += self.n_heads * self.d_head * d  # o
            elif mixer == "mamba":
                di, n = self.d_inner, self.d_state
                c += d * 2 * di + di * self.d_conv + di * (2 * n + 1) \
                    + di // 16 * di + di * d  # in/conv/BCdt/dt_proj/out
            elif mixer == "rwkv":
                dd = d
                c += 5 * d * dd + d * 64 * 2 + d * self.d_ff + self.d_ff * d \
                    + d * d  # rkvgw + decay lora + channel mix
            if ffn == "mlp":
                c += 3 * d * f
            elif ffn == "moe":
                c += self.n_experts * 3 * d * f + d * self.n_experts
            total += c * self.n_blocks
        if self.is_encoder_decoder:
            enc = self.n_enc_layers * (
                d * self.n_heads * self.d_head * 2
                + 2 * d * self.n_kv_heads * self.d_head + 3 * d * f)
            total += enc
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count()
        moe_layers = sum(k.endswith("moe") for k in self.block_pattern) \
            * self.n_blocks
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * f
        return dense - inactive
