"""Deterministic synthetic token pipeline — shardable and checkpointable
(a copy of the JAX package's ``repro.data.pipeline``; numpy only, the same
batches for the same ``(seed, step, host_index)``).

Real deployments plug a file-backed loader behind the same interface; the
contract that matters for fault tolerance is that ``state`` fully determines
the next batch (restoring a checkpointed state replays the exact stream),
and that per-host slicing is a pure function of (state, host_index).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineState:
    step: int
    seed: int

    def to_dict(self):
        return {"step": self.step, "seed": self.seed}

    @staticmethod
    def from_dict(d):
        return PipelineState(step=int(d["step"]), seed=int(d["seed"]))


class TokenPipeline:
    """Zipf-ish synthetic LM batches: batch["tokens"/"labels"] (B, S)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 ext_embed_len: int = 0, d_model: int = 0,
                 num_hosts: int = 1, host_index: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.ext_embed_len, self.d_model = ext_embed_len, d_model
        if batch % num_hosts:
            raise ValueError(f"batch {batch} does not split over "
                             f"{num_hosts} hosts")
        self.num_hosts, self.host_index = num_hosts, host_index
        self.state = PipelineState(step=0, seed=seed)

    def _host_rng(self, state: PipelineState):
        # per-(step, host) stream: elastic re-sharding keeps determinism
        return np.random.default_rng(
            (state.seed, state.step, self.host_index))

    def next(self):
        rng = self._host_rng(self.state)
        b = self.batch // self.num_hosts
        # zipf-flavoured ids: realistic token-frequency skew
        raw = rng.zipf(1.3, size=(b, self.seq + 1))
        toks = (raw % self.vocab).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.ext_embed_len:
            batch["ext_embed"] = rng.standard_normal(
                (b, self.ext_embed_len, self.d_model)).astype(np.float32)
        self.state = dataclasses.replace(self.state, step=self.state.step + 1)
        return batch

    # -- checkpoint interface -------------------------------------------
    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        self.state = PipelineState.from_dict(d)
