"""Serving on the card (port of the JAX package's ``repro.serving``).

Max-flow serving (the WBPR paper's workload): ``MaxflowService`` —
shape-bucketed microbatching over the batched solver core with result
caching, warm-started re-solves, pooled phase-2 corrections, streaming
sessions, a measured per-bucket mode policy and a degradation ladder.
See ``repro_torch.serving.maxflow_service``.

LM serving: the prefill/decode steps and the cache constructors.  The
cache machinery (contiguous KV, SWA ring buffers, and the specs of the
Mamba/RWKV states and cross-attention KV) lives with the model definition
in ``repro_torch.models.transformer``; this package re-exports that
surface too, ``cache_shape_tree`` (the cache on a mesh) with it.
"""
from repro_torch.models.transformer import (cache_shape_tree,  # noqa: F401
                                            cache_specs, cache_zeros)
from repro_torch.serving.maxflow_service import (MaxflowResult,  # noqa: F401
                                                 MaxflowService,
                                                 ServiceConfig)
from repro_torch.serving.policy import (BucketModePolicy,  # noqa: F401
                                        candidate_modes)
from repro_torch.training.train_step import (make_decode_step,  # noqa: F401
                                             make_prefill_step)

__all__ = ["BucketModePolicy", "MaxflowResult", "MaxflowService",
           "ServiceConfig", "cache_shape_tree", "cache_specs", "cache_zeros",
           "candidate_modes",
           "make_decode_step", "make_prefill_step"]
