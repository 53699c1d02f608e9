"""Max-flow serving on the card (port of the max-flow half of the JAX
package's ``repro.serving``): ``MaxflowService`` — shape-bucketed
microbatching over the batched solver core with result caching,
warm-started re-solves, pooled phase-2 corrections, streaming sessions,
a measured per-bucket mode policy and a degradation ladder.  See
``repro_torch.serving.maxflow_service``."""
from repro_torch.serving.maxflow_service import (MaxflowResult,  # noqa: F401
                                                 MaxflowService,
                                                 ServiceConfig)
from repro_torch.serving.policy import (BucketModePolicy,  # noqa: F401
                                        candidate_modes)

__all__ = ["BucketModePolicy", "MaxflowResult", "MaxflowService",
           "ServiceConfig", "candidate_modes"]
