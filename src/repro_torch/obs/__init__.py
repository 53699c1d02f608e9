"""Telemetry of the port: the process-global metrics registry (a copy of
the JAX package's ``repro.obs.metrics``) and the device-side solver
counters (``repro_torch.obs.solvercounters``, the counter half of the JAX
package's ``repro.obs``)."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry, counter,
                                     gauge, histogram)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram",
]
