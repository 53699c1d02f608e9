"""Telemetry of the port: the process-global metrics registry and the
span tracer (copies of the JAX package's ``repro.obs.metrics`` and
``repro.obs.trace``) and the device-side solver counters
(``repro_torch.obs.solvercounters``, the counter half of the JAX
package's ``repro.obs``)."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry, counter,
                                     gauge, histogram)
from repro_torch.obs.trace import TRACER, Tracer, span, traced  # noqa: F401

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram",
    "TRACER", "Tracer", "span", "traced",
]
