"""Telemetry of the port: the process-global metrics registry and the
span tracer (copies of the JAX package's ``repro.obs.metrics`` and
``repro.obs.trace``), the device-side solver counters
(``repro_torch.obs.solvercounters``, the counter half of the JAX
package's ``repro.obs``) and ``to_jsonable``, the one converter of every
``stats()`` tree to JSON."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry, counter,
                                     gauge, histogram)
from repro_torch.obs.trace import TRACER, Tracer, span, traced  # noqa: F401

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram",
    "TRACER", "Tracer", "span", "traced",
    "to_jsonable",
]


def to_jsonable(obj):
    """Recursively convert a stats tree to pure-JSON Python values.

    numpy scalars become ints/floats, numpy arrays become lists, tuples
    and sets become lists, dataclasses become dicts, non-string dict
    keys are stringified.  ``json.dumps(to_jsonable(x))`` must never
    raise for any ``stats()`` tree in the repo — that is the contract
    the telemetry snapshot (and its tests) enforce.
    """
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return [to_jsonable(v) for v in obj.tolist()] \
            if obj.dtype == object else obj.tolist()
    if isinstance(obj, dict):
        return {_key(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if hasattr(obj, "tolist"):  # torch.Tensor (on any device) and friends
        return to_jsonable(obj.tolist())
    return repr(obj)  # last resort: loud but serializable


def _key(k) -> str:
    if isinstance(k, str):
        return k
    if isinstance(k, (bool, int, float)) or k is None:
        return str(k)
    label = getattr(k, "label", None)  # BucketKey and friends
    if isinstance(label, str):
        return label
    return str(to_jsonable(k))
