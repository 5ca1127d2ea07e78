"""Observability: span tracer + metrics registry (a copy of the JAX
package's ``obs/``).

``repro_torch.obs.trace`` is the span tracer with Chrome-trace/Perfetto
export; ``repro_torch.obs.metrics`` is the counters/gauges/histograms
registry and the incremental ``IntervalUnion`` that ``controller.stats``
aggregates on.  Run ``python -m repro_torch.obs trace.json`` for a
per-phase summary of an exported trace.

Everything here is host-side Python: no kernel or model module imports
it, so enabling tracing never changes what runs on the device.
"""
from repro_torch.obs import trace  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, IntervalUnion, MetricsRegistry,
    interval_overlap, registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer, disable, enable, enabled, epoch, export, instant, now, span,
    to_chrome, tracer, validate_chrome,
)
