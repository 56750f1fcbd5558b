"""Observability: tracing and metrics (copies of the reference's ``obs``).

  * ``obs.trace`` — host-side spans / instant events / counter tracks
    with Chrome ``trace_event`` export (open in ``ui.perfetto.dev``).
    Disabled by default; ``trace.enable()`` turns a run into a timeline.
  * ``obs.metrics`` — process-wide counters/gauges/streaming histograms.
"""

from repro_torch.obs import trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     default_registry)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "trace",
]
