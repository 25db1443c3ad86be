"""Observability layer: span tracing, streaming metrics, tail diagnosis.

Three pieces, all off by default (the standing invariant: with tracing and
metrics disabled, every backend's rankings and device-clock bills are
bitwise-identical to a build without this package on the path):

* ``repro_torch.obs.trace`` — a dual-clock (wall + simulated device) ``Tracer``
  whose spans are stitched into one tree per query and exported as
  Chrome/Perfetto trace-event JSON.
* ``repro_torch.obs.metrics`` — constant-memory counters/gauges/log-bucketed
  streaming histograms plus a ``MetricsRegistry`` with Prometheus-style
  text exposition.
* ``repro_torch.obs.analyze`` — ingests a trace and attributes each SLO
  violation to its dominant stage (queueing vs critical I/O vs rerank vs
  retry/repair vs hedge-loss).
"""
from repro_torch.obs.analyze import analyze_trace
from repro_torch.obs.metrics import (Counter, Gauge, MetricsRegistry,
                               StreamingHistogram)
from repro_torch.obs.trace import Span, Tracer

__all__ = ["Counter", "Gauge", "MetricsRegistry", "StreamingHistogram",
           "Span", "Tracer", "analyze_trace"]
