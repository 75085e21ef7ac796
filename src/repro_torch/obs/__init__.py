"""Serving-side observability: metrics registry + request-span tracing.

The runtime mirror of the hardware path's ``core.trace``/``core.profiler``
stack: one canonical schema per surface, zero-cost-when-off hooks
(every instrumentation site in the engine is guarded by
``if metrics is not None`` / ``if spans is not None``), and exporters whose
output is deterministic under a fixed seed (``stable=True`` normalizes the
wall-clock fields, everything else is already byte-stable).

Modules
-------
``metrics``   process-local counters/gauges/fixed-bucket histograms with
              Prometheus-text and JSON exporters
``spans``     per-request span events (enqueue -> admit -> prefill ->
              decode -> complete) + per-engine-step events, JSONL
``traffic``   seeded synthetic heavy-traffic traces (Poisson arrivals,
              mixed prompt/gen lengths) for the load harness
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .spans import SpanEvent, SpanTracer  # noqa: F401
from .traffic import TraceRequest, synth_trace  # noqa: F401
