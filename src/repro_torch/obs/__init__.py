"""Observability: query tracing + process-wide metrics.

Two cooperating pieces:

* :mod:`repro_torch.obs.trace` — a lightweight span recorder (monotonic-clock
  start/end, nested parent ids, typed attributes) threaded through the
  whole execution path, merging driver and per-worker spans into one
  rank-attributed :class:`~repro_torch.obs.trace.QueryTrace` with a
  Chrome/Perfetto ``trace_event`` export;
* :mod:`repro_torch.obs.metrics` — a process-wide :class:`~repro_torch.obs.metrics
  .MetricsRegistry` of named counters/gauges (plan-cache hits, kernel-LRU
  evictions, cumulative shuffle bytes, per-query wall) that benchmarks and
  schedulers poll via ``snapshot()``.

Tracing is zero-cost when off: every instrumentation site talks to a
shared no-op :data:`~repro_torch.obs.trace.NULL` recorder unless the session
was built with ``Session(trace=True)`` (or ``REPRO_TRACE=1``), and the
span structure is deterministic — byte-identity tests run unchanged with
tracing on.
"""
from repro_torch.obs.metrics import METRICS, MetricsRegistry
from repro_torch.obs.render import last_run_lines, render_analyze
from repro_torch.obs.trace import (NULL, NullRecorder, QueryTrace, Span,
                             SpanRecorder, current, op_name, using)

__all__ = ["METRICS", "MetricsRegistry", "NULL", "NullRecorder",
           "QueryTrace", "Span", "SpanRecorder", "current", "op_name",
           "using", "last_run_lines", "render_analyze"]
