"""Process-wide metrics registry.

Where :mod:`repro_torch.obs.trace` answers "where did *this* query's time go",
the registry answers "what has this *process* done so far": cumulative
counters (plan-cache hits, kernel-LRU evictions, total shuffle bytes,
exchanges elided, queries run) and last-value gauges, all under one lock
so benchmarks and the future multi-tenant scheduler can ``snapshot()``
from any thread.

Metric names used by the engine:

========================  =====  =============================================
name                      kind   incremented by
========================  =====  =============================================
queries.total             ctr    Session per executed query
query.wall_ms.total       ctr    Session (cumulative query wall)
query.wall_ms.last        gauge  Session (most recent query wall)
plan_cache.hits/.misses   ctr    Session plan cache
plan_cache.evictions      ctr    Session plan cache
kernel_cache.hits/.misses ctr    exprc kernel LRU
kernel_cache.evictions    ctr    exprc kernel LRU
rows.scanned.total        ctr    Session from per-query ExecStats
rows.output.total         ctr    Session from per-query ExecStats
shuffle.bytes.total       ctr    Session from per-query ExecStats
exchanges.elided.total    ctr    Session from per-query ExecStats
========================  =====  =============================================

The persistent query service (``repro_torch.service``) adds:

=============================  =====  ========================================
name                           kind   incremented by
=============================  =====  ========================================
service.queries.total          ctr    QueryService per completed query
service.queries.admitted.total ctr    AdmissionScheduler on admission
service.queries.rejected.total ctr    AdmissionScheduler (never fits /
                                      queue overflow)
service.queries.queued.total   ctr    AdmissionScheduler on enqueue
service.queries.timeout.total  ctr    scheduler + service on timeout
service.setup.bytes.total      ctr    QueryService (shard bytes shipped;
                                      0 for catalog-warm queries)
service.workers.died.total     ctr    QueryService pump on worker death
service.pool.workers           gauge  QueryService (connected ranks)
catalog.shards.total           gauge  ShardCatalog (live rank holdings)
catalog.hits.total             ctr    ShardCatalog per held-reference
                                      SETUP entry (scan-in-place)
=============================  =====  ========================================

The admitted/rejected/queued counters and the catalog gauge/hits are the
observable half of the admission feedback loop: ``explain(analyze=True)``
on a service session appends them as a footer.

Per-query ``ExecStats`` stay per-query (reset at query start); these are
the cumulative totals that used to be unobtainable on a reused Session.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

__all__ = ["MetricsRegistry", "METRICS"]

Number = Union[int, float]


class MetricsRegistry:
    """Thread-safe named counters and gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, Number] = {}

    def inc(self, name: str, value: Number = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: Number) -> None:
        with self._lock:
            self._gauges[name] = value

    def counter(self, name: str) -> Number:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, Number]]:
        """A point-in-time copy: ``{"counters": {...}, "gauges": {...}}``."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


METRICS = MetricsRegistry()
