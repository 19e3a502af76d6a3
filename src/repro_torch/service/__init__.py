"""repro_torch.service — the persistent query service (resident worker pool,
shard catalog, concurrent multi-tenant scheduling).

The one-shot distributed runtime (:mod:`repro_torch.dist`) pays a rendezvous
and a full shard SETUP per query. This package keeps the pool *resident*:

* :class:`~repro_torch.service.service.QueryService` — the long-lived driver;
* :class:`~repro_torch.service.catalog.ShardCatalog` — which rank holds which
  persisted shard (repeat queries scan in place, zero re-ship);
* :class:`~repro_torch.service.scheduler.AdmissionScheduler` — K client
  sessions interleave under a per-worker memory budget with a bounded
  queue, timeouts, and named-run accounting;
* :mod:`~repro_torch.service.resident` — the worker-side resident loop that
  multiplexes many queries over one connection.

Attach a client with ``Session(backend="service", service=svc)`` or
``Session.connect(svc)``.
"""
from repro_torch.service.catalog import CatalogEntry, ShardCatalog, StubSet
from repro_torch.service.scheduler import (AdmissionScheduler, FootprintModel,
                                     QueryRejected, QueryTimeout, RunRecord)
from repro_torch.service.service import QueryService, ServiceExecutor

__all__ = ["AdmissionScheduler", "CatalogEntry", "FootprintModel",
           "QueryRejected", "QueryService", "QueryTimeout", "RunRecord",
           "ServiceExecutor", "ShardCatalog", "StubSet"]
