"""The shard catalog: which worker rank holds which persisted shard.

PlinyCompute's catalog is what makes its runtime *resident*: a query over
a persisted set does not re-ship data — the workers that already hold the
shards scan them in place. This module is that registry for the
:class:`~repro_torch.service.service.QueryService` pool.

Two kinds of entry:

* **holdings** — ``(rank, set name) -> version``: the pool worker at
  ``rank`` retains that set's shard (its partition under the current
  placement) at that version. The service consults this when building a
  query's SETUP entries: a current holding becomes a ``("held", version)``
  manifest reference (a catalog *hit* — zero page bytes on the wire), a
  stale or missing one ships pages and registers the new holding.
* **materialized sets** — sets created worker-side by ``write()``: the
  pages exist *only* on the workers (the driver holds a row-count/dtype
  stub for planning). The catalog carries their metadata — dtype,
  per-rank row counts — because no driver-side :class:`PagedSet` does.
  Losing a rank that held rows of a materialized set loses data: the set
  is marked **lost** and queries over it fail cleanly (a driver-backed
  set just re-ships the dead rank's partition from the driver store).

Gauges/counters: ``catalog.shards.total`` tracks live holdings,
``catalog.hits.total`` counts held-reference SETUP entries.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.obs.metrics import METRICS
from repro_torch.objectmodel.store import PagedSet

__all__ = ["CatalogEntry", "ShardCatalog", "StubSet"]


class StubSet(PagedSet):
    """A driver-side stand-in for a worker-materialized set: carries the
    dtype and row count the planner needs (cardinality × itemsize
    estimates, schema inference) but no pages — the data lives in the
    pool workers' resident stores. Scanning it driver-side yields nothing
    (``pages``/``counts`` stay empty), which is exactly right: placement
    for materialized sets comes from the catalog, never from here."""

    def __init__(self, name: str, dtype: np.dtype, rows: int,
                 page_size: int):
        super().__init__(name, dtype, page_size)
        self._rows = int(rows)

    @property
    def num_records(self) -> int:  # type: ignore[override]
        return self._rows


class CatalogEntry:
    """Metadata for one worker-materialized set."""

    def __init__(self, name: str, version: int, dtype: np.dtype,
                 per_rank_rows: Dict[int, int]):
        self.name = name
        self.version = version
        self.dtype = np.dtype(dtype)
        self.per_rank_rows = dict(per_rank_rows)
        self.lost = False

    @property
    def total_rows(self) -> int:
        return sum(self.per_rank_rows.values())


class ShardCatalog:
    """Thread-safe registry of pool holdings + materialized-set metadata.
    All mutation happens under one lock; the service additionally holds
    its submit lock across the read-entries/enqueue-QUERY window so
    holdings can never be observed out of order with the frames that
    created them."""

    def __init__(self):
        self._lock = threading.RLock()
        self._holdings: Dict[Tuple[int, str], int] = {}
        self._materialized: Dict[str, CatalogEntry] = {}
        self.hits = 0

    # ---------------------------------------------------------- holdings
    def lookup(self, rank: int, name: str) -> Optional[int]:
        """The version rank holds for ``name`` (None if not held)."""
        with self._lock:
            return self._holdings.get((rank, name))

    def register(self, rank: int, name: str, version: int) -> None:
        with self._lock:
            self._holdings[(rank, name)] = version
            METRICS.gauge("catalog.shards.total", len(self._holdings))

    def hit(self, n: int = 1) -> None:
        """Record ``n`` held-reference SETUP entries (catalog hits)."""
        with self._lock:
            self.hits += n
            METRICS.inc("catalog.hits.total", n)

    def holders(self, name: str) -> Dict[int, int]:
        """rank -> held version for one set."""
        with self._lock:
            return {r: v for (r, n), v in self._holdings.items()
                    if n == name}

    # ------------------------------------------------------ materialized
    def register_materialized(self, name: str, version: int,
                              dtype: np.dtype,
                              per_rank_rows: Dict[int, int]) -> None:
        with self._lock:
            self._materialized[name] = CatalogEntry(name, version, dtype,
                                                    per_rank_rows)

    def materialized(self, name: str) -> Optional[CatalogEntry]:
        with self._lock:
            return self._materialized.get(name)

    # ----------------------------------------------------------- failure
    def evict_rank(self, rank: int) -> List[str]:
        """A pool worker died: drop every holding at that rank, and mark
        any materialized set that had rows there as lost (those pages
        existed nowhere else). Returns the names of newly lost sets —
        driver-backed sets just go cold for that rank and re-ship."""
        lost: List[str] = []
        with self._lock:
            for key in [k for k in self._holdings if k[0] == rank]:
                del self._holdings[key]
            METRICS.gauge("catalog.shards.total", len(self._holdings))
            for entry in self._materialized.values():
                if entry.per_rank_rows.get(rank, 0) > 0 and not entry.lost:
                    entry.lost = True
                    lost.append(entry.name)
        return lost

    def evict_set(self, name: str) -> None:
        with self._lock:
            for key in [k for k in self._holdings if k[1] == name]:
                del self._holdings[key]
            METRICS.gauge("catalog.shards.total", len(self._holdings))
            self._materialized.pop(name, None)

    # ------------------------------------------------------------- stats
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            sets: Set[str] = {n for _, n in self._holdings}
            return {"holdings": len(self._holdings),
                    "sets": sorted(sets),
                    "materialized": sorted(self._materialized),
                    "hits": self.hits}
