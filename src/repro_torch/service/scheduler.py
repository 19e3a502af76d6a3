"""Admission control for the shared query pool.

K client sessions submit concurrently; the pool has finite worker memory.
Each query arrives with a *predicted* per-worker footprint (planlint's
inferred schemas × the planner's cardinality estimates — see
:func:`repro_torch.analysis.footprint.estimate_plan_footprint`), corrected by a
feedback model fed from observed execution (``query.wall_ms`` /
``shuffle.bytes``-style signals ride back in the workers' stats frames).
The scheduler admits a query when it fits:

* at most ``max_concurrent`` queries run at once;
* the sum of admitted footprints stays within ``worker_budget_bytes``
  (None = unlimited);
* waiting queries form a bounded FIFO (``max_queue``) — overflow is
  rejected immediately (:class:`QueryRejected`), as is a query whose
  footprint can never fit the budget;
* a waiter that outlives its timeout raises :class:`QueryTimeout`.

Admission is FIFO-fair: only the queue head may take the next slot, so a
big query cannot be starved by a stream of small ones slipping past it.

Counters: ``service.queries.admitted.total`` / ``rejected.total`` /
``queued.total`` (plus ``timeout.total``), per the observability contract.
Named-run accounting keeps a bounded history of :class:`RunRecord`s so
``QueryService.accounting()`` can answer "what has tenant X cost".
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.metrics import METRICS

__all__ = ["AdmissionScheduler", "FootprintModel", "QueryRejected",
           "QueryTimeout", "RunRecord"]


class QueryRejected(RuntimeError):
    """Admission refused outright: the footprint can never fit the
    per-worker budget, or the wait queue is full."""


class QueryTimeout(RuntimeError):
    """The query did not finish (or get admitted) within its timeout."""


class RunRecord:
    """One query's accounting line."""

    __slots__ = ("qid", "name", "predicted_bytes", "observed_bytes",
                 "wall_ms", "status")

    def __init__(self, qid: str, name: str, predicted_bytes: float):
        self.qid = qid
        self.name = name
        self.predicted_bytes = predicted_bytes
        self.observed_bytes: Optional[float] = None
        self.wall_ms: Optional[float] = None
        self.status = "running"


class FootprintModel:
    """EWMA correction of predicted footprints from observed execution.

    Keyed by the query's plan signature: the first run of a shape uses the
    static estimate verbatim; later runs scale it by the smoothed
    observed/predicted ratio, so a plan whose estimate is systematically
    off (selective filters, fat flattens) converges toward what it really
    costs instead of over- or under-admitting forever."""

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self._ratio: Dict[object, float] = {}
        self._lock = threading.Lock()

    def corrected(self, key: object, predicted: float) -> float:
        with self._lock:
            return predicted * self._ratio.get(key, 1.0)

    def observe(self, key: object, predicted: float,
                observed: float) -> None:
        if predicted <= 0 or observed <= 0:
            return
        ratio = observed / predicted
        with self._lock:
            old = self._ratio.get(key)
            self._ratio[key] = (ratio if old is None
                                else old + self.alpha * (ratio - old))


class AdmissionScheduler:
    def __init__(self, worker_budget_bytes: Optional[int] = None,
                 max_concurrent: int = 4, max_queue: int = 16,
                 default_timeout: Optional[float] = None,
                 history: int = 256):
        self.worker_budget_bytes = worker_budget_bytes
        self.max_concurrent = max_concurrent
        self.max_queue = max_queue
        self.default_timeout = default_timeout
        self._cv = threading.Condition()
        self._running: Dict[str, float] = {}   # qid -> admitted footprint
        self._waiters: Deque[str] = deque()
        self.runs: Deque[RunRecord] = deque(maxlen=history)
        self._records: Dict[str, RunRecord] = {}

    # ---------------------------------------------------------- admission
    def _fits(self, footprint: float) -> bool:
        if len(self._running) >= self.max_concurrent:
            return False
        if self.worker_budget_bytes is None:
            return True
        return (sum(self._running.values()) + footprint
                <= self.worker_budget_bytes)

    def admit(self, qid: str, footprint: float, name: str = "",
              timeout: Optional[float] = None) -> RunRecord:
        """Block until the query fits, then reserve its footprint.
        Raises :class:`QueryRejected` (never fits / queue full) or
        :class:`QueryTimeout` (wait exceeded). Returns the accounting
        record (also kept in ``runs``)."""
        timeout = self.default_timeout if timeout is None else timeout
        if (self.worker_budget_bytes is not None
                and footprint > self.worker_budget_bytes):
            METRICS.inc("service.queries.rejected.total")
            raise QueryRejected(
                f"query {qid} ({name or 'unnamed'}): predicted per-worker "
                f"footprint {footprint:,.0f} bytes exceeds the pool's "
                f"worker budget {self.worker_budget_bytes:,} bytes — it "
                "can never be admitted; shrink the query or raise "
                "worker_budget_bytes")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            if not self._fits(footprint) and (len(self._waiters)
                                              >= self.max_queue):
                METRICS.inc("service.queries.rejected.total")
                raise QueryRejected(
                    f"query {qid}: admission queue is full "
                    f"({self.max_queue} waiting) — back off and resubmit")
            queued = False
            if not (self._fits(footprint) and not self._waiters):
                self._waiters.append(qid)
                queued = True
                METRICS.inc("service.queries.queued.total")
            try:
                # FIFO fairness: only the queue head takes the next slot
                while not ((not queued or self._waiters[0] == qid)
                           and self._fits(footprint)):
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        METRICS.inc("service.queries.timeout.total")
                        raise QueryTimeout(
                            f"query {qid}: not admitted within "
                            f"{timeout:.1f}s (pool saturated)")
                    self._cv.wait(remaining)
            finally:
                if queued:
                    self._waiters.remove(qid)
                    self._cv.notify_all()
            self._running[qid] = footprint
            METRICS.inc("service.queries.admitted.total")
            rec = RunRecord(qid, name, footprint)
            self.runs.append(rec)
            self._records[qid] = rec
            return rec

    def release(self, qid: str, observed_bytes: Optional[float] = None,
                wall_ms: Optional[float] = None,
                status: str = "ok") -> None:
        with self._cv:
            self._running.pop(qid, None)
            rec = self._records.pop(qid, None)
            if rec is not None:
                rec.observed_bytes = observed_bytes
                rec.wall_ms = wall_ms
                rec.status = status
            self._cv.notify_all()

    # ------------------------------------------------------------- stats
    def accounting(self) -> List[Dict[str, object]]:
        """The bounded run history, oldest first, as plain dicts."""
        with self._cv:
            return [{"qid": r.qid, "name": r.name, "status": r.status,
                     "predicted_bytes": r.predicted_bytes,
                     "observed_bytes": r.observed_bytes,
                     "wall_ms": r.wall_ms}
                    for r in self.runs]

    def load(self) -> Dict[str, object]:
        with self._cv:
            return {"running": len(self._running),
                    "queued": len(self._waiters),
                    "reserved_bytes": sum(self._running.values())}
