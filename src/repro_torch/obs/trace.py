"""Span tracing for the query engine.

A :class:`Span` is one timed region — monotonic-clock start/end
nanoseconds, a per-recorder id, the id of the enclosing span, the worker
rank it was recorded on (``None`` = driver), and a small dict of typed
attributes (rows, bytes, op kind, backend, exchange tag, ...).

:class:`SpanRecorder` collects spans for one query on one rank; the
driver merges its own recorder with the per-rank span lists the workers
ship back in their stats frame into one :class:`QueryTrace`, which
renders three ways: the ``explain(analyze=True)`` per-op table
(:mod:`repro_torch.obs.render`), :meth:`QueryTrace.to_chrome_trace`
(Chrome/Perfetto ``trace_event`` JSON, one lane per rank, exchange spans
flow-linked across ranks), and plain :meth:`QueryTrace.find` queries for
tests.

Zero-cost-when-off contract: call sites hold (or look up via
:func:`current`) a recorder that is the shared :data:`NULL` no-op when
tracing is disabled — ``NULL.span(...)`` returns one preallocated inert
context manager, records nothing, allocates nothing but the call's
kwargs. Sites additionally guard any non-trivial attribute computation
(row counts) behind ``recorder.enabled``.

Determinism contract: span *structure* (names, categories, parentage,
per-plan counts) is a pure function of the physical plan and worker
count — never of timing, memory addresses, or hash seeds — so tests can
assert exact span trees while durations vary.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "SpanRecorder", "NullRecorder", "NULL", "QueryTrace",
           "current", "using", "op_name"]


def op_name(first: int, last: int, kinds) -> str:
    """The canonical span name for the op (or fused op run) covering
    program indices ``first..last`` — one definition shared by the local
    executor and the worker runtime, so the per-op span names of a plan
    are identical across backends (a property the span-shape tests pin)."""
    label = "+".join(kinds)
    prefix = f"op{first}" if first == last else f"op{first}-{last}"
    return f"{prefix}:{label}"


@dataclasses.dataclass
class Span:
    """One timed region. Picklable — worker spans ride the stats frame."""

    name: str
    cat: str                      # query|phase|plan|driver|wait|op|exchange|kernel
    id: int                       # unique within one recorder (== one rank)
    parent: Optional[int]         # enclosing span's id (same recorder)
    t0: int                       # monotonic ns
    t1: int = 0
    rank: Optional[int] = None    # worker rank; None == driver
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur_ns(self) -> int:
        return max(0, self.t1 - self.t0)

    @property
    def dur_ms(self) -> float:
        return self.dur_ns / 1e6

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _OpenSpan:
    """Context manager for one span on one recorder."""

    __slots__ = ("_rec", "_name", "_cat", "_attrs", "span")

    def __init__(self, rec: "SpanRecorder", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._attrs = attrs

    def __enter__(self) -> Span:
        rec = self._rec
        sp = Span(self._name, self._cat, rec._next,
                  rec._stack[-1].id if rec._stack else None,
                  time.monotonic_ns(), rank=rec.rank, attrs=self._attrs)
        rec._next += 1
        rec.spans.append(sp)
        rec._stack.append(sp)
        self.span = sp
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self._rec._stack.pop()
        sp.t1 = time.monotonic_ns()
        return False


class SpanRecorder:
    """Collects spans for one query on one rank. Not thread-safe — each
    worker (thread or process) records into its own instance; the driver
    records into its own and merges afterwards."""

    enabled = True

    def __init__(self, rank: Optional[int] = None):
        self.rank = rank
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next = 0

    def span(self, name: str, cat: str = "exec", **attrs) -> _OpenSpan:
        return _OpenSpan(self, name, cat, attrs)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None


class _NullSpan:
    """Inert stand-in for both an open-span context manager and a span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The no-op recorder every instrumentation site sees when tracing is
    off: ``span()`` hands back one shared inert context manager."""

    enabled = False
    rank = None
    spans: List[Span] = []  # always empty; never mutated

    def span(self, name: str, cat: str = "exec", **attrs) -> _NullSpan:
        return _NULL_SPAN

    def current(self) -> None:
        return None


NULL = NullRecorder()

# ------------------------------------------------- ambient recorder (TLS)
# Deeply shared code (the kernel compiler's specialization path, the
# exchange patterns) cannot thread a recorder argument through every
# caller; they look up the thread's ambient recorder instead. Each worker
# thread/process installs its own via `using`, so rank attribution is
# automatic and the lookup is one thread-local read when tracing is off.
_TLS = threading.local()


def current() -> "SpanRecorder | NullRecorder":
    """The ambient recorder of this thread (:data:`NULL` when none)."""
    return getattr(_TLS, "rec", NULL)


@contextlib.contextmanager
def using(rec):
    """Install ``rec`` as this thread's ambient recorder for the block."""
    prev = getattr(_TLS, "rec", NULL)
    _TLS.rec = rec
    try:
        yield rec
    finally:
        _TLS.rec = prev


# ------------------------------------------------------------ query trace
def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return int(v)  # numpy integer scalars
    except (TypeError, ValueError):
        return str(v)


@dataclasses.dataclass
class QueryTrace:
    """One query's merged, rank-attributed span set (driver + workers)."""

    spans: List[Span]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def merge(cls, driver: SpanRecorder,
              worker_spans: Optional[List[List[Span]]] = None,
              **meta) -> "QueryTrace":
        spans = list(driver.spans)
        for per_rank in worker_spans or []:
            spans.extend(per_rank)
        return cls(spans, dict(meta))

    # ----------------------------------------------------------- queries
    def ranks(self) -> List[int]:
        return sorted({sp.rank for sp in self.spans if sp.rank is not None})

    def find(self, name: Optional[str] = None, cat: Optional[str] = None,
             rank: Any = "any") -> List[Span]:
        """Spans matching the given name/category/rank (``rank=None``
        selects driver spans; the default matches every rank)."""
        out = []
        for sp in self.spans:
            if name is not None and sp.name != name:
                continue
            if cat is not None and sp.cat != cat:
                continue
            if rank != "any" and sp.rank != rank:
                continue
            out.append(sp)
        return out

    def root(self) -> Optional[Span]:
        for sp in self.spans:
            if sp.rank is None and sp.parent is None:
                return sp
        return None

    def shape(self) -> List:
        """The deterministic structure — ``(rank, name, cat, parent
        name)`` per span, in record order — for exact-tree assertions."""
        by_key = {(sp.rank, sp.id): sp for sp in self.spans}
        return [(sp.rank, sp.name, sp.cat,
                 by_key[(sp.rank, sp.parent)].name
                 if sp.parent is not None else None)
                for sp in self.spans]

    # ------------------------------------------------------ chrome export
    def to_chrome_trace(self, path: Optional[str] = None) -> Dict:
        """Chrome/Perfetto ``trace_event`` JSON: complete (``X``) events,
        one process lane per worker rank (pid ``rank+1``; the driver is
        pid 0), exchange spans flow-linked across ranks by their shared
        exchange tag. Returns the trace dict; with ``path``, also writes
        it as JSON (open the file at https://ui.perfetto.dev).

        Timestamps are normalized to the earliest span. All ranks of one
        host share ``CLOCK_MONOTONIC``, so thread/fork/socket-localhost
        lanes align exactly; lanes of true multi-host ``connect`` workers
        carry each host's own clock and may be skewed by the hosts'
        boot-time difference."""
        events: List[Dict] = []
        if not self.spans:
            trace = {"traceEvents": [], "metadata": dict(self.meta)}
        else:
            t_base = min(sp.t0 for sp in self.spans)
            pids = sorted({self._pid(sp) for sp in self.spans})
            for pid in pids:
                label = "driver" if pid == 0 else f"worker {pid - 1}"
                events.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "args": {"name": label}})
                events.append({"name": "process_sort_index", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"sort_index": pid}})
            for sp in self.spans:
                events.append({
                    "name": sp.name, "cat": sp.cat, "ph": "X",
                    "ts": (sp.t0 - t_base) / 1e3,
                    "dur": sp.dur_ns / 1e3,
                    "pid": self._pid(sp), "tid": 0,
                    "args": {k: _json_safe(v) for k, v in sp.attrs.items()},
                })
            events.extend(self._flow_events(t_base))
            trace = {"traceEvents": events, "metadata": dict(self.meta)}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    @staticmethod
    def _pid(sp: Span) -> int:
        return 0 if sp.rank is None else sp.rank + 1

    def _flow_events(self, t_base: int) -> List[Dict]:
        """Flow arrows tying each exchange's per-rank spans together: all
        spans sharing one exchange tag get one flow id; the earliest is
        the flow start (``s``), the latest the finish (``f``), the rest
        steps (``t``)."""
        by_tag: Dict[str, List[Span]] = {}
        for sp in self.spans:
            tag = sp.attrs.get("tag") if sp.cat == "exchange" else None
            if tag is not None and sp.rank is not None:
                by_tag.setdefault(str(tag), []).append(sp)
        events: List[Dict] = []
        for flow_id, tag in enumerate(sorted(by_tag), start=1):
            group = sorted(by_tag[tag], key=lambda s: (s.t0, s.rank))
            if len(group) < 2:
                continue
            for pos, sp in enumerate(group):
                ph = ("s" if pos == 0
                      else "f" if pos == len(group) - 1 else "t")
                ev = {"name": f"x:{tag}", "cat": "exchange", "ph": ph,
                      "id": flow_id, "ts": (sp.t0 - t_base) / 1e3 + 0.001,
                      "pid": self._pid(sp), "tid": 0}
                if ph == "f":
                    ev["bp"] = "e"  # bind the finish to the enclosing slice
                events.append(ev)
        return events
