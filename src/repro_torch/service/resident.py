"""The resident pool worker: one connection, many queries (port of
``repro.service.resident``; queries on ``expr_backend="torch"`` run their
kernels on the worker's device, as the one-shot worker's do).

A worker that joins a :class:`~repro_torch.service.service.QueryService`
(``welcome["service"]`` set at the rendezvous) does not run one query and
hang up — it holds the connection and multiplexes queries over it. Frames
carry :func:`~repro_torch.dist.protocol.mux_tag`-namespaced tags
(``"<qid>|<tag>"``); the demux loop routes each to its query's inbox, and
each query runs in its own thread over a :class:`MuxTransport` facade
that looks exactly like a :class:`~repro_torch.dist.exchange.SocketTransport`
to the unchanged :class:`~repro_torch.dist.worker.WorkerRuntime`.

Control frames from the service (bare tags, never mux-prefixed):

* ``QUERY`` — ``{"qid", "setup"}``: build the shard (reusing retained
  sets for ``("held", version)`` entries — the catalog's scan-in-place
  path), spawn the query thread;
* ``ABORT`` — ``{"qid": q}`` aborts one query (a peer died), ``None``
  aborts all;
* ``BYE`` (or EOF) — drain and exit.

Shards are *retained* across queries in ``retained`` (set name →
(version, PagedSet)), which is also where ``write()`` materializes: a
query whose setup carries ``"write"`` packs its OUTPUT partition into a
new retained set and announces ``(name, rows, dtype)`` to the service
instead of gathering pages to the driver.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.physical import plan_from_wire
from repro_torch.dist.exchange import PeerAborted
from repro_torch.dist.protocol import (ABORT, BYE, DRIVER, QUERY, mux_tag,
                                 read_frame, split_mux, write_frame)
from repro_torch.dist.worker import WorkerRuntime, build_setup_shard, worker_main
from repro_torch.objectmodel.page import DEFAULT_PAGE_SIZE
from repro_torch.objectmodel.store import PagedSet

__all__ = ["MuxTransport", "ResidentWorkerRuntime", "serve_resident"]


class _QueryInbox:
    """Per-query receive buffer fed by the demux loop. ``pop`` blocks on a
    condition instead of the socket — the socket has exactly one reader
    (the demux thread) and one writer lock (shared by all query threads),
    which is what lets K queries interleave on one connection."""

    def __init__(self):
        self._cv = threading.Condition()
        self._buf: Dict[Tuple[int, str], deque] = {}
        self._aborted = False

    def push(self, src: int, tag: str, msg: Any) -> None:
        with self._cv:
            self._buf.setdefault((src, tag), deque()).append(msg)
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def pop(self, src: int, tag: str) -> Any:
        want = (src, tag)
        with self._cv:
            while True:
                if self._aborted:
                    raise PeerAborted(
                        "query aborted by the service; unwinding")
                buf = self._buf.get(want)
                if buf:
                    return buf.popleft()
                self._cv.wait()


class MuxTransport:
    """The transport one query's :class:`WorkerRuntime` sees: sends get
    the query id spliced into the tag (single writer per socket enforced
    by ``wlock``), receives come from the demux-fed inbox."""

    def __init__(self, rank: int, sock, qid: str, inbox: _QueryInbox,
                 wlock: threading.Lock):
        self.rank = rank
        self._sock = sock
        self._qid = qid
        self._inbox = inbox
        self._wlock = wlock

    def send(self, dst: int, tag: str, msg: Any) -> None:
        with self._wlock:
            write_frame(self._sock, self.rank, dst,
                        mux_tag(self._qid, tag), msg)

    def recv(self, src: int, tag: str) -> Any:
        return self._inbox.pop(src, tag)


class ResidentWorkerRuntime(WorkerRuntime):
    """A :class:`WorkerRuntime` whose OUTPUT can materialize in place:
    with ``write`` set (``{"name", "version"}`` from the query setup),
    the projected output partition is packed into a retained
    :class:`PagedSet` on this worker — no page gather to the driver — and
    a ``written`` announce carries the metadata the catalog needs."""

    def __init__(self, *args, write: Optional[Dict] = None,
                 retained: Optional[Dict] = None,
                 retained_lock: Optional[threading.Lock] = None, **kw):
        super().__init__(*args, **kw)
        self._write = write
        self._retained = retained
        self._retained_lock = retained_lock

    def _output(self, op, i, batches) -> None:
        if self._write is None:
            return super()._output(op, i, batches)
        name, version = self._write["name"], self._write["version"]
        cols: Dict[str, list] = {c: [] for c in op.apply_cols}
        for vl in batches:
            for c in op.apply_cols:
                cols[c].append(np.asarray(vl[c]))
        arrays = {c: (np.concatenate(v) if v else None)
                  for c, v in cols.items()}
        if any(a is not None and a.dtype == object
               for a in arrays.values()):
            bad = [c for c, a in arrays.items()
                   if a is not None and a.dtype == object]
            raise ValueError(
                f"write({name!r}): cannot materialize object-dtype "
                f"column(s) {bad} as packed records")
        n = next((len(a) for a in arrays.values() if a is not None), 0)
        self.stats.rows_output = n
        if n == 0:
            # empty partition: nothing to retain (column dtypes are
            # unknowable here) — the service learns the dtype from a
            # nonempty rank and ships this rank an empty shard later
            self.tr.send(DRIVER, f"{i}:written",
                         {"name": name, "rows": 0, "dtype": None})
            return
        dtype = np.dtype([(c, a.dtype, a.shape[1:])
                          for c, a in arrays.items()])
        recs = np.zeros(n, dtype)
        for c, a in arrays.items():
            recs[c] = a
        s = PagedSet(name, dtype, DEFAULT_PAGE_SIZE)
        s.append_records(recs)
        with self._retained_lock:
            self._retained[name] = (version, s)
        self.tr.send(DRIVER, f"{i}:written",
                     {"name": name, "rows": n, "dtype": dtype})


def serve_resident(sock, welcome: Dict, device=None) -> Tuple[int, int]:
    """Serve queries on one service connection until BYE/EOF, the torch
    backend's kernels on ``device`` (CUDA unless another device is named).
    Returns ``(completed, failed)`` like the one-shot remote worker."""
    rank, P = int(welcome["rank"]), int(welcome["P"])
    retained: Dict[str, Tuple[int, PagedSet]] = {}
    retained_lock = threading.Lock()
    wlock = threading.Lock()
    inboxes: Dict[str, _QueryInbox] = {}
    threads: Dict[str, threading.Thread] = {}
    counts = {"ok": 0, "failed": 0}
    counts_lock = threading.Lock()

    def run_query(qid: str, setup: Dict, shard) -> None:
        inbox = inboxes[qid]
        tr = MuxTransport(rank, sock, qid, inbox, wlock)
        prog = setup["prog"]
        plan = plan_from_wire(prog, setup["plan"])
        write = setup.get("write")

        def runtime_cls(*args, **kw):
            return ResidentWorkerRuntime(
                *args, write=write, retained=retained,
                retained_lock=retained_lock, **kw)

        ok = worker_main(rank, P, tr, shard, setup["vector_rows"], prog,
                         plan, setup["expr_backend"],
                         trace=bool(setup.get("trace", False)),
                         runtime_cls=runtime_cls, device=device)
        with counts_lock:
            counts["ok" if ok else "failed"] += 1
        inboxes.pop(qid, None)

    try:
        while True:
            try:
                frame = read_frame(sock)
            except OSError:
                break
            if frame is None:
                break
            src, _dst, tag, msg = frame
            if tag == BYE:
                break
            if tag == QUERY:
                qid = msg["qid"]
                # the shard is built *here*, in frame-arrival order, not
                # in the query thread: a QUERY that ships pages must
                # retain them before a later QUERY's ("held", version)
                # reference resolves — per-connection FIFO gives that
                # ordering for free, thread scheduling would not
                with retained_lock:
                    shard = build_setup_shard(msg["setup"]["sets"],
                                              retained)
                inboxes[qid] = _QueryInbox()
                t = threading.Thread(target=run_query,
                                     args=(qid, msg["setup"], shard),
                                     name=f"pc-resident-{rank}-{qid}",
                                     daemon=True)
                threads[qid] = t
                t.start()
            elif tag == ABORT:
                if isinstance(msg, dict) and "qid" in msg:
                    inbox = inboxes.get(msg["qid"])
                    if inbox is not None:
                        inbox.abort()
                else:
                    for inbox in list(inboxes.values()):
                        inbox.abort()
            else:
                qid, bare = split_mux(tag)
                inbox = inboxes.get(qid) if qid is not None else None
                if inbox is not None:
                    inbox.push(src, bare, msg)
                # unknown qid: the query was aborted and cleaned up —
                # late peer frames are dropped silently
    finally:
        for inbox in list(inboxes.values()):
            inbox.abort()
        for t in threads.values():
            t.join(timeout=10)
        try:
            sock.close()
        except OSError:
            pass
    return counts["ok"], counts["failed"]
