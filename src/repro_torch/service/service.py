"""The persistent query service: a long-lived driver over a resident pool
(port of ``repro.service.service``; on ``expr_backend="torch"``, the
default, the pool's queries run their kernels on the service's device).

:class:`QueryService` keeps a pool of connected socket workers alive
across queries — the rendezvous and shard SETUP that the one-shot
:class:`~repro_torch.dist.driver.DistributedExecutor` pays per query are paid
once per pool. Queries from any number of client sessions multiplex over
the same worker connections (per-query ids namespace every frame — see
:mod:`repro_torch.service.resident`), admitted by the
:class:`~repro_torch.service.scheduler.AdmissionScheduler` and placed through
the :class:`~repro_torch.service.catalog.ShardCatalog`: a set the pool already
holds at the current version is scanned *in place* (zero SETUP bytes).

Pool launch modes mirror the driver's ``socket_launch``: ``"thread"``
(resident workers as in-process threads over real TCP — the CUDA-safe
default), ``"fork"`` (forked resident processes), ``"connect"`` (await N
external ``python -m repro_torch.dist.worker --connect host:port --serve``
processes; a worker joining a service is told so in its WELCOME and
switches to the resident loop). All three ship programs through pickled
QUERY frames — the pool exists before any query does, so programs must
be picklable under every launch mode (the analyzer's PL301 gate covers
``backend="service"``).

:class:`ServiceExecutor` adapts ``submit()`` to the executor interface,
so ``Session(backend="service", service=svc)`` runs the unchanged
fluent front-end against the shared pool.
"""
from __future__ import annotations

import pickle
import queue
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.footprint import estimate_plan_footprint
from repro_torch.core.executor import ExecStats
from repro_torch.core.exprc import expr_device
from repro_torch.core.physical import PhysicalPlan, plan_physical, plan_to_wire
from repro_torch.core.relops import greedy_page_placement
from repro_torch.core.tcap import TCAPProgram
from repro_torch.dist.driver import DistributedExecutor
from repro_torch.dist.protocol import (ABORT, BYE, DRIVER, HELLO, PROTO_VERSION,
                                 QUERY, WELCOME, PageBlock, ProtocolError,
                                 StatsFrame, configure_socket, read_frame,
                                 split_mux, write_frame)
from repro_torch.dist.worker import connect_worker
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import NULL
from repro_torch.service.catalog import ShardCatalog, StubSet
from repro_torch.service.scheduler import (AdmissionScheduler, FootprintModel,
                                     QueryTimeout)
from repro_torch.objectmodel.store import PagedStore

__all__ = ["QueryService", "ServiceExecutor"]

POOL_LAUNCHES = ("thread", "fork", "connect")


def _pool_worker_entry(addr: Tuple[str, int], rank: int,
                       epoch: str, device=None) -> None:
    """A launched pool worker: dial the service, run the resident loop
    (the torch backend's kernels on ``device``). Runs in a thread
    (launch='thread') or a forked process (launch='fork') — only
    picklable args, so fork survives spawn-free."""
    from repro_torch.service.resident import serve_resident
    try:
        sock, welcome = connect_worker(addr, rank=rank, epoch=epoch,
                                       retry_seconds=10.0)
    except (OSError, ProtocolError):
        return  # service gone before we joined; supervisor notices
    serve_resident(sock, welcome, device)


class _Sender:
    """One connection's single writer: a queue drained by a thread, so K
    query threads and the router never interleave partial frames."""

    _STOP = object()

    def __init__(self, sock, rank: int):
        self._sock = sock
        self._rank = rank
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._t = threading.Thread(target=self._drain, daemon=True,
                                   name=f"pc-svc-sender-{rank}")
        self._t.start()

    def put(self, src: int, tag: str, msg) -> None:
        self.q.put((src, tag, msg))

    def _drain(self) -> None:
        while True:
            item = self.q.get()
            if item is _Sender._STOP:
                return
            src, tag, msg = item
            try:
                write_frame(self._sock, src, self._rank, tag, msg)
            except OSError:
                # connection died. Shut the socket down so the pump's
                # blocked recv wakes immediately — a close() alone does
                # not interrupt it, and a query whose frames were just
                # dropped here must fail over to _worker_died's error
                # broadcast, not hang in _collect.
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return

    def stop(self, join: float = 5.0) -> None:
        self.q.put(_Sender._STOP)
        self._t.join(timeout=join)


class QueryService:
    """The resident driver. ``start()`` brings the pool up; ``submit()``
    runs one query over it; ``stop()`` tears it down. Client sessions
    attach with ``Session(backend="service", service=svc)`` (or
    ``Session.connect(svc)``) and share the service's store and pool."""

    def __init__(self, store: Optional[PagedStore] = None,
                 num_workers: int = 2, launch: str = "thread",
                 addr: Tuple[str, int] = ("127.0.0.1", 0),
                 vector_rows: int = 8192,
                 broadcast_threshold_bytes: int = 2 << 30,
                 expr_backend: str = "torch",
                 worker_budget_bytes: Optional[int] = None,
                 max_concurrent: int = 4, max_queue: int = 16,
                 default_timeout: Optional[float] = None,
                 accept_timeout: float = 60.0, device=None):
        if launch not in POOL_LAUNCHES:
            raise ValueError(f"unknown service launch {launch!r} "
                             f"(expected one of {POOL_LAUNCHES})")
        if launch == "fork" and expr_backend == "torch":
            raise ValueError(
                "QueryService(launch='fork') cannot run "
                "expr_backend='torch': CUDA's context does not survive "
                "the fork that spawns the pool — use launch='thread' or "
                "external workers via launch='connect'")
        self.store = store if store is not None else PagedStore()
        self.P = num_workers
        self.launch = launch
        self.addr = addr
        self.vector_rows = vector_rows
        self.broadcast_threshold = broadcast_threshold_bytes
        self.expr_backend = expr_backend
        # where the torch backend's kernels run in thread-launched pool
        # workers: CUDA unless the caller names another device, never the
        # CPU on its own (external workers take their own --device)
        self.device = expr_device(expr_backend, device)
        self.accept_timeout = accept_timeout
        self.catalog = ShardCatalog()
        self.scheduler = AdmissionScheduler(
            worker_budget_bytes=worker_budget_bytes,
            max_concurrent=max_concurrent, max_queue=max_queue,
            default_timeout=default_timeout)
        self.model = FootprintModel()
        # pool state (all guarded by _lock; _ready signals rank joins)
        self._lock = threading.RLock()
        self._ready = threading.Condition(self._lock)
        self._conns: List[Optional[socket.socket]] = [None] * num_workers
        self._senders: List[Optional[_Sender]] = [None] * num_workers
        self._pumps: List[Optional[threading.Thread]] = [None] * num_workers
        self._gen = [0] * num_workers  # connection generation per rank
        self._procs: List = []
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self.epoch: Optional[str] = None
        self._started = False
        self._stopping = False
        # query state
        self._collectors: Dict[str, "queue.SimpleQueue"] = {}
        self._qid_lock = threading.Lock()
        self._qid_counter = 0
        self._submit_lock = threading.Lock()
        self.queries_run = 0
        self.last_setup_bytes = 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "QueryService":
        if self._started:
            return self
        import os
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(self.addr)
        listener.listen(self.P + 4)
        self._listener = listener
        host, port = listener.getsockname()[:2]
        self.advertised = ("127.0.0.1" if host in ("0.0.0.0", "") else host,
                           port)
        self.epoch = os.urandom(8).hex()
        self._started = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="pc-svc-accept")
        self._accept_thread.start()
        for rank in range(self.P):
            self._launch_worker(rank)
        if self.launch == "connect":
            print(f"service: waiting for {self.P} workers at "
                  f"{self.advertised[0]}:{self.advertised[1]} "
                  f"(python -m repro_torch.dist.worker --connect "
                  f"{self.advertised[0]}:{self.advertised[1]} --serve)",
                  file=sys.stderr)
        return self

    def _launch_worker(self, rank: int) -> None:
        if self.launch == "thread":
            t = threading.Thread(
                target=_pool_worker_entry,
                args=(self.advertised, rank, self.epoch, self.device),
                name=f"pc-svc-worker-{rank}", daemon=True)
            self._threads.append(t)
            t.start()
        elif self.launch == "fork":
            import multiprocessing as mp
            try:
                ctx = mp.get_context("fork")
            except ValueError as e:  # pragma: no cover - non-fork platform
                raise RuntimeError(
                    "QueryService(launch='fork') needs the fork start "
                    "method — use launch='thread' or external workers via "
                    "launch='connect'") from e
            p = ctx.Process(target=_pool_worker_entry,
                            args=(self.advertised, rank, self.epoch),
                            name=f"pc-svc-worker-{rank}", daemon=True)
            self._procs.append(p)
            p.start()
        # launch == "connect": external workers dial in on their own

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                self._listener.settimeout(1.0)
                c, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: service stopping
            try:
                self._handshake(c)
            except (ProtocolError, OSError):
                try:
                    c.close()
                except OSError:
                    pass

    def _handshake(self, c) -> None:
        configure_socket(c)
        c.settimeout(15.0)
        frame = read_frame(c)
        if frame is None:
            raise ProtocolError("closed during handshake")
        _, _, tag, hello = frame
        if (tag != HELLO or not isinstance(hello, dict)
                or hello.get("proto") != PROTO_VERSION):
            raise ProtocolError("bad hello")
        with self._lock:
            if self._stopping:
                raise ProtocolError("service stopping")
            if hello.get("epoch") == self.epoch and isinstance(
                    hello.get("rank"), int):
                rank = hello["rank"]  # launched (or relaunched) worker
                if not 0 <= rank < self.P or self._conns[rank] is not None:
                    raise ProtocolError("bad rank")
            else:
                # external --serve worker: previous rank back when free
                # (catalog state for it is gone either way — the service
                # is the authority on holdings), else lowest free rank
                prev = hello.get("prev") or {}
                pr = prev.get("rank")
                if (prev.get("P") == self.P and isinstance(pr, int)
                        and 0 <= pr < self.P and self._conns[pr] is None):
                    rank = pr
                else:
                    try:
                        rank = self._conns.index(None)
                    except ValueError:
                        raise ProtocolError("pool full") from None
            write_frame(c, DRIVER, rank, WELCOME,
                        {"rank": rank, "P": self.P, "epoch": self.epoch,
                         "service": True})
            c.settimeout(None)
            self._conns[rank] = c
            self._gen[rank] += 1
            gen = self._gen[rank]
            self._senders[rank] = _Sender(c, rank)
            pump = threading.Thread(target=self._pump, args=(rank, gen),
                                    daemon=True,
                                    name=f"pc-svc-pump-{rank}")
            self._pumps[rank] = pump
            pump.start()
            METRICS.gauge("service.pool.workers",
                          sum(x is not None for x in self._conns))
            self._ready.notify_all()

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every rank is connected (pool complete)."""
        timeout = self.accept_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._ready:
            while any(c is None for c in self._conns):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    n = sum(c is not None for c in self._conns)
                    raise RuntimeError(
                        f"service pool incomplete after {timeout:.0f}s: "
                        f"{n}/{self.P} workers connected")
                self._ready.wait(remaining)

    def stop(self) -> None:
        """Tear the pool down. Idempotent — same contract as the one-shot
        runtime's ``shutdown()``."""
        if not self._started or self._stopping:
            return
        self._stopping = True
        # the listener dies FIRST: a --serve worker redials the moment it
        # gets its BYE, and an accept loop still running here would
        # welcome it back into a pool that is being torn down — it would
        # then wait forever on a connection nothing drains
        with self._lock:
            if self._listener is not None:
                try:
                    self._listener.close()
                except OSError:
                    pass
                self._listener = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._lock:
            for rank, sender in enumerate(self._senders):
                if sender is not None:
                    sender.put(DRIVER, BYE, None)
                    sender.stop()
                self._senders[rank] = None
            for rank, c in enumerate(self._conns):
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass
                self._conns[rank] = None
        for pump in self._pumps:
            if pump is not None:
                pump.join(timeout=5)
        for t in self._threads:
            t.join(timeout=10)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():  # pragma: no cover - hung worker
                p.terminate()
        METRICS.gauge("service.pool.workers", 0)

    def __enter__(self) -> "QueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ routing
    def _pump(self, rank: int, gen: int) -> None:
        """Drain one worker connection: driver-bound frames go to their
        query's collector (de-multiplexed by qid), peer-bound frames to
        that peer's sender (mux tag preserved verbatim)."""
        conn = self._conns[rank]
        while True:
            try:
                frame = read_frame(conn)
            except OSError:
                frame = None
            if frame is None:
                break
            src, dst, tag, msg = frame
            if dst == DRIVER:
                qid, bare = split_mux(tag)
                collector = self._collectors.get(qid)
                if collector is not None:
                    collector.put((src, bare, msg))
                # else: late frame from an aborted query — dropped
            else:
                with self._lock:
                    sender = (self._senders[dst]
                              if 0 <= dst < self.P else None)
                if sender is not None:
                    sender.put(src, tag, msg)
        self._worker_died(rank, gen)

    def _worker_died(self, rank: int, gen: int) -> None:
        with self._lock:
            if self._stopping or self._gen[rank] != gen:
                return  # planned teardown, or an already-replaced conn
            self._conns[rank] = None
            sender, self._senders[rank] = self._senders[rank], None
            METRICS.gauge("service.pool.workers",
                          sum(x is not None for x in self._conns))
        if sender is not None:
            sender.stop(join=1.0)
        lost = self.catalog.evict_rank(rank)
        METRICS.inc("service.workers.died.total")
        # in-flight queries get a clean error (their collect loop turns
        # this into the abort broadcast + client exception); queries
        # submitted afterwards wait for the replacement worker instead
        for collector in list(self._collectors.values()):
            collector.put((rank, "error",
                           f"pool worker rank {rank} died mid-query"
                           + (f" (materialized set(s) {lost} lost with "
                              "it)" if lost else "")))
        if self.launch in ("thread", "fork") and not self._stopping:
            self._launch_worker(rank)

    # ------------------------------------------------------------ queries
    def _new_qid(self) -> str:
        with self._qid_lock:
            self._qid_counter += 1
            return f"q{self._qid_counter:x}"

    def submit(self, prog: TCAPProgram, plan: PhysicalPlan, *,
               trace=NULL, write_name: Optional[str] = None,
               name: str = "", timeout: Optional[float] = None
               ) -> Dict[str, object]:
        """Run one query over the pool: admit → place (catalog-first) →
        QUERY frames → collect → release. Returns ``{"outputs", "stats",
        "spans", "setup_bytes", "written"}`` (outputs/stats/spans per
        rank, as the one-shot runtime presents them)."""
        if not self._started or self._stopping:
            raise RuntimeError("QueryService is not running — call "
                               "start() (or use it as a context manager)")
        try:
            pickle.dumps(prog)
        except Exception as e:
            raise ValueError(
                "backend='service' ships the TCAP program to resident "
                f"pool workers by pickling, and this program cannot be "
                f"pickled ({e!r}) — native Python lambdas (make_lambda) "
                "only exist in-process; express the query in the lambda "
                "DSL") from e
        rec = trace if trace is not None else NULL
        timeout = (self.scheduler.default_timeout if timeout is None
                   else timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        qid = self._new_qid()
        fp = estimate_plan_footprint(prog, self.store, plan=plan,
                                     num_partitions=self.P)
        key = tuple((op.op, op.stage) for op in prog.ops)
        predicted = self.model.corrected(key, fp.per_worker_bytes)
        with rec.span("service:admit", cat="driver", qid=qid):
            self.scheduler.admit(qid, predicted, name=name,
                                 timeout=timeout)
        t0 = time.monotonic_ns()
        status = "error"
        stats: List[ExecStats] = []
        try:
            self.wait_ready()
            collector: "queue.SimpleQueue" = queue.SimpleQueue()
            with rec.span("service:setup", cat="driver", qid=qid):
                with self._submit_lock:
                    # entries + enqueue stay one atomic step: a holding
                    # registered here must have its pages queued ahead of
                    # any later query's ("held", ...) reference on every
                    # rank's FIFO sender
                    setups, setup_bytes = self._build_setups(
                        prog, plan, rec.enabled, write_name)
                    self._collectors[qid] = collector
                    with self._lock:
                        senders = list(self._senders)
                    if any(s is None for s in senders):
                        raise RuntimeError(
                            "a pool worker died while the query was being "
                            "dispatched — resubmit once the pool recovers")
                    for r in range(self.P):
                        senders[r].put(DRIVER, QUERY,
                                       {"qid": qid, "setup": setups[r]})
            self.last_setup_bytes = setup_bytes
            METRICS.inc("service.setup.bytes.total", setup_bytes)
            with rec.span("service:collect", cat="wait", qid=qid):
                outputs, stats, spans, written = self._collect(
                    qid, collector, deadline)
            if write_name is not None:
                self._register_written(write_name, written)
            self.queries_run += 1
            METRICS.inc("service.queries.total")
            status = "ok"
            return {"outputs": outputs, "stats": stats, "spans": spans,
                    "setup_bytes": setup_bytes, "written": written,
                    "qid": qid}
        finally:
            self._collectors.pop(qid, None)
            wall_ms = (time.monotonic_ns() - t0) / 1e6
            observed = None
            if status == "ok" and stats:
                observed = (fp.scan_bytes / max(1, self.P)
                            + max(s.shuffle_bytes for s in stats))
                self.model.observe(key, fp.per_worker_bytes, observed)
            self.scheduler.release(qid, observed_bytes=observed,
                                   wall_ms=wall_ms, status=status)

    def _build_setups(self, prog: TCAPProgram, plan: PhysicalPlan,
                      trace: bool, write_name: Optional[str]
                      ) -> Tuple[List[Dict], int]:
        """Per-rank QUERY setups: catalog-first placement. A rank holding
        a scanned set at its current version gets a ``("held", version)``
        reference (a catalog hit — zero bytes); otherwise its partition
        ships as pages (greedy placement, same rule as every backend) and
        the new holding is registered."""
        entries: List[Dict] = [{} for _ in range(self.P)]
        setup_bytes = 0
        hits = 0
        seen = set()
        for op in prog.ops:
            if op.op != "SCAN" or op.info["set"] in seen:
                continue
            sname = op.info["set"]
            seen.add(sname)
            ment = self.catalog.materialized(sname)
            if ment is not None:
                if ment.lost:
                    raise RuntimeError(
                        f"set {sname!r} was materialized on the pool and "
                        "a worker holding part of it died — the shard is "
                        "lost; re-run the write() that produced it")
                ver = ment.version
                for r in range(self.P):
                    if self.catalog.lookup(r, sname) == ver:
                        entries[r][sname] = ("held", ver)
                        hits += 1
                    else:
                        # a replacement worker at a rank whose partition
                        # was empty: ship an empty shard (rows lived only
                        # on ranks still holding theirs)
                        block = PageBlock(ment.dtype.descr, [], ())
                        entries[r][sname] = ("pages", self.store.page_size,
                                             ment.dtype, block, ver)
                        self.catalog.register(r, sname, ver)
            else:
                s = self.store.get_set(sname)
                ver = self.store.set_version(sname)
                dest = greedy_page_placement(
                    [c * s.dtype.itemsize for c in s.counts], self.P)
                for r in range(self.P):
                    if self.catalog.lookup(r, sname) == ver:
                        entries[r][sname] = ("held", ver)
                        hits += 1
                    else:
                        pages = [i for i, d in enumerate(dest) if d == r]
                        block = PageBlock(
                            s.dtype.descr,
                            [(s.counts[i], s.pages[i].payload())
                             for i in pages], ())
                        setup_bytes += block.nbytes
                        entries[r][sname] = ("pages", s.page_size,
                                             s.dtype, block, ver)
                        self.catalog.register(r, sname, ver)
        if hits:
            self.catalog.hit(hits)
        write = None
        if write_name is not None:
            write = {"name": write_name,
                     "version": self.store.set_version(write_name) + 1}
        wire_plan = plan_to_wire(prog, plan)
        setups = [{"prog": prog, "plan": wire_plan,
                   "vector_rows": self.vector_rows,
                   "expr_backend": self.expr_backend,
                   "sets": entries[r], "trace": trace, "write": write}
                  for r in range(self.P)]
        return setups, setup_bytes

    def _collect(self, qid: str, collector: "queue.SimpleQueue",
                 deadline: Optional[float]):
        """Drain one query's collector until every rank reports done.
        On a worker error or timeout: abort the query on every rank
        (``ABORT {"qid"}`` — only this query's inboxes unwind; the pool
        and its other queries are untouched) and raise."""
        outputs: List[List] = [[] for _ in range(self.P)]
        stats: List[Optional[ExecStats]] = [None] * self.P
        spans: List[List] = [[] for _ in range(self.P)]
        written: Dict[int, Dict] = {}
        remaining = self.P
        try:
            while remaining:
                block_for = (None if deadline is None
                             else deadline - time.monotonic())
                if block_for is not None and block_for <= 0:
                    raise QueryTimeout(
                        f"query {qid}: did not complete before its "
                        "timeout; aborted on the pool")
                try:
                    src, tag, msg = collector.get(timeout=block_for)
                except queue.Empty:
                    raise QueryTimeout(
                        f"query {qid}: did not complete before its "
                        "timeout; aborted on the pool") from None
                if tag == "error":
                    raise RuntimeError(f"worker {src} failed:\n{msg}")
                if tag == "done":
                    if isinstance(msg, StatsFrame):
                        stats[src] = msg.stats
                        spans[src] = msg.spans
                    else:
                        stats[src] = msg
                    remaining -= 1
                elif tag.endswith(":written"):
                    written[src] = msg
                else:  # an OUTPUT gather ("<i>:output")
                    outputs[src] = msg
        except QueryTimeout:
            METRICS.inc("service.queries.timeout.total")
            self._abort_query(qid)
            raise
        except Exception:
            self._abort_query(qid)
            raise
        return (outputs, [s for s in stats if s is not None], spans,
                written)

    def _abort_query(self, qid: str) -> None:
        self._collectors.pop(qid, None)
        with self._lock:
            for sender in self._senders:
                if sender is not None:
                    sender.put(DRIVER, ABORT, {"qid": qid})

    def _register_written(self, name: str,
                          written: Dict[int, Dict]) -> None:
        """A write() completed worker-side: record the materialized set in
        the catalog (per-rank rows, dtype) and give the driver store a
        planning stub at the version the workers retained."""
        dtype = next((w["dtype"] for w in written.values()
                      if w.get("dtype") is not None), None)
        if dtype is None:
            raise ValueError(
                f"write({name!r}): query produced no rows on any worker — "
                "nothing to materialize")
        per_rank = {r: int(w["rows"]) for r, w in written.items()}
        self.store.sets[name] = StubSet(name, dtype, sum(per_rank.values()),
                                        self.store.page_size)
        self.store._bump(name)
        ver = self.store.set_version(name)
        self.catalog.register_materialized(name, ver, dtype, per_rank)
        for r, rows in per_rank.items():
            if rows > 0:
                self.catalog.register(r, name, ver)

    # -------------------------------------------------------------- stats
    def info(self) -> Dict[str, object]:
        with self._lock:
            connected = sum(c is not None for c in self._conns)
        return {"P": self.P, "launch": self.launch,
                "connected": connected, "queries_run": self.queries_run,
                "catalog": self.catalog.snapshot(),
                "scheduler": self.scheduler.load()}


class ServiceExecutor(DistributedExecutor):
    """The executor a ``backend="service"`` Session drives: same
    interface as :class:`DistributedExecutor`, but ``execute_program``
    submits to the shared :class:`QueryService` instead of launching a
    per-query runtime. Inherits the stat-aggregation and OUTPUT-assembly
    contracts so results stay byte-identical with every other backend."""

    def __init__(self, service: QueryService):
        # deliberately no super().__init__: the service owns the runtime
        # configuration; this adapter only carries the executor surface
        self.service = service
        self.store = service.store
        self.P = service.P
        self.vector_rows = service.vector_rows
        self.do_optimize = False
        self.broadcast_threshold = service.broadcast_threshold
        self.write_outputs = False
        self.worker_kind = "service"
        self.expr_backend = service.expr_backend
        self.device = service.device
        self.socket_launch = service.launch
        self.stats = ExecStats()
        self.worker_stats: List[ExecStats] = []
        self.worker_spans: List[List] = []
        self.last_setup_bytes = 0
        # set by Session._run around write() queries: the service
        # materializes worker-side instead of the driver round-trip
        self.write_name: Optional[str] = None
        self.timeout: Optional[float] = None

    def execute_program(self, prog: TCAPProgram,
                        plan: Optional[PhysicalPlan] = None,
                        steps=None, trace=None) -> Dict[str, np.ndarray]:
        rec = NULL if trace is None else trace
        self.stats = ExecStats()
        self.worker_spans = []
        if plan is None:
            plan = plan_physical(prog, self.store, self.broadcast_threshold,
                                 num_partitions=self.P)
        out_op = next((op for op in prog.ops if op.op == "OUTPUT"), None)
        res = self.service.submit(
            prog, plan, trace=rec, write_name=self.write_name,
            name=out_op.info.get("set", "") if out_op is not None else "",
            timeout=self.timeout)
        self.worker_stats = res["stats"]
        self.last_setup_bytes = res["setup_bytes"]
        self.worker_spans = res["spans"]
        self._aggregate_stats(prog, plan)
        if self.write_name is not None:
            # materialized on the workers: no output pages crossed the
            # wire, so there is nothing to assemble driver-side
            self.stats.rows_output = sum(
                int(w["rows"]) for w in res["written"].values())
            return {}
        return self._assemble(prog, res["outputs"])
