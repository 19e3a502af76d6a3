"""The driver: plans, places, launches workers, routes, collects (port of
``repro.dist.driver``; on ``expr_backend="torch"``, the default, every
rank runs its kernels on the driver's device).

:class:`DistributedExecutor` is interface-compatible with
:class:`~repro_torch.core.executor.Executor` (``execute`` /
``execute_program`` / ``stats`` / ``P`` / ``broadcast_threshold`` /
``write_outputs``), so the :class:`~repro_torch.core.session.Session` front-end
swaps it in behind ``backend="workers"`` with no other change. Per query
it:

1. optimizes (unless the session already did) and plans physically — the
   broadcast decision priced against real transfer cost (``plan_physical``
   with ``num_partitions``);
2. places set pages greedily by byte load (equal pages degenerate to
   round-robin) and builds each worker's shard store
   (page references: zero-copy in-process, copy-on-write across a fork);
3. launches N workers (threads, or forked processes routed through the
   driver star) running the SPMD :class:`~repro_torch.dist.worker.WorkerRuntime`;
4. collects OUTPUT page blocks and per-worker :class:`ExecStats`.

``stats`` aggregates the workers: counts and ``shuffle_bytes`` are summed
(shuffle_bytes is *real serialized page traffic* — shuffles, broadcasts,
AGG partials, and the TOPK/OUTPUT gathers — unlike the local executor's
estimate, which prices JOIN/AGG exchanges only); join-algorithm counters
are taken per plan decision, not per worker. ``worker_stats[w]`` keeps
worker ``w``'s own view for skew analysis.

Worker kinds: ``"thread"`` (default; shares one address space — fine
because TCAP execution is numpy-bound), ``"fork"`` (real process
isolation; requires the ``fork`` start method since TCAP programs carry
native lambdas that cannot be pickled — they ride the fork image instead,
and only page blocks cross process boundaries), and ``"socket"`` (framed
TCP through a driver-side rendezvous — the true multi-host transport).

``worker_kind="socket"`` launches workers one of three ways
(``socket_launch``): ``"fork"`` (default) forks N processes that dial
back over localhost TCP — programs ride the fork image, data rides real
sockets; ``"thread"`` runs the workers as in-process threads over real
TCP (the only socket mode compatible with ``expr_backend="torch"``, since
CUDA does not survive a fork); ``"connect"`` waits for N external
``python -m repro_torch.dist.worker --connect host:port`` processes, shipping
each its rank, the program (which must then be picklable — no native
lambdas), the physical plan, and its shard's page bytes.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.compiler import compile_graph
from repro_torch.core.computations import Computation
from repro_torch.core.executor import ExecStats
from repro_torch.core.exprc import expr_device
from repro_torch.core.optimizer import optimize
from repro_torch.core.physical import PhysicalPlan, plan_physical, plan_to_wire
from repro_torch.core.tcap import TCAPProgram
from repro_torch.core.relops import assemble_output
from repro_torch.dist.exchange import (ProcessTransport, SocketTransport,
                                 ThreadTransport)
from repro_torch.dist.placement import build_shard_store, place_scans
from repro_torch.dist.protocol import (ABORT, DRIVER, HELLO, PROTO_VERSION, SETUP,
                                 WELCOME, PageBlock, ProtocolError,
                                 StatsFrame, configure_socket, decode_batch,
                                 read_frame, write_frame)
from repro_torch.dist.worker import connect_worker, worker_main
from repro_torch.obs.trace import NULL, using
from repro_torch.objectmodel.store import PagedStore

__all__ = ["DistributedExecutor"]

# canonical home is the analyzer's capability rules; re-exported here for
# the transport-facing callers that historically imported it from the driver
from repro_torch.analysis.capability import SOCKET_LAUNCHES, check_worker_config  # noqa: E402


class DistributedExecutor:
    """Driver + N workers, each owning a PagedStore shard, exchanging
    page-serialized data (the real realization of the plan the local
    ``Executor`` simulates)."""

    def __init__(self, store: PagedStore, num_workers: int = 4,
                 vector_rows: int = 8192, do_optimize: bool = True,
                 broadcast_threshold_bytes: int = 2 << 30,
                 write_outputs: bool = True, worker_kind: str = "thread",
                 expr_backend: str = "torch",
                 socket_launch: Optional[str] = None,
                 socket_addr: Optional[Tuple[str, int]] = None,
                 socket_accept_timeout: float = 60.0, device=None):
        # the constructor rules (exact messages, fixed order) are analyzer
        # capability rules now — one home for the checks the Session, the
        # raw-driver API, and `Dataset.check()` all agree on
        check_worker_config(num_workers, expr_backend, worker_kind,
                            socket_launch, socket_addr)
        if worker_kind != "socket":
            self.socket_launch = None
        else:
            self.socket_launch = socket_launch or "fork"
        self.socket_addr = socket_addr
        self.socket_accept_timeout = socket_accept_timeout
        self.store = store
        self.P = num_workers
        self.vector_rows = vector_rows
        self.do_optimize = do_optimize
        self.broadcast_threshold = broadcast_threshold_bytes
        self.write_outputs = write_outputs
        self.worker_kind = worker_kind
        self.expr_backend = expr_backend
        # where the torch backend's kernels run, handed to every rank:
        # CUDA unless the caller names another device, never the CPU on
        # its own (external workers take their own --device)
        self.device = expr_device(expr_backend, device)
        self.stats = ExecStats()
        self.worker_stats: List[ExecStats] = []
        # per-rank span lists from the last traced query ([] when tracing
        # was off) — the Session merges these into its QueryTrace
        self.worker_spans: List[List] = []
        # shard page bytes shipped in SETUP frames by the last query —
        # 0 for non-connect launches (shards ride the fork image / shared
        # address space) and for fully warm `--serve` reconnects
        self.last_setup_bytes = 0

    # ------------------------------------------------------------ public
    def execute(self, sink: Computation) -> Dict[str, np.ndarray]:
        return self.execute_program(compile_graph(sink))

    def execute_program(self, prog: TCAPProgram,
                        plan: Optional[PhysicalPlan] = None,
                        steps=None, trace=None) -> Dict[str, np.ndarray]:
        # `steps` (the Session's locally compiled stage plan) is accepted
        # for interface parity with Executor and ignored: each worker
        # compiles its own stages from the shipped program, deduplicated by
        # the process-wide kernel LRU. `trace` is a SpanRecorder for the
        # driver's own spans; it also switches per-rank recording on in
        # every worker (spans ship back inside the done stats frame).
        rec = NULL if trace is None else trace
        self.stats = ExecStats()
        self.worker_spans = []
        if self.do_optimize:
            prog, rep = optimize(prog)
            self.stats.optimizer = rep
            plan = None
        if plan is None:
            plan = plan_physical(prog, self.store, self.broadcast_threshold,
                                 num_partitions=self.P)
        with using(rec):
            with rec.span("placement", cat="driver"):
                placement = place_scans(prog, self.store, self.P)
                shards = [build_shard_store(self.store, placement, w)
                          for w in range(self.P)]
            self.last_setup_bytes = 0
            if self.worker_kind == "socket":
                runtime = _SocketRuntime(
                    self.P, self.socket_launch,
                    self.socket_addr or ("127.0.0.1", 0),
                    self.socket_accept_timeout)
                versions = {name: self.store.set_version(name)
                            for name in placement}
                outputs, self.worker_stats, self.worker_spans = runtime.run(
                    prog, plan, shards, self.vector_rows, self.expr_backend,
                    trace=rec.enabled, rec=rec, set_versions=versions,
                    device=self.device)
                self.last_setup_bytes = runtime.setup_bytes
            else:
                runtime = (_ThreadRuntime if self.worker_kind == "thread"
                           else _ProcessRuntime)(self.P)
                outputs, self.worker_stats, self.worker_spans = runtime.run(
                    prog, plan, shards, self.vector_rows, self.expr_backend,
                    trace=rec.enabled, rec=rec, device=self.device)
            self._aggregate_stats(prog, plan)
            with rec.span("assemble", cat="driver"):
                result = self._assemble(prog, outputs)
        return result

    # --------------------------------------------------------- internals
    def _aggregate_stats(self, prog: TCAPProgram, plan: PhysicalPlan) -> None:
        agg = self.stats
        for ws in self.worker_stats:
            agg.pages_scanned += ws.pages_scanned
            agg.rows_scanned += ws.rows_scanned
            agg.rows_joined += ws.rows_joined
            agg.shuffle_bytes += ws.shuffle_bytes
        # join and elision counters per plan decision (each worker
        # participates in every join/exchange, so summing worker counters
        # would multiply by N — the local executor counts each decision
        # once, and the aggregate view must match it)
        for op in prog.ops:
            if op.op == "JOIN":
                if plan.join_algo.get(id(op), "hash_partition") == "broadcast":
                    agg.broadcast_joins += 1
                else:
                    agg.hash_partition_joins += 1
                    agg.exchanges_elided += len(
                        plan.join_elide.get(id(op), ()))
            elif op.op == "AGG" and id(op) in plan.agg_elide:
                agg.exchanges_elided += 1

    def _assemble(self, prog: TCAPProgram,
                  outputs: List[List]) -> Dict[str, np.ndarray]:
        out_op = next((op for op in prog.ops if op.op == "OUTPUT"), None)
        if out_op is None:
            return {}
        # rank order == local partition order, so the shared OUTPUT
        # contract sees batches exactly as the local executor does
        batches = [decode_batch(block)
                   for w in range(self.P) for block in outputs[w]]
        return assemble_output(out_op, batches, self.stats, self.store,
                               self.write_outputs)


@dataclasses.dataclass
class _Collected:
    outputs: List[List]
    stats: List[Optional[ExecStats]]
    spans: List[List]  # per rank; [] when that worker did not trace

    def present(self) -> Tuple[List[List], List[ExecStats], List[List]]:
        """outputs + the stats/spans of the workers that reported."""
        return (self.outputs, [s for s in self.stats if s is not None],
                self.spans)


class _StarRouter:
    """The star-routing mechanism the process-backed runtimes share: one
    pump thread per source drains that worker and routes driver-bound
    messages; one sender thread per destination serializes forwards, so a
    blocked write never stalls draining (the P>=3 deadlock fix); an ABORT
    broadcast on failure unwinds peers blocked in ``recv``. Parametrized
    by the medium: ``read(src)`` returns the next ``(rank, dst, tag,
    msg)`` from that worker (``None`` on clean EOF, raising on transport
    errors); ``write(dst, (src, tag, msg))`` forwards one message.
    Teardown ordering differs per medium, so the runtime composes
    ``stop_senders``/``join_*`` itself."""

    def __init__(self, P: int, read, write):
        self.P = P
        self._read = read
        self._write = write
        self.driver_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._out = [queue.SimpleQueue() for _ in range(P)]
        self._stop = object()
        self._tag_done = [False] * P
        self._senders = [threading.Thread(target=self._sender, args=(d,),
                                          daemon=True) for d in range(P)]
        self._pumps = [threading.Thread(target=self._pump, args=(s,),
                                        daemon=True) for s in range(P)]

    def start(self) -> None:
        for t in self._senders + self._pumps:
            t.start()

    def collect_or_abort(self) -> _Collected:
        """Drain until every worker reports done; on failure, broadcast
        ABORT to every worker before re-raising so peers blocked in recv
        unwind immediately instead of stalling into the join timeout."""
        try:
            return _collect(self.driver_queue, self.P)
        except Exception:
            for q in self._out:
                q.put((DRIVER, ABORT, None))
            raise

    def stop_senders(self) -> None:
        for q in self._out:
            q.put(self._stop)

    def join_senders(self, timeout: float) -> None:
        for t in self._senders:
            t.join(timeout=timeout)

    def join_pumps(self, timeout: float) -> None:
        for t in self._pumps:
            t.join(timeout=timeout)

    # ------------------------------------------------------------ threads
    def _sender(self, dst: int) -> None:
        q = self._out[dst]
        while True:
            item = q.get()
            if item is self._stop:
                return
            try:
                self._write(dst, item)
            except OSError:
                return  # dst died; its pump reports the failure

    def _pump(self, src: int) -> None:
        while True:
            try:
                frame = self._read(src)
            except Exception as e:
                if not self._tag_done[src]:
                    self.driver_queue.put(
                        (src, "error",
                         f"worker {src} connection failed mid-frame: {e}"))
                return
            if frame is None:
                if not self._tag_done[src]:
                    self.driver_queue.put(
                        (src, "error",
                         f"worker {src} died unexpectedly "
                         "(connection closed)"))
                return
            rank, dst, tag, msg = frame
            if dst == DRIVER:
                if tag in ("done", "error"):
                    self._tag_done[src] = True
                    self.driver_queue.put((rank, tag, msg))
                    if tag == "error":
                        return
                else:
                    self.driver_queue.put((rank, tag, msg))
            elif isinstance(dst, int) and 0 <= dst < self.P:
                self._out[dst].put((rank, tag, msg))
            else:
                # a version-skewed or confused peer (e.g. built for a
                # different P) — mis-routing would deliver to the wrong
                # worker, and a dead pump would hang _collect forever
                self.driver_queue.put(
                    (src, "error",
                     f"worker {src} sent a frame for invalid "
                     f"destination {dst!r} (P={self.P})"))
                return


class _ThreadRuntime:
    """Workers as threads; mailboxes are in-process queues. Worker→worker
    messages go peer-to-peer; only OUTPUT/stats touch the driver queue."""

    def __init__(self, P: int):
        self.P = P

    def run(self, prog: TCAPProgram, plan: PhysicalPlan,
            shards: List[PagedStore], vector_rows: int,
            expr_backend: str = "numpy", trace: bool = False, rec=NULL,
            device=None) -> Tuple[List[List], List[ExecStats], List[List]]:
        worker_queues = [queue.SimpleQueue() for _ in range(self.P)]
        driver_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        threads = []
        with rec.span("launch", cat="driver", kind="thread"):
            for rank in range(self.P):
                tr = ThreadTransport(rank, worker_queues, driver_queue)
                t = threading.Thread(
                    target=worker_main,
                    args=(rank, self.P, tr, shards[rank], vector_rows, prog,
                          plan, expr_backend, trace, None, device),
                    name=f"pc-worker-{rank}", daemon=True)
                threads.append(t)
                t.start()
        try:
            with rec.span("collect", cat="wait"):
                col = _collect(driver_queue, self.P)
        except Exception:
            # unblock peers stuck in recv waiting on the failed worker —
            # otherwise they'd pin their shard stores for the process
            # lifetime
            for q in worker_queues:
                q.put((DRIVER, ABORT, None))
            for t in threads:
                t.join(timeout=10)
            raise
        for t in threads:
            t.join()
        return col.present()


class _ProcessRuntime:
    """Workers as forked processes; the driver routes worker→worker
    messages over per-worker duplex pipes (a star topology — one recv
    thread per worker so a blocked forward never stalls draining)."""

    def __init__(self, P: int):
        self.P = P

    def run(self, prog: TCAPProgram, plan: PhysicalPlan,
            shards: List[PagedStore], vector_rows: int,
            expr_backend: str = "numpy", trace: bool = False, rec=NULL,
            device=None) -> Tuple[List[List], List[ExecStats], List[List]]:
        # `device` is unused: the capability rules refuse fork workers on
        # the torch backend, so forked children run no kernel
        import multiprocessing as mp
        try:
            ctx = mp.get_context("fork")
        except ValueError as e:  # pragma: no cover - non-fork platforms
            raise RuntimeError(
                "worker_kind='fork' needs the fork start method (native "
                "lambdas in TCAP programs cannot be pickled; they ride the "
                "fork image) — use worker_kind='thread' here") from e
        pipes = [ctx.Pipe(duplex=True) for _ in range(self.P)]
        procs = []
        with rec.span("launch", cat="driver", kind="fork"):
            for rank in range(self.P):
                # fork inherits prog/plan/shards copy-on-write; the child
                # only ever touches its own pipe end
                p = ctx.Process(
                    target=_process_child,
                    args=(rank, self.P, pipes[rank][1], shards[rank],
                          vector_rows, prog, plan, expr_backend, trace),
                    name=f"pc-worker-{rank}", daemon=True)
                procs.append(p)
                p.start()
                pipes[rank][1].close()  # child's end, in the parent

        conns = [pipes[rank][0] for rank in range(self.P)]

        def pipe_read(src: int):
            try:
                return conns[src].recv()  # (rank, dst, tag, msg)
            except EOFError:
                return None

        router = _StarRouter(
            self.P, read=pipe_read,
            write=lambda dst, item: conns[dst].send(item))
        router.start()
        try:
            # on failure collect_or_abort broadcasts the same ABORT the
            # thread runtime does: peers blocked in recv unwind instead
            # of stalling into the 30 s join timeout and a SIGTERM
            with rec.span("collect", cat="wait"):
                col = router.collect_or_abort()
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():  # pragma: no cover - hung worker
                    p.terminate()
            router.stop_senders()
        return col.present()


def _process_child(rank: int, P: int, conn, shard: PagedStore,
                   vector_rows: int, prog: TCAPProgram, plan: PhysicalPlan,
                   expr_backend: str,
                   trace: bool = False) -> None:  # pragma: no cover - forked
    tr = ProcessTransport(rank, conn)
    worker_main(rank, P, tr, shard, vector_rows, prog, plan, expr_backend,
                trace)
    conn.close()


def _socket_child(rank: int, P: int, addr: Tuple[str, int], epoch: str,
                  shard: PagedStore, vector_rows: int, prog: TCAPProgram,
                  plan: PhysicalPlan, expr_backend: str,
                  trace: bool = False, device=None) -> None:
    """A driver-launched socket worker (fork child or in-process thread):
    dial the rendezvous with its pre-assigned rank, then run the shard
    (the torch backend's kernels on ``device``)."""
    try:
        sock, _welcome = connect_worker(addr, rank=rank, epoch=epoch,
                                        retry_seconds=10.0)
    except OSError:  # pragma: no cover - driver died first
        return  # the rendezvous reports the missing worker
    tr = SocketTransport(rank, sock)
    worker_main(rank, P, tr, shard, vector_rows, prog, plan, expr_backend,
                trace, device=device)
    tr.close()


class _SocketRuntime:
    """Workers over framed TCP, the driver routing worker→worker frames —
    the fork star with sockets for pipes (same per-destination sender
    threads so a blocked forward never stalls draining, same ABORT
    broadcast so a dead peer unwinds the query instead of hanging a
    ``recv``). The rendezvous: workers dial the advertised host:port,
    handshake rank/epoch (a per-query epoch rejects stale reconnects),
    then frames flow until every worker reports done.

    The *runtime* lifecycle (listener, launched processes, connections,
    router) is split from the *query* lifecycle: :meth:`open` binds the
    listener, :meth:`run` executes one query, and :meth:`shutdown` tears
    everything down. ``shutdown()`` is idempotent — every exit path
    (clean completion, ABORT, rendezvous timeout, a raise mid-teardown)
    funnels through it, so a double close can never leak the listener
    socket or orphan a worker process. The persistent
    :class:`~repro_torch.service.service.QueryService` holds its own pool; this
    runtime stays the one-shot per-query realization.

    ``--serve`` workers (``socket_launch="connect"``) retain their shard
    across reconnects: their HELLO announces what they hold (set name →
    version, plus the rank/P they held it for), the rendezvous hands a
    reconnecting worker its previous rank back when free, and SETUP then
    ships a ``("held", version)`` manifest reference instead of the page
    bytes — zero shard bytes on the wire for the warm path
    (``setup_bytes`` counts what actually shipped)."""

    def __init__(self, P: int, launch: str, addr: Tuple[str, int],
                 accept_timeout: float):
        self.P = P
        self.launch = launch
        self.addr = addr
        self.accept_timeout = accept_timeout
        # runtime state, torn down (once) by shutdown()
        self._listener = None
        self._conns: List = []
        self._procs: List = []
        self._worker_threads: List[threading.Thread] = []
        self._router: Optional[_StarRouter] = None
        self._closed = False
        # shard page bytes actually shipped in SETUP frames this query —
        # 0 when every external worker reconnected warm
        self.setup_bytes = 0

    # ------------------------------------------------- runtime lifecycle
    def open(self) -> Tuple[str, int]:
        """Bind + listen; returns the advertised (host, port)."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            listener.bind(self.addr)
            listener.listen(self.P + 2)
        except BaseException:
            listener.close()
            raise
        self._listener = listener
        self._closed = False
        host, port = listener.getsockname()[:2]
        return ("127.0.0.1" if host in ("0.0.0.0", "") else host, port)

    def shutdown(self) -> None:
        """Tear the runtime down: stop the router's senders (queued ABORT
        frames reach the kernel buffers before the FIN), close every
        worker connection and the listener, reap launched processes and
        threads. Safe to call any number of times — the first call wins,
        later calls are no-ops (the ABORT path and the normal teardown
        both land here without double-closing anything)."""
        if self._closed:
            return
        self._closed = True
        if self._router is not None:
            self._router.stop_senders()
            self._router.join_senders(10)
        for c in self._conns:
            if c is None:
                continue
            try:
                c.close()
            except OSError:  # pragma: no cover - already torn down
                pass
        self._conns = []
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover - already closed
                pass
            self._listener = None
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():  # pragma: no cover - hung worker
                p.terminate()
        self._procs = []
        for t in self._worker_threads:
            t.join(timeout=10)
        self._worker_threads = []
        if self._router is not None:
            self._router.join_pumps(5)
            self._router = None

    # ------------------------------------------------------------ query
    def run(self, prog: TCAPProgram, plan: PhysicalPlan,
            shards: List[PagedStore], vector_rows: int,
            expr_backend: str = "numpy", trace: bool = False, rec=NULL,
            set_versions: Optional[Dict[str, int]] = None, device=None
            ) -> Tuple[List[List], List[ExecStats], List[List]]:
        if self.launch == "connect":
            try:
                pickle.dumps(prog)
            except Exception as e:
                raise ValueError(
                    "socket_launch='connect' ships the TCAP program to "
                    "external workers by pickling, and this program cannot "
                    f"be pickled ({e!r}) — native Python lambdas "
                    "(make_lambda) only exist in-process; express the "
                    "query in the lambda DSL, or run socket_launch='fork' "
                    "workers on the driver host") from e
        self.setup_bytes = 0
        versions = set_versions or {}
        host, port = self.open()
        advert = (host, port)
        epoch = os.urandom(8).hex()

        def setup_for(rank: int, held: Dict[str, int]) -> Dict:
            sets: Dict[str, Tuple] = {}
            for name, s in shards[rank].sets.items():
                ver = versions.get(name, 0)
                if held.get(name) == ver:
                    # the worker still holds this shard at this version
                    # (and was handed the same rank back): a manifest
                    # reference, zero page bytes on the wire
                    sets[name] = ("held", ver)
                else:
                    block = PageBlock(s.dtype.descr, s.to_payloads(), ())
                    self.setup_bytes += block.nbytes
                    sets[name] = ("pages", s.page_size, s.dtype, block, ver)
            return {"prog": prog, "plan": plan_to_wire(prog, plan),
                    "vector_rows": vector_rows,
                    "expr_backend": expr_backend, "sets": sets,
                    "trace": trace}

        try:
            with rec.span("launch", cat="driver",
                          kind=f"socket/{self.launch}"):
                if self.launch == "fork":
                    import multiprocessing as mp
                    try:
                        ctx = mp.get_context("fork")
                    except ValueError as e:  # pragma: no cover - non-fork
                        raise RuntimeError(
                            "socket_launch='fork' needs the fork start "
                            "method (native lambdas in TCAP programs cannot "
                            "be pickled; they ride the fork image) — use "
                            "socket_launch='thread' here, or external "
                            "workers via socket_launch='connect'") from e
                    for rank in range(self.P):
                        p = ctx.Process(
                            target=_socket_child,
                            args=(rank, self.P, advert, epoch, shards[rank],
                                  vector_rows, prog, plan, expr_backend,
                                  trace),
                            name=f"pc-worker-{rank}", daemon=True)
                        self._procs.append(p)
                        p.start()
                elif self.launch == "thread":
                    for rank in range(self.P):
                        t = threading.Thread(
                            target=_socket_child,
                            args=(rank, self.P, advert, epoch, shards[rank],
                                  vector_rows, prog, plan, expr_backend,
                                  trace, device),
                            name=f"pc-worker-{rank}", daemon=True)
                        self._worker_threads.append(t)
                        t.start()
                else:
                    print(f"driver: waiting for {self.P} workers at "
                          f"{host}:{port} (python -m repro_torch.dist.worker "
                          f"--connect {host}:{port})",
                          file=sys.stderr)

            with rec.span("rendezvous", cat="driver", launch=self.launch):
                self._conns = self._rendezvous(self._listener, epoch,
                                               setup_for)
            conns = self._conns
            with rec.span("route:start", cat="driver"):
                self._router = _StarRouter(
                    self.P, read=lambda src: read_frame(conns[src]),
                    write=lambda dst, item: write_frame(
                        conns[dst], item[0], dst, item[1], item[2]))
                self._router.start()
            with rec.span("collect", cat="wait"):
                col = self._router.collect_or_abort()
        finally:
            with rec.span("teardown", cat="driver"):
                self.shutdown()
        return col.present()

    def _rendezvous(self, listener, epoch: str, setup_for):
        """Accept until all P ranks joined (or the deadline passes):
        verify HELLO (protocol version; for driver-launched workers also
        the per-query epoch and the pre-assigned rank), reply WELCOME,
        and for external workers ship the SETUP frame. External workers
        get their previous rank back when it is free (so retained shards
        stay valid — otherwise the next free rank, shipped cold). Rogue
        or stale connections are dropped without consuming a slot."""
        conns: List = [None] * self.P
        deadline = time.monotonic() + self.accept_timeout
        pending = self.P
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            listener.settimeout(min(remaining, 1.0))
            try:
                c, _peer = listener.accept()
            except socket.timeout:
                continue
            except OSError:  # pragma: no cover - listener torn down
                break
            try:
                configure_socket(c)
                c.settimeout(min(max(remaining, 1.0), 15.0))
                frame = read_frame(c)
                if frame is None:
                    raise ProtocolError("closed during handshake")
                _, _, tag, hello = frame
                if (tag != HELLO or not isinstance(hello, dict)
                        or hello.get("proto") != PROTO_VERSION):
                    raise ProtocolError("bad hello")
                held: Dict[str, int] = {}
                if self.launch == "connect":
                    rank = conns.index(None)
                    prev = hello.get("prev") or {}
                    pr = prev.get("rank")
                    if (prev.get("P") == self.P and isinstance(pr, int)
                            and 0 <= pr < self.P and conns[pr] is None):
                        # same rank + same P: the retained shards are the
                        # shards this query's placement gives that rank
                        rank = pr
                        held = hello.get("held") or {}
                else:
                    if hello.get("epoch") != epoch:
                        raise ProtocolError("stale epoch")
                    rank = hello.get("rank")
                    if (not isinstance(rank, int)
                            or not 0 <= rank < self.P
                            or conns[rank] is not None):
                        raise ProtocolError("bad rank")
                write_frame(c, DRIVER, rank, WELCOME,
                            {"rank": rank, "P": self.P, "epoch": epoch})
                # SETUP carries the whole shard's page bytes — it must
                # not run under the (small) handshake timeout, or a big
                # shard / slow link gets the worker dropped mid-frame
                c.settimeout(None)
                if self.launch == "connect":
                    write_frame(c, DRIVER, rank, SETUP,
                                setup_for(rank, held))
                conns[rank] = c
                pending -= 1
            except (ProtocolError, OSError):
                try:
                    c.close()
                except OSError:  # pragma: no cover
                    pass
        if pending:
            for c in conns:
                if c is not None:
                    c.close()
            raise RuntimeError(
                f"socket rendezvous timed out after "
                f"{self.accept_timeout:.0f}s: {self.P - pending}/{self.P} "
                "workers connected")
        return conns


def _collect(driver_queue: "queue.SimpleQueue", P: int) -> _Collected:
    """Drain driver-bound messages until every worker reports done."""
    outputs: List[List] = [[] for _ in range(P)]
    stats: List[Optional[ExecStats]] = [None] * P
    spans: List[List] = [[] for _ in range(P)]
    remaining = P
    while remaining:
        src, tag, msg = driver_queue.get()
        if tag == "error":
            raise RuntimeError(f"worker {src} failed:\n{msg}")
        if tag == "done":
            if isinstance(msg, StatsFrame):
                stats[src] = msg.stats
                spans[src] = msg.spans
            else:  # a pre-StatsFrame peer (bare ExecStats)
                stats[src] = msg
            remaining -= 1
        else:  # an OUTPUT gather ("<i>:output")
            outputs[src] = msg
    return _Collected(outputs, stats, spans)
