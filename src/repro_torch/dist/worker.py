"""The worker runtime: SPMD execution of one TCAP program over one shard
(port of ``repro.dist.worker``; on ``expr_backend="torch"`` every fused
stage's numeric core and the shard's pre-aggregation run through the
hand-written kernels on the rank's device).

Every worker runs the *same* op sequence (the paper's staged plan), calling
the same per-partition kernels as the local simulated executor
(:mod:`repro_torch.core.relops`) over its own :class:`~repro_torch.objectmodel.store
.PagedStore` shard, and hitting the exchange layer at the ops the physical
plan stages across workers:

* JOIN — ``all_gather`` of the build side (broadcast) or
  ``exchange_partitions`` of both sides (hash-partition shuffle);
* AGG — pre-aggregate locally, ``exchange_partitions`` of the partial maps
  by key hash, final merge;
* TOPK — local per-batch top-k, ``gather_to`` worker 0, global merge there;
* OUTPUT — ``gather_to`` the driver.

Because placement is the same greedy-by-bytes rule the local executor
simulates and
exchanges preserve (source rank, batch) order, results are byte-identical
to ``Executor`` with ``num_partitions == num_workers`` — enforced by
``tests/test_torch_dist.py``.

Thread ranks sharing a card queue their kernels on its current stream
(a stream per rank was 5-6% slower for Q1 at SF 10 on 4 thread workers,
in two runs on one H100). The thread ranks of one process run fused
stage batches one at a time (``_FUSED``): a batch is a few hundred µs of
host work in many short numpy calls, each of which lets go of the GIL
and takes it back, and ranks interleaving them hand the GIL over at every
call; one at a time they run at one thread's speed, while the ranks
still overlap what runs without the GIL (the key discovery's sort, the
AGG's packing).
"""
from __future__ import annotations

import socket
import time
import traceback
from typing import Dict, List, Optional, Tuple

import threading

import numpy as np

from repro_torch.core.executor import ExecStats
from repro_torch.core.exprc import FusedStage, build_steps, expr_device
from repro_torch.core.physical import PhysicalPlan, plan_from_wire
from repro_torch.core.relops import (AggMap, AggSpec, batch_kernel, batch_topk,
                               concat_batches, device_segment_reducer,
                               merge_topk, probe_join, split_by_hash)
from repro_torch.core.tcap import TCAPOp, TCAPProgram
from repro_torch.dist.exchange import (PeerAborted, SocketTransport, all_gather,
                                 exchange_partitions, gather_to)
from repro_torch.dist.protocol import (DRIVER, HELLO, PROTO_VERSION, SETUP,
                                 WELCOME, ProtocolError, StatsFrame,
                                 configure_socket, decode_agg_map,
                                 encode_agg_map, read_frame, write_frame)
from repro_torch.obs.trace import NULL, SpanRecorder, op_name, using
from repro_torch.objectmodel.store import PagedSet, PagedStore
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = ["WorkerRuntime", "worker_main", "connect_worker",
           "build_setup_shard", "run_remote_worker", "main"]

# one fused batch at a time across the process's thread ranks (see above)
_FUSED = threading.Lock()


def _batch_rows(batches: List[VectorList]) -> int:
    """Total rows across a batch list (trace attribute only — called
    solely when a recorder is enabled)."""
    return sum(vl.num_rows or 0 for vl in batches)


class WorkerRuntime:
    """One worker: a rank, its shard store, and a transport to its peers.
    On ``expr_backend="torch"`` its kernels run on ``device``: CUDA unless
    the caller names another device (``models.resolve_device``)."""

    def __init__(self, rank: int, num_workers: int, transport,
                 shard: PagedStore, vector_rows: int = 8192,
                 expr_backend: str = "numpy", device=None):
        self.rank = rank
        self.P = num_workers
        self.tr = transport
        self.store = shard
        self.vector_rows = vector_rows
        self.expr_backend = expr_backend
        self.device = expr_device(expr_backend, device)
        self.stats = ExecStats()

    # ------------------------------------------------------------ driver
    def run(self, prog: TCAPProgram, plan: PhysicalPlan, rec=NULL) -> None:
        """Execute the program; OUTPUT batches stream to the driver.
        ``rec`` is this rank's span recorder (per-op spans; the exchange
        patterns pick it up ambiently via ``obs.trace.using``).

        The worker compiles its own stage plan from the shipped program
        (:func:`~repro_torch.core.exprc.build_steps`) — compilation is
        deterministic and the kernel LRU is process-wide, so thread workers
        share one jitted kernel per query shape and fork workers rebuild
        identical ones (prefer ``worker_kind="thread"`` with
        ``expr_backend="torch"``: CUDA's context does not survive a
        fork taken after torch initialized CUDA in the parent). Exchange
        ops index the program by op position, so the fused steps are
        walked with their op indices preserved."""
        self.stats = ExecStats()
        steps = build_steps(prog, self.expr_backend, self.device)
        data: Dict[str, List[VectorList]] = {}
        i = -1  # op index within prog (exchange tags key on it)
        for step in steps:
            if isinstance(step, FusedStage):
                first, i = i + 1, i + len(step.ops)
                name = op_name(first, i, [o.op for o in step.ops])
                with rec.span(name, cat="op", idx=first) as sp:
                    data[step.out] = [_fused_batch(step, vl)
                                      for vl in data[step.in_list]]
                if rec.enabled:
                    sp.set(rows=_batch_rows(data[step.out]))
                continue
            op = step
            i += 1
            sb0 = self.stats.shuffle_bytes
            with rec.span(op_name(i, i, [op.op]), cat="op",
                          idx=i, op=op.op) as sp:
                if op.op == "SCAN":
                    data[op.out] = self._scan(op)
                elif op.op in ("APPLY", "FILTER", "FLATTEN", "HASH"):
                    kern = batch_kernel(op)
                    data[op.out] = [kern(vl) for vl in data[op.in_list]]
                elif op.op == "JOIN":
                    algo = plan.join_algo.get(id(op), "hash_partition")
                    data[op.out] = self._join(
                        op, i, data[op.in_list], data[op.in_list2], algo,
                        elide=plan.join_elide.get(id(op), ()))
                elif op.op == "AGG":
                    data[op.out] = self._aggregate(
                        op, i, data[op.in_list],
                        elide=id(op) in plan.agg_elide)
                elif op.op == "TOPK":
                    data[op.out] = self._topk(op, i, data[op.in_list])
                elif op.op == "OUTPUT":
                    self._output(op, i, data[op.in_list])
                else:
                    raise ValueError(f"unknown op {op.op}")
            if rec.enabled:
                sp.set(rows=(self.stats.rows_output if op.op == "OUTPUT"
                             else _batch_rows(data[op.out])),
                       bytes=self.stats.shuffle_bytes - sb0)

    # --------------------------------------------------------------- ops
    def _scan(self, op: TCAPOp) -> List[VectorList]:
        s = self.store.get_set(op.info["set"])
        col = op.out_cols[0]
        batches: List[VectorList] = []
        for page_records in s.scan():
            self.stats.pages_scanned += 1
            self.stats.rows_scanned += len(page_records)
            for j in range(0, len(page_records), self.vector_rows):
                batches.append(
                    VectorList({col: page_records[j: j + self.vector_rows]}))
        return batches

    def _join(self, op: TCAPOp, i: int, left: List[VectorList],
              right: List[VectorList], algo: str,
              elide: Tuple[str, ...] = ()) -> List[VectorList]:
        if algo == "broadcast":
            self.stats.broadcast_joins += 1
            srcs = all_gather(self.tr, self.P, f"{i}:build", right,
                              self.stats)
            rvl = concat_batches([vl for src in srcs for vl in src])
            lvl = concat_batches(left)
        else:
            self.stats.hash_partition_joins += 1
            # an elided side was proven already hash-partitioned on its
            # join key (PL202): every row routes back to this rank, every
            # peer's split toward us is empty — the exchange is the
            # identity permutation. All ranks take the branch together
            # (join_elide ships with the wire plan), so no rank blocks
            # in recv.
            if "L" in elide:
                self.stats.exchanges_elided += 1
                lvl = concat_batches(left)
            else:
                lvl = self._shuffle_side(op.apply_cols[0], f"{i}:L", left)
            if "R" in elide:
                self.stats.exchanges_elided += 1
                rvl = concat_batches(right)
            else:
                rvl = self._shuffle_side(op.apply_cols2[0], f"{i}:R", right)
        probed = probe_join(op, lvl, rvl)
        if probed is None:
            return []
        res, n = probed
        self.stats.rows_joined += n
        return [res]

    def _shuffle_side(self, hash_name: str, tag: str,
                      batches: List[VectorList]) -> VectorList:
        buckets: List[List[VectorList]] = [[] for _ in range(self.P)]
        for vl in batches:
            for p, sub in enumerate(split_by_hash(vl, hash_name, self.P)):
                if sub is not None:
                    buckets[p].append(sub)
        inbox = exchange_partitions(self.tr, self.P, tag, buckets,
                                    self.stats)
        return concat_batches([vl for src in inbox for vl in src])

    def _aggregate(self, op: TCAPOp, i: int, batches: List[VectorList],
                   elide: bool = False) -> List[VectorList]:
        spec = AggSpec.from_op(op)
        kcols, acols = spec.key_cols(op), spec.acc_cols(op)
        reducer = (device_segment_reducer(spec.combiners, self.device)
                   if self.expr_backend == "torch" else None)
        # one absorb over the shard's concatenated rows (shared with the
        # local simulation — identical association order by construction)
        m = AggMap(spec)
        m.absorb_batches(batches, kcols, acols, reducer=reducer)
        if elide:
            # the planner proved this shard's rows are already stable_key_
            # hash-partitioned on the key tuple: every key in `m` routes
            # back to this rank, every peer's split toward us is empty —
            # the exchange is the identity permutation. All ranks take this
            # branch together (agg_elide ships with the wire plan), so no
            # rank blocks in recv.
            self.stats.exchanges_elided += 1
            emitted = m.emit()
            return [emitted] if emitted is not None else []
        split = m.split_by_key_hash(self.P)
        tag = f"{i}:partials"
        # packed multi-column partial maps ride the same page-block wire
        # as batches (accumulators cross the wire, never finalized means)
        for dst in range(self.P):
            if dst == self.rank:
                continue
            block = encode_agg_map(split[dst])
            if block is not None:
                self.stats.shuffle_bytes += block.nbytes
            self.tr.send(dst, tag, block)
        final = AggMap(spec)
        for src in range(self.P):
            if src == self.rank:
                part = split[self.rank]
            else:
                block = self.tr.recv(src, tag)
                part = (decode_agg_map(block, spec)
                        if block is not None else None)
            if part is not None and part.data:
                final.merge(part)
        emitted = final.emit()
        return [emitted] if emitted is not None else []

    def _topk(self, op: TCAPOp, i: int,
              batches: List[VectorList]) -> List[VectorList]:
        best_s: List[np.ndarray] = []
        best_p: List[np.ndarray] = []
        for vl in batches:
            s, pay = batch_topk(op, vl)
            best_s.append(s)
            best_p.append(pay)
        local = ([VectorList({"score": np.concatenate(best_s),
                              "payload": np.concatenate(best_p)})]
                 if best_s else [])
        gathered = gather_to(self.tr, self.P, f"{i}:topk", 0, local,
                             self.stats)
        if gathered is None:  # not the merge root
            return []
        cand_s = [np.asarray(vl["score"]) for src in gathered for vl in src]
        cand_p = [np.asarray(vl["payload"]) for src in gathered for vl in src]
        merged = merge_topk(op, cand_s, cand_p)
        return [merged] if merged is not None else []

    def _output(self, op: TCAPOp, i: int, batches: List[VectorList]) -> None:
        out = [vl.project(op.apply_cols) for vl in batches]
        self.stats.rows_output = sum(vl.num_rows or 0 for vl in out)
        gather_to(self.tr, self.P, f"{i}:output", DRIVER, out, self.stats)


def _fused_batch(step: FusedStage, vl: VectorList) -> VectorList:
    with _FUSED:
        return step(vl)


def worker_main(rank: int, num_workers: int, transport, shard: PagedStore,
                vector_rows: int, prog: TCAPProgram,
                plan: PhysicalPlan, expr_backend: str = "numpy",
                trace: bool = False, runtime_cls=None,
                device=None) -> bool:
    """Entry point for every worker kind: run, then report stats (or the
    failure) to the driver. With ``trace=True`` the worker records its own
    rank-attributed spans and ships them back inside the ``done`` stats
    frame. ``runtime_cls`` swaps the runtime (the service's resident
    worker injects its write-materializing subclass). ``device`` is where
    ``expr_backend="torch"`` runs its kernels. Returns whether the
    query completed here — False when it aborted (a peer failed) or this
    worker errored, so process-worker entry points can exit nonzero for
    supervisors."""
    rec = SpanRecorder(rank=rank) if trace else NULL
    try:
        rt = (runtime_cls or WorkerRuntime)(rank, num_workers, transport,
                                            shard, vector_rows, expr_backend,
                                            device)
        with using(rec):
            with rec.span("worker", cat="phase", rank=rank):
                rt.run(prog, plan, rec)
        transport.send(DRIVER, "done",
                       StatsFrame(rt.stats, list(rec.spans)))
        return True
    except PeerAborted:
        return False  # the driver raised already; nothing left to report
    except BaseException:
        try:
            transport.send(DRIVER, "error", traceback.format_exc())
        except Exception:
            pass  # transport already dead; the driver's pump reports it
        return False


# ----------------------------------------------------- socket rendezvous
def connect_worker(addr: Tuple[str, int], *, rank: Optional[int] = None,
                   epoch: Optional[str] = None, timeout: float = 30.0,
                   retry_seconds: float = 0.0,
                   hello_extra: Optional[Dict] = None):
    """Dial the driver's rendezvous at ``addr`` and handshake: send HELLO
    (protocol version + the launched worker's pre-assigned rank/epoch, or
    ``None`` for an external worker asking to be assigned one), expect
    WELCOME back. Returns ``(socket, welcome)`` with the socket blocking
    and Nagle disabled (exchange frames are latency-sensitive). With
    ``retry_seconds``, the initial TCP connect is retried until the window
    closes — external workers may be started before the driver listens.
    ``hello_extra`` rides along in the HELLO payload — ``--serve`` workers
    announce the shards they retained (``held``/``prev``) through it."""
    deadline = time.monotonic() + retry_seconds
    while True:
        try:
            sock = socket.create_connection(addr, timeout=timeout)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)
    try:
        configure_socket(sock)
        hello = {"proto": PROTO_VERSION, "rank": rank, "epoch": epoch}
        if hello_extra:
            hello.update(hello_extra)
        write_frame(sock, rank if rank is not None else DRIVER, DRIVER,
                    HELLO, hello)
        frame = read_frame(sock)
        if frame is None:
            raise ProtocolError(
                "driver closed the connection during handshake (stale "
                "epoch, duplicate rank, or a full rendezvous?)")
        _, _, tag, welcome = frame
        if tag != WELCOME or not isinstance(welcome, dict):
            raise ProtocolError(f"expected {WELCOME!r}, got {tag!r}")
        sock.settimeout(None)
        return sock, welcome
    except BaseException:
        sock.close()
        raise


def build_setup_shard(setup_sets: Dict,
                      retained: Optional[Dict[str, Tuple[int, PagedSet]]]
                      = None) -> PagedStore:
    """Materialize one SETUP frame's ``sets`` into a shard store. Entries
    are tagged (protocol v2): ``("pages", page_size, dtype, block, ver)``
    adopts shipped page bytes verbatim; ``("held", ver)`` reuses the
    retained :class:`PagedSet` from a previous connection at that version
    (the driver only emits it after the HELLO announced we hold it).
    With ``retained`` given, freshly shipped shards are recorded in it so
    the next reconnect can announce them."""
    shard = PagedStore()
    for name, entry in setup_sets.items():
        if entry[0] == "held":
            if retained is None or name not in retained:
                raise ProtocolError(
                    f"driver sent a 'held' reference for {name!r} but this "
                    "worker retains no such shard")
            ver, s = retained[name]
            if ver != entry[1]:
                raise ProtocolError(
                    f"'held' reference for {name!r} at version {entry[1]} "
                    f"but the retained shard is version {ver}")
            shard.sets[name] = s
        else:
            _, page_size, dtype, block, ver = entry
            s = PagedSet.from_payloads(name, dtype, block.payloads,
                                       page_size)
            shard.sets[name] = s
            if retained is not None:
                retained[name] = (ver, s)
    return shard


def run_remote_worker(addr: Tuple[str, int], serve: bool = False,
                      retry_seconds: float = 30.0,
                      device=None) -> Tuple[int, int]:
    """A worker on (potentially) another machine: connect to the driver's
    advertised ``host:port``, receive rank + the query setup (program,
    physical plan, this rank's shard pages — page bytes adopted verbatim),
    run it, report. One query per connection; with ``serve=True`` the
    worker reconnects for subsequent queries until the driver goes away —
    *retaining* its shard pages between connections and announcing them
    (set name → version, plus the rank/P they were placed for) in the
    HELLO, so a warm reconnect gets a ``("held", version)`` manifest
    reference instead of the page bytes.

    When the WELCOME says the far end is a persistent
    :class:`~repro_torch.service.service.QueryService` (``welcome["service"]``),
    the connection is handed to the resident loop — many queries share
    one connection, multiplexed by query id — and its counts are merged.

    A query on ``expr_backend="torch"`` runs its kernels on ``device``:
    CUDA unless another device is named.

    Returns ``(completed, failed)`` query counts — failed covers queries
    that aborted (a peer died) or errored here, so the entry point can
    exit nonzero for supervisors."""
    queries = 0
    failed = 0
    retained: Dict[str, Tuple[int, PagedSet]] = {}
    prev: Optional[Dict] = None  # {"rank": r, "P": P} from the last query
    # set after each served query: between queries the driver's
    # per-query listener flaps, so a redial can be refused or cut
    # mid-handshake (the dying listener's backlog is reset) just as the
    # next query's listener opens — those must be retried, bounded by
    # one retry window per gap. On the *first* dial (deadline unset) a
    # refusal or drop is a verdict (driver absent / rendezvous full).
    redial_deadline: Optional[float] = None
    while True:
        extra = ({"held": {n: v for n, (v, _) in retained.items()},
                  "prev": prev} if serve and prev is not None else None)
        window = (retry_seconds if redial_deadline is None
                  else redial_deadline - time.monotonic())
        if window <= 0:
            return queries, failed  # driver stayed gone; done serving
        try:
            sock, welcome = connect_worker(addr, retry_seconds=window,
                                           hello_extra=extra)
        except (OSError, ProtocolError):
            if redial_deadline is None:
                raise
            time.sleep(0.2)
            continue
        redial_deadline = None
        rank, P = int(welcome["rank"]), int(welcome["P"])
        if welcome.get("service"):
            from repro_torch.service.resident import serve_resident
            q, f = serve_resident(sock, welcome, device)
            queries += q
            failed += f
            if not serve:
                return queries, failed
            prev = None
            retained.clear()
            redial_deadline = time.monotonic() + retry_seconds
            continue
        frame = read_frame(sock)
        if frame is None:
            sock.close()
            raise ProtocolError("driver closed before shipping the query "
                                "setup")
        _, _, tag, setup = frame
        if tag != SETUP:
            sock.close()
            raise ProtocolError(f"expected {SETUP!r}, got {tag!r}")
        prog = setup["prog"]
        plan = plan_from_wire(prog, setup["plan"])
        if not serve:
            shard = build_setup_shard(setup["sets"])
        else:
            if prev is not None and (rank, P) != (prev["rank"], prev["P"]):
                # assigned a different rank (or the pool was resized) —
                # the retained shards are the wrong partition now; drop
                # them (the driver knows: on a rank/P mismatch it never
                # honors ``held`` and ships pages)
                retained.clear()
            shard = build_setup_shard(setup["sets"], retained)
        prev = {"rank": rank, "P": P}
        tr = SocketTransport(rank, sock)
        ok = worker_main(rank, P, tr, shard, setup["vector_rows"], prog,
                         plan, setup["expr_backend"],
                         trace=bool(setup.get("trace", False)),
                         device=device)
        tr.close()
        if ok:
            queries += 1
        else:
            failed += 1
        if not serve:
            return queries, failed
        redial_deadline = time.monotonic() + retry_seconds


def main(argv=None) -> int:
    """``python -m repro_torch.dist.worker --connect host:port`` — launch one
    worker process that joins a ``Session(backend="workers",
    worker_kind="socket", socket_launch="connect", ...)`` driver."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dist.worker",
        description="Join a PlinyCompute socket-transport driver as one "
                    "worker (true multi-host: run this on any machine "
                    "that can reach the driver's advertised host:port).")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="the driver's rendezvous address")
    ap.add_argument("--serve", action="store_true",
                    help="reconnect and serve subsequent queries until "
                         "the driver goes away (default: one query)")
    ap.add_argument("--retry-seconds", type=float, default=30.0,
                    help="keep retrying the initial connect this long "
                         "(the worker may be started before the driver)")
    ap.add_argument("--device", default=None,
                    help="where expr_backend='torch' queries run their "
                         "kernels (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        ap.error(f"--connect takes HOST:PORT, got {args.connect!r}")
    try:
        served, failed = run_remote_worker((host, int(port)),
                                           serve=args.serve,
                                           retry_seconds=args.retry_seconds,
                                           device=args.device)
    except (OSError, ProtocolError) as e:
        # e.g. driver unreachable, or accepted-then-dropped (rendezvous
        # already full: more workers dialed than num_workers)
        print(f"worker: could not join the driver at {args.connect}: {e}",
              file=sys.stderr)
        return 1
    print(f"worker: served {served} "
          f"quer{'y' if served == 1 else 'ies'}"
          + (f", {failed} aborted/failed" if failed else ""),
          file=sys.stderr)
    # nonzero when any query did not complete here (peer death or own
    # error) so a supervisor keyed on the exit code can react
    return 1 if failed else 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys
    sys.exit(main())
