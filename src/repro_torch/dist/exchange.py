"""The exchange layer: transports + the three communication patterns.

Patterns (each operating on page blocks, tagged by TCAP op index so
concurrent exchanges of one program never interleave):

* :func:`exchange_partitions` — hash-partition shuffle (JOIN sides, one
  call per side): every worker sends each peer that peer's bucket of
  sub-batches and keeps its own bucket unserialized (locality is free);
* :func:`all_gather` — broadcast: every worker replicates its batches to
  all peers (small-side joins; serialized once, shipped P-1 times);
* :func:`gather_to` — gather-merge: everyone ships to one root (TOPK's
  global merge at worker 0, OUTPUT's collect at the driver).

Three transports behind one interface:

* :class:`ThreadTransport` — per-worker in-process mailboxes;
* :class:`ProcessTransport` — a duplex pipe per forked worker, with the
  driver routing worker→worker messages (a star);
* :class:`SocketTransport` — one framed TCP connection to the driver,
  which routes worker→worker frames over the same star — the true
  multi-host transport (workers may live on other machines; see
  ``python -m repro_torch.dist.worker --connect host:port``).

All move the same serialized page blocks, so ``shuffle_bytes`` measures
identical traffic regardless of the worker kind. ``recv`` buffers by
(source, tag): the exchange schedule is SPMD-deterministic, but message
*arrival* order is not.
"""
from __future__ import annotations

import queue
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.executor import ExecStats
from repro_torch.dist.protocol import (ABORT, DRIVER, decode_batch, encode_batch,
                                 read_frame, write_frame)
from repro_torch.obs.trace import current
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = ["PeerAborted", "ThreadTransport", "ProcessTransport",
           "SocketTransport", "exchange_partitions", "all_gather",
           "gather_to"]


class PeerAborted(RuntimeError):
    """Raised inside a worker's ``recv`` when the driver broadcasts ABORT
    (a peer failed): the worker must stop waiting for messages that will
    never arrive and unwind."""


class ThreadTransport:
    """In-process transport: one queue per worker plus the driver's."""

    def __init__(self, rank: int, worker_queues: List["queue.SimpleQueue"],
                 driver_queue: "queue.SimpleQueue"):
        self.rank = rank
        self._queues = worker_queues
        self._driver = driver_queue
        self._buffer: Dict[Tuple[int, str], deque] = {}

    def send(self, dst: int, tag: str, msg: Any) -> None:
        q = self._driver if dst == DRIVER else self._queues[dst]
        q.put((self.rank, tag, msg))

    def recv(self, src: int, tag: str) -> Any:
        want = (src, tag)
        buf = self._buffer.get(want)
        if buf:
            return buf.popleft()
        while True:
            got_src, got_tag, msg = self._queues[self.rank].get()
            if got_src == DRIVER and got_tag == ABORT:
                raise PeerAborted("a peer worker failed; aborting")
            if (got_src, got_tag) == want:
                return msg
            self._buffer.setdefault((got_src, got_tag),
                                    deque()).append(msg)


class ProcessTransport:
    """Forked-worker transport: a duplex pipe to the driver, which routes
    worker→worker messages (see ``driver._ProcessRuntime``)."""

    def __init__(self, rank: int, conn):
        self.rank = rank
        self._conn = conn
        self._buffer: Dict[Tuple[int, str], deque] = {}

    def send(self, dst: int, tag: str, msg: Any) -> None:
        self._conn.send((self.rank, dst, tag, msg))

    def recv(self, src: int, tag: str) -> Any:
        want = (src, tag)
        buf = self._buffer.get(want)
        if buf:
            return buf.popleft()
        while True:
            got_src, got_tag, msg = self._conn.recv()
            if got_src == DRIVER and got_tag == ABORT:
                raise PeerAborted("a peer worker failed; aborting")
            if (got_src, got_tag) == want:
                return msg
            self._buffer.setdefault((got_src, got_tag),
                                    deque()).append(msg)


class SocketTransport:
    """TCP transport: one length-prefixed framed connection to the driver,
    which routes worker→worker frames (the same star topology as the fork
    router — peers never dial each other, so workers only need to reach
    the driver's advertised host:port). Page payloads cross as raw bytes
    (no pickle copy; see :mod:`repro_torch.dist.protocol`). The socket has a
    single writer — the worker's own thread."""

    def __init__(self, rank: int, sock):
        self.rank = rank
        self.sock = sock
        self._buffer: Dict[Tuple[int, str], deque] = {}

    def send(self, dst: int, tag: str, msg: Any) -> None:
        write_frame(self.sock, self.rank, dst, tag, msg)

    def recv(self, src: int, tag: str) -> Any:
        want = (src, tag)
        buf = self._buffer.get(want)
        if buf:
            return buf.popleft()
        while True:
            frame = read_frame(self.sock)
            if frame is None:
                raise PeerAborted(
                    "driver connection closed mid-query; aborting")
            got_src, _dst, got_tag, msg = frame
            if got_src == DRIVER and got_tag == ABORT:
                raise PeerAborted("a peer worker failed; aborting")
            if (got_src, got_tag) == want:
                return msg
            self._buffer.setdefault((got_src, got_tag),
                                    deque()).append(msg)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- patterns
def exchange_partitions(tr, P: int, tag: str,
                        buckets: List[List[VectorList]],
                        stats: ExecStats) -> List[List[VectorList]]:
    """Hash-partition shuffle. ``buckets[p]`` is what this worker routed to
    partition ``p`` (sub-batches in batch order). Returns, per source rank,
    the sub-batches that landed here — own bucket stays unserialized."""
    rank = tr.rank
    sb0 = stats.shuffle_bytes
    with current().span(f"x:shuffle:{tag}", cat="exchange", tag=tag) as sp:
        for dst in range(P):
            if dst == rank:
                continue
            blocks = [encode_batch(vl) for vl in buckets[dst]]
            stats.shuffle_bytes += sum(b.nbytes for b in blocks)
            tr.send(dst, tag, blocks)
        inbox: List[List[VectorList]] = []
        for src in range(P):
            if src == rank:
                inbox.append(buckets[rank])
            else:
                inbox.append([decode_batch(b) for b in tr.recv(src, tag)])
    sp.set(bytes=stats.shuffle_bytes - sb0)
    return inbox


def all_gather(tr, P: int, tag: str, batches: List[VectorList],
               stats: ExecStats) -> List[List[VectorList]]:
    """Broadcast: replicate this worker's batches to every peer; returns
    all workers' batches in rank order (serialize once, ship P-1 times)."""
    rank = tr.rank
    sb0 = stats.shuffle_bytes
    with current().span(f"x:bcast:{tag}", cat="exchange", tag=tag) as sp:
        blocks = None
        for dst in range(P):
            if dst == rank:
                continue
            if blocks is None:
                blocks = [encode_batch(vl) for vl in batches]
            stats.shuffle_bytes += sum(b.nbytes for b in blocks)
            tr.send(dst, tag, blocks)
        out = [batches if src == rank else
               [decode_batch(b) for b in tr.recv(src, tag)]
               for src in range(P)]
    sp.set(bytes=stats.shuffle_bytes - sb0)
    return out


def gather_to(tr, P: int, tag: str, root: int,
              batches: List[VectorList],
              stats: ExecStats) -> Optional[List[List[VectorList]]]:
    """Gather-merge: every worker ships its batches to ``root`` (a worker
    rank, or :data:`DRIVER`). Returns the per-source batch lists at the
    root, ``None`` elsewhere."""
    rank = tr.rank
    sb0 = stats.shuffle_bytes
    with current().span(f"x:gather:{tag}", cat="exchange", tag=tag) as sp:
        if rank != root:
            blocks = [encode_batch(vl) for vl in batches]
            stats.shuffle_bytes += sum(b.nbytes for b in blocks)
            tr.send(root, tag, blocks)
            out = None
        else:
            out = [batches if src == rank else
                   [decode_batch(b) for b in tr.recv(src, tag)]
                   for src in range(P)]
    sp.set(bytes=stats.shuffle_bytes - sb0)
    return out
