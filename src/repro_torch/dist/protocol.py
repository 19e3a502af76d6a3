"""Wire protocol for the exchange layer: page blocks + TCP framing.

A batch (vector list) crossing a worker boundary is packed into a
structured-dtype record array, paged through a throwaway
:class:`~repro_torch.objectmodel.store.PagedSet`, and shipped as that set's raw
page payloads — the serialized form *is* the page byte format, so the
receiver adopts the bytes (:meth:`PagedSet.from_payloads`) and takes typed
views; no parsing happens on either end. ``nbytes`` is the real payload
traffic, which is what per-worker ``ExecStats.shuffle_bytes`` accounts.

Columns whose dtype numpy cannot pack (``object``) fall back to a pickled
block — still measured, but outside the zero-copy claim; the relational
benchmarks never hit this path.

The second half of this module is the **binary framing** the socket
transport speaks: each message ``(src, dst, tag, msg)`` becomes one
length-prefixed frame whose body carries page payloads as raw bytes
(referenced by a small pickled manifest, never pickled themselves — the
fork transport's ``Connection.send`` pickles every payload; the socket
frame writes the same buffers straight to the wire). A truncated or
corrupt stream raises :class:`ProtocolError` instead of deadlocking or
mis-framing the next message; a connection closed exactly at a frame
boundary reads as a clean EOF (``read_frame`` returns ``None``).
"""
from __future__ import annotations

import pickle
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.relops import AggMap, AggSpec
from repro_torch.objectmodel.page import DEFAULT_PAGE_SIZE
from repro_torch.objectmodel.store import PagedSet
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = ["ABORT", "DRIVER", "HELLO", "WELCOME", "SETUP", "QUERY", "BYE",
           "PROTO_VERSION", "PageBlock", "PickleBlock", "ProtocolError",
           "StatsFrame", "encode_batch", "decode_batch", "encode_agg_map",
           "decode_agg_map", "frame_buffers", "write_frame", "read_frame",
           "decode_frame", "configure_socket", "mux_tag", "split_mux"]

DRIVER = -1  # transport address of the driver
ABORT = "__abort__"  # driver -> workers: a peer failed, stop waiting

# rendezvous control tags (dunder-named so they can never collide with the
# exchange layer's "<op index>:<role>" data tags)
HELLO = "__hello__"      # worker -> driver: first frame on a connection
WELCOME = "__welcome__"  # driver -> worker: rank/P/epoch assignment
SETUP = "__setup__"      # driver -> external worker: program + shard pages
QUERY = "__query__"      # service -> resident worker: one query's setup
BYE = "__bye__"          # service -> resident worker: clean pool shutdown
# v2: SETUP set entries are tagged ("pages", ...) | ("held", version) so a
# reconnecting --serve worker that still holds a shard at the current
# version is sent a manifest reference instead of the page bytes
PROTO_VERSION = 2


# ------------------------------------------------- query multiplexing
# A resident service pool runs many queries concurrently over the same
# worker connections. Every data/control tag of one query is prefixed by
# that query's epoch id, so interleaved frames from different queries
# demultiplex unambiguously at both ends ("|" cannot appear in the
# exchange layer's "<op index>:<role>" tags or in epoch ids).
MUX_SEP = "|"


def mux_tag(qid: str, tag: str) -> str:
    """Namespace ``tag`` under query epoch ``qid``."""
    return f"{qid}{MUX_SEP}{tag}"


def split_mux(tag: str) -> Tuple[Optional[str], str]:
    """``(qid, bare tag)`` — qid is None for un-namespaced tags."""
    qid, sep, rest = tag.partition(MUX_SEP)
    return (qid, rest) if sep else (None, tag)


class PageBlock:
    """A batch as raw page payloads + the dtype needed to view them."""

    __slots__ = ("descr", "payloads", "names")

    def __init__(self, descr, payloads: List[Tuple[int, np.ndarray]],
                 names: Tuple[str, ...]):
        self.descr = descr          # np.dtype(...).descr round-trip
        self.payloads = payloads    # [(record_count, payload_bytes), ...]
        self.names = names          # column order (== field order)

    @property
    def nbytes(self) -> int:
        return sum(raw.nbytes for _, raw in self.payloads)


class StatsFrame:
    """A worker's end-of-query report: its :class:`~repro_torch.core.executor
    .ExecStats` plus the spans its recorder collected (empty when tracing
    is off). Rides the ``done`` message over every transport — pipes
    pickle it whole; the socket framing carries it through the generic
    object path (spans are plain dataclasses of ints/strs)."""

    __slots__ = ("stats", "spans")

    def __init__(self, stats, spans=None):
        self.stats = stats
        self.spans = spans if spans is not None else []

    def __getstate__(self):
        return (self.stats, self.spans)

    def __setstate__(self, state):
        self.stats, self.spans = state


class PickleBlock:
    """Fallback for object-dtype columns (no page representation)."""

    __slots__ = ("data", "nbytes")

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.data = pickle.dumps(columns, protocol=pickle.HIGHEST_PROTOCOL)
        self.nbytes = len(self.data)


def encode_batch(vl: VectorList) -> "PageBlock | PickleBlock":
    cols = {n: np.asarray(vl[n]) for n in vl.names}
    if any(c.dtype == object for c in cols.values()):
        return PickleBlock(cols)
    dtype = np.dtype([(n, c.dtype, c.shape[1:]) for n, c in cols.items()])
    n = vl.num_rows or 0
    rec = np.empty(n, dtype)
    for name, c in cols.items():
        rec[name] = c
    # a single oversized record must still fit one page
    page_size = max(DEFAULT_PAGE_SIZE, dtype.itemsize + 8)
    wire = PagedSet("wire", dtype, page_size)
    wire.append_records(rec)
    return PageBlock(dtype.descr, wire.to_payloads(), tuple(cols))


def decode_batch(block: "PageBlock | PickleBlock") -> VectorList:
    if isinstance(block, PickleBlock):
        return VectorList(pickle.loads(block.data))
    dtype = np.dtype(block.descr)
    recs = PagedSet.from_payloads("wire", dtype, block.payloads).all_records()
    return VectorList({n: recs[n] for n in block.names})


# --------------------------------------------------- AGG partial transfer
def encode_agg_map(m: AggMap) -> Optional["PageBlock | PickleBlock"]:
    """A pre-aggregation partial as one packed page block: the key
    column(s) under ``__k<i>`` plus every accumulator column under
    ``__a<j>`` (``None`` when empty — empty partials never hit the wire).
    Accumulators cross the wire, never finalized outputs, so composite
    aggregates (mean) merge exactly at the receiver."""
    if not m.data:
        return None
    keys = list(m.data.keys())
    cols: Dict[str, np.ndarray] = {}
    dts = m.key_dtypes or [None] * m.spec.n_keys
    if m.spec.n_keys == 1:
        cols["__k0"] = np.array(keys, dtype=dts[0])
    else:
        for i in range(m.spec.n_keys):
            cols[f"__k{i}"] = np.array([k[i] for k in keys], dtype=dts[i])
    for j in range(len(m.spec.combiners)):
        cols[f"__a{j}"] = np.stack(
            [np.asarray(vals[j]) for vals in m.data.values()])
    return encode_batch(VectorList(cols))


def decode_agg_map(block, spec: AggSpec) -> AggMap:
    vl = decode_batch(block)
    m = AggMap(spec)
    # the page block's dtype descr preserved the source key dtypes — hand
    # them back to the map so its final emit restores them exactly
    m.key_dtypes = [np.asarray(vl[f"__k{i}"]).dtype
                    for i in range(spec.n_keys)]
    accs = [np.asarray(vl[f"__a{j}"])
            for j in range(len(spec.combiners))]
    # .tolist() restores native python keys so hashing and dict identity
    # match the sender's map exactly
    if spec.n_keys == 1:
        keys = np.asarray(vl["__k0"]).tolist()
    else:
        keys = list(zip(*(np.asarray(vl[f"__k{i}"]).tolist()
                          for i in range(spec.n_keys))))
    for i, k in enumerate(keys):
        m.data[k] = [a[i] for a in accs]
    return m


# ----------------------------------------------------------- TCP framing
PROTO_MAGIC = b"PCF1"
# magic | header bytes (u32) | body bytes (u64)
_PREFIX = struct.Struct("<4sIQ")
MAX_HEADER_BYTES = 1 << 28   # manifests are small; a corrupt length fails
MAX_FRAME_BYTES = 1 << 40    # fast instead of allocating garbage


def configure_socket(sock) -> None:
    """Tuning every exchange connection gets (both ends): Nagle off
    (frames are latency-sensitive and gather-written whole), and TCP
    keepalive with aggressive probes where the platform exposes them —
    a silently partitioned peer (host power loss: no FIN ever arrives)
    must surface as a dead connection within minutes, not hang every
    blocked ``recv`` until operator intervention."""
    import socket as _socket
    sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 10),
                     ("TCP_KEEPCNT", 6)):
        if hasattr(_socket, opt):  # pragma: no branch - platform-dependent
            sock.setsockopt(_socket.IPPROTO_TCP,
                            getattr(_socket, opt), val)


class ProtocolError(RuntimeError):
    """A malformed, truncated, or implausible frame. The stream cannot be
    resynchronized after this (framing is length-prefixed, not
    self-delimiting), so the connection must be torn down — which is
    exactly what the driver's pump and the worker transport do."""


def _encode_meta(msg, body: List) -> Tuple:
    """Describe ``msg`` as a small picklable manifest, appending its raw
    buffers (page payloads, pickled fallbacks) to ``body`` in order.
    Page payload bytes are never re-pickled: they go to the wire verbatim
    and are re-viewed zero-copy at the receiver."""
    if msg is None:
        return ("none",)
    if isinstance(msg, PageBlock):
        parts = []
        for count, raw in msg.payloads:
            raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
            body.append(raw)
            parts.append((int(count), int(raw.nbytes)))
        return ("page", msg.descr, tuple(msg.names), parts)
    if isinstance(msg, PickleBlock):
        body.append(msg.data)
        return ("pklblk", len(msg.data))
    if type(msg) in (list, tuple):
        return ("seq", type(msg) is tuple,
                [_encode_meta(m, body) for m in msg])
    if type(msg) is dict:
        return ("map", [(k, _encode_meta(v, body)) for k, v in msg.items()])
    data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    body.append(data)
    return ("obj", len(data))


def _decode_meta(meta, body, off: int):
    kind = meta[0]
    if kind == "none":
        return None, off
    if kind == "page":
        _, descr, names, parts = meta
        payloads = []
        for count, nbytes in parts:
            payloads.append((count, np.frombuffer(body, np.uint8,
                                                  count=nbytes, offset=off)))
            off += nbytes
        return PageBlock(descr, payloads, tuple(names)), off
    if kind == "pklblk":
        n = meta[1]
        blk = object.__new__(PickleBlock)
        blk.data = bytes(body[off:off + n])
        blk.nbytes = n
        return blk, off + n
    if kind == "seq":
        _, is_tuple, metas = meta
        out = []
        for m in metas:
            v, off = _decode_meta(m, body, off)
            out.append(v)
        return (tuple(out) if is_tuple else out), off
    if kind == "map":
        out = {}
        for k, m in meta[1]:
            out[k], off = _decode_meta(m, body, off)
        return out, off
    if kind == "obj":
        n = meta[1]
        return pickle.loads(body[off:off + n]), off + n
    raise ProtocolError(f"unknown frame element kind {kind!r}")


def frame_buffers(src: int, dst: int, tag: str, msg) -> List:
    """One message as wire buffers: ``[prefix + header, *raw body bufs]``.
    Writing them in order (``write_frame``) emits exactly one frame; page
    payloads are passed through as buffers, never copied into a pickle."""
    body: List = []
    meta = _encode_meta(msg, body)
    header = pickle.dumps((src, dst, tag, meta),
                          protocol=pickle.HIGHEST_PROTOCOL)
    blen = sum(b.nbytes if isinstance(b, np.ndarray) else len(b)
               for b in body)
    return [_PREFIX.pack(PROTO_MAGIC, len(header), blen) + header, *body]


_IOV_CAP = 512  # stay under IOV_MAX for very page-fragmented frames


def write_frame(sock, src: int, dst: int, tag: str, msg) -> None:
    """Emit one frame on ``sock``. The socket must have a single writer
    (frames from concurrent writers would interleave mid-frame). Uses a
    gather-write (``sendmsg``) so the prefix+header and every payload go
    out in one syscall — with Nagle disabled, per-buffer ``sendall``
    would flush each tiny buffer as its own packet."""
    bufs = frame_buffers(src, dst, tag, msg)
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:  # pragma: no cover - platforms without sendmsg
        for buf in bufs:
            sock.sendall(buf)
        return
    views = [memoryview(b).cast("B") for b in bufs]
    while views:
        sent = sendmsg(views[:_IOV_CAP])
        # advance across the iovec by bytes actually sent (a full kernel
        # buffer yields a partial gather-write)
        while sent > 0:
            n = views[0].nbytes
            if sent >= n:
                views.pop(0)
                sent -= n
            else:
                views[0] = views[0][sent:]
                sent = 0


def _check_frame_sizes(magic: bytes, hlen: int, blen: int) -> None:
    if magic != PROTO_MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r} "
                            f"(expected {PROTO_MAGIC!r})")
    if not 0 < hlen <= MAX_HEADER_BYTES:
        raise ProtocolError(f"implausible frame header length {hlen}")
    if blen > MAX_FRAME_BYTES:
        raise ProtocolError(f"implausible frame body length {blen}")


def _decode_payload(header, body):
    try:
        src, dst, tag, meta = pickle.loads(header)
    except Exception as e:
        raise ProtocolError(f"undecodable frame header: {e!r}") from e
    try:
        msg, off = _decode_meta(meta, body, 0)
    except ProtocolError:
        raise
    except Exception as e:
        raise ProtocolError(f"malformed frame manifest: {e!r}") from e
    if off != len(body):
        raise ProtocolError(f"frame body length mismatch: manifest consumed "
                            f"{off} of {len(body)} bytes")
    return src, dst, tag, msg


_ALLOC_CHUNK = 64 << 20  # progressive-allocation step for frame bodies


def _read_exact(sock, n: int, what: str, allow_clean_eof: bool = False):
    # the buffer grows in capped steps as bytes actually arrive: a
    # corrupt length prefix (e.g. a flipped high byte claiming a 256 GiB
    # body) fails on the short read with a clean ProtocolError instead of
    # zero-filling a garbage-sized allocation up front
    buf = bytearray(min(n, _ALLOC_CHUNK))
    got = 0
    while got < n:
        if got == len(buf):
            buf.extend(bytes(min(n - len(buf), _ALLOC_CHUNK)))
        r = sock.recv_into(memoryview(buf)[got:])
        if r == 0:
            if got == 0 and allow_clean_eof:
                return None
            raise ProtocolError(f"truncated frame: connection closed after "
                                f"{got}/{n} bytes of {what}")
        got += r
    return buf


def read_frame(sock) -> Optional[Tuple[int, int, str, object]]:
    """Read one frame from a blocking socket: ``(src, dst, tag, msg)``, or
    ``None`` on a clean EOF at a frame boundary. Truncation mid-frame or
    corruption raises :class:`ProtocolError` — never a hang, never a
    mis-framed next message. Page payloads in the body are adopted as
    writable zero-copy views over the received buffer."""
    prefix = _read_exact(sock, _PREFIX.size, "frame prefix",
                         allow_clean_eof=True)
    if prefix is None:
        return None
    magic, hlen, blen = _PREFIX.unpack(bytes(prefix))
    _check_frame_sizes(magic, hlen, blen)
    header = _read_exact(sock, hlen, "frame header")
    body = _read_exact(sock, blen, "frame body") if blen else bytearray()
    return _decode_payload(bytes(header), memoryview(body))


def decode_frame(data, offset: int = 0):
    """Pure-bytes counterpart of :func:`read_frame` (for tests and
    buffered decoding): returns ``((src, dst, tag, msg), next_offset)``."""
    mv = memoryview(data)
    if len(mv) - offset < _PREFIX.size:
        raise ProtocolError(
            f"truncated frame: {len(mv) - offset} bytes, prefix needs "
            f"{_PREFIX.size}")
    magic, hlen, blen = _PREFIX.unpack_from(mv, offset)
    _check_frame_sizes(magic, hlen, blen)
    start = offset + _PREFIX.size
    end = start + hlen + blen
    if len(mv) < end:
        raise ProtocolError(f"truncated frame: have {len(mv) - offset} "
                            f"bytes of a {end - offset}-byte frame")
    return _decode_payload(bytes(mv[start:start + hlen]),
                           mv[start + hlen:end]), end
