"""Per-partition relational operator kernels (paper §5.2, Appendix C/D).

Everything here operates on ONE partition's data — a vector list or a list
of vector-list batches — with no knowledge of where partitions live or how
they exchange data. The local simulated :class:`~repro_torch.core.executor
.Executor` and the distributed :class:`~repro_torch.dist.driver
.DistributedExecutor` both call these kernels, so the two backends differ
only in partition *placement* and *exchange*, never in operator semantics.
That is what makes byte-identical results across backends a structural
property rather than a testing accident.

Kernels:

* :func:`stage_eval` / :func:`batch_kernel` — the compiled pipeline stages
  (APPLY / FILTER / FLATTEN / HASH) over one vector-list batch;
* :func:`hash_col` — stable vectorized key hashing (drives both the HASH
  op and shuffle destinations);
* :func:`split_by_hash` — partition one batch by ``hash % P`` (the shuffle
  kernel: what goes on the wire is decided here, identically for the
  simulated and the real exchange);
* :func:`probe_join` — sort-probe equi-join of two co-partitioned sides;
* :class:`AggMap` — PC's pre-aggregation map (a "combiner page"),
  generalized to multi-column keys and named multi-aggregate accumulators
  (:class:`AggSpec` parses the AGG op's plan); on the torch expression
  backend the per-partition reduction runs on device through
  :func:`device_segment_reducer` (one segment-reduce kernel call);
* :func:`greedy_page_placement` — least-loaded-by-bytes page placement,
  shared by the local scan partitioner and ``dist.placement``;
* :func:`batch_topk` / :func:`merge_topk` — per-partition top-k and the
  global gather-merge;
* :func:`assemble_output` — the OUTPUT contract (column concat in
  partition-then-batch order, row count, single-column write-back);
* :func:`concat_batches` / :func:`bytes_of` — glue.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lambdas import METHOD_REGISTRY
from repro_torch.core.tcap import TCAPOp
from repro_torch.kernels import ops
from repro_torch.kernels.segment_reduce import acc_dtype
from repro_torch.kernels.transfer import to_device, to_device_pinned
from repro_torch.obs.trace import current
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = [
    "AggMap", "AggSpec", "assemble_output", "batch_kernel", "batch_topk",
    "bytes_of", "concat_batches", "device_segment_reducer",
    "greedy_page_placement", "hash_col", "merge_topk", "probe_join",
    "split_by_hash", "stable_key_hash", "stage_eval",
]

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_U64 = (1 << 64) - 1


_SPLITMIX_PRIME = 0xFF51AFD7ED558CCD  # == np.int64(-49064778989728563)


def _fnv1a(data: bytes) -> int:
    """FNV-1a 64-bit, folded into int64 range."""
    h = _FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _U64
    return h - (1 << 64) if h >= (1 << 63) else h


def _asr64(u: int, s: int) -> int:
    """Arithmetic shift right of a 64-bit two's-complement pattern held
    in an unsigned Python int (sign bit replicates, as numpy ``>>`` on
    int64 does)."""
    if u & (1 << 63):
        return ((u >> s) | ((_U64 << (64 - s)) & _U64)) & _U64
    return u >> s


def _splitmix64(u: int) -> int:
    """Scalar twin of :func:`hash_col`'s int64 mix — bit-identical to
    ``(x ^ (x >> 33)) * prime; x ^ (x >> 29)`` in wrapping int64
    arithmetic, folded into int64 range."""
    u &= _U64
    u = ((u ^ _asr64(u, 33)) * _SPLITMIX_PRIME) & _U64
    u ^= _asr64(u, 29)
    return u - (1 << 64) if u >= (1 << 63) else u


def stable_key_hash(k) -> int:
    """Process-independent scalar key hash, bit-identical per element to
    the vectorized :func:`hash_col` on a column of the same keys. Two
    properties hang off this:

    * Python salts built-in str/bytes hashing per process
      (PYTHONHASHSEED), which would route the same key to different
      destinations on independent worker processes — silently splitting
      groups and losing join matches under the socket transport's
      connect mode. Hence FNV-1a for bytes/str.
    * planlint's partitioning pass (PL201/PL202) elides exchanges when a
      stream is already placed by an equivalent routing: the AGG family
      routes by this function while the JOIN family routes by
      ``hash_col``, so the two must be the *same* hash or co-partitioned
      facts could never survive a hash-partition JOIN. int/bool take the
      splitmix64-style mix; floats hash their float64 bit pattern with
      ``-0.0`` normalized to ``+0.0`` (matching ``hash_col``) so equal
      keys co-route.
    """
    if isinstance(k, tuple):
        h = _FNV_OFFSET
        for item in k:
            h = ((h ^ (stable_key_hash(item) & _U64)) * _FNV_PRIME) & _U64
        return h - (1 << 64) if h >= (1 << 63) else h
    if isinstance(k, bytes):  # np.bytes_ is a bytes subclass
        return _fnv1a(k)
    if isinstance(k, str):    # np.str_ is a str subclass
        return _fnv1a(k.encode("utf-8", "surrogatepass"))
    if isinstance(k, (bool, np.bool_)) or isinstance(k, (int, np.integer)):
        return _splitmix64(int(k))
    if isinstance(k, (float, np.floating)):
        # the float64 bit pattern, with -0.0 -> +0.0 (hash_col adds 0.0
        # for the same normalization); NaNs hash by payload bits
        bits = struct.unpack("=q", struct.pack("=d", float(k) + 0.0))[0]
        return _splitmix64(bits)
    return hash(k)


def hash_col(col: np.ndarray) -> np.ndarray:
    """Stable vectorized key hashing (process-independent: shuffle
    routing derived from these values must agree across worker processes
    that share no hash salt)."""
    if col.dtype.kind in "iu":
        x = col.astype(np.int64, copy=True)
        x = (x ^ (x >> 33)) * np.int64(-49064778989728563)  # splitmix64-ish
        return x ^ (x >> 29)
    if col.dtype.kind == "f":
        # + 0.0 normalizes -0.0 to +0.0 before taking bits, so equal
        # float keys co-route (and match stable_key_hash's scalar path)
        return hash_col((col.astype(np.float64) + 0.0).view(np.int64))
    if col.dtype.kind == "S" and len(col):
        return _fnv1a_bytes_col(col)
    return np.fromiter((stable_key_hash(x) for x in col.tolist()),
                       np.int64, count=len(col))


def _fnv1a_bytes_col(col: np.ndarray) -> np.ndarray:
    """FNV-1a folded across a fixed-width bytes column, vectorized over
    rows (``itemsize`` numpy passes instead of a per-byte Python loop
    per element — the hot path for string-keyed shuffles). Bit-identical
    to ``stable_key_hash`` on each element: trailing NUL padding is
    excluded exactly the way ``.tolist()`` strips it, so an S8 and an
    S16 column holding the same logical key hash alike (join sides of
    different declared widths co-partition)."""
    w = col.dtype.itemsize
    mat = np.ascontiguousarray(col).view(np.uint8).reshape(len(col), w)
    rev_nonzero = mat[:, ::-1] != 0
    lengths = np.where(rev_nonzero.any(axis=1),
                       w - rev_nonzero.argmax(axis=1), 0)
    h = np.full(len(col), _FNV_OFFSET, dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    for j in range(w):
        # uint64 arithmetic wraps mod 2**64, matching the scalar fold
        h = np.where(j < lengths,
                     (h ^ mat[:, j].astype(np.uint64)) * prime, h)
    return h.view(np.int64)


def stage_eval(op: TCAPOp, cols: Sequence[np.ndarray],
               n_rows: int = 1) -> np.ndarray:
    t = op.info["type"]
    if t == "attAccess":
        return cols[0][op.info["attName"]]
    if t == "methodCall":
        fn = METHOD_REGISTRY[(op.info["onType"], op.info["methodName"])]
        return fn(cols[0])
    if t == "native":
        return op.info["fn"](*cols)
    if t == "const":
        n = len(cols[0]) if cols else n_rows
        return np.full(n, op.info["value"])
    if t == "rename":
        return cols[0]
    if t == "pack":
        # grouped-aggregation outputs chained into a downstream op: pack
        # the named columns into one structured record column, field order
        # = AGG output order (matches the synthesized group schema)
        names = op.info["fields"].split(",")
        arrs = [np.asarray(c) for c in cols]
        rec = np.zeros(len(arrs[0]), np.dtype(
            [(nm, a.dtype, a.shape[1:]) for nm, a in zip(names, arrs)]))
        for nm, a in zip(names, arrs):
            rec[nm] = a
        return rec
    if t in ("cmp", "bool", "arith"):
        o = op.info["op"]
        if o == "!":
            return np.logical_not(cols[0])
        a, b = cols
        return {
            "==": lambda: a == b, "!=": lambda: a != b,
            ">": lambda: a > b, ">=": lambda: a >= b,
            "<": lambda: a < b, "<=": lambda: a <= b,
            "&&": lambda: np.logical_and(a, b),
            "||": lambda: np.logical_or(a, b),
            "+": lambda: a + b, "-": lambda: a - b,
            "*": lambda: a * b, "/": lambda: a / b,
        }[o]()
    raise ValueError(f"unknown stage type {t}")


def _flatten(op: TCAPOp, vl: VectorList) -> VectorList:
    objcol = vl[op.apply_cols[0]]
    counts = np.fromiter((len(x) for x in objcol), np.int64,
                         count=len(objcol))
    out = VectorList()
    flat = (np.concatenate([np.asarray(x) for x in objcol])
            if counts.sum() else np.empty(0))
    out.append(op.out_cols[0], flat)
    for c in op.copy_cols:
        out.append(c, np.repeat(vl[c], counts))
    return out


def batch_kernel(op: TCAPOp) -> Callable[[VectorList], VectorList]:
    """The per-batch transform for a pipelined (non-exchange) TCAP op."""
    if op.op == "APPLY":
        if op.new_cols:
            return lambda vl: vl.extended(
                op.copy_cols, op.new_cols[0],
                stage_eval(op, [vl[c] for c in op.apply_cols],
                           vl.num_rows or 0))
        return lambda vl: vl.project(op.copy_cols)
    if op.op == "FILTER":
        return lambda vl: vl.filtered(
            np.asarray(vl[op.apply_cols[0]], bool), op.copy_cols)
    if op.op == "FLATTEN":
        return lambda vl: _flatten(op, vl)
    if op.op == "HASH":
        return lambda vl: vl.extended(
            op.copy_cols, op.new_cols[0],
            hash_col(np.asarray(vl[op.apply_cols[0]])))
    raise ValueError(f"{op.op} is not a per-batch pipelined op")


def split_by_hash(vl: VectorList, hash_name: str, P: int
                  ) -> List[Optional[VectorList]]:
    """Partition one batch by ``hash % P``; ``None`` where no rows land
    (nothing goes on the wire for that destination)."""
    h = np.asarray(vl[hash_name])
    dest = (h % P + P) % P
    out: List[Optional[VectorList]] = []
    for p in range(P):
        mask = dest == p
        out.append(vl.filtered(mask, vl.names) if mask.any() else None)
    return out


def probe_join(op: TCAPOp, lvl: VectorList, rvl: VectorList
               ) -> Optional[Tuple[VectorList, int]]:
    """Sort-probe equi-join of two co-partitioned sides; returns the joined
    batch and its row count, or ``None`` when either side is empty."""
    lh, rh = op.apply_cols[0], op.apply_cols2[0]
    if lvl.num_rows in (None, 0) or rvl.num_rows in (None, 0):
        return None
    lcode = np.asarray(lvl[lh])
    rcode = np.asarray(rvl[rh])
    order = np.argsort(rcode, kind="stable")
    rsorted = rcode[order]
    lo = np.searchsorted(rsorted, lcode, "left")
    hi = np.searchsorted(rsorted, lcode, "right")
    counts = hi - lo
    l_idx = np.repeat(np.arange(len(lcode)), counts)
    starts = np.repeat(lo, counts)
    within = np.arange(len(starts)) - np.repeat(
        np.cumsum(counts) - counts, counts)
    r_idx = order[starts + within]
    res = VectorList()
    for c in op.copy_cols:
        res.append(c, np.asarray(lvl[c])[l_idx])
    for c in op.copy_cols2:
        res.append(c, np.asarray(rvl[c])[r_idx])
    return res, len(l_idx)


# ------------------------------------------------------------ aggregation
_COMBINE = {
    "sum": lambda acc, inv, vals, n: _scatter_add(acc, inv, vals, n),
    "max": lambda acc, inv, vals, n: _scatter_minmax(acc, inv, vals, n,
                                                     np.maximum),
    "min": lambda acc, inv, vals, n: _scatter_minmax(acc, inv, vals, n,
                                                     np.minimum),
}

# pairwise merge of two accumulated values (map-merge and wire-merge path)
_MERGE2 = {
    "sum": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
}


def sum_acc_dtype(dtype: np.dtype) -> np.dtype:
    """Accumulator dtype of a ``sum`` over values of ``dtype``: floats
    widen to float64, bools widen to int64 (summing an indicator counts
    it — ``np.add.at`` on a bool accumulator would saturate at True),
    other integers keep their dtype. Single source for the host scatter,
    the device reducer, and the group-schema synthesis."""
    if dtype.kind == "f":
        return np.result_type(dtype, np.float64)
    if dtype.kind == "b":
        return np.dtype(np.int64)
    return dtype


def _scatter_add(acc, inv, vals, n):
    if acc is None:
        acc = np.zeros((n,) + vals.shape[1:], dtype=sum_acc_dtype(vals.dtype))
    np.add.at(acc, inv, vals)
    return acc


def _scatter_minmax(acc, inv, vals, n, fn):
    init = -np.inf if fn is np.maximum else np.inf
    if acc is None:
        acc = np.full((n,) + vals.shape[1:], init, dtype=np.float64)
    fn.at(acc, inv, vals)
    return acc


@dataclass(frozen=True)
class AggSpec:
    """The parsed plan of one generalized AGG op: which output columns are
    keys, the combiner of every accumulator column, and how accumulators
    finalize into the named outputs (``"i"`` emits accumulator *i*;
    ``"i/j"`` divides — the mean composite)."""

    key_names: Tuple[str, ...]
    combiners: Tuple[str, ...]
    finalize: Tuple[str, ...]
    out_names: Tuple[str, ...]

    @classmethod
    def from_op(cls, op: TCAPOp) -> "AggSpec":
        nk = int(op.info["nkeys"])
        return cls(key_names=tuple(op.out_cols[:nk]),
                   combiners=tuple(op.info["combiners"].split(",")),
                   finalize=tuple(op.info["finalize"].split(",")),
                   out_names=tuple(op.out_cols[nk:]))

    @property
    def n_keys(self) -> int:
        return len(self.key_names)

    def key_cols(self, op: TCAPOp) -> Tuple[str, ...]:
        return op.apply_cols[:self.n_keys]

    def acc_cols(self, op: TCAPOp) -> Tuple[str, ...]:
        return op.apply_cols[self.n_keys:]


def _col_unique(c: np.ndarray):
    """``np.unique(..., return_inverse=True)`` with a fast path for byte
    strings: an ``S1``/``S2``/``S4``/``S8`` column sorts identically as a
    big-endian unsigned view (lexicographic bytes == big-endian integer
    order), and integer argsort is ~2x faster than the generic string
    compare loop. The unique values are viewed back, so callers always
    see the original dtype."""
    if c.dtype.kind == "S" and c.dtype.itemsize in (1, 2, 4, 8):
        u, inv = np.unique(c.view(f">u{c.dtype.itemsize}"),
                           return_inverse=True)
        return u.view(c.dtype), inv
    return np.unique(c, return_inverse=True)


def _unique_keys(key_cols: Sequence[np.ndarray]):
    """(python key list, inverse index) for one partition's rows. Single
    keys stay scalars (hash/dict identity as before); multi-column keys
    become tuples. Multi-key grouping runs per-column integer coding — one
    cheap ``np.unique`` per column, combined into one int64 code — which
    is ~4x faster than a structured-array sort and yields the identical
    lexicographic group order (the combined code sorts by (code0, code1,
    ...) = per-column sorted order). Every backend runs exactly this
    function, so group order is deterministic by construction. Falls back
    to the structured sort when the code space could overflow int64."""
    if len(key_cols) == 1:
        uniq, inv = _col_unique(np.asarray(key_cols[0]))
        return uniq.tolist(), inv
    cols = [np.asarray(c) for c in key_cols]
    uniqs, codes, space = [], [], 1
    if all(c.ndim == 1 for c in cols):
        for c in cols:
            u, code = _col_unique(c)
            uniqs.append(u)
            codes.append(code)
            space *= max(len(u), 1)  # python int: overflow-safe check
    if uniqs and space < (1 << 62):
        combined = codes[0].astype(np.int64)
        for u, code in zip(uniqs[1:], codes[1:]):
            combined = combined * len(u) + code
        ucomb, inv = np.unique(combined, return_inverse=True)
        parts = []
        idx = ucomb
        for u in reversed(uniqs[1:]):
            parts.append(idx % len(u))
            idx = idx // len(u)
        parts.append(idx)
        parts.reverse()
        keys = list(zip(*(u[i].tolist() for u, i in zip(uniqs, parts))))
        return keys, inv
    packed = np.empty(len(cols[0]), dtype=np.dtype(
        [(f"k{i}", c.dtype, c.shape[1:]) for i, c in enumerate(cols)]))
    for i, c in enumerate(cols):
        packed[f"k{i}"] = c
    uniq, inv = np.unique(packed, return_inverse=True)
    return uniq.tolist(), inv


class AggMap:
    """A pre-aggregation map (the per-thread PC ``Map`` on a combiner page),
    generalized to multi-column keys and multiple named accumulators.

    Each entry maps a key (scalar, or tuple for multi-key grouping) to the
    list of accumulated values — one per accumulator column of the AGG op.
    Key order is insertion order everywhere (absorb batches in batch order,
    merge peers in rank order) — both executors preserve it, which is what
    keeps final AGG output ordering identical across backends.
    """

    def __init__(self, spec: AggSpec):
        self.spec = spec
        self.data: Dict[Any, List[Any]] = {}
        # source dtypes of the key columns, captured at first absorb and
        # propagated through splits/merges/the wire: emit() must restore
        # them exactly (np.array over python natives would widen i32 keys
        # to int64 and narrow S(n) keys to the longest seen value,
        # contradicting the synthesized group schema)
        self.key_dtypes: Optional[List[np.dtype]] = None

    def absorb(self, key_cols: Sequence[np.ndarray],
               val_cols: Sequence[np.ndarray],
               reducer: Optional[Callable] = None) -> None:
        """Fold one batch in: group rows by key, scatter-combine every
        accumulator column. ``reducer`` (the torch segment-reduce kernel)
        replaces the numpy scatter for the per-batch reduction when set;
        it receives ``(inv, n_groups, val_parts)``, each accumulator
        column as an array or as the list of arrays whose concatenation it
        is, and must return one ``(n_groups, ...)`` array per accumulator
        — or ``None`` to decline (non-numeric dtypes), falling back to
        numpy."""
        self._absorb(key_cols, [[np.asarray(v)] for v in val_cols], reducer)

    def _absorb(self, key_cols: Sequence[np.ndarray],
                val_parts: Sequence[Sequence[np.ndarray]],
                reducer: Optional[Callable]) -> None:
        if len(np.asarray(key_cols[0])) == 0:
            return
        if self.key_dtypes is None:
            self.key_dtypes = [np.asarray(c).dtype for c in key_cols]
        # "agg" spans split the AGG op's time (the analyze table leaves
        # them out: it tiles the wall with op spans)
        rec = current()
        with rec.span("agg:keys", cat="agg"):
            keys, inv = _unique_keys(key_cols)
        n = len(keys)
        accs = reducer(inv, n, val_parts) if reducer is not None else None
        if accs is None:
            with rec.span("agg:concat", cat="agg"):
                vals = [p[0] if len(p) == 1 else np.concatenate(p)
                        for p in val_parts]
            with rec.span("agg:scatter", cat="agg"):
                accs = [_COMBINE[comb](None, inv, v, n)
                        for comb, v in zip(self.spec.combiners, vals)]
        combs = self.spec.combiners
        with rec.span("agg:merge", cat="agg"):
            for i, k in enumerate(keys):
                cur = self.data.get(k)
                if cur is None:
                    self.data[k] = [a[i] for a in accs]
                else:
                    self.data[k] = [_MERGE2[c](old, a[i])
                                    for c, old, a in zip(combs, cur, accs)]

    def absorb_batches(self, batches: Sequence[VectorList],
                       key_cols: Sequence[str],
                       acc_cols: Sequence[str],
                       reducer: Optional[Callable] = None) -> None:
        """One absorb over a partition's concatenated rows — a single
        group discovery + one (fused, possibly on-device) scatter per
        partition. Both executors pre-aggregate through exactly this
        method, so the float association order (row order within the
        partition) is identical on every backend by construction. The
        key columns are concatenated here; the value columns go to the
        reducer as the batches' parts (the device reducer packs them
        straight into pinned staging), and are concatenated only for the
        numpy scatter."""
        if not batches:
            return
        with current().span("agg:concat", cat="agg"):
            keys = [np.concatenate([np.asarray(vl[c]) for vl in batches])
                    for c in key_cols]
        parts = [[np.asarray(vl[c]) for vl in batches] for c in acc_cols]
        self._absorb(keys, parts, reducer)

    def merge(self, other: "AggMap") -> None:
        if self.key_dtypes is None:
            self.key_dtypes = other.key_dtypes
        combs = self.spec.combiners
        for k, vals in other.data.items():
            cur = self.data.get(k)
            if cur is None:
                self.data[k] = vals
            else:
                self.data[k] = [_MERGE2[c](old, v)
                                for c, old, v in zip(combs, cur, vals)]

    def split_by_key_hash(self, P: int) -> List["AggMap"]:
        """Partition this map's entries by ``stable_key_hash(key) % P``
        (the AGG shuffle kernel — process-independent, so connect-mode
        workers with different hash salts route each key identically);
        insertion order is preserved within each split."""
        out = [AggMap(self.spec) for _ in range(P)]
        for m in out:
            m.key_dtypes = self.key_dtypes
        for k, v in self.data.items():
            out[stable_key_hash(k) % P].data[k] = v
        return out

    def nbytes(self) -> int:
        """Accumulator payload size (what an AGG partial puts on the wire
        in the local simulation's accounting)."""
        return sum(np.asarray(v).nbytes
                   for vals in self.data.values() for v in vals)

    def emit(self) -> Optional[VectorList]:
        """The final AGG output batch for this partition (``None`` if the
        partition holds no groups): key columns, then every named output
        finalized from its accumulator(s)."""
        if not self.data:
            return None
        keys = list(self.data.keys())
        out = VectorList()
        dts = self.key_dtypes or [None] * self.spec.n_keys
        if self.spec.n_keys == 1:
            out.append(self.spec.key_names[0], np.array(keys, dtype=dts[0]))
        else:
            for i, kn in enumerate(self.spec.key_names):
                out.append(kn, np.array([k[i] for k in keys],
                                        dtype=dts[i]))
        accs = [np.stack([np.asarray(vals[j]) for vals in
                          self.data.values()])
                for j in range(len(self.spec.combiners))]
        for name, fin in zip(self.spec.out_names, self.spec.finalize):
            if "/" in fin:
                i, j = map(int, fin.split("/"))
                out.append(name, accs[i] / accs[j])
            else:
                out.append(name, accs[int(fin)])
        return out


# ------------------------------------- device (torch) segment reduction
def device_segment_reducer(combiners: Tuple[str, ...], device) -> Callable:
    """The on-device pre-aggregation for ``expr_backend="torch"``: one call
    of the segment-reduce kernel (``kernels/segment_reduce.py``, K2; its
    plain torch version on the CPU) reducing every accumulator column of a
    partition, accumulator dtypes matching the host scatters. Group
    discovery (``np.unique``) stays on host — it is what fixes the
    deterministic key order — only the reduction itself runs on device.
    On a card the group ids and the value columns' parts (the partition's
    batches) are packed straight into the device's pinned "agg" staging
    buffer, reused and grown to the largest partition, and go over in one
    asynchronous copy (``transfer.to_device_pinned``).

    Bit-identity with the host scatters holds by construction: the kernel
    adds each group's rows in row order, as ``np.add.at`` does, where the
    reference's jax scatter leaves the float order to XLA. Unlike the
    reference, the reducer always runs on the torch backend (there is no
    CPU-cost gate): on the CPU it is the plain version.

    The returned reducer returns ``None`` per call for non-numeric value
    dtypes (the caller reduces those with the numpy scatter): a scope of
    dtypes fixed before any launch.

    Under a recorder, the pack and copy in, the kernel and the copy out
    are spans of their own ("agg" category), each ended by a wait on the
    calling thread's current stream."""

    def reducer(inv: np.ndarray, n: int, vals: Sequence):
        # a column is an array, or the list of its parts
        parts = [[v] if isinstance(v, np.ndarray) else list(v) for v in vals]
        dts = [p[0].dtype for p in parts]
        if any(dt.kind not in "biuf" or dt.names is not None for dt in dts):
            return None
        shapes = [(sum(len(a) for a in p),) + p[0].shape[1:] for p in parts]
        rec = current()
        inv = np.asarray(inv, np.int64)
        if device.type == "cpu":
            flat = to_device([inv] + [p[0] if len(p) == 1
                                      else np.concatenate(p) for p in parts],
                             device)
        else:
            with rec.span("agg:pinned_in", cat="agg"):
                flat = to_device_pinned([[inv]] + list(parts), device,
                                        "agg")
                _sync(rec, flat[0])
        with rec.span("agg:reduce", cat="agg"):
            cols = [t.reshape(shape) for t, shape in zip(flat[1:], shapes)]
            accs = ops.segment_reduce(flat[0], n, cols, dts, combiners)
            _sync(rec, flat[0])
        with rec.span("agg:to_host", cat="agg"):
            return [a.cpu().numpy().view(acc_dtype(dt, c))
                    for a, dt, c in zip(accs, dts, combiners)]

    return reducer


def _sync(rec, t: torch.Tensor) -> None:
    """End a traced span's device work: wait for the calling thread's
    current stream on t's card when a recorder is on (nothing otherwise),
    not for the whole device, which other threads' ranks may share."""
    if rec.enabled and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


# ------------------------------------------------------------------ top-k
def batch_topk(op: TCAPOp, vl: VectorList
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-batch top-k: the local pre-selection before the gather-merge."""
    k = int(op.info["k"])
    scol, pcol = op.apply_cols
    s = np.asarray(vl[scol])
    idx = np.argsort(-s, kind="stable")[:k]
    return s[idx], np.asarray(vl[pcol])[idx]


def merge_topk(op: TCAPOp, best_s: Sequence[np.ndarray],
               best_p: Sequence[np.ndarray]) -> Optional[VectorList]:
    """Gather-merge of per-batch top-k candidates (concatenation order is
    the tie-break, so callers must append in partition-then-batch order)."""
    if not best_s:
        return None
    k = int(op.info["k"])
    s = np.concatenate(list(best_s))
    p = np.concatenate(list(best_p))
    idx = np.argsort(-s, kind="stable")[:k]
    return VectorList({"score": s[idx], "payload": p[idx]})


# ----------------------------------------------------------------- output
def assemble_output(op: TCAPOp, batches: Sequence[VectorList], stats,
                    store, write_outputs: bool) -> Dict[str, np.ndarray]:
    """The OUTPUT contract, shared by both backends: concatenate the
    projected columns (callers pass batches in partition-then-batch
    order), record ``rows_output``, and persist a single packed column
    under the OUTPUT set name when write-back is on."""
    cols: Dict[str, List[np.ndarray]] = {c: [] for c in op.apply_cols}
    for vl in batches:
        for c in op.apply_cols:
            cols[c].append(np.asarray(vl[c]))
    out = {c: (np.concatenate(v) if v else np.empty(0))
           for c, v in cols.items()}
    stats.rows_output = len(next(iter(out.values()))) if out else 0
    set_name = op.info["set"]
    if len(out) == 1 and write_outputs:
        rec = next(iter(out.values()))
        if set_name not in store.sets and rec.dtype != object:
            store.send_data(set_name, rec)
    return out


# -------------------------------------------------------------- placement
def greedy_page_placement(page_bytes: Sequence[int], P: int) -> List[int]:
    """Destination partition per page: each page (in storage order) goes to
    the currently least-loaded-by-bytes partition, ties broken by lowest
    rank. With equal-size pages this degenerates to exactly the old
    round-robin ``i % P``; with skewed page sizes it keeps byte loads
    balanced. Shared by the local simulation's ``Executor._scan`` and the
    distributed ``dist.placement`` so the two backends always shard
    identically — byte-identical results stay a structural property."""
    loads = [0] * P
    dest: List[int] = []
    for sz in page_bytes:
        w = min(range(P), key=lambda i: loads[i])
        dest.append(w)
        loads[w] += int(sz)
    return dest


# ------------------------------------------------------------------- glue
def concat_batches(batches: Sequence[VectorList]) -> VectorList:
    out: Optional[VectorList] = None
    for b in batches:
        out = b if out is None else out.concat(b)
    return out if out is not None else VectorList()


def bytes_of(vl: VectorList) -> int:
    total = 0
    for _, c in vl.items():
        arr = np.asarray(c)
        total += arr.nbytes if arr.dtype != object else len(arr) * 64
    return total
