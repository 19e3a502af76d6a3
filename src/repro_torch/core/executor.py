"""PC's vectorized execution engine (paper §5.2, Appendix C/D), host side
(port of ``repro.core.executor``; ``expr_backend="torch"`` runs the fused
stages' numeric cores and the pre-aggregation on ``device``).

Pipelines push *vector lists* (column batches) through compiled stages. The
distributed semantics are simulated with P logical partitions on one host:

* **JOIN** — broadcast (build side replicated) or hash-partition (both sides
  shuffled by key hash) per the physical planner's decision, then build+probe;
* **AGG** — PC's two-stage plan: per-partition *pre-aggregation* into maps
  ("combiner pages"), shuffle partials by key hash, final aggregation;
* **TOPK** — per-partition top-k, then a global merge (the paper's
  TopJaccard pattern).

The per-partition operator kernels live in :mod:`repro_torch.core.relops` and are
shared verbatim with the distributed worker runtime (:mod:`repro_torch.dist`);
this module only decides partition *placement* (greedy least-loaded pages,
shared with ``dist.placement``) and
simulates the *exchange* in-process. The real exchange — page-serialized
transfers between workers — is :class:`repro_torch.dist.driver
.DistributedExecutor`, which runs the same kernels.

A row-at-a-time *volcano* interpreter (:class:`NaiveExecutor`) implements
identical semantics one record at a time — the execution model the paper
argues is obsolete — and serves as the measured baseline for the
paper-claims validation benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.compiler import compile_graph
from repro_torch.core.computations import Computation
from repro_torch.core.exprc import (EXPR_BACKENDS, FusedStage, build_steps,
                                    expr_device)
from repro_torch.core.optimizer import OptimizerReport, optimize
from repro_torch.core.physical import PhysicalPlan, plan_physical
from repro_torch.core.relops import (AggMap, AggSpec, assemble_output,
                               batch_kernel, batch_topk, bytes_of,
                               concat_batches, device_segment_reducer,
                               greedy_page_placement, merge_topk,
                               probe_join, split_by_hash)
from repro_torch.core.tcap import TCAPOp, TCAPProgram
from repro_torch.obs.trace import NULL, current, op_name, using
from repro_torch.objectmodel.store import PagedStore
from repro_torch.objectmodel.vectorlist import VectorList

__all__ = ["Executor", "NaiveExecutor", "ExecStats"]


@dataclasses.dataclass
class ExecStats:
    pages_scanned: int = 0
    rows_scanned: int = 0
    rows_joined: int = 0
    rows_output: int = 0
    shuffle_bytes: int = 0
    broadcast_joins: int = 0
    hash_partition_joins: int = 0
    exchanges_elided: int = 0
    optimizer: Optional[OptimizerReport] = None


def _part_rows(parts) -> int:
    """Total rows across a partitioned batch list (trace attribute only —
    called solely when a recorder is enabled)."""
    return sum(vl.num_rows or 0 for batches in parts for vl in batches)


class Executor:
    """Vectorized TCAP executor over a PagedStore with P logical partitions."""

    #: stage-compiler backend; NaiveExecutor pins "interp" (see below)
    expr_backend = "torch"

    def __init__(self, store: PagedStore, num_partitions: int = 4,
                 vector_rows: int = 8192, do_optimize: bool = True,
                 broadcast_threshold_bytes: int = 2 << 30,
                 write_outputs: bool = True,
                 expr_backend: Optional[str] = None,
                 device=None):
        self.store = store
        self.P = num_partitions
        self.vector_rows = vector_rows
        self.do_optimize = do_optimize
        self.broadcast_threshold = broadcast_threshold_bytes
        # when False, OUTPUT never writes back to the store — the caller
        # (the Session facade) materializes results itself so single- and
        # multi-column outputs get the same structured-record treatment.
        self.write_outputs = write_outputs
        if expr_backend is not None:
            if expr_backend not in EXPR_BACKENDS:
                raise ValueError(f"unknown expr_backend {expr_backend!r} "
                                 f"(expected one of {EXPR_BACKENDS})")
            self.expr_backend = expr_backend
        # where the torch backend's kernels run: CUDA unless the caller
        # names another device, never the CPU on its own
        self.device = expr_device(self.expr_backend, device)
        self.stats = ExecStats()

    # ------------------------------------------------------------ public
    def execute(self, sink: Computation) -> Dict[str, np.ndarray]:
        prog = compile_graph(sink)
        return self.execute_program(prog)

    def execute_program(self, prog: TCAPProgram,
                        plan: Optional[PhysicalPlan] = None,
                        steps: Optional[list] = None,
                        trace=None) -> Dict[str, np.ndarray]:
        """Run a TCAP program. ``plan`` / ``steps`` let the Session front-end
        pass its cached physical plan and compiled stage plan; standalone
        callers leave them None and both are derived here. ``trace`` is a
        :class:`~repro_torch.obs.trace.SpanRecorder` to record per-op spans into
        (None — the default — records nothing)."""
        self.stats = ExecStats()
        if self.do_optimize:
            prog, rep = optimize(prog)
            self.stats.optimizer = rep
            plan = steps = None  # derived for the pre-optimized program
        if plan is None:
            plan = plan_physical(prog, self.store, self.broadcast_threshold,
                                 num_partitions=self.P)
        if steps is None:
            steps = build_steps(prog, self.expr_backend, self.device)
        return self._run(steps, plan, NULL if trace is None else trace)

    # --------------------------------------------------------- internals
    def _run(self, steps: list, plan: PhysicalPlan, rec=NULL
             ) -> Dict[str, np.ndarray]:
        # data[list_name][partition] -> list of VectorList batches
        data: Dict[str, List[List[VectorList]]] = {}
        result: Dict[str, np.ndarray] = {}

        # the op index within the program: exchange tags key on it, and the
        # per-op span names must match the worker runtime's exactly (fused
        # steps advance it by their op count)
        i = -1
        with using(rec):
            for step in steps:
                if isinstance(step, FusedStage):
                    first, i = i + 1, i + len(step.ops)
                    name = op_name(first, i, [o.op for o in step.ops])
                    with rec.span(name, cat="op", idx=first) as sp:
                        data[step.out] = self._map_batches(
                            data[step.in_list], step)
                    if rec.enabled:
                        sp.set(rows=_part_rows(data[step.out]))
                    continue
                op = step
                i += 1
                sb0 = self.stats.shuffle_bytes
                with rec.span(op_name(i, i, [op.op]), cat="op",
                              idx=i, op=op.op) as sp:
                    if op.op == "SCAN":
                        data[op.out] = self._scan(op)
                    elif op.op in ("APPLY", "FILTER", "FLATTEN", "HASH"):
                        data[op.out] = self._map_batches(data[op.in_list],
                                                         batch_kernel(op))
                    elif op.op == "JOIN":
                        data[op.out] = self._join(
                            op, i, data[op.in_list], data[op.in_list2],
                            plan.join_algo.get(id(op), "hash_partition"),
                            elide=plan.join_elide.get(id(op), ()))
                    elif op.op == "AGG":
                        data[op.out] = self._aggregate(
                            op, i, data[op.in_list],
                            elide=id(op) in plan.agg_elide)
                    elif op.op == "TOPK":
                        data[op.out] = self._topk(op, data[op.in_list])
                    elif op.op == "OUTPUT":
                        result = self._output(op, data[op.in_list])
                    else:
                        raise ValueError(f"unknown op {op.op}")
                if rec.enabled:
                    sp.set(rows=(self.stats.rows_output
                                 if op.op == "OUTPUT"
                                 else _part_rows(data[op.out])),
                           bytes=self.stats.shuffle_bytes - sb0)
        return result

    def _scan(self, op: TCAPOp) -> List[List[VectorList]]:
        s = self.store.get_set(op.info["set"])
        parts: List[List[VectorList]] = [[] for _ in range(self.P)]
        col = op.out_cols[0]
        # skew-aware placement, identical to the distributed runtime's
        # (dist.placement shares this helper): least-loaded-by-bytes,
        # degenerating to round-robin for equal-size pages
        dest = greedy_page_placement(
            [c * s.dtype.itemsize for c in s.counts], self.P)
        for i, page_records in enumerate(s.scan()):
            self.stats.pages_scanned += 1
            self.stats.rows_scanned += len(page_records)
            for j in range(0, len(page_records), self.vector_rows):
                batch = page_records[j: j + self.vector_rows]
                parts[dest[i]].append(VectorList({col: batch}))
        return parts

    def _map_batches(self, parts, fn) -> List[List[VectorList]]:
        return [[fn(vl) for vl in batches] for batches in parts]

    # ------------------------------------------------------------- join
    def _join(self, op: TCAPOp, i: int, left, right, algo: str,
              elide: Tuple[str, ...] = ()) -> List[List[VectorList]]:
        """``elide`` names the hash-join sides ("L"/"R") the plan proved
        already hash-partitioned on their join key (PL202): those concat
        in place — byte-identical to shuffling, since the shuffle of a
        correctly-placed side is the identity permutation — and count as
        elided exchanges instead of shuffle bytes."""
        if algo == "broadcast":
            self.stats.broadcast_joins += 1
            sb0 = self.stats.shuffle_bytes
            with current().span(f"x:bcast:{i}:build", cat="exchange",
                                tag=f"{i}:build") as sp:
                build_all = concat_batches([vl for bl in right for vl in bl])
                self.stats.shuffle_bytes += (bytes_of(build_all)
                                             * max(0, self.P - 1))
            sp.set(bytes=self.stats.shuffle_bytes - sb0)
            rparts = [build_all] * self.P
            lparts = [concat_batches(p) for p in left]
        else:
            self.stats.hash_partition_joins += 1
            if "L" in elide:
                self.stats.exchanges_elided += 1
                lparts = [concat_batches(p) for p in left]
            else:
                lparts = self._shuffle(left, op.apply_cols[0], f"{i}:L")
            if "R" in elide:
                self.stats.exchanges_elided += 1
                rparts = [concat_batches(p) for p in right]
            else:
                rparts = self._shuffle(right, op.apply_cols2[0], f"{i}:R")
        out: List[List[VectorList]] = [[] for _ in range(self.P)]
        for p in range(self.P):
            probed = probe_join(op, lparts[p], rparts[p])
            if probed is None:
                continue
            res, n = probed
            self.stats.rows_joined += n
            out[p].append(res)
        return out

    def _shuffle(self, parts, hash_name: str, tag: str) -> List[VectorList]:
        """Repartition batches by hash % P (the network shuffle)."""
        sb0 = self.stats.shuffle_bytes
        with current().span(f"x:shuffle:{tag}", cat="exchange",
                            tag=tag) as sp:
            buckets: List[List[VectorList]] = [[] for _ in range(self.P)]
            for pi, batches in enumerate(parts):
                for vl in batches:
                    for p, sub in enumerate(
                            split_by_hash(vl, hash_name, self.P)):
                        if sub is None:
                            continue
                        if p != pi:
                            self.stats.shuffle_bytes += bytes_of(sub)
                        buckets[p].append(sub)
            out = [concat_batches(b) for b in buckets]
        sp.set(bytes=self.stats.shuffle_bytes - sb0)
        return out

    # -------------------------------------------------------------- agg
    def _aggregate(self, op: TCAPOp, i: int, parts,
                   elide: bool = False) -> List[List[VectorList]]:
        spec = AggSpec.from_op(op)
        kcols, acols = spec.key_cols(op), spec.acc_cols(op)
        # the torch backend pre-aggregates on device: one segment-reduce
        # kernel call per partition over all accumulator columns
        reducer = (device_segment_reducer(spec.combiners, self.device)
                   if self.expr_backend == "torch" else None)
        # stage 1: per-partition pre-aggregation (combiner pages), one
        # absorb over the partition's concatenated rows (AggMap
        # .absorb_batches — shared with the worker runtime, which is what
        # keeps the float association order identical across backends)
        partials = []
        for batches in parts:
            m = AggMap(spec)
            m.absorb_batches(batches, kcols, acols, reducer=reducer)
            partials.append(m)
        # shuffle partials by key hash, final merge + finalize per partition;
        # when the planner proved the input already stable_key_hash-
        # partitioned on the key tuple, every partial holds only keys
        # routing to itself — the split+merge is the identity permutation,
        # so the partials *are* the finals and no bytes move
        if elide:
            self.stats.exchanges_elided += 1
            finals = partials
        else:
            sb0 = self.stats.shuffle_bytes
            with current().span(f"x:shuffle:{i}:partials", cat="exchange",
                                tag=f"{i}:partials") as sp:
                finals = [AggMap(spec) for _ in range(self.P)]
                for m in partials:
                    split = m.split_by_key_hash(self.P)
                    for p in range(self.P):
                        if split[p].data:
                            self.stats.shuffle_bytes += split[p].nbytes()
                            finals[p].merge(split[p])
            sp.set(bytes=self.stats.shuffle_bytes - sb0)
        out: List[List[VectorList]] = [[] for _ in range(self.P)]
        for p, m in enumerate(finals):
            emitted = m.emit()
            if emitted is not None:
                out[p].append(emitted)
        return out

    def _topk(self, op: TCAPOp, parts) -> List[List[VectorList]]:
        best_s: List[np.ndarray] = []
        best_p: List[np.ndarray] = []
        for batches in parts:  # per-partition top-k, then merge
            for vl in batches:
                s, pay = batch_topk(op, vl)
                best_s.append(s)
                best_p.append(pay)
        out: List[List[VectorList]] = [[] for _ in range(self.P)]
        merged = merge_topk(op, best_s, best_p)
        if merged is not None:
            out[0].append(merged)
        return out

    def _output(self, op: TCAPOp, parts) -> Dict[str, np.ndarray]:
        return assemble_output(
            op, [vl for batches in parts for vl in batches],
            self.stats, self.store, self.write_outputs)


class NaiveExecutor(Executor):
    """Volcano-style record-at-a-time interpreter (paper §5.1's strawman).

    Identical semantics, but every stage is applied one record at a time via
    Python-level iteration — the cost model of a managed-runtime row
    iterator. Used only as the measured baseline in benchmarks. Always runs
    the per-op interpreter (``expr_backend="interp"``): fused stages would
    defeat the point of the strawman."""

    expr_backend = "interp"

    def __init__(self, *args, **kw):
        kw.pop("expr_backend", None)
        super().__init__(*args, **kw)
        self.expr_backend = "interp"

    def _map_batches(self, parts, fn) -> List[List[VectorList]]:
        out: List[List[VectorList]] = []
        for batches in parts:
            res = []
            for vl in batches:
                rows = []
                n = vl.num_rows or 0
                for i in range(n):  # row-at-a-time
                    row = VectorList({c: np.asarray(vl[c])[i:i + 1]
                                      for c in vl.names})
                    rows.append(fn(row))
                if rows:
                    acc = rows[0]
                    for r in rows[1:]:
                        acc = acc.concat(r)
                    res.append(acc)
                elif n == 0:
                    res.append(fn(vl))
            out.append(res)
        return out
