"""The ``Session`` facade — one declarative front-end over the whole
compile → optimize → plan → execute pipeline (paper §1's "declarative in
the large" claim, made literal).

A Session owns:

* a :class:`~repro_torch.objectmodel.store.PagedStore` (or adopts a shared one),
* a :class:`~repro_torch.core.naming.NameScope` — all set and computation names
  synthesized by this session come from its own numbering stream, so two
  sessions in one process never collide (set names are additionally probed
  against the store, which covers sessions *sharing* a store),
* the executor configuration (backend, partition/worker count, vector
  width, broadcast threshold, vectorized vs volcano),
* a **plan cache**: optimized TCAP programs memoized by the unoptimized
  program's structural signature (:func:`~repro_torch.core.tcap
  .structural_signature`), so a repeated query skips the rule-engine
  fixpoint entirely. The cache is a bounded LRU (``plan_cache_size``,
  default 64) with hit/miss/eviction counters, so long-lived sessions
  cannot grow it without bound. Cache entries pin the unoptimized program
  too, keeping native-lambda objects alive so id-based keys can never be
  reused by a different function.

Backends: ``backend="local"`` (default) simulates P partitions in-process
(:class:`~repro_torch.core.executor.Executor`); ``backend="workers"`` runs
the real driver + N worker runtime (:class:`~repro_torch.dist.driver
.DistributedExecutor`) with page-serialized exchanges — same kernels,
identical results, real ``shuffle_bytes``; ``backend="service"`` submits
to a resident :class:`~repro_torch.service.service.QueryService` pool.
Expression backends:
``expr_backend="torch"`` (default) runs every fused stage's numeric core
and every partition's pre-aggregation through the hand-written kernels
on ``device`` (CUDA unless the caller names another device; with no
card it raises rather than fall back to the CPU); ``"numpy"`` and
``"interp"`` run on the host when asked for by name.

Usage::

    sess = Session(num_partitions=4)            # or backend="workers",
    emps = sess.load("employees", records,      #    num_workers=4
                     type_name="Employee")
    payroll = (emps.filter(lambda e: e.salary > 60_000)
                   .group_by("dept")
                   .agg(total=agg.sum("salary"), n=agg.count(),
                        avg=agg.mean("salary")))
    print(payroll.explain())
    result = payroll.collect()  # named columns: dept, total, n, avg
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.compiler import compile_graph
from repro_torch.core.dataset import Dataset, _Scan
from repro_torch.core.executor import Executor
from repro_torch.core.exprc import build_steps
from repro_torch.core.naming import NameScope
from repro_torch.core.optimizer import OptimizerReport, optimize
from repro_torch.core.physical import PhysicalPlan, plan_physical
from repro_torch.core.tcap import TCAPProgram, structural_signature
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.render import last_run_lines, render_analyze
from repro_torch.obs.trace import NULL, QueryTrace, SpanRecorder, using
from repro_torch.objectmodel.schema import Record
from repro_torch.objectmodel.store import PagedStore

__all__ = ["Session"]


@dataclasses.dataclass
class _CacheEntry:
    # the unoptimized program is pinned deliberately: the signature keys on
    # native-lambda id(), which stays unique only while the object lives.
    unoptimized: TCAPProgram
    optimized: TCAPProgram
    report: OptimizerReport
    # the physical plan derived from the optimized program + live catalog
    # statistics, valid while the store's stats_version is unchanged
    physical: Optional[PhysicalPlan] = None
    stats_version: int = -1
    # the compiled stage plan (fused/jitted kernels) for this session's
    # expr_backend — pinned here so the warm path reuses kernel callables
    # with no lookups at all
    steps: Optional[list] = None
    # the planlint report (repro_torch.analysis) for optimized+physical, reset
    # whenever the physical plan is re-derived (join algorithms and elided
    # exchanges feed the partitioning/capability passes)
    analysis: Optional[object] = None


class Session:
    """Owns storage, naming, executor configuration, and the plan cache."""

    def __init__(self, store: Optional[PagedStore] = None, db: str = "db",
                 num_partitions: Optional[int] = None,
                 vector_rows: int = 8192,
                 do_optimize: bool = True,
                 broadcast_threshold_bytes: int = 2 << 30,
                 executor_cls=Executor, backend: str = "local",
                 num_workers: Optional[int] = None,
                 worker_kind: Optional[str] = None,
                 socket_launch: Optional[str] = None,
                 socket_addr: Optional[Tuple[str, int]] = None,
                 plan_cache_size: int = 64,
                 expr_backend: str = "torch",
                 elide_exchanges: bool = True,
                 advise_joins: bool = False,
                 trace: bool = False,
                 service=None,
                 device=None):
        if backend == "service" and service is not None:
            # client sessions share the service's store (the catalog and
            # the pool's resident shards are keyed against it) — a
            # different store here would plan against data the pool
            # cannot see
            if store is not None and store is not service.store:
                raise ValueError(
                    "backend='service' sessions share the QueryService's "
                    "store — drop the store argument (or pass "
                    "service.store)")
            store = service.store
            expr_backend = service.expr_backend
        self.service = service
        self.store = store if store is not None else PagedStore()
        self.db = db
        self.scope = NameScope()
        self.do_optimize = do_optimize
        self.backend = backend
        self.expr_backend = expr_backend
        self.elide_exchanges = elide_exchanges
        # advise_joins=True: let planlint's width-aware byte model (the
        # PL203 cross-check) override the catalog-itemsize broadcast-vs-
        # hash decision in plan_physical
        self.advise_joins = advise_joins
        # query tracing: per-query span recording through plan, executor,
        # kernels, and (workers backend) every rank — `Session(trace=True)`
        # or REPRO_TRACE=1. Off by default: every instrumentation site then
        # sees the shared no-op recorder (repro_torch.obs.trace.NULL).
        self.trace = bool(trace) or os.environ.get("REPRO_TRACE") == "1"
        self.last_trace: Optional[QueryTrace] = None
        # build-time configuration validation is an analyzer capability
        # rule set (repro_torch.analysis.capability) — one fixed rule order, the
        # historical exception messages preserved verbatim. Imported here,
        # not at module top: the analysis package imports repro_torch.core
        # submodules, and a module-level import both ways would cycle
        # through the package inits.
        from repro_torch.analysis.capability import (BuildConfig,
                                               check_session_config)
        self._build_config = BuildConfig(
            backend=backend, num_partitions=num_partitions,
            num_workers=num_workers, worker_kind=worker_kind,
            socket_launch=socket_launch, socket_addr=socket_addr,
            expr_backend=expr_backend, plan_cache_size=plan_cache_size,
            custom_executor=executor_cls is not Executor,
            has_service=service is not None)
        check_session_config(self._build_config)
        # the session drives optimization itself (through the plan cache),
        # so its executor always runs programs as given.
        # expr_backend="torch" runs its kernels on `device`: CUDA unless
        # the caller names another device (models.resolve_device); the
        # workers hand it to every rank, the service's pool has its own
        if backend == "service":
            from repro_torch.service.service import ServiceExecutor
            self.executor = ServiceExecutor(service)
        elif backend == "workers":
            from repro_torch.dist.driver import DistributedExecutor
            self.executor = DistributedExecutor(
                self.store,
                num_workers=num_workers or num_partitions or 4,
                vector_rows=vector_rows, do_optimize=False,
                broadcast_threshold_bytes=broadcast_threshold_bytes,
                write_outputs=False, worker_kind=worker_kind or "thread",
                expr_backend=expr_backend, socket_launch=socket_launch,
                socket_addr=socket_addr, device=device)
        else:
            self.executor = executor_cls(
                self.store,
                num_partitions=4 if num_partitions is None
                else num_partitions,
                vector_rows=vector_rows, do_optimize=False,
                broadcast_threshold_bytes=broadcast_threshold_bytes,
                write_outputs=False, expr_backend=expr_backend,
                device=device)
        self.plan_cache_size = plan_cache_size
        self._plan_cache: "OrderedDict[Tuple, _CacheEntry]" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.phys_hits = 0
        self.phys_misses = 0
        self.last_stats = None
        self.last_report: Optional[OptimizerReport] = None

    # ----------------------------------------------------------- service
    @classmethod
    def connect(cls, service, **kw) -> "Session":
        """A client session over a running
        :class:`~repro_torch.service.service.QueryService` — shorthand for
        ``Session(backend="service", service=service)``. Any number of
        clients may connect to one service; their queries interleave on
        the shared pool under its admission control."""
        return cls(backend="service", service=service, **kw)

    # ------------------------------------------------------------ naming
    def fresh_set_name(self, prefix: str) -> str:
        """A set name absent from the store and not yet handed out to
        anyone — reservations live on the (possibly shared) store, so two
        sessions sharing one store can never claim the same name even
        before either writes."""
        while True:
            name = self.scope.fresh(prefix)
            if (name not in self.store.sets
                    and name not in self.store.reserved_names):
                self.store.reserved_names.add(name)
                return name

    # -------------------------------------------------------------- I/O
    def read(self, set_name: str, type_name=None) -> Dataset:
        """A Dataset over an existing stored set.

        ``type_name`` may be a :class:`~repro_torch.objectmodel.schema.Record`
        subclass — the canonical typed form: column accesses on the dataset
        are then resolved against the schema at graph-build time — or a
        plain string (untyped, ``col()`` escape hatch available)."""
        if isinstance(type_name, type) and issubclass(type_name, Record):
            stored = self.store.sets.get(set_name)
            if stored is not None and stored.dtype != type_name.dtype:
                raise TypeError(
                    f"read({set_name!r}): stored layout {stored.dtype} does "
                    f"not match schema {type_name.type_name!r} "
                    f"({type_name.dtype})")
            return Dataset(self, _Scan(set_name, type_name.type_name,
                                       schema=type_name))
        return Dataset(self, _Scan(set_name, type_name or set_name))

    def load(self, name: str, records: np.ndarray,
             type_name=None) -> Dataset:
        """Store packed records under a fresh session-scoped set name and
        return a Dataset over them (``sendData`` + scan). With a Record
        schema as ``type_name``, the records are validated against the
        schema's layout and the dataset is typed."""
        if isinstance(type_name, type) and issubclass(type_name, Record):
            records = type_name.validate(records)
        sname = self.fresh_set_name(name)
        self.store.send_data(sname, records)
        return self.read(sname, type_name or name)

    def create_set(self, schema, name: Optional[str] = None) -> Dataset:
        """Create an empty typed set from a Record schema and return the
        (typed) Dataset over it; feed it via ``session.store.send_data``
        or :meth:`load`. The schema class is the canonical argument — its
        dtype defines the page layout, its fields type the columns."""
        if not (isinstance(schema, type) and issubclass(schema, Record)):
            raise TypeError(
                f"create_set() takes a Record schema class, got {schema!r}")
        if name is None:
            sname = self.fresh_set_name(schema.type_name.lower())
        else:
            if name in self.store.reserved_names:
                raise ValueError(
                    f"create_set({name!r}): name is already reserved by a "
                    "session (fresh_set_name) — creating it would let that "
                    "session silently append into this set")
            sname = name
        self.store.create_set(sname, schema.dtype)
        return self.read(sname, schema)

    # --------------------------------------------------------- pipeline
    def _compile(self, ds: Dataset) -> TCAPProgram:
        # memoized per handle: recompiling would re-invoke the user's
        # lambda-construction functions, and inline native lambdas would
        # get fresh identities — defeating the plan cache.
        if ds._prog is None:
            ds._prog = compile_graph(ds._build_sink())
            ds._sig = structural_signature(ds._prog, strict=True)
        return ds._prog

    def _plan(self, ds: Dataset, rec=NULL):
        """Compile + optimize (plan-cached) + physically plan (cached per
        store stats_version) + analyze (the planlint gate: a plan with
        error-severity diagnostics is refused before execution) +
        stage-compile (kernels pinned on the cache entry). Returns
        ``(prog, report, physical_plan, steps)`` — the latter two are None
        when optimization is off (the executor then derives both itself,
        and the gate is skipped with it). ``rec`` records one span per
        phase (cached phases show up as near-zero spans — the plan cache
        paying off is itself visible in the trace)."""
        with rec.span("plan", cat="phase"):
            with rec.span("plan:compile", cat="plan"):
                prog = self._compile(ds)
            if not self.do_optimize:
                return prog, None, None, None
            with rec.span("plan:optimize", cat="plan"):
                entry = self._entry_for(ds)
            with rec.span("plan:physical", cat="plan"):
                plan = self._physical_for(entry)
            with rec.span("plan:analyze", cat="plan"):
                errors = self._analysis_for(entry, plan).errors()
            if errors:
                raise ValueError(errors[0].message)
            with rec.span("plan:stages", cat="plan"):
                steps = self._steps_for(entry)
            return (self._rebind_output(entry.optimized, ds.output_set),
                    entry.report, plan, steps)

    def _entry_for(self, ds: Dataset) -> _CacheEntry:
        key = ds._sig
        entry = self._plan_cache.get(key)
        if entry is not None:
            self.cache_hits += 1
            METRICS.inc("plan_cache.hits")
            self._plan_cache.move_to_end(key)  # LRU touch
        else:
            opt, rep = optimize(ds._prog)
            self.cache_misses += 1
            METRICS.inc("plan_cache.misses")
            entry = _CacheEntry(ds._prog, opt, rep)
            self._plan_cache[key] = entry
            while len(self._plan_cache) > self.plan_cache_size:
                self._plan_cache.popitem(last=False)
                self.cache_evictions += 1
                METRICS.inc("plan_cache.evictions")
        return entry

    def _physical_for(self, entry: _CacheEntry) -> PhysicalPlan:
        """The physical plan cached alongside the logical one, re-derived
        only when the store's statistics version moved (sets grew or
        appeared) — the ROADMAP follow-up to per-execution re-planning."""
        ver = self.store.stats_version
        if entry.physical is not None and entry.stats_version == ver:
            self.phys_hits += 1
            return entry.physical
        self.phys_misses += 1
        entry.physical = plan_physical(
            entry.optimized, self.store, self.executor.broadcast_threshold,
            num_partitions=self.executor.P,
            elide_exchanges=self.elide_exchanges,
            advise_joins=self.advise_joins)
        entry.stats_version = ver
        entry.analysis = None  # join algos / elisions may have changed
        return entry.physical

    def _analysis_for(self, entry: _CacheEntry, plan: PhysicalPlan):
        """The planlint report cached with the plan (re-run only when the
        physical plan re-derives)."""
        if entry.analysis is None:
            from repro_torch.analysis import analyze
            entry.analysis = analyze(
                entry.optimized, store=self.store, plan=plan,
                config=self._build_config, expr_backend=self.expr_backend,
                broadcast_threshold=self.executor.broadcast_threshold,
                num_partitions=self.executor.P)
        return entry.analysis

    def _check(self, ds: Dataset):
        """``Dataset.check()``: the full planlint report for this query
        under this session's configuration — never raises on findings."""
        prog = self._compile(ds)
        if not self.do_optimize:
            from repro_torch.analysis import analyze
            plan = plan_physical(
                prog, self.store, self.executor.broadcast_threshold,
                num_partitions=self.executor.P,
                elide_exchanges=self.elide_exchanges,
                advise_joins=self.advise_joins)
            return analyze(prog, store=self.store, plan=plan,
                           config=self._build_config,
                           expr_backend=self.expr_backend,
                           broadcast_threshold=(
                               self.executor.broadcast_threshold),
                           num_partitions=self.executor.P)
        entry = self._entry_for(ds)
        return self._analysis_for(entry, self._physical_for(entry))

    def _steps_for(self, entry: _CacheEntry) -> Optional[list]:
        """The compiled stage plan for the local executor, pinned on the
        cache entry so warm queries reuse fused/jitted kernel callables
        directly. The workers backend compiles its own stages from the
        shipped program (same kernel LRU, shared per process)."""
        if self.backend != "local":
            return None
        if entry.steps is None:
            entry.steps = build_steps(entry.optimized,
                                      self.executor.expr_backend,
                                      getattr(self.executor, "device", None))
        return entry.steps

    @staticmethod
    def _rebind_output(prog: TCAPProgram, out_set: str) -> TCAPProgram:
        """The OUTPUT set name is excluded from the cache key (it's a sink
        label, not query shape) — point a reused program at this handle's
        output set."""
        ops = list(prog.ops)
        for i, op in enumerate(ops):
            if op.op == "OUTPUT" and op.info.get("set") != out_set:
                ops[i] = dataclasses.replace(
                    op, info={**op.info, "set": out_set})
                return TCAPProgram(ops)
        return prog

    def _run(self, ds: Dataset) -> Dict[str, np.ndarray]:
        write_name = ds._write_name
        if (write_name is not None and not ds._materialized
                and write_name in self.store.sets):
            raise ValueError(
                f"write({write_name!r}): set already exists in the store — "
                "pick a fresh name (Session.fresh_set_name) to avoid "
                "silently reading stale or merged data")
        rec = SpanRecorder() if self.trace else NULL
        # the service backend materializes write() worker-side: the pool
        # packs each rank's output partition into catalog-registered
        # resident shards (no page round-trip through the driver), so the
        # driver-side materialization below is skipped — the collect()
        # result is empty; read the set back to see the rows
        service_write = (self.backend == "service"
                         and write_name is not None
                         and not ds._materialized)
        if service_write:
            self.executor.write_name = write_name
        try:
            result, rep = self._traced_execute(ds, rec)
        finally:
            if service_write:
                self.executor.write_name = None
        if write_name is not None and not ds._materialized:
            if not service_write:
                self._materialize(write_name, result)
            ds._materialized = True
        return result

    def _traced_execute(self, ds: Dataset, rec):
        """Plan + execute one query under ``rec`` (root span "query"),
        updating ``last_stats`` / ``last_report`` / ``last_trace`` and the
        process-wide metrics. Shared by ``collect()`` and
        ``explain(analyze=True)``."""
        t0 = time.monotonic_ns()
        with using(rec):
            with rec.span("query", cat="query", backend=self.backend,
                          expr_backend=self.expr_backend):
                prog, rep, plan, steps = self._plan(ds, rec)
                with rec.span("execute", cat="phase"):
                    result = self.executor.execute_program(
                        prog, plan=plan, steps=steps,
                        trace=rec if rec.enabled else None)
        wall_ms = (time.monotonic_ns() - t0) / 1e6
        self.last_stats = st = self.executor.stats
        self.last_report = rep
        if rec.enabled:
            self.last_trace = QueryTrace.merge(
                rec, getattr(self.executor, "worker_spans", None),
                backend=self.backend,
                transport=getattr(self.executor, "worker_kind", None),
                P=self.executor.P, expr_backend=self.expr_backend,
                wall_ms=wall_ms)
        METRICS.inc("queries.total")
        METRICS.inc("query.wall_ms.total", wall_ms)
        METRICS.gauge("query.wall_ms.last", wall_ms)
        METRICS.inc("rows.scanned.total", int(st.rows_scanned))
        METRICS.inc("rows.output.total", int(st.rows_output))
        METRICS.inc("shuffle.bytes.total", int(st.shuffle_bytes))
        METRICS.inc("exchanges.elided.total", int(st.exchanges_elided))
        return result, rep

    def _materialize(self, name: str, result: Dict[str, np.ndarray]) -> None:
        """Persist a collect() result as a structured-record set — the only
        write-back path for session-run queries (the session's executor has
        write_outputs=False), so single- and multi-column results get the
        same named-field treatment."""
        arrays = {c: np.asarray(a) for c, a in result.items()}
        bad = [c for c, a in arrays.items() if a.dtype == object]
        if bad:
            raise ValueError(
                f"write({name!r}): cannot materialize object-dtype "
                f"column(s) {bad} as packed records")
        if not arrays:
            raise ValueError(f"write({name!r}): query produced no columns")
        n = len(next(iter(arrays.values())))
        dtype = np.dtype([(c, a.dtype, a.shape[1:])
                          for c, a in arrays.items()])
        recs = np.zeros(n, dtype)
        for c, a in arrays.items():
            recs[c] = a
        self.store.send_data(name, recs)

    def _explain(self, ds: Dataset, diagnostics: bool = False,
                 analyze: bool = False) -> str:
        # deliberately not via _plan(): explain never gates, so a plan the
        # analyzer refuses can still be inspected (with its diagnostics).
        # analyze=True *executes* the query under a forced recorder first
        # (and does go through _plan's gate, since it runs the plan), so
        # the static plan below is rendered next to measured per-op time.
        analyzed = None
        if analyze:
            self._traced_execute(ds, SpanRecorder())
            analyzed = render_analyze(self.last_trace)
        prog = self._compile(ds)
        analysis = rep = None
        if self.do_optimize:
            entry = self._entry_for(ds)
            plan = self._physical_for(entry)
            analysis = self._analysis_for(entry, plan)
            rep = entry.report
            prog = self._rebind_output(entry.optimized, ds.output_set)
        else:
            plan = plan_physical(prog, self.store,
                                 self.executor.broadcast_threshold,
                                 num_partitions=self.executor.P,
                                 elide_exchanges=self.elide_exchanges,
                                 advise_joins=self.advise_joins)
        if self.backend == "workers":
            backend = (f"workers x{self.executor.P} "
                       f"via {self.executor.worker_kind}")
        elif self.backend == "service":
            backend = (f"service pool x{self.executor.P} "
                       f"via {self.service.launch}")
        else:
            backend = f"local sim x{self.executor.P}"
        lines = [f"== optimized TCAP ({len(prog)} ops) =="]
        if rep is not None:
            lines.append(
                f"-- optimizer: {rep.iterations} iterations, CSE removed "
                f"{rep.cse_removed}, filters pushed {rep.filters_pushed}, "
                f"dead cols {rep.dead_cols_removed}, dead ops "
                f"{rep.dead_ops_removed}")
        lines.append(prog.to_text())
        lines.append(f"== physical plan: {len(plan.pipelines)} pipelines, "
                     f"{self.executor.P} partitions ({backend}, "
                     f"expr={self.executor.expr_backend}) ==")
        for i, pipe in enumerate(plan.pipelines):
            stages = " -> ".join(op.op for op in pipe)
            lines.append(f"  pipeline {i}: {stages}")
            for op in pipe:
                if op.op == "JOIN":
                    algo = plan.join_algo.get(id(op), "hash_partition")
                    est = plan.estimates.get(op.in_list2, 0.0)
                    lines.append(f"    join: {algo} "
                                 f"(build side ~{est:,.0f} bytes)")
                    sides = plan.join_elide.get(id(op), ())
                    if sides:
                        named = {"L": "probe", "R": "build"}
                        lines.append(
                            "    join: exchange elided on "
                            + " and ".join(named[s] for s in sides)
                            + " side (already hash-partitioned on the "
                            "join key)")
                elif op.op == "AGG" and id(op) in plan.agg_elide:
                    lines.append("    agg: exchange elided (input already "
                                 "hash-partitioned on the key)")
        if diagnostics:
            if analysis is None:
                from repro_torch.analysis import analyze
                analysis = analyze(prog, store=self.store, plan=plan,
                                   config=self._build_config,
                                   expr_backend=self.expr_backend,
                                   broadcast_threshold=(
                                       self.executor.broadcast_threshold),
                                   num_partitions=self.executor.P)
            lines.append(analysis.format())
        if analyzed is not None:
            lines.append(analyzed)
        lines.extend(self._explain_last_run())
        return "\n".join(lines)

    def _explain_last_run(self) -> list:
        """Execution stats from the session's most recent query, if any —
        for backend='workers' the shuffle_bytes are real serialized page
        traffic, reported per worker with the transport named (rendering
        single-sourced in :mod:`repro_torch.obs.render`). Service sessions add
        the admission/catalog footer — the observable feedback loop."""
        lines = last_run_lines(
            self.last_stats,
            getattr(self.executor, "worker_stats", None),
            getattr(self.executor, "worker_kind", None))
        if self.backend == "service" and self.service is not None:
            from repro_torch.obs.render import service_lines
            lines.extend(service_lines(
                self.service, getattr(self.executor,
                                      "last_setup_bytes", 0)))
        return lines

    # ------------------------------------------------------------ stats
    def plan_cache_info(self) -> Dict[str, int]:
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "entries": len(self._plan_cache),
                "evictions": self.cache_evictions,
                "capacity": self.plan_cache_size}

    def physical_plan_cache_info(self) -> Dict[str, int]:
        """Hit/miss counters for the physical plans cached alongside the
        logical plan cache (invalidated by the store stats_version)."""
        return {"hits": self.phys_hits, "misses": self.phys_misses}
