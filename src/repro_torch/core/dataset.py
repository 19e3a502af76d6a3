"""The fluent, lazy ``Dataset`` handle — "declarative in the large" (§1, §4)
as a chainable front-end.

A :class:`Dataset` is an immutable description of a query: each chain method
(``filter`` / ``select`` / ``flat_map`` / ``join`` / ``group_by(...).agg`` /
``aggregate`` / ``top_k`` / ``write``) returns a new handle holding one more
plan node.
Nothing runs until a terminal — ``collect()`` / ``to_numpy()`` — at which
point the owning :class:`~repro_torch.core.session.Session` synthesizes the
corresponding :class:`~repro_torch.core.computations.Computation` subclass graph,
compiles it to TCAP, optimizes (memoized per structural signature), plans
physically, and executes. ``explain()`` renders the optimized TCAP and the
physical plan without executing.

The Computation subclass layer stays the stable "capable systems
programmer" API (the paper's two-level design); this module only
*synthesizes* those classes — a run of ``filter`` calls followed by an
optional ``select`` fuses into a single SelectionComp, exactly the shape a
hand-written subclass would take, so both front-ends compile to identical
TCAP (verified by ``tests/test_fluent_api.py``).

Lambda specifications accepted by the chain methods:

* a **callable** receiving one :class:`LambdaArg` per input and returning a
  :class:`LambdaTerm` — the same construction-function contract as the
  subclass layer (``lambda e: e.salary > 60_000``, or using
  ``make_lambda`` / ``make_lambda_from_method`` for opaque/registered
  code). Note ``arg.<attr>`` sugar is shadowed by the few real LambdaArg
  attributes (``name``, ``slot``, ``type_name``, ``term``, ``col``); use
  ``arg.col("name")`` (or ``make_lambda_from_member``) for columns with
  those names.
* a **string** — attribute access on the record (``"salary"``);
* ``None`` — identity (``make_lambda_from_self``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.aggregates import AggTerm, agg
from repro_torch.core.computations import (AggregateComp, Computation, JoinComp,
                                     MultiSelectionComp, ScanSet,
                                     SelectionComp, TopKComp, WriteSet)
from repro_torch.core.lambdas import (LambdaArg, LambdaTerm, TypedLambdaArg,
                                UnknownColumnError, constant, make_lambda,
                                make_lambda_from_member,
                                make_lambda_from_self)
from repro_torch.core.relops import sum_acc_dtype
from repro_torch.objectmodel.schema import (Field, group_schema, pair_field_map,
                                      pair_schema)

__all__ = ["Dataset", "GroupedDataset"]

LambdaSpec = Union[str, Callable[..., LambdaTerm], None]


def _as_term(spec: LambdaSpec, arg: LambdaArg) -> LambdaTerm:
    if spec is None:
        return make_lambda_from_self(arg)
    if isinstance(spec, str):
        return make_lambda_from_member(arg, spec)
    term = spec(arg)
    if not isinstance(term, LambdaTerm):
        raise TypeError(f"lambda construction function returned {term!r}, "
                        "expected a LambdaTerm")
    return term


def _validate_spec(spec, schemas: Tuple) -> None:
    """Eager graph-build-time column check for typed datasets: dry-run the
    lambda construction function against typed placeholder args so a typo'd
    column raises here — at the chain call — naming the schema's fields.
    Untyped inputs (schema None) skip the check; construction-time errors
    other than unknown columns still surface at compile, as before.

    This invokes the construction function once more than compile does.
    That is within contract — construction functions build terms, they
    never touch data, and the paper requires them to be pure — and the
    dry-run's terms are discarded, so native-lambda identities (the plan
    cache key) are unaffected. A construction function with side effects
    (consuming an iterator, counting calls) is out of contract on typed
    datasets."""
    if spec is None or any(s is None for s in schemas):
        return
    if isinstance(spec, str):
        if spec not in schemas[0].field_set:
            raise UnknownColumnError(spec, schemas[0])
        return
    args = [TypedLambdaArg(i, s) for i, s in enumerate(schemas)]
    try:
        spec(*args)
    except UnknownColumnError:
        raise
    except Exception:
        pass  # construction bug unrelated to columns — reported at compile


@functools.lru_cache(maxsize=None)
def _pair_projection(left: type, right: type):
    """The default ``join()`` projection for two typed inputs: a native
    stage packing both records into the synthesized pair schema (field
    layout from :func:`~repro_torch.objectmodel.schema.pair_field_map`, the
    single source of the rename rule). Cached per schema pair so repeated
    joins share one native-lambda identity (the strict plan-cache
    signature keys natives by function id)."""
    pair = pair_schema(left, right)
    moves = pair_field_map(left, right)

    def pack_pair(lrows, rrows):
        sides = (lrows, rrows)
        out = np.zeros(len(lrows), pair.dtype)
        for dst, side, src in moves:
            out[dst] = sides[side][src]
        return out

    return pack_pair, pair


# --------------------------------------------------------------- plan nodes
@dataclasses.dataclass(frozen=True)
class _Scan:
    set_name: str
    type_name: str
    schema: Optional[type] = None  # Record subclass when the set is typed


@dataclasses.dataclass(frozen=True)
class _Filter:
    parent: Any
    pred: Callable


@dataclasses.dataclass(frozen=True)
class _Select:
    parent: Any
    proj: LambdaSpec


@dataclasses.dataclass(frozen=True)
class _FlatMap:
    parent: Any
    proj: LambdaSpec
    pred: Optional[Callable]


@dataclasses.dataclass(frozen=True)
class _Join:
    left: Any
    right: Any
    on: Callable
    project: Callable
    schema: Optional[type] = None  # pair schema for the default projection


@dataclasses.dataclass(frozen=True)
class _GroupedAgg:
    parent: Any
    keys: Tuple[Tuple[str, Any], ...]  # (output column name, lambda spec)
    outs: Tuple[Tuple[str, AggTerm], ...]  # (output column name, aggregate)
    schema: Optional[type] = None  # synthesized group schema, when typed


@dataclasses.dataclass(frozen=True)
class _TopK:
    parent: Any
    k: int
    score: LambdaSpec
    payload: LambdaSpec


def _node_schema(node) -> Optional[type]:
    """The record schema of a plan node's output, when statically known:
    filters preserve it, identity selects preserve it, the default join
    projection introduces the pair schema, grouped aggregations introduce
    their synthesized group schema; projections through arbitrary lambdas
    yield fresh (unknown) record types."""
    if isinstance(node, _Scan):
        return node.schema
    if isinstance(node, _Filter):
        return _node_schema(node.parent)
    if isinstance(node, _Select):
        return _node_schema(node.parent) if node.proj is None else None
    if isinstance(node, _Join):
        return node.schema
    if isinstance(node, _GroupedAgg):
        return node.schema
    return None


def _spec_result(spec: LambdaSpec, schema) -> Optional[np.ndarray]:
    """Evaluate a lambda spec over zero rows of a typed parent — the same
    zero-row dtype propagation the stage compiler uses — to learn the
    result dtype/inner shape for group-schema synthesis. ``None`` when the
    dtype cannot be determined (untyped parent, natives that reject empty
    input, non-packable dtypes)."""
    if schema is None:
        return None
    try:
        term = _as_term(spec, TypedLambdaArg(0, schema))
        with np.errstate(all="ignore"):
            val = np.asarray(term.evaluate({0: np.zeros(0, schema.dtype)}))
        return val if val.dtype.kind in "biufSU" else None
    except UnknownColumnError:
        raise
    except Exception:
        return None


def _group_fields(schema, keys, outs) -> Optional[dict]:
    """Field layout of a grouped-aggregation result — key fields then the
    named aggregate fields, dtyped by the combiner rules shared with
    :mod:`repro_torch.core.relops` (sum via :func:`~repro_torch.core.relops
    .sum_acc_dtype` — int dtypes kept, floats and bools widened; min/max
    accumulate f64, count is i64, mean is f64). ``None`` when any
    column's dtype cannot be determined statically (the result dataset is
    then untyped; columns keep their names either way)."""
    fields: dict = {}
    for name, spec in keys:
        val = _spec_result(spec, schema)
        if val is None:
            return None
        fields[name] = Field(val.dtype, val.shape[1:])
    for name, term in outs:
        if term.kind == "count":
            fields[name] = Field(np.int64)
            continue
        val = _spec_result(term.spec, schema)
        if val is None or val.dtype.kind not in "biuf":
            return None
        if term.kind == "sum":
            dt = sum_acc_dtype(val.dtype)
        elif term.kind in ("min", "max", "mean"):
            dt = np.dtype(np.float64)
        else:  # pragma: no cover - kinds validated by AggTerm
            return None
        fields[name] = Field(dt, val.shape[1:])
    return fields


class Dataset:
    """A lazy handle on a (chain of) relational transformations.

    Obtained from :meth:`Session.read` / :meth:`Session.load`; immutable —
    every chain method returns a new handle sharing the session.
    """

    def __init__(self, session, node, write_name: Optional[str] = None):
        self._session = session
        self._node = node
        self._write_name = write_name
        # memoized per-handle so repeated collect() recompiles nothing and
        # native-lambda identities stay stable (the plan-cache key relies
        # on this).
        self._sink: Optional[WriteSet] = None
        self._out_name: Optional[str] = None
        self._prog = None  # compiled TCAP, set by Session._compile
        self._sig = None   # its structural signature (plan-cache key)
        self._materialized = False  # write() target persisted already

    # ------------------------------------------------------------ typing
    @property
    def schema(self) -> Optional[type]:
        """The :class:`~repro_torch.objectmodel.schema.Record` schema of this
        handle's records, when statically known (typed scan, filters,
        identity selects, default join projections)."""
        return _node_schema(self._node)

    # ----------------------------------------------------------- chaining
    def _derive(self, node) -> "Dataset":
        if self._write_name is not None:
            raise ValueError(
                f"write({self._write_name!r}) is terminal — chain before "
                "write(), or collect() and session.read() the "
                "materialized set")
        return Dataset(self._session, node)

    def filter(self, pred: Callable) -> "Dataset":
        """Keep records where ``pred(arg)`` evaluates true."""
        if not callable(pred):
            raise TypeError("filter() takes a lambda construction function")
        _validate_spec(pred, (self.schema,))
        return self._derive(_Filter(self._node, pred))

    def select(self, proj: LambdaSpec) -> "Dataset":
        """Project each record through ``proj`` (a.k.a. :meth:`map`)."""
        _validate_spec(proj, (self.schema,))
        return self._derive(_Select(self._node, proj))

    map = select

    def flat_map(self, proj: LambdaSpec,
                 pred: Optional[Callable] = None) -> "Dataset":
        """Set-valued projection: each record maps to zero or more outputs
        (MultiSelectionComp — the projection returns per-row sequences)."""
        _validate_spec(proj, (self.schema,))
        _validate_spec(pred, (self.schema,))
        return self._derive(_FlatMap(self._node, proj, pred))

    def join(self, other: "Dataset", on: Callable,
             project: Optional[Callable] = None) -> "Dataset":
        """Equi/theta join. ``on(a, b)`` builds the predicate (equality
        conjuncts become hash-join keys, the rest a residual filter — §7);
        ``project(a, b)`` builds the output record.

        ``project`` is optional when both inputs are typed: the default
        packs both records into a synthesized pair schema
        (:func:`~repro_torch.objectmodel.schema.pair_schema` — left fields keep
        their names, colliding right fields get a type-name prefix), and
        the joined dataset stays typed under that schema."""
        if other._session is not self._session:
            raise ValueError("cannot join datasets from different sessions")
        if other._write_name is not None:
            raise ValueError(
                "cannot join against a write()-terminated dataset — "
                "collect() it and session.read() the materialized set")
        schemas = (self.schema, other.schema)
        _validate_spec(on, schemas)
        pair = None
        if project is None:
            if schemas[0] is None or schemas[1] is None:
                raise ValueError(
                    "join(project=None) needs typed datasets on both sides "
                    "(load them with a Record schema) — otherwise pass an "
                    "explicit project=")
            pack, pair = _pair_projection(*schemas)
            name = f"pack{pair.type_name}"
            moves = pair_field_map(*schemas)

            def project(a, b, _fn=pack, _nm=name, _mv=moves):
                term = make_lambda([a, b], _fn, _nm)
                # provenance for planlint: which (side, src) record field
                # each output field copies — lets the partitioning pass
                # resolve attAccess on the pair back through the join, so
                # a JOIN->AGG chain on the join key elides its exchange
                term.info["pair_fields"] = _mv
                return term
        else:
            _validate_spec(project, schemas)
        return self._derive(_Join(self._node, other._node, on, project,
                                  schema=pair))

    def group_by(self, *keys: LambdaSpec) -> "GroupedDataset":
        """Declarative grouped aggregation: ``ds.group_by(k1, k2).agg(
        total=agg.sum(expr), n=agg.count(), ...)``.

        Each key is a column name (the output key column keeps that name)
        or a lambda construction function (named ``key``/``key<i>``); the
        named aggregates come from the :class:`~repro_torch.core.aggregates.agg`
        factories. The result is one row per distinct key tuple with the
        key columns followed by the named aggregate columns — typed under
        a synthesized group schema when the dtypes are statically known,
        so ``filter``/``top_k``/``join`` chain off grouped results."""
        if not keys:
            raise ValueError(
                "group_by() needs at least one key (for a global aggregate "
                "use a constant key, e.g. group_by(lambda r: constant(0)))")
        named = []
        for i, k in enumerate(keys):
            if isinstance(k, str):
                name = k
            else:
                if not callable(k):
                    raise TypeError(f"group_by() keys are column names or "
                                    f"lambda construction functions, got "
                                    f"{k!r}")
                name = "key" if len(keys) == 1 else f"key{i}"
            named.append((name, k))
            _validate_spec(k, (self.schema,))
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError(f"group_by() key names must be distinct, "
                             f"got {names}")
        return GroupedDataset(self, tuple(named))

    def aggregate(self, key: LambdaSpec, value: LambdaSpec,
                  combiner: str = "sum") -> "Dataset":
        """Two-stage distributed aggregation (legacy single-output form):
        per-record (key, value) extraction + an associative combiner
        (``sum``/``max``/``min``/``mean``), output columns ``key`` and
        ``value``. A thin compatibility wrapper over the generalized
        :meth:`group_by` path — both lower to the same multi-aggregate
        AGG plan."""
        _validate_spec(key, (self.schema,))
        _validate_spec(value, (self.schema,))
        return self._grouped_agg((("key", key),),
                                 (("value", AggTerm(combiner, value)),))

    def _grouped_agg(self, keys, outs) -> "Dataset":
        schema = None
        fields = _group_fields(self.schema, keys, outs)
        if fields is not None:
            try:
                schema = group_schema(fields)
            except Exception:
                schema = None
        return self._derive(_GroupedAgg(self._node, tuple(keys),
                                        tuple(outs), schema=schema))

    def top_k(self, k: int, score: LambdaSpec,
              payload: LambdaSpec) -> "Dataset":
        """Global top-k by score (the paper's TopJaccard pattern)."""
        _validate_spec(score, (self.schema,))
        _validate_spec(payload, (self.schema,))
        return self._derive(_TopK(self._node, int(k), score, payload))

    def write(self, set_name: str) -> "Dataset":
        """Name the output set; ``collect()`` materializes the result there
        (structured record array) if the set does not already exist."""
        return Dataset(self._session, self._node, write_name=set_name)

    # ---------------------------------------------------------- terminals
    def collect(self) -> Dict[str, np.ndarray]:
        """Compile → optimize (plan-cached) → plan → execute; returns the
        output vector list as named numpy columns."""
        return self._session._run(self)

    def to_numpy(self) -> np.ndarray:
        result = self.collect()
        if len(result) != 1:
            raise ValueError(
                f"to_numpy() needs a single-column result, got "
                f"{sorted(result)}; use collect()")
        return next(iter(result.values()))

    def explain(self, diagnostics: bool = False,
                analyze: bool = False) -> str:
        """Render the optimized TCAP program + physical plan (no
        execution). With ``diagnostics=True``, the planlint report —
        structured findings plus the inferred output schema — is appended.
        With ``analyze=True`` the query is *executed* under a forced span
        recorder and a per-op table (wall ms / rows / bytes / % of query
        wall) is rendered next to the static plan; the merged trace stays
        available as ``session.last_trace`` (Perfetto export via
        ``last_trace.to_chrome_trace(path)``). Unlike ``collect()``, plain
        explain never refuses a plan: a query the analyzer gates on can
        still be inspected here (``analyze=True`` runs the plan, so it
        gates exactly as ``collect()`` does)."""
        return self._session._explain(self, diagnostics=diagnostics,
                                      analyze=analyze)

    def check(self):
        """Run the compile-time analyzer (planlint) over this query under
        the session's configuration and return the
        :class:`~repro_torch.analysis.diagnostics.AnalysisReport` — schema/dtype
        inference, partitioning facts and elided exchanges, capability and
        fusion findings. Never executes and never raises on findings."""
        return self._session._check(self)

    @property
    def output_set(self) -> Optional[str]:
        """The output set name (explicit via write(), else assigned at first
        compile)."""
        return self._write_name or self._out_name

    @property
    def set_name(self) -> Optional[str]:
        """For a plain scan handle, the stored set it reads; otherwise the
        output set name (if any)."""
        if isinstance(self._node, _Scan):
            return self._node.set_name
        return self.output_set

    # ------------------------------------------------------------- build
    def _build_sink(self) -> WriteSet:
        if self._sink is None:
            sess = self._session
            if self._write_name is not None:
                self._out_name = self._write_name
            else:
                self._out_name = sess.fresh_set_name("out")
            comp = _synthesize(sess, self._node)
            sink = WriteSet(sess.db, self._out_name, scope=sess.scope)
            sink.set_input(comp)
            self._sink = sink
        return self._sink


class GroupedDataset:
    """The intermediate handle of :meth:`Dataset.group_by`: holds the key
    specs, waiting for :meth:`agg` to name the aggregate outputs."""

    def __init__(self, ds: Dataset, keys: Tuple[Tuple[str, Any], ...]):
        self._ds = ds
        self._keys = keys

    @property
    def key_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self._keys)

    def agg(self, **outputs: AggTerm) -> Dataset:
        """Named multi-aggregate outputs over the grouped keys::

            ds.group_by("returnflag", "linestatus").agg(
                sum_qty=agg.sum("qty"),
                avg_disc=agg.mean("discount"),
                n=agg.count())

        Every output is an :class:`~repro_torch.core.aggregates.AggTerm` from
        the ``agg`` factories; value specs are column names or lambda
        construction functions, validated against the schema here — at the
        chain call."""
        if not outputs:
            raise ValueError("agg() needs at least one named aggregate, "
                             "e.g. agg(total=agg.sum('price'))")
        ds = self._ds
        key_names = set(self.key_names)
        for name, term in outputs.items():
            if not isinstance(term, AggTerm):
                raise TypeError(
                    f"agg({name}=...) takes an AggTerm from the agg "
                    f"factories (agg.sum/min/max/mean/count), got {term!r}")
            if name in key_names:
                raise ValueError(
                    f"agg() output {name!r} collides with a group_by key "
                    f"name {sorted(key_names)}")
            if term.kind != "count":
                _validate_spec(term.spec, (ds.schema,))
        return ds._grouped_agg(self._keys, tuple(outputs.items()))


# ----------------------------------------------------- graph synthesis
def _synthesize(sess, node) -> Computation:
    scope = sess.scope

    if isinstance(node, _Scan):
        return ScanSet(sess.db, node.set_name, node.schema or node.type_name,
                       scope=scope)

    if isinstance(node, (_Filter, _Select)):
        # fuse the maximal filter* [select] run into ONE SelectionComp —
        # the same shape a hand-written subclass takes.
        proj: LambdaSpec = None
        cur = node
        if isinstance(cur, _Select):
            proj = cur.proj
            cur = cur.parent
        preds = []
        while isinstance(cur, _Filter):
            preds.append(cur.pred)
            cur = cur.parent
        preds.reverse()
        upstream = _synthesize(sess, cur)

        class _FluentSelection(SelectionComp):
            def get_selection(self, arg):
                if not preds:
                    return constant(True)
                term = preds[0](arg)
                for p in preds[1:]:
                    term = term & p(arg)
                return term

            def get_projection(self, arg):
                return _as_term(proj, arg)

        comp = _FluentSelection(name=scope.fresh("Select"), scope=scope)
        comp.set_input(upstream)
        # filters (and identity selects) preserve the record schema, so
        # downstream lambda args stay typed across the fused selection
        comp.output_schema = _node_schema(node)
        return comp

    if isinstance(node, _FlatMap):
        upstream = _synthesize(sess, node.parent)
        pred, proj = node.pred, node.proj

        class _FluentFlatMap(MultiSelectionComp):
            def get_selection(self, arg):
                return pred(arg) if pred is not None else constant(True)

            def get_projection(self, arg):
                return _as_term(proj, arg)

        comp = _FluentFlatMap(name=scope.fresh("FlatMap"), scope=scope)
        comp.set_input(upstream)
        return comp

    if isinstance(node, _Join):
        left = _synthesize(sess, node.left)
        right = _synthesize(sess, node.right)
        on, project = node.on, node.project

        class _FluentJoin(JoinComp):
            def get_selection(self, *args):
                return on(*args)

            def get_projection(self, *args):
                return project(*args)

        comp = _FluentJoin(arity=2, name=scope.fresh("Join"), scope=scope)
        comp.set_input(0, left)
        comp.set_input(1, right)
        comp.output_schema = node.schema  # pair schema (default projection)
        return comp

    if isinstance(node, _GroupedAgg):
        upstream = _synthesize(sess, node.parent)
        keys, outs = node.keys, node.outs

        class _FluentGroupedAgg(AggregateComp):
            key_names = tuple(n for n, _ in keys)

            def get_key_projections(self, arg):
                return [_as_term(spec, arg) for _, spec in keys]

            def get_aggregates(self, arg):
                return [(name, t.kind,
                         None if t.kind == "count"
                         else _as_term(t.spec, arg))
                        for name, t in outs]

        comp = _FluentGroupedAgg(name=scope.fresh("Aggregate"), scope=scope)
        comp.set_input(upstream)
        # grouped results stay typed under the synthesized group schema,
        # so downstream chains resolve columns at graph-build time
        comp.output_schema = node.schema
        return comp

    if isinstance(node, _TopK):
        upstream = _synthesize(sess, node.parent)
        score, payload = node.score, node.payload

        class _FluentTopK(TopKComp):
            def get_score(self, arg):
                return _as_term(score, arg)

            def get_payload(self, arg):
                return _as_term(payload, arg)

        comp = _FluentTopK(node.k, name=scope.fresh("TopK"), scope=scope)
        comp.set_input(upstream)
        return comp

    raise TypeError(f"unknown plan node {node!r}")
