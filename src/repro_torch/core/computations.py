"""The PC Computation toolkit (paper §4): SelectionComp, JoinComp,
AggregateComp, MultiSelectionComp, plus set readers/writers.

A user builds a *graph* of Computations; each exposes lambda-term
construction functions that the TCAP compiler calls with placeholder
arguments. The user never touches the data inside these functions — they
construct the computation, they do not run it.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lambdas import LambdaArg, LambdaTerm
from repro_torch.core.naming import NameScope, default_scope

__all__ = ["Computation", "ScanSet", "WriteSet", "SelectionComp",
           "MultiSelectionComp", "JoinComp", "AggregateComp", "TopKComp"]


class Computation(abc.ABC):
    """Base of the computation graph. ``set_input`` wires the DAG.

    Naming comes from a :class:`NameScope` — the process-wide default for
    bare construction, or a Session's own scope when the fluent front-end
    synthesizes computations (so sessions never share numbering streams).
    """

    arity = 1

    # the declared Record schema of this computation's output records, or
    # None when unknown (untyped sets, projections to fresh types). When
    # set, the compiler hands lambda construction functions a
    # TypedLambdaArg, so column typos fail at graph-build time.
    output_schema = None

    def __init__(self, name: Optional[str] = None,
                 scope: Optional[NameScope] = None):
        self.comp_id = (scope or default_scope()).next_id()
        self.name = name or f"{type(self).__name__}_{self.comp_id}"
        self.inputs: List[Optional["Computation"]] = [None] * self.arity

    def set_input(self, i_or_comp, comp: Optional["Computation"] = None):
        if comp is None:
            i, comp = 0, i_or_comp
        else:
            i = i_or_comp
        self.inputs[i] = comp
        return self

    @property
    def input_type_names(self) -> List[str]:
        return [c.output_type_name for c in self.inputs]  # type: ignore

    @property
    def output_type_name(self) -> str:
        return self.name


class ScanSet(Computation):
    """Reads a stored set page-by-page (ObjectReader).

    ``type_name`` may be a plain string (untyped, as before) or a
    :class:`~repro_torch.objectmodel.schema.Record` subclass — the canonical
    typed form, which flows the schema to every downstream lambda argument.
    """

    arity = 0

    def __init__(self, db: str, set_name: str, type_name,
                 scope: Optional[NameScope] = None):
        super().__init__(name=f"Scan_{set_name}", scope=scope)
        self.db = db
        self.set_name = set_name
        if isinstance(type_name, type):
            from repro_torch.objectmodel.schema import Record
            if not issubclass(type_name, Record):
                raise TypeError(
                    f"ScanSet type_name must be a string or a Record "
                    f"schema class, got {type_name!r}")
            self.output_schema = type_name
            type_name = type_name.type_name
        self.type_name = type_name

    @property
    def output_type_name(self) -> str:
        return self.type_name


class WriteSet(Computation):
    """Writes its input set to storage (Writer)."""

    def __init__(self, db: str, set_name: str,
                 scope: Optional[NameScope] = None):
        super().__init__(name=f"Write_{set_name}", scope=scope)
        self.db = db
        self.set_name = set_name


class SelectionComp(Computation):
    """Relational selection + projection over one input set."""

    def __init__(self, name: Optional[str] = None,
                 scope: Optional[NameScope] = None):
        super().__init__(name, scope)

    @abc.abstractmethod
    def get_selection(self, arg: LambdaArg) -> LambdaTerm:
        ...

    @abc.abstractmethod
    def get_projection(self, arg: LambdaArg) -> LambdaTerm:
        ...


class MultiSelectionComp(Computation):
    """Selection with a set-valued projection: each input row maps to zero or
    more output rows. The projection lambda must return, per input column, a
    pair (values, repeats) — values flattened, repeats giving the fan-out."""

    @abc.abstractmethod
    def get_selection(self, arg: LambdaArg) -> LambdaTerm:
        ...

    @abc.abstractmethod
    def get_projection(self, arg: LambdaArg) -> LambdaTerm:
        ...


class JoinComp(Computation):
    """N-ary join with arbitrary predicate. The optimizer extracts equality
    conjuncts as hash-join keys and leaves the rest as a residual filter —
    exactly the paper's treatment (§7)."""

    def __init__(self, arity: int = 2, name: Optional[str] = None,
                 scope: Optional[NameScope] = None):
        self.arity = arity
        super().__init__(name, scope)

    @abc.abstractmethod
    def get_selection(self, *args: LambdaArg) -> LambdaTerm:
        ...

    @abc.abstractmethod
    def get_projection(self, *args: LambdaArg) -> LambdaTerm:
        ...


class AggregateComp(Computation):
    """Grouped aggregation: per-record key-tuple extraction + a list of
    named value projections with per-output combiners, executed with PC's
    two-stage distributed plan (pre-aggregate into packed multi-column
    combiner pages → shuffle partials by key hash → final merge + finalize).

    Two subclassing surfaces:

    * **legacy single-output** — override :meth:`get_key_projection` /
      :meth:`get_value_projection` (one key, one value, ``combiner=`` from
      the constructor); the multi-output defaults below wrap them, so every
      pre-existing subclass compiles unchanged to the generalized AGG op
      with key column ``key`` and output column ``value``;
    * **canonical multi-output** — set :attr:`key_names` and override
      :meth:`get_key_projections` (one term per key name) and
      :meth:`get_aggregates` (``(name, kind, term)`` triples; ``kind`` from
      :data:`~repro_torch.core.aggregates.AGG_KINDS`, ``term`` is ``None`` for
      ``count``). This is what the fluent ``group_by().agg()`` synthesizes.
    """

    #: output column names of the grouping key(s), in key-projection order
    key_names: Tuple[str, ...] = ("key",)

    def __init__(self, name: Optional[str] = None,
                 combiner: str = "sum",
                 scope: Optional[NameScope] = None):
        super().__init__(name, scope)
        if combiner not in ("sum", "max", "min", "mean"):
            raise ValueError(f"unknown combiner {combiner!r} "
                             "(expected sum|max|min|mean)")
        self.combiner = combiner  # legacy single-output combiner

    # ------------------------------------------------ legacy single API
    def get_key_projection(self, arg: LambdaArg) -> LambdaTerm:
        raise NotImplementedError(
            f"{type(self).__name__} must override get_key_projection "
            "(legacy API) or get_key_projections (multi-key API)")

    def get_value_projection(self, arg: LambdaArg) -> LambdaTerm:
        raise NotImplementedError(
            f"{type(self).__name__} must override get_value_projection "
            "(legacy API) or get_aggregates (multi-output API)")

    # -------------------------------------------- canonical multi API
    def get_key_projections(self, arg: LambdaArg) -> List[LambdaTerm]:
        """One term per entry of :attr:`key_names`; the default delegates
        to the legacy single-key projection."""
        return [self.get_key_projection(arg)]

    def get_aggregates(self, arg: LambdaArg
                       ) -> List[Tuple[str, str, Optional[LambdaTerm]]]:
        """``(output name, aggregate kind, value term)`` triples; ``term``
        is ``None`` only for ``count``. The default delegates to the legacy
        single-value projection under the constructor's combiner."""
        return [("value", self.combiner, self.get_value_projection(arg))]


class TopKComp(Computation):
    """Top-k by a score lambda (the paper's TopJaccard pattern): extract a
    (score, payload) pair per record; keep the global k best. Implemented as
    pre-top-k per page, merge across pages/workers — an aggregation sink."""

    def __init__(self, k: int, name: Optional[str] = None,
                 scope: Optional[NameScope] = None):
        super().__init__(name, scope)
        self.k = k

    @abc.abstractmethod
    def get_score(self, arg: LambdaArg) -> LambdaTerm:
        ...

    @abc.abstractmethod
    def get_payload(self, arg: LambdaArg) -> LambdaTerm:
        ...
