"""Named aggregate specifications — the vocabulary of ``group_by().agg()``.

The declarative grouped-aggregation front-end takes *named* outputs, each
built from one of the factories on the :class:`agg` namespace::

    ds.group_by("returnflag", "linestatus").agg(
        sum_qty=agg.sum("qty"),
        avg_disc=agg.mean("discount"),
        n=agg.count())

Each factory returns an :class:`AggTerm` — a (kind, lambda-spec) pair that
the fluent layer validates against the dataset's schema and the compiler
lowers onto :class:`~repro_torch.core.computations.AggregateComp`'s multi-output
plan. Kinds and their lowering (the composite rules):

* ``sum`` / ``min`` / ``max`` — one accumulator column, combined with the
  matching associative vectorized combiner (the paper's combiner-page
  pre-aggregation, now one column of a packed multi-column map);
* ``count`` — an ``int64`` constant-one column summed (no value lambda);
* ``mean`` — lowered to ``sum`` + ``count`` accumulators, divided at
  finalize (after the partial-map shuffle merge), so partial means never
  cross the wire — only exact partial sums and counts do.

Accumulator dtype rules (single-sourced in :func:`repro_torch.core.relops
.sum_acc_dtype` and shared with the schema synthesis in
:mod:`repro_torch.core.dataset`): ``sum`` keeps integer dtypes, widens floats
to ``float64`` and bools to ``int64`` (summing an indicator expression
counts it); ``min``/``max`` accumulate in ``float64``; ``count`` is
``int64``; ``mean`` is ``float64``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["AggTerm", "agg", "AGG_KINDS"]

#: every aggregate kind the compiler knows how to lower
AGG_KINDS = ("sum", "min", "max", "count", "mean")


@dataclasses.dataclass(frozen=True)
class AggTerm:
    """One named-aggregate specification: an aggregate ``kind`` plus the
    value lambda-spec it reduces (a column name, a lambda construction
    function, or ``None`` — identity for the legacy ``aggregate()`` path,
    absent for ``count``)."""

    kind: str
    spec: Any = None

    def __post_init__(self):
        if self.kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {self.kind!r} "
                             f"(expected one of {AGG_KINDS})")


class agg:
    """Factory namespace for named aggregates (``agg.sum("qty")``, ...).

    Purely declarative — nothing here touches data; the specs are lowered
    by the TCAP compiler into per-output accumulator columns."""

    @staticmethod
    def sum(spec) -> AggTerm:
        """Sum of a value expression (int dtypes kept, floats in f64,
        bool indicators counted in i64)."""
        return AggTerm("sum", spec)

    @staticmethod
    def min(spec) -> AggTerm:
        """Minimum of a value expression (accumulated in float64)."""
        return AggTerm("min", spec)

    @staticmethod
    def max(spec) -> AggTerm:
        """Maximum of a value expression (accumulated in float64)."""
        return AggTerm("max", spec)

    @staticmethod
    def count() -> AggTerm:
        """Group cardinality (int64); takes no value expression."""
        return AggTerm("count", None)

    @staticmethod
    def mean(spec) -> AggTerm:
        """Arithmetic mean (float64) — lowered to sum + count accumulators
        merged exactly across partials, divided only at finalize."""
        return AggTerm("mean", spec)
