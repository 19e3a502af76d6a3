"""The paper's big-object analytics (§8.4) over denormalized TPC-H,
written against the fluent :class:`~repro_torch.core.session.Session` API with
typed record schemas (:class:`Customer` / :class:`Lineitem`):

* customers-per-supplier — for each supplier, the map customer -> parts
  sold (one two-stage aggregation);
* top-k Jaccard — customers whose purchased-part set is most similar to a
  query set (the TopJaccard pattern): an aggregation phase materialized via
  ``write()``, then a ``top_k`` over the per-customer sets (typed through a
  dynamically synthesized per-width schema, :func:`custset_schema`).

Loading validates record layout against the schema and column references
are checked at graph-build time. Set naming is session-scoped (no
module-global counters), so concurrent sessions in one process cannot
collide on store set names.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import Executor, Session, agg, make_lambda
from repro_torch.objectmodel.schema import (Record, S, f64, i32, i64, record,
                                      vector)

__all__ = ["Customer", "Lineitem", "LineitemQ1", "custset_schema",
           "customers_per_supplier", "topk_jaccard", "load_tpch",
           "q1_pricing_summary"]


class Customer(Record):
    """Denormalized TPC-H customer (matches ``data.synthetic`` layout)."""
    custkey: i64
    name: S(16)
    n_orders: i32


class Lineitem(Record):
    """Flattened lineitem of the denormalized nested objects (§8.4)."""
    custkey: i64
    orderkey: i64
    suppkey: i64
    partkey: i64
    qty: i32
    price: f64


class LineitemQ1(Record):
    """Lineitem with the Q1 pricing columns (matches
    ``data.synthetic.tpch_q1_lineitems``); ``shipdate`` is days since
    epoch."""
    returnflag: S(1)
    linestatus: S(1)
    qty: f64
    extendedprice: f64
    discount: f64
    tax: f64
    shipdate: i32


def q1_pricing_summary(store, lineitems_set: str, *,
                       ship_cutoff: int = 9400,
                       num_partitions=None, executor_cls=None,
                       session: Optional[Session] = None):
    """TPC-H Q1 (pricing summary report) as ONE ``group_by().agg()`` query
    — the shape the paper's AggregateComp benchmarks exercise, now with
    every aggregate column in a single pass::

        SELECT l_returnflag, l_linestatus,
               SUM(l_quantity), SUM(l_extendedprice),
               SUM(l_extendedprice*(1-l_discount)),
               SUM(l_extendedprice*(1-l_discount)*(1+l_tax)),
               AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount),
               COUNT(*)
        FROM lineitem WHERE l_shipdate <= :cutoff
        GROUP BY l_returnflag, l_linestatus

    Returns the (lazy) grouped dataset — typed under the synthesized
    group schema — so callers can ``collect()``, ``explain()``, or chain
    further. The filter fuses with the key/value extraction into one
    compiled stage per backend; on ``expr_backend="torch"`` the
    pre-aggregation runs as a fused on-device segment reduction."""
    sess = _session_for(store, num_partitions, executor_cls, session)
    return (sess.read(lineitems_set, LineitemQ1)
            .filter(lambda l, _c=ship_cutoff: l.shipdate <= _c)
            .group_by("returnflag", "linestatus")
            .agg(sum_qty=agg.sum("qty"),
                 sum_base_price=agg.sum("extendedprice"),
                 sum_disc_price=agg.sum(
                     lambda l: l.extendedprice * (1 - l.discount)),
                 sum_charge=agg.sum(
                     lambda l: l.extendedprice * (1 - l.discount)
                     * (1 + l.tax)),
                 avg_qty=agg.mean("qty"),
                 avg_price=agg.mean("extendedprice"),
                 avg_disc=agg.mean("discount"),
                 count_order=agg.count()))


def custset_schema(n_parts: int) -> type:
    """The per-customer part-presence schema of the materialized
    aggregation phase (one presence slot per part; float64 because the
    max-combiner accumulates in float64)."""
    return record(f"CustSet{n_parts}", key=i64, value=vector(f64, n_parts))


def _session_for(store, num_partitions, executor_cls,
                 session: Optional[Session]) -> Session:
    """Resolve the session, refusing silently-conflicting arguments: when
    ``session=`` is given, explicit store/num_partitions/executor_cls must
    be absent or agree with it (a volcano-baseline measurement must not
    silently run on a vectorized session)."""
    if session is None:
        return Session(store=store, num_partitions=num_partitions or 4,
                       executor_cls=executor_cls or Executor)
    if store is not None and session.store is not store:
        raise ValueError("session= provided but store= is a different store")
    if (num_partitions is not None
            and session.executor.P != num_partitions):
        raise ValueError(
            f"session= provided with num_partitions={num_partitions}, but "
            f"the session has {session.executor.P} partitions")
    if (executor_cls is not None
            and type(session.executor) is not executor_cls):
        raise ValueError(
            f"session= provided with executor_cls={executor_cls.__name__}, "
            f"but the session runs {type(session.executor).__name__}")
    return session


def load_tpch(store, customers: np.ndarray,
              lineitems: np.ndarray, session: Optional[Session] = None
              ) -> Tuple[str, str]:
    """Load packed TPC-H records as typed sets (layouts validated against
    the :class:`Customer` / :class:`Lineitem` schemas)."""
    sess = _session_for(store, None, None, session)
    cds = sess.load("customers", customers, Customer)
    lds = sess.load("lineitems", lineitems, Lineitem)
    return cds.set_name, lds.set_name


def _supp_cust_key(rows):
    return rows["suppkey"] * (1 << 24) + rows["custkey"]


def _part_presence(n_parts: int):
    def val(rows):
        out = np.zeros((len(rows), n_parts), np.int8)
        out[np.arange(len(rows)), rows["partkey"]] = 1
        return out
    return val


def customers_per_supplier(store, lineitems_set: str,
                           n_parts: int, num_partitions: Optional[int] = None,
                           executor_cls=None,
                           session: Optional[Session] = None
                           ) -> Dict[int, Dict[int, np.ndarray]]:
    """supplier -> sorted unique part ids per customer sold to.

    One two-stage aggregation keyed by (supplier, customer); values are
    per-part presence vectors combined with max (set union)."""
    sess = _session_for(store, num_partitions, executor_cls, session)
    r = (sess.read(lineitems_set, Lineitem)
             .aggregate(
                 key=lambda a: make_lambda(a, _supp_cust_key, "suppCust"),
                 value=lambda a: make_lambda(a, _part_presence(n_parts),
                                             "partSet"),
                 combiner="max")
             .collect())
    out: Dict[int, Dict[int, np.ndarray]] = {}
    for key, vec in zip(np.asarray(r["key"]), np.asarray(r["value"])):
        supp, cust = int(key) >> 24, int(key) & ((1 << 24) - 1)
        out.setdefault(supp, {})[cust] = np.nonzero(vec)[0]
    return out


def topk_jaccard(store, lineitems_set: str, n_parts: int,
                 query_parts: np.ndarray, k: int,
                 num_partitions: Optional[int] = None, executor_cls=None,
                 session: Optional[Session] = None):
    """Top-k customers by Jaccard(parts bought, query set). Two phases, as
    in the paper: build each customer's part-presence set (aggregation,
    materialized with ``write()``), then a top_k over the stored sets."""
    sess = _session_for(store, num_partitions, executor_cls, session)

    custsets = sess.fresh_set_name("custsets")
    (sess.read(lineitems_set, Lineitem)
         .aggregate(key="custkey",
                    value=lambda a: make_lambda(a, _part_presence(n_parts),
                                                "partSet"),
                    combiner="max")
         .write(custsets)
         .collect())

    qvec = np.zeros(n_parts, bool)
    qvec[query_parts] = True

    def jaccard(rows):
        parts = rows["value"] > 0
        inter = (parts & qvec).sum(1)
        union = (parts | qvec).sum(1)
        return inter / np.maximum(union, 1)

    r = (sess.read(custsets, custset_schema(n_parts))
             .top_k(k, score=lambda a: make_lambda(a, jaccard, "jaccard"),
                    payload="key")
             .collect())
    return np.asarray(r["payload"]), np.asarray(r["score"])
