"""Physical planning (paper §5, Appendix C/D).

Two decisions mirror the paper exactly:

1. **Join algorithm** — broadcast join when the build side is estimated
   under a threshold (the paper uses 2 GB), hash-partition join otherwise.
   The estimate traces the build pipeline to its SCAN and uses catalog
   statistics (record count × record size); like the paper we have no value
   statistics, so filters apply a fixed selectivity discount. When the
   partition count is known, the threshold check is additionally priced
   against the real transfer cost of each algorithm: a broadcast ships the
   build side to P-1 peers, a hash-partition shuffle ships a (P-1)/P
   fraction of *both* sides — broadcast must win on modeled bytes moved,
   not just clear the absolute threshold.
2. **Pipeline decomposition** — the TCAP DAG is split into pipelines at
   *pipe sinks* (JOIN build sides, AGG, TOPK, OUTPUT); each pipeline runs
   stage-fused over vector lists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tcap import TCAPOp, TCAPProgram
from repro_torch.objectmodel.store import PagedStore

__all__ = ["PhysicalPlan", "plan_physical", "estimate_bytes",
           "split_pipelines", "plan_to_wire", "plan_from_wire"]

FILTER_SELECTIVITY = 0.5  # no value statistics (paper §7 future work)


@dataclasses.dataclass
class PhysicalPlan:
    join_algo: Dict[int, str]
    pipelines: List[List[TCAPOp]]
    estimates: Dict[str, float]  # list name -> estimated bytes
    # AGG ops (keyed by id()) whose exchange the partitioning analysis
    # proved redundant: the input is already stable_key_hash-partitioned
    # on the key tuple, so the split+merge is the identity permutation
    # and executors skip it (byte-identical results, zero shuffle)
    agg_elide: frozenset = frozenset()
    # hash-partition JOIN ops (keyed by id()) -> sides ("L" probe /
    # "R" build) whose split+route exchange the analysis proved
    # redundant (PL202): that side is already hash-partitioned on its
    # join key, so executors concat it in place instead of shuffling
    join_elide: Dict[int, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)


def estimate_bytes(prog: TCAPProgram, list_name: str, store: PagedStore,
                   memo: Optional[Dict[str, float]] = None) -> float:
    memo = memo if memo is not None else {}
    if list_name in memo:
        return memo[list_name]
    op = prog.producer_of(list_name)
    if op is None:
        return 0.0
    if op.op == "SCAN":
        try:
            s = store.get_set(op.info["set"])
            est = float(s.num_records * s.dtype.itemsize)
        except KeyError:
            est = float(1 << 20)
    elif op.op == "FILTER":
        est = estimate_bytes(prog, op.in_list, store, memo) * FILTER_SELECTIVITY
    elif op.op == "JOIN":
        est = (estimate_bytes(prog, op.in_list, store, memo)
               + estimate_bytes(prog, op.in_list2, store, memo))
    elif op.op == "AGG":
        est = estimate_bytes(prog, op.in_list, store, memo) * 0.1
    else:
        est = estimate_bytes(prog, op.in_list, store, memo)
    memo[list_name] = est
    return est


def plan_physical(prog: TCAPProgram, store: PagedStore,
                  broadcast_threshold: int = 2 << 30,
                  num_partitions: Optional[int] = None,
                  elide_exchanges: bool = True,
                  advise_joins: bool = False) -> PhysicalPlan:
    """``advise_joins=True`` re-prices each join with planlint's
    width-aware byte model (inferred per-column itemsize × cardinality,
    :func:`repro_torch.analysis.footprint.modeled_join_algo`) instead of the
    catalog-itemsize trace alone — the decision PL203 advises — and
    adopts its choice where the two disagree."""
    memo: Dict[str, float] = {}
    algo: Dict[int, str] = {}
    for op in prog.ops:
        if op.op == "JOIN":
            build = estimate_bytes(prog, op.in_list2, store, memo)
            choice = "broadcast" if build < broadcast_threshold \
                else "hash_partition"
            if choice == "broadcast" and num_partitions and num_partitions > 1:
                # price against modeled transfer bytes: broadcast replicates
                # the build side to P-1 peers; a shuffle moves the non-local
                # (P-1)/P fraction of both sides once.
                P = num_partitions
                probe = estimate_bytes(prog, op.in_list, store, memo)
                bcast_cost = build * (P - 1)
                shuffle_cost = (build + probe) * (P - 1) / P
                if bcast_cost > shuffle_cost:
                    choice = "hash_partition"
            algo[id(op)] = choice

    if advise_joins:
        from repro_torch.analysis.footprint import modeled_join_algo
        advised = modeled_join_algo(prog, store, broadcast_threshold,
                                    num_partitions)
        for i, op in enumerate(prog.ops):
            if op.op == "JOIN" and i in advised:
                algo[id(op)] = advised[i]

    agg_elide: frozenset = frozenset()
    join_elide: Dict[int, Tuple[str, ...]] = {}
    if elide_exchanges:
        from repro_torch.core.optimizer import plan_exchange_elisions
        join_by_index = {i: algo.get(id(op), "hash_partition")
                         for i, op in enumerate(prog.ops) if op.op == "JOIN"}
        aggs, joins = plan_exchange_elisions(prog, join_by_index)
        agg_elide = frozenset(id(prog.ops[i]) for i in aggs)
        join_elide = {id(prog.ops[i]): sides for i, sides in joins.items()}
    return PhysicalPlan(algo, split_pipelines(prog), memo,
                        agg_elide=agg_elide, join_elide=join_elide)


def split_pipelines(prog: TCAPProgram) -> List[List[TCAPOp]]:
    """Pipeline decomposition (decision 2): split at pipe sinks. A pure
    function of the program, so a receiver of a shipped plan rebuilds the
    identical decomposition from the program alone."""
    pipelines: List[List[TCAPOp]] = []
    cur: List[TCAPOp] = []
    for op in prog.ops:
        cur.append(op)
        if op.op in ("JOIN", "AGG", "TOPK", "OUTPUT", "FLATTEN"):
            pipelines.append(cur)
            cur = []
    if cur:
        pipelines.append(cur)
    return pipelines


# ------------------------------------------------------- wire round-trip
def plan_to_wire(prog: TCAPProgram, plan: PhysicalPlan) -> Dict:
    """A picklable view of ``plan``: join decisions re-keyed from op
    ``id()`` (which does not survive pickling) to op index within
    ``prog``. Pipelines are not shipped — they are re-derived from the
    program (:func:`split_pipelines`)."""
    algo = {i: plan.join_algo.get(id(op), "hash_partition")
            for i, op in enumerate(prog.ops) if op.op == "JOIN"}
    elide = sorted(i for i, op in enumerate(prog.ops)
                   if id(op) in plan.agg_elide)
    join_elide = {i: tuple(plan.join_elide[id(op)])
                  for i, op in enumerate(prog.ops)
                  if id(op) in plan.join_elide}
    return {"join_algo": algo, "estimates": dict(plan.estimates),
            "agg_elide": elide, "join_elide": join_elide}


def plan_from_wire(prog: TCAPProgram, wire: Dict) -> PhysicalPlan:
    """Rebuild a :class:`PhysicalPlan` against this process's copy of
    ``prog`` (the one the ops' ids refer to). Elision keys default to
    empty so plans shipped by older peers still load."""
    return PhysicalPlan(
        {id(prog.ops[i]): a for i, a in wire["join_algo"].items()},
        split_pipelines(prog), dict(wire["estimates"]),
        agg_elide=frozenset(id(prog.ops[i])
                            for i in wire.get("agg_elide", ())),
        join_elide={id(prog.ops[i]): tuple(sides) for i, sides in
                    wire.get("join_elide", {}).items()})
