"""Pass 4 — static memory-footprint estimation (the admission signal).

The service's :class:`~repro_torch.service.scheduler.AdmissionScheduler` needs
a *per-worker bytes* number before a query runs. This pass combines the
two static sources the analyzer already has:

* **cardinality** — the planner's row-estimate conventions
  (:func:`repro_torch.core.physical.estimate_bytes` heritage: SCAN is the
  stored row count, FILTER keeps ~half, AGG collapses to ~10%, TOPK caps
  at k, FLATTEN fans out ~4×, JOIN carries the larger side);
* **width** — planlint's inferred per-edge dtypes
  (:func:`~repro_torch.analysis.schema_pass.infer_dtypes`); columns the
  inference cannot type fall back to 8 bytes.

The total working set divides across the pool (hash-partitioned lists),
plus every broadcast-join build side replicated per worker. Static
estimates are deliberately crude — the scheduler corrects them with the
observed-bytes feedback model (:class:`~repro_torch.service.scheduler
.FootprintModel`), so what matters here is determinism and monotonicity,
not precision.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.analysis.schema_pass import infer_dtypes
from repro_torch.core.tcap import TCAPProgram

__all__ = ["PlanFootprint", "estimate_plan_footprint", "footprint_line",
           "modeled_join_bytes", "modeled_join_algo"]

FALLBACK_COL_BYTES = 8

# row-count multipliers per op kind (matched to the physical planner's
# estimate_bytes conventions so the two estimators never disagree on
# direction)
_FILTER_SELECTIVITY = 0.5
_AGG_REDUCTION = 0.1
_FLATTEN_FANOUT = 4.0


@dataclasses.dataclass(frozen=True)
class PlanFootprint:
    """The estimate the scheduler admits against."""

    per_list_bytes: Dict[str, float]  # list name -> estimated bytes
    total_bytes: float                # sum of all materialized lists
    per_worker_bytes: float           # total/P + replicated build sides
    scan_bytes: float                 # stored input bytes (observed base)


def _list_widths(prog: TCAPProgram, store) -> Dict[str, float]:
    """Estimated bytes per row for every list, from the inferred edge
    dtypes (fallback: 8 bytes per untyped column)."""
    widths: Dict[str, float] = {}
    counted: Dict[str, set] = {}
    for (lst, col), dt in infer_dtypes(prog, store=store).items():
        seen = counted.setdefault(lst, set())
        if col in seen:
            continue
        seen.add(col)
        widths[lst] = widths.get(lst, 0.0) + (
            dt.itemsize if isinstance(dt, np.dtype) else FALLBACK_COL_BYTES)
    return widths


def _row_walk(prog: TCAPProgram, store) -> tuple:
    """The shared cardinality walk: per-list row estimates under the
    planner's multiplier conventions, plus total scanned input bytes."""
    rows: Dict[str, float] = {}
    scan_bytes = 0.0
    for op in prog.ops:
        if op.op == "SCAN":
            try:
                s = store.get_set(op.info["set"])
                n = float(s.num_records)
                scan_bytes += n * s.dtype.itemsize
            except KeyError:
                n = 0.0
            rows[op.out] = n
        elif op.op == "FILTER":
            rows[op.out] = rows.get(op.in_list, 0.0) * _FILTER_SELECTIVITY
        elif op.op == "FLATTEN":
            rows[op.out] = rows.get(op.in_list, 0.0) * _FLATTEN_FANOUT
        elif op.op == "AGG":
            rows[op.out] = rows.get(op.in_list, 0.0) * _AGG_REDUCTION
        elif op.op == "TOPK":
            k = float(op.info.get("k", 1))
            rows[op.out] = min(rows.get(op.in_list, 0.0), k)
        elif op.op == "JOIN":
            rows[op.out] = max(rows.get(op.in_list, 0.0),
                               rows.get(op.in_list2, 0.0))
        elif op.op == "OUTPUT":
            continue
        else:  # APPLY / HASH keep cardinality
            rows[op.out] = rows.get(op.in_list, 0.0)
    return rows, scan_bytes


def estimate_plan_footprint(prog: TCAPProgram, store, plan=None,
                            num_partitions: int = 1) -> PlanFootprint:
    """Static per-worker memory estimate for one plan over ``store``.
    ``plan`` (a :class:`~repro_torch.core.physical.PhysicalPlan`) contributes
    the broadcast-join decisions — each broadcast build side is resident
    in full on every worker (P× replicated cluster-wide): per worker it
    costs the 1/P base share plus (P-1)/P replicated bytes, and the
    total counts all P copies. With P=1 nothing replicates."""
    P = max(1, num_partitions)
    widths = _list_widths(prog, store)
    rows, scan_bytes = _row_walk(prog, store)
    per_list: Dict[str, float] = {}
    broadcast_extra = 0.0   # per-worker bytes beyond the 1/P base share
    replicated = 0.0        # cluster-wide extra copies (P-1 of each build)

    def width(lst: str) -> float:
        return widths.get(lst) or float(FALLBACK_COL_BYTES)

    for op in prog.ops:
        if op.op == "OUTPUT":
            continue
        per_list[op.out] = rows.get(op.out, 0.0) * width(op.out)
        if (op.op == "JOIN" and plan is not None
                and plan.join_algo.get(id(op)) == "broadcast"):
            build = rows.get(op.in_list2, 0.0) * width(op.in_list2)
            broadcast_extra += build * (P - 1) / P
            replicated += build * (P - 1)

    base_total = sum(per_list.values())
    total = base_total + replicated
    per_worker = base_total / P + broadcast_extra
    return PlanFootprint(per_list_bytes=per_list, total_bytes=total,
                         per_worker_bytes=per_worker,
                         scan_bytes=scan_bytes)


def modeled_join_bytes(prog: TCAPProgram, store
                       ) -> Dict[int, tuple]:
    """Width-aware join input sizes: JOIN op index -> (probe_bytes,
    build_bytes), rows from the shared cardinality walk × inferred
    per-column itemsize. Unlike the planner's
    :func:`~repro_torch.core.physical.estimate_bytes` — which traces catalog
    record itemsize through the pipeline — this sees projections and
    aggregations *narrow* the stream, which is exactly where the two
    models disagree (PL203)."""
    widths = _list_widths(prog, store)
    rows, _ = _row_walk(prog, store)

    def width(lst: str) -> float:
        return widths.get(lst) or float(FALLBACK_COL_BYTES)

    return {i: (rows.get(op.in_list, 0.0) * width(op.in_list),
                rows.get(op.in_list2, 0.0) * width(op.in_list2))
            for i, op in enumerate(prog.ops) if op.op == "JOIN"}


def modeled_join_algo(prog: TCAPProgram, store,
                      broadcast_threshold: int = 2 << 30,
                      num_partitions=None) -> Dict[int, str]:
    """The broadcast-vs-hash choice the width-aware model makes: JOIN op
    index -> algorithm, under the *same* threshold and transfer-cost
    rules as :func:`~repro_torch.core.physical.plan_physical` (broadcast ships
    build×(P-1); a shuffle ships (build+probe)×(P-1)/P) so the only
    possible source of disagreement is the byte model. PL203 reports a
    disagreement; ``plan_physical(advise_joins=True)`` adopts this
    choice."""
    out: Dict[int, str] = {}
    for i, (probe, build) in modeled_join_bytes(prog, store).items():
        choice = ("broadcast" if build < broadcast_threshold
                  else "hash_partition")
        if choice == "broadcast" and num_partitions and num_partitions > 1:
            P = num_partitions
            if build * (P - 1) > (build + probe) * (P - 1) / P:
                choice = "hash_partition"
        out[i] = choice
    return out


def footprint_line(fp: PlanFootprint, num_partitions: int) -> str:
    """One human line for explain()/planlint surfaces."""
    return (f"footprint: ~{fp.total_bytes:,.0f} bytes total, "
            f"~{fp.per_worker_bytes:,.0f}/worker across "
            f"{num_partitions} partitions")
