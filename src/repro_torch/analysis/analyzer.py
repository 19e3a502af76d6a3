"""The analyzer orchestrator: run every pass over one optimized program
and fold the findings into a single :class:`~repro_torch.analysis.diagnostics
.AnalysisReport`.

``analyze()`` is what ``Dataset.check()``, ``explain(diagnostics=True)``,
the ``python -m repro_torch.analysis`` CLI, and the Session's execution gate all
call — one entry point, so a plan the gate accepts is exactly a plan the
inspection surfaces report clean at error severity.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.analysis.capability import BuildConfig, capability_diagnostics
from repro_torch.analysis.diagnostics import AnalysisReport, Diagnostic, op_path
from repro_torch.analysis.partitioning import propagate_partitioning
from repro_torch.analysis.schema_pass import schema_pass
from repro_torch.core.exprc import FusedStage, build_steps, schedule_torch_run
from repro_torch.core.tcap import TCAPProgram

__all__ = ["analyze"]


def _join_algo_by_index(prog: TCAPProgram, plan) -> Optional[Dict[int, str]]:
    if plan is None:
        return None
    return {i: plan.join_algo.get(id(op), "hash_partition")
            for i, op in enumerate(prog.ops) if op.op == "JOIN"}


def _fusion_diagnostics(prog: TCAPProgram, edge_dtypes,
                        expr_backend: str) -> List[Diagnostic]:
    """Pass 3b — what breaks fusion runs (PL401) and, on the torch backend,
    which fused runs bounce back to the host after their jitted core
    (PL402). The interp backend never fuses, so it gets neither."""
    diags: List[Diagnostic] = []
    if expr_backend == "interp":
        return diags
    for i, op in enumerate(prog.ops):
        if op.op == "APPLY" and op.info.get("type") == "native":
            diags.append(Diagnostic(
                "PL401", "info",
                f"fusion barrier: native lambda {op.info.get('name', op.stage)!r} "
                "is opaque to the stage compiler — the pipelined run splits "
                "here and intermediate vector lists materialize", op_path(i, op)))
        elif op.op == "FLATTEN":
            diags.append(Diagnostic(
                "PL401", "info",
                "fusion barrier: FLATTEN re-shapes the row space and cannot "
                "join a fused run", op_path(i, op)))
    if expr_backend != "torch":
        return diags
    # walk the compiled step plan with op indices preserved (the worker
    # runtime's convention) so PL402 lands on the run's first op
    steps = build_steps(prog, "torch")
    i = -1
    for step in steps:
        if not isinstance(step, FusedStage):
            i += 1
            continue
        first = i + 1
        i += len(step.ops)
        ir = step.ir
        in_dts = [edge_dtypes.get((step.in_list, c)) for c in ir.in_cols]
        if any(d is None for d in in_dts):
            continue  # inference gave up upstream; nothing sound to say
        arrays = [np.zeros(0, d) for d in in_dts]
        # the raw schedule names the finding; the hoisted schedule (what
        # _compile_torch actually builds) shows the action taken on it
        raw, _ = schedule_torch_run(ir, arrays, hoist_host=False)
        n_core = sum(1 for ins in ir.instrs if raw[ins.out] == "jit")
        n_post = sum(1 for ins in ir.instrs if raw[ins.out] == "post")
        if n_core and n_post:
            kinds = sorted({ins.kind for ins in ir.instrs
                            if raw[ins.out] == "post"})
            hoisted, _ = schedule_torch_run(ir, arrays, hoist_host=True)
            n_demoted = sum(1 for ins in ir.instrs
                            if raw[ins.out] == "jit"
                            and hoisted[ins.out] != "jit")
            diags.append(Diagnostic(
                "PL402", "info",
                f"host-device round-trip: {n_post} instruction(s) "
                f"({', '.join(kinds)}) would return to the host after the "
                "jitted core of this fused run (non-jaxable dtypes or "
                "host-only stages downstream of device values) — the "
                "scheduler reorders them ahead of the core, demoting "
                f"{n_demoted} numeric instruction(s) to the host prologue "
                "for a single device crossing",
                op_path(first, prog.ops[first])))
    return diags


def _join_advisories(prog: TCAPProgram, store, plan,
                     broadcast_threshold: int,
                     num_partitions: Optional[int]) -> List[Diagnostic]:
    """Pass 5 — PL203: cross-check the plan's broadcast-vs-hash choice
    against the width-aware byte model (inferred per-column itemsize ×
    catalog cardinality). The planner's trace carries the scanned record
    itemsize through projections and aggregations, so a narrowed build
    side can look big to it; where the two models disagree, advise."""
    from repro_torch.analysis.footprint import modeled_join_algo
    if plan is None or store is None:
        return []
    if not any(op.op == "JOIN" for op in prog.ops):
        return []  # the width model re-walks inference; skip join-free plans
    advised = modeled_join_algo(prog, store, broadcast_threshold,
                                num_partitions)
    diags: List[Diagnostic] = []
    for i, op in enumerate(prog.ops):
        if op.op != "JOIN" or i not in advised:
            continue
        chosen = plan.join_algo.get(id(op), "hash_partition")
        if advised[i] != chosen:
            diags.append(Diagnostic(
                "PL203", "info",
                f"join algorithm disagreement: the plan chose {chosen} "
                f"but modeled bytes (inferred itemsize x cardinality) "
                f"favor {advised[i]} — plan_physical(advise_joins=True) "
                "or Session(advise_joins=True) adopts the modeled choice",
                op_path(i, op)))
    return diags


def analyze(prog: TCAPProgram, store=None, plan=None,
            config: Optional[BuildConfig] = None,
            expr_backend: Optional[str] = None,
            broadcast_threshold: int = 2 << 30,
            num_partitions: Optional[int] = None) -> AnalysisReport:
    """Run schema/dtype dataflow, partitioning propagation, and the
    capability + fusion + join-advisory rules over one (optimized) TCAP
    program.

    ``store`` resolves SCAN dtypes for untyped sets; ``plan`` (a
    :class:`~repro_torch.core.physical.PhysicalPlan`) feeds the partitioning
    pass the join-algorithm decisions; ``config`` enables the build-config
    capability rules; ``broadcast_threshold``/``num_partitions`` let the
    PL203 cross-check price joins under the session's actual planner
    inputs. All are optional — passes degrade conservatively without
    them."""
    if expr_backend is None:
        expr_backend = config.expr_backend if config is not None else "torch"
    diags, edge_dtypes, output_schema = schema_pass(prog, store)
    part = propagate_partitioning(prog, _join_algo_by_index(prog, plan))
    diags = list(diags) + list(part.diagnostics)
    diags += capability_diagnostics(prog, config)
    diags += _fusion_diagnostics(prog, edge_dtypes, expr_backend)
    diags += _join_advisories(prog, store, plan, broadcast_threshold,
                              num_partitions)
    order = {"error": 0, "warning": 1, "info": 2}
    diags.sort(key=lambda d: (order[d.severity], d.op_path, d.code))
    # PL201/PL202 state the *finding* (the exchange is provably redundant)
    # and stay either way; elided_exchanges states the *action* — the op
    # indices whose exchange this plan will actually skip (empty when the
    # session disables elision)
    elided = tuple(sorted(set(part.redundant) | set(part.join_elide)))
    if plan is not None:
        elided = tuple(i for i, op in enumerate(prog.ops)
                       if id(op) in plan.agg_elide
                       or id(op) in plan.join_elide)
    return AnalysisReport(diagnostics=diags, output_schema=output_schema,
                          elided_exchanges=elided)
