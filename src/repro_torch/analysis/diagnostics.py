"""Structured diagnostics — the analyzer's output vocabulary.

Every finding is a :class:`Diagnostic` with a *stable* code (tools and
tests key on them), a severity, a human message, and an ``op_path``
locating the finding in the TCAP program (``op[i]:OP stage``). Codes:

======  ========  =====================================================
code    severity  meaning
======  ========  =====================================================
PL101   warning   dtype narrowing: a 64-bit integer operand enters a
                  float-producing arithmetic stage (values above 2^53
                  lose precision)
PL102   warning   accumulator saturation: ``sum`` over a small integer
                  dtype accumulates in that dtype (i8/i16/i32 sums can
                  overflow silently)
PL103   error     unresolved column: ``attAccess`` of a field the
                  inferred input record dtype does not define
PL104   warning   float group key: grouping on a float-dtype key —
                  ``NaN != NaN``, so NaN keys silently fragment into
                  one group per row
PL201   info      redundant exchange: a planned AGG shuffle whose input
                  is already hash-partitioned on the same key tuple by
                  ``stable_key_hash`` (the optimizer elides it)
PL202   info      co-partitioned join: a hash-partition JOIN side
                  already hash-partitioned on its join key — the side's
                  split+route exchange is the identity permutation (the
                  optimizer elides it)
PL203   info      join algorithm disagreement: the planner's broadcast-
                  vs-hash choice differs from the width-aware byte
                  model (``advise_joins=True`` adopts the modeled
                  choice)
PL301   error     native lambda on a connect-mode plan: the program
                  cannot be pickled to external workers
PL401   info      fusion barrier: an op the stage compiler cannot fuse
                  splits a pipelined run (native lambdas, FLATTEN)
PL402   info      host↔device round-trip: instructions that would
                  return to the host *after* a jitted core within one
                  fused run (torch backend) — the scheduler hoists them
                  ahead of the core
======  ========  =====================================================

Severities: ``error`` diagnostics make :meth:`AnalysisReport.errors`
non-empty — the Session refuses to execute such plans; ``warning`` and
``info`` never block execution.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Diagnostic", "AnalysisReport", "SEVERITIES", "op_path"]

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str       # stable code, e.g. "PL201"
    severity: str   # "error" | "warning" | "info"
    message: str
    op_path: str    # locator within the program, e.g. "op[4]:AGG"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r} "
                             f"(expected one of {SEVERITIES})")

    def format(self) -> str:
        return f"{self.code} {self.severity:<7} {self.op_path}: " \
               f"{self.message}"


def op_path(i: int, op) -> str:
    """The canonical locator of op ``i``: index, kind, and the stage name
    when the compiler assigned one (APPLY stages carry the lambda kind)."""
    tail = f" {op.stage}" if getattr(op, "stage", "") else ""
    return f"op[{i}]:{op.op}{tail}"


@dataclasses.dataclass
class AnalysisReport:
    """Everything one analyzer run learned about a plan: the diagnostics,
    the forward-inferred output schema (column name -> numpy dtype, None
    where inference gave up), and the AGG op indices whose exchange the
    partitioning pass proved redundant."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    output_schema: Dict[str, Optional[np.dtype]] = \
        dataclasses.field(default_factory=dict)
    # op indices (AGG and JOIN) whose exchange the plan actually skips
    elided_exchanges: Tuple[int, ...] = ()

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "info"]

    def format(self) -> str:
        lines = [f"== diagnostics ({len(self.diagnostics)}) =="]
        for d in self.diagnostics:
            lines.append("  " + d.format())
        if not self.diagnostics:
            lines.append("  (clean)")
        if self.output_schema:
            cols = ", ".join(
                f"{c}: {dt if dt is not None else '?'}"
                for c, dt in self.output_schema.items())
            lines.append(f"== inferred output schema: {cols} ==")
        return "\n".join(lines)

    def to_json_dict(self) -> Dict:
        """A machine-readable view (``python -m repro_torch.analysis --json``):
        plain strings/ints only, so it serializes with ``json.dump``."""
        return {
            "findings": [{"code": d.code, "severity": d.severity,
                          "op_path": d.op_path, "message": d.message}
                         for d in self.diagnostics],
            "output_schema": {c: (str(dt) if dt is not None else None)
                              for c, dt in self.output_schema.items()},
            "elided_exchanges": list(self.elided_exchanges),
            "counts": {"error": len(self.errors()),
                       "warning": len(self.warnings()),
                       "info": len(self.infos())},
        }
