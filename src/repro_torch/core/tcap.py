"""TCAP — the DAG of atomic operations PC compiles lambda terms into
(paper §5.2). Logically operates over vector lists (sets of named columns).

Each op carries the paper's five-tuple: (apply-input columns, copy-through
columns, computation name, compiled-stage name, key-value info map). The
info map "is only informational and does not affect execution" but drives
the rule-based optimizer — we keep that contract.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["TCAPOp", "TCAPProgram", "structural_signature"]


@dataclass
class TCAPOp:
    out: str  # output vector-list name
    out_cols: Tuple[str, ...]
    op: str  # SCAN|APPLY|FILTER|HASH|JOIN|AGG|FLATTEN|TOPK|OUTPUT
    in_list: str = ""
    apply_cols: Tuple[str, ...] = ()
    copy_cols: Tuple[str, ...] = ()
    comp: str = ""
    stage: str = ""
    info: Dict = field(default_factory=dict)
    # JOIN only: right-hand input
    in_list2: str = ""
    apply_cols2: Tuple[str, ...] = ()
    copy_cols2: Tuple[str, ...] = ()

    @property
    def new_cols(self) -> Tuple[str, ...]:
        copied = set(self.copy_cols) | set(self.copy_cols2)
        return tuple(c for c in self.out_cols if c not in copied)

    def to_text(self) -> str:
        kv = ", ".join(f"('{k}', '{v}')" for k, v in self.info.items()
                       if k not in ("fn",))
        if self.op == "SCAN":
            return f"{self.out}({', '.join(self.out_cols)}) <= SCAN('{self.info.get('db','')}', '{self.info.get('set','')}', '{self.comp}')"
        if self.op == "JOIN":
            return (f"{self.out}({', '.join(self.out_cols)}) <= JOIN("
                    f"{self.in_list}({', '.join(self.apply_cols)}), "
                    f"{self.in_list}({', '.join(self.copy_cols)}), "
                    f"{self.in_list2}({', '.join(self.apply_cols2)}), "
                    f"{self.in_list2}({', '.join(self.copy_cols2)}), "
                    f"'{self.comp}', [{kv}])")
        return (f"{self.out}({', '.join(self.out_cols)}) <= {self.op}("
                f"{self.in_list}({', '.join(self.apply_cols)}), "
                f"{self.in_list}({', '.join(self.copy_cols)}), "
                f"'{self.comp}', '{self.stage}', [{kv}])")


class TCAPProgram:
    def __init__(self, ops: Optional[List[TCAPOp]] = None):
        self.ops: List[TCAPOp] = list(ops or [])

    def append(self, op: TCAPOp) -> TCAPOp:
        self.ops.append(op)
        return op

    # --------------------------------------------------------- structure
    def producer_of(self, list_name: str) -> Optional[TCAPOp]:
        for op in self.ops:
            if op.out == list_name:
                return op
        return None

    def consumers_of(self, list_name: str) -> List[TCAPOp]:
        return [op for op in self.ops
                if op.in_list == list_name or op.in_list2 == list_name]

    def column_producer(self, list_name: str, col: str) -> Optional[TCAPOp]:
        """Walk upstream to the op that first created `col`."""
        op = self.producer_of(list_name)
        while op is not None:
            if col in op.new_cols or op.op in ("SCAN", "JOIN", "AGG"):
                return op
            op = self.producer_of(op.in_list)
        return None

    def to_text(self) -> str:
        return ";\n".join(op.to_text() for op in self.ops) + ";"

    def __len__(self) -> int:
        return len(self.ops)

    def copy(self) -> "TCAPProgram":
        return TCAPProgram([replace(op, info=dict(op.info)) for op in self.ops])

    def validate(self) -> None:
        """Every op's inputs must exist with the referenced columns."""
        seen: Dict[str, Tuple[str, ...]] = {}
        for op in self.ops:
            for in_name, a_cols, c_cols in ((op.in_list, op.apply_cols, op.copy_cols),
                                            (op.in_list2, op.apply_cols2, op.copy_cols2)):
                if not in_name:
                    continue
                if in_name not in seen:
                    raise ValueError(f"{op.out}: input {in_name} not yet produced")
                avail = set(seen[in_name])
                for c in (*a_cols, *c_cols):
                    if c not in avail:
                        raise ValueError(
                            f"{op.out}: column {c!r} not in {in_name}{seen[in_name]}")
            if op.out in seen:
                raise ValueError(f"duplicate vector list {op.out}")
            seen[op.out] = op.out_cols


def structural_signature(prog: TCAPProgram, strict: bool = True) -> Tuple:
    """A name-independent structural key for a TCAP program.

    Vector-list and column names are canonicalized to first-appearance
    ordinals, and the ``comp``/``stage`` fields (which embed per-compile
    counters) are dropped, so two compilations of the same logical query
    produce equal signatures regardless of naming streams.

    ``strict=True`` (the plan-cache key) distinguishes native lambdas by
    function identity and keeps SCAN set names — a cached optimized
    program is only reused for a query that scans the same sets and runs
    the identical native code. ``strict=False`` (the API-equivalence view)
    collapses native lambdas to their declared name, so a fluent chain and
    a hand-written Computation graph of the same query compare equal
    op-for-op. Both modes ignore the OUTPUT set name: it is a sink label,
    not part of the query shape (the session rebinds it on cache reuse).
    """
    list_ord: Dict[str, int] = {}
    col_ord: Dict[str, int] = {}

    def lid(name: str) -> int:
        return list_ord.get(name, -1)

    def cid(col: str) -> int:
        if col not in col_ord:
            col_ord[col] = len(col_ord)
        return col_ord[col]

    sig = []
    for i, op in enumerate(prog.ops):
        info = []
        for k in sorted(op.info):
            v = op.info[k]
            if k == "fn":
                info.append((k, id(v) if strict else "<fn>"))
            elif op.op == "OUTPUT" and k == "set":
                continue
            elif k == "onType" and v in col_ord:
                # intermediate record types are named after their producing
                # computation (= its output column, already canonicalized);
                # per-compile name counters must not leak into the key.
                info.append((k, ("col", col_ord[v])))
            else:
                info.append((k, str(v)))
        sig.append((op.op,
                    lid(op.in_list), tuple(cid(c) for c in op.apply_cols),
                    tuple(cid(c) for c in op.copy_cols),
                    lid(op.in_list2), tuple(cid(c) for c in op.apply_cols2),
                    tuple(cid(c) for c in op.copy_cols2),
                    tuple(cid(c) for c in op.out_cols),
                    tuple(info)))
        list_ord[op.out] = i
    return tuple(sig)
