"""Rule-based TCAP optimization (paper §7).

The paper fires Prolog rewrite rules to a fixpoint; we implement the same
rules as Python passes over the IR:

* **redundant-APPLY elimination** — two APPLYs of the same pure stage
  (attAccess/methodCall/operator) over the same value are merged, even
  across FILTERs (the paper's ``getSalary()`` example);
* **selection pushdown past joins** — a residual conjunct that depends on a
  single join input moves into that input's pipeline, before the HASH;
* **dead-column elimination** — columns never consumed downstream are
  dropped, and side-effect-free APPLYs producing them are removed.

Passes run iteratively until no rule fires (the paper's fixpoint loop).
Every pass preserves program semantics; `tests/test_optimizer.py` checks
optimized-vs-unoptimized result equality (hypothesis-driven).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.tcap import TCAPOp, TCAPProgram

__all__ = ["optimize", "eliminate_redundant_applies",
           "push_filters_past_joins", "dead_column_elimination",
           "elide_redundant_exchanges", "plan_exchange_elisions",
           "OptimizerReport"]

_CSEABLE = {"attAccess", "methodCall", "cmp", "bool", "arith", "const"}


def elide_redundant_exchanges(prog: TCAPProgram,
                              join_algo_by_index: Optional[Dict[int, str]]
                              = None) -> Tuple[int, ...]:
    """AGG op indices whose shuffle the partitioning analysis proved to be
    the identity permutation (input already stable_key_hash-partitioned on
    the key tuple) — see :func:`plan_exchange_elisions` for the full
    decision the planner records."""
    return plan_exchange_elisions(prog, join_algo_by_index)[0]


def plan_exchange_elisions(prog: TCAPProgram,
                           join_algo_by_index: Optional[Dict[int, str]]
                           = None
                           ) -> Tuple[Tuple[int, ...],
                                      Dict[int, Tuple[str, ...]]]:
    """Exchanges the partitioning analysis proved to be identity
    permutations: ``(agg_indices, {join_index: elided sides})``. AGG
    indices (PL201) land in ``PhysicalPlan.agg_elide``; join sides
    (PL202 — "L" probe / "R" build already hash-partitioned on the join
    key) land in ``PhysicalPlan.join_elide``; executors skip the
    corresponding exchanges. The rule itself lives in the analyzer
    (:mod:`repro_torch.analysis.partitioning`) so the PL201/PL202 diagnostics
    and the optimization can never disagree."""
    from repro_torch.analysis.partitioning import propagate_partitioning
    part = propagate_partitioning(prog, join_algo_by_index)
    return part.redundant, dict(part.join_elide)


@dataclasses.dataclass
class OptimizerReport:
    cse_removed: int = 0
    filters_pushed: int = 0
    dead_cols_removed: int = 0
    dead_ops_removed: int = 0
    iterations: int = 0


def optimize(prog: TCAPProgram, max_iters: int = 10
             ) -> Tuple[TCAPProgram, OptimizerReport]:
    rep = OptimizerReport()
    cur = prog.copy()
    for it in range(max_iters):
        rep.iterations = it + 1
        changed = False
        cur, n = eliminate_redundant_applies(cur)
        rep.cse_removed += n
        changed |= n > 0
        cur, n = push_filters_past_joins(cur)
        rep.filters_pushed += n
        changed |= n > 0
        cur, nc, no = dead_column_elimination(cur)
        rep.dead_cols_removed += nc
        rep.dead_ops_removed += no
        changed |= (nc + no) > 0
        if not changed:
            break
    cur.validate()
    return cur, rep


# ----------------------------------------------------------------- CSE
def _info_key(op: TCAPOp):
    items = tuple(sorted((k, str(v)) for k, v in op.info.items()
                         if k not in ("fn", "conjunct", "depends_slots",
                                      "role")))
    return (op.info.get("type"), items)


def eliminate_redundant_applies(prog: TCAPProgram
                                ) -> Tuple[TCAPProgram, int]:
    """Forward value-numbering. A column's value number survives FILTERs
    (same defining expression, restricted rows); aliasing only happens when
    the equivalent column is still live in the same vector list, which
    guarantees an identical row space."""
    new_ops: List[TCAPOp] = []
    vn_of: Dict[Tuple[str, str], int] = {}  # (list, col) -> value number
    expr_of: Dict[Tuple, Tuple[str]] = {}  # expr key -> canonical col name
    list_alias: Dict[str, str] = {}
    col_alias: Dict[str, str] = {}
    fresh = iter(range(1, 1 << 30)).__next__
    removed = 0

    def resolve_list(name: str) -> str:
        while name in list_alias:
            name = list_alias[name]
        return name

    def rc(col: str) -> str:
        while col in col_alias:
            col = col_alias[col]
        return col

    for op in prog.ops:
        op = dataclasses.replace(
            op,
            in_list=resolve_list(op.in_list),
            in_list2=resolve_list(op.in_list2),
            apply_cols=tuple(rc(c) for c in op.apply_cols),
            copy_cols=tuple(dict.fromkeys(rc(c) for c in op.copy_cols)),
            apply_cols2=tuple(rc(c) for c in op.apply_cols2),
            copy_cols2=tuple(dict.fromkeys(rc(c) for c in op.copy_cols2)),
        )
        op.out_cols = tuple(dict.fromkeys(
            (*op.copy_cols, *op.copy_cols2,
             *(c for c in op.out_cols if rc(c) == c and c not in
               (*op.copy_cols, *op.copy_cols2)))))

        if op.op == "APPLY" and op.info.get("type") in _CSEABLE:
            in_vns = tuple(vn_of.get((op.in_list, c), -1)
                           for c in op.apply_cols)
            key = (_info_key(op), in_vns)
            canon = expr_of.get(key)
            new_col = op.new_cols[0] if op.new_cols else None
            if (canon is not None and new_col is not None
                    and -1 not in in_vns):
                canon_col, canon_vn = canon
                # only alias if canonical column is live in the input list
                if vn_of.get((op.in_list, canon_col)) == canon_vn:
                    list_alias[op.out] = op.in_list
                    col_alias[new_col] = canon_col
                    removed += 1
                    continue
            if new_col is not None and -1 not in in_vns:
                vn = fresh()
                expr_of[key] = (new_col, vn)
                for c in op.out_cols:
                    vn_of[(op.out, c)] = (vn if c == new_col
                                          else vn_of.get((op.in_list, c), -1))
                new_ops.append(op)
                continue

        # default: propagate value numbers for copied columns, fresh for new
        for c in op.out_cols:
            src = None
            if c in op.copy_cols:
                src = vn_of.get((op.in_list, c), -1)
            elif c in op.copy_cols2:
                src = vn_of.get((op.in_list2, c), -1)
            vn_of[(op.out, c)] = src if src is not None else fresh()
        new_ops.append(op)

    return TCAPProgram(new_ops), removed


# ------------------------------------------------------------ pushdown
def push_filters_past_joins(prog: TCAPProgram) -> Tuple[TCAPProgram, int]:
    """Move single-input residual conjuncts (APPLY chain + FILTER, tagged by
    the compiler with ``conjunct``/``depends_slots``) before that input's
    HASH — the paper's selection-pushdown rule. Fires one rewrite at a time
    to a fixpoint."""
    total = 0
    while True:
        prog, n = _push_one_filter(prog)
        if n == 0:
            return prog, total
        total += n


def _push_one_filter(prog: TCAPProgram) -> Tuple[TCAPProgram, int]:
    ops = list(prog.ops)
    pushed = 0
    for i, flt in enumerate(ops):
        if flt.op != "FILTER" or "conjunct" not in flt.info:
            continue
        slots = flt.info.get("depends_slots", "")
        if "," in slots or slots == "":
            continue  # depends on >1 input: stays post-join
        slot, comp, ci = slots, flt.comp, flt.info["conjunct"]
        # the chain: contiguous APPLYs with the same conjunct tag feeding flt
        chain: List[TCAPOp] = []
        cur = prog.producer_of(flt.in_list)
        while (cur is not None and cur.op == "APPLY"
               and cur.info.get("conjunct") == ci and cur.comp == comp):
            chain.append(cur)
            cur = prog.producer_of(cur.in_list)
        if not chain:
            continue
        chain = chain[::-1]
        # ensure there IS a join between here and the slot's HASH
        target_hash = None
        for op in ops:
            if (op.op == "HASH" and op.comp == comp
                    and op.info.get("slot") == slot):
                target_hash = op
                break
        if target_hash is None:
            continue
        join_between = any(o.op == "JOIN" and o.comp == comp
                           for o in ops[ops.index(target_hash):i])
        if not join_between:
            continue

        # --- remove chain + filter from the post-join stream
        chain_cols = {c for o in chain for c in o.new_cols}
        first, last = chain[0], flt
        for op in ops:
            if op is flt or op in chain:
                continue
            if op.in_list == last.out:
                op.in_list = first.in_list
            if op.in_list2 == last.out:
                op.in_list2 = first.in_list
        for op in ops:
            if op is flt or op in chain:
                continue
            op.copy_cols = tuple(c for c in op.copy_cols if c not in chain_cols)
            op.copy_cols2 = tuple(c for c in op.copy_cols2
                                  if c not in chain_cols)
            op.out_cols = tuple(c for c in op.out_cols if c not in chain_cols)
        for o in (*chain, flt):
            ops.remove(o)

        # --- insert equivalent chain + FILTER before the target HASH
        at = ops.index(target_hash)
        in_list = target_hash.in_list
        in_cols = tuple(prog.producer_of(in_list).out_cols
                        if prog.producer_of(in_list) else target_hash.copy_cols)
        stream_list, stream_cols = in_list, in_cols
        inserted: List[TCAPOp] = []
        for o in chain:
            nl = f"Pu_{o.out}"
            new = dataclasses.replace(
                o, out=nl, in_list=stream_list, copy_cols=stream_cols,
                out_cols=(*stream_cols, *o.new_cols), info=dict(o.info))
            inserted.append(new)
            stream_list, stream_cols = nl, new.out_cols
        mask = chain[-1].new_cols[0]
        nl = f"Pu_{flt.out}"
        inserted.append(TCAPOp(out=nl, out_cols=in_cols, op="FILTER",
                               in_list=stream_list, apply_cols=(mask,),
                               copy_cols=in_cols, comp=comp,
                               info={"type": "filter", "pushed": "1"}))
        target_hash.in_list = nl
        ops[at:at] = inserted
        pushed += 1
        return TCAPProgram(ops), pushed
    return TCAPProgram(ops), pushed


# ------------------------------------------------------- dead columns
def dead_column_elimination(prog: TCAPProgram
                            ) -> Tuple[TCAPProgram, int, int]:
    needed: Dict[str, Set[str]] = {}
    ops = list(prog.ops)
    kept: List[TCAPOp] = []
    cols_removed = ops_removed = 0
    for op in reversed(ops):
        need_out = needed.get(op.out, set())
        if op.op in ("OUTPUT", "AGG", "TOPK"):
            need_out = set(op.out_cols)
        true_new = op.new_cols  # capture BEFORE trimming copy_cols
        if op.op == "APPLY" and op.info.get("type") in (*_CSEABLE, "rename"):
            new = set(true_new)
            if new and not (new & need_out) and op.info.get("type") != "rename":
                # op computes only dead columns -> drop it entirely
                needed.setdefault(op.in_list, set()).update(
                    c for c in need_out if c in op.copy_cols)
                # rewire consumers
                for o in ops:
                    if o.in_list == op.out:
                        o.in_list = op.in_list
                    if o.in_list2 == op.out:
                        o.in_list2 = op.in_list
                ops_removed += 1
                continue
        keep_copy = tuple(c for c in op.copy_cols if c in need_out)
        keep_copy2 = tuple(c for c in op.copy_cols2 if c in need_out)
        cols_removed += (len(op.copy_cols) - len(keep_copy)
                         + len(op.copy_cols2) - len(keep_copy2))
        op.copy_cols, op.copy_cols2 = keep_copy, keep_copy2
        if op.op in ("SCAN", "AGG", "TOPK"):
            pass  # source/sink column sets are fixed
        else:
            op.out_cols = tuple(c for c in op.out_cols
                                if c in keep_copy or c in keep_copy2
                                or c in true_new)
        needed.setdefault(op.in_list, set()).update(
            (*op.apply_cols, *keep_copy))
        if op.in_list2:
            needed.setdefault(op.in_list2, set()).update(
                (*op.apply_cols2, *keep_copy2))
        kept.append(op)
    out = TCAPProgram(kept[::-1])
    return out, cols_removed, ops_removed
