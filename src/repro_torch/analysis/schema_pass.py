"""Pass 1 — schema/dtype dataflow (forward inference over TCAP edges).

Every ``(list, column)`` edge of the program gets a numpy dtype inferred
*without executing the plan*: SCANs resolve their registered record schema
(or the stored set's layout), pipelined stages are probed on zero-row
slices through the very same :func:`~repro_torch.core.relops.stage_eval` the
executors run — so the inferred dtype is the executed dtype by
construction, the property the differential suite pins — and AGG outputs
follow the combiner dtype rules shared with :func:`~repro_torch.core.relops
.sum_acc_dtype` and the group-schema synthesis.

Native lambdas are probed on zero rows too (the same dry-run contract as
``dataset._spec_result``), but columns whose value flows through a native
are marked *tainted*: a native's zero-row dtype is best-effort, so no
error- or warning-severity diagnostic is ever raised on tainted inputs —
the analyzer must never reject a plan that would have executed fine.

Diagnostics raised here:

* **PL103** (error) — ``attAccess`` names a field the inferred structured
  input dtype does not define (untainted inputs only).
* **PL101** (warning) — a float-producing arithmetic stage consumes a
  64-bit integer operand: values above 2^53 lose precision in the float64
  result.
* **PL102** (warning) — ``sum`` accumulates in a small integer dtype
  (i8/i16/i32 and unsigned kin keep their width by the shared accumulator
  rule, so large partitions can overflow silently).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic, op_path
from repro_torch.core.relops import AggSpec, stage_eval, sum_acc_dtype
from repro_torch.core.tcap import TCAPOp, TCAPProgram
from repro_torch.objectmodel.schema import schema_for

__all__ = ["infer_dtypes", "schema_pass"]

Edge = Tuple[str, str]  # (list name, column name)


def _scan_dtype(op: TCAPOp, store) -> Optional[np.dtype]:
    sch = schema_for(op.info.get("type"))
    if sch is not None:
        return sch.dtype
    if store is not None:
        try:
            return store.get_set(op.info["set"]).dtype
        except KeyError:
            return None
    return None


_PROBE_MEMO: Dict[Tuple, Optional[np.dtype]] = {}
_PROBE_MEMO_CAP = 4096


def _probe_key(op: TCAPOp, ins: Sequence[np.dtype]) -> Optional[Tuple]:
    """A content key for deterministic stage types: same payload + same
    input dtypes -> same output dtype, across programs and sessions.
    Native lambdas (arbitrary user code) never memoize."""
    t = op.info.get("type")
    if t in ("cmp", "bool", "arith"):
        payload: object = op.info["op"]
    elif t == "methodCall":
        payload = (op.info["onType"], op.info["methodName"])
    else:
        return None
    # np.dtype objects hash and compare by content — usable key parts
    return (t, payload, tuple(ins))


def _stage_out_dtype(op: TCAPOp, t: Optional[str],
                     ins: Sequence[Optional[np.dtype]]
                     ) -> Optional[np.dtype]:
    """Output dtype of one pipelined stage. Structurally determined types
    resolve without touching a kernel; only value-semantics stages (arith
    promotion, method calls, natives) fall through to the zero-row probe.
    ``.base`` mirrors the probe's behavior on sub-array record fields: the
    column carries the element dtype (the rows carry the extra axis)."""
    if any(d is None for d in ins):
        return None
    if t == "rename":
        return ins[0]
    if t in ("cmp", "bool"):
        return np.dtype(np.bool_)
    if t == "const":
        return np.asarray(op.info["value"]).dtype
    if t == "attAccess" and ins[0].fields is not None:
        fd = ins[0].fields.get(op.info["attName"])
        return None if fd is None else fd[0].base
    return _probe(op, ins)


def _probe(op: TCAPOp, ins: Sequence[Optional[np.dtype]]
           ) -> Optional[np.dtype]:
    """Zero-row evaluation of one pipelined stage through the shared
    kernel — the dtype the executors will produce, or None when any input
    dtype is unknown or the stage rejects empty input."""
    if any(d is None for d in ins):
        return None
    key = _probe_key(op, ins)
    if key is not None and key in _PROBE_MEMO:
        return _PROBE_MEMO[key]
    try:  # caller holds np.errstate(all="ignore") for the whole pass
        out: Optional[np.dtype] = np.asarray(
            stage_eval(op, [np.zeros(0, d) for d in ins], 0)).dtype
    except Exception:
        out = None
    if key is not None:
        if len(_PROBE_MEMO) >= _PROBE_MEMO_CAP:
            _PROBE_MEMO.clear()
        _PROBE_MEMO[key] = out
    return out


def _agg_dtypes(op: TCAPOp, spec: AggSpec,
                dt: Dict[Edge, Optional[np.dtype]]
                ) -> Dict[str, Optional[np.dtype]]:
    """Output dtypes of one AGG op from the shared combiner rules: sum
    keeps/widen per :func:`sum_acc_dtype`, min/max accumulate float64,
    ``i/j`` finalizers divide (the mean composite)."""
    out: Dict[str, Optional[np.dtype]] = {}
    for kname, kcol in zip(spec.key_names, spec.key_cols(op)):
        out[kname] = dt.get((op.in_list, kcol))
    accs: List[Optional[np.dtype]] = []
    for comb, acol in zip(spec.combiners, spec.acc_cols(op)):
        d = dt.get((op.in_list, acol))
        if d is None:
            accs.append(None)
        elif comb == "sum":
            accs.append(sum_acc_dtype(d))
        else:  # min/max accumulate float64 (relops._scatter_minmax)
            accs.append(np.dtype(np.float64))
    for name, fin in zip(spec.out_names, spec.finalize):
        if "/" in fin:
            i, j = map(int, fin.split("/"))
            a, b = accs[i], accs[j]
            out[name] = (None if a is None or b is None else
                         (np.zeros(0, a) / np.zeros(0, b)).dtype)
        else:
            out[name] = accs[int(fin)]
    return out


def schema_pass(prog: TCAPProgram, store=None
                ) -> Tuple[List[Diagnostic],
                           Dict[Edge, Optional[np.dtype]],
                           Dict[str, Optional[np.dtype]]]:
    """Run the forward dataflow. Returns ``(diagnostics, edge dtypes,
    output schema)`` — the output schema maps the OUTPUT op's projected
    columns to their inferred dtypes (empty when the program has no
    OUTPUT op)."""
    diags: List[Diagnostic] = []
    dt: Dict[Edge, Optional[np.dtype]] = {}
    tainted: Set[Edge] = set()  # value passed through a native lambda
    consty: Set[Edge] = set()   # value derived only from scalar constants

    def copy_through(op: TCAPOp) -> None:
        for c in op.copy_cols:
            dt[(op.out, c)] = dt.get((op.in_list, c))
            if (op.in_list, c) in tainted:
                tainted.add((op.out, c))
            if (op.in_list, c) in consty:
                consty.add((op.out, c))
        for c in op.copy_cols2:
            dt[(op.out, c)] = dt.get((op.in_list2, c))
            if (op.in_list2, c) in tainted:
                tainted.add((op.out, c))
            if (op.in_list2, c) in consty:
                consty.add((op.out, c))

    # one errstate frame for the whole pass: the zero-row probes would
    # otherwise enter/exit it per stage, which dominates analyzer time
    with np.errstate(all="ignore"):
        return _schema_pass_loop(prog, store, diags, dt, tainted, consty,
                                 copy_through)


def _schema_pass_loop(prog, store, diags, dt, tainted, consty,
                      copy_through):
    output: Dict[str, Optional[np.dtype]] = {}
    for i, op in enumerate(prog.ops):
        if op.op == "SCAN":
            dt[(op.out, op.out_cols[0])] = _scan_dtype(op, store)
            continue
        copy_through(op)
        if op.op == "APPLY" and (newc := op.new_cols):
            t = op.info.get("type")
            new = newc[0]
            in_edges = [(op.in_list, c) for c in op.apply_cols]
            ins = [dt.get(e) for e in in_edges]
            in_taint = any(e in tainted for e in in_edges)
            if t == "attAccess" and ins and ins[0] is not None:
                att = op.info["attName"]
                if ins[0].names is not None and att not in ins[0].names:
                    if not in_taint:
                        diags.append(Diagnostic(
                            "PL103", "error",
                            f"unresolved column: field {att!r} is not in "
                            f"the inferred input record dtype "
                            f"(fields: {list(ins[0].names)})",
                            op_path(i, op)))
                    dt[(op.out, new)] = None
                    tainted.add((op.out, new))
                    continue
            out_d = _stage_out_dtype(op, t, ins)
            if t == "native":
                tainted.add((op.out, new))
            elif in_taint:
                tainted.add((op.out, new))
            if t == "const" and np.ndim(op.info.get("value")) == 0:
                consty.add((op.out, new))
            elif (t in ("rename", "cmp", "bool", "arith") and in_edges
                    and all(e in consty for e in in_edges)):
                consty.add((op.out, new))
            # a scalar-constant operand (the literal 1 in `1 - discount`)
            # cannot exceed 2^53 — only data-carrying i64 operands narrow
            if (t == "arith" and out_d is not None and out_d.kind == "f"
                    and not in_taint
                    and any(d is not None and d.kind in "iu"
                            and d.itemsize == 8 and e not in consty
                            for e, d in zip(in_edges, ins))):
                diags.append(Diagnostic(
                    "PL101", "warning",
                    f"dtype narrowing: 64-bit integer operand enters a "
                    f"float-producing '{op.info.get('op')}' stage — values "
                    "above 2^53 lose precision in the float64 result",
                    op_path(i, op)))
            dt[(op.out, new)] = out_d
        elif op.op == "HASH":
            hnew = op.new_cols[0]
            dt[(op.out, hnew)] = np.dtype(np.int64)
            if (op.in_list, op.apply_cols[0]) in tainted:
                tainted.add((op.out, hnew))
        elif op.op == "FLATTEN":
            d0 = dt.get((op.in_list, op.apply_cols[0]))
            # a fixed-width vector column flattens to its base dtype;
            # object sequences (ragged rows) stay unknown
            if d0 is None or d0.kind == "O":
                dt[(op.out, op.out_cols[0])] = None
            else:
                dt[(op.out, op.out_cols[0])] = (
                    d0.subdtype[0] if d0.subdtype else d0)
            if (op.in_list, op.apply_cols[0]) in tainted:
                tainted.add((op.out, op.out_cols[0]))
        elif op.op == "AGG":
            spec = AggSpec.from_op(op)
            acc_taint = any((op.in_list, c) in tainted
                            for c in op.apply_cols)
            for comb, acol in zip(spec.combiners, spec.acc_cols(op)):
                d = dt.get((op.in_list, acol))
                if (comb == "sum" and not acc_taint and d is not None
                        and d.kind in "iu" and d.itemsize < 8):
                    diags.append(Diagnostic(
                        "PL102", "warning",
                        f"accumulator saturation: sum over {d} accumulates "
                        f"in {sum_acc_dtype(d)} — large partitions can "
                        "overflow silently; widen the value to int64 first",
                        op_path(i, op)))
            for kname, kcol in zip(spec.key_names, spec.key_cols(op)):
                kd = dt.get((op.in_list, kcol))
                if (kd is not None and kd.kind == "f"
                        and (op.in_list, kcol) not in tainted):
                    diags.append(Diagnostic(
                        "PL104", "warning",
                        f"float group key {kname!r} ({kd}): NaN != NaN, so "
                        "NaN keys silently fragment into one group per "
                        "row — round or cast the key to an integer/bytes "
                        "dtype if NaNs can occur",
                        op_path(i, op)))
            for name, d in _agg_dtypes(op, spec, dt).items():
                dt[(op.out, name)] = d
                if acc_taint:
                    tainted.add((op.out, name))
        elif op.op == "TOPK":
            # out_cols are ("score", "payload"), carried from apply_cols
            for out_c, in_c in zip(op.out_cols, op.apply_cols):
                dt[(op.out, out_c)] = dt.get((op.in_list, in_c))
                if (op.in_list, in_c) in tainted:
                    tainted.add((op.out, out_c))
        elif op.op == "OUTPUT":
            output = {c: dt.get((op.in_list, c)) for c in op.apply_cols}
        # FILTER and JOIN are pure routing: copy_through covered them

    return diags, dt, output


def infer_dtypes(prog: TCAPProgram, store=None
                 ) -> Dict[Edge, Optional[np.dtype]]:
    """Just the edge dtypes (no diagnostics) — the fusion pass and other
    consumers share the same inference."""
    return schema_pass(prog, store)[1]
