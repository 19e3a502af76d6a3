"""TCAP compiler (paper §5): calls each Computation's lambda-term
construction functions and flattens the resulting expression trees into a
TCAP program — one APPLY per lambda node, FILTERs for selections, HASH/JOIN
for joins, AGG/TOPK/OUTPUT sinks.

Join selections are decomposed into conjuncts; equality conjuncts whose two
sides each depend on a single (distinct) input become hash-join keys, the
rest become a residual post-join predicate tagged with ``conjunct`` +
``depends_slots`` metadata so the optimizer can push it down (paper §7).

FILTER ops copy *all* live columns through (paper: vectors are
shallow-copied); dead-column elimination prunes the unused ones afterwards —
this is what lets redundant-APPLY elimination work across filters, as in the
paper's getSalary() example.

Grouped aggregations lower to one generalized AGG op: key-term columns plus
one accumulator column per sum/min/max output, a summed int64 constant-one
for ``count``, and a sum+count pair for ``mean`` (divided only at finalize,
after the partial-map shuffle — CSE merges the shared subterms and constant
columns across outputs). An AGG's multi-column result feeds OUTPUT
directly (named result columns); any other consumer first gets a ``pack``
APPLY assembling the columns into one structured record column, which is
what lets chains continue off grouped results.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.aggregates import AGG_KINDS
from repro_torch.core.computations import (AggregateComp, Computation, JoinComp,
                                     MultiSelectionComp, ScanSet,
                                     SelectionComp, TopKComp, WriteSet)
from repro_torch.core.lambdas import LambdaArg, LambdaTerm, TypedLambdaArg, constant
from repro_torch.core.tcap import TCAPOp, TCAPProgram

__all__ = ["compile_graph"]


def _arg_for(comp_input: Computation, slot: int, col: str) -> LambdaArg:
    """The lambda argument for one input: typed (members resolved against
    the schema, typos fail at graph-build time) when the producing
    computation declares an output schema, the classic untyped placeholder
    otherwise."""
    schema = comp_input.output_schema
    if schema is not None:
        return TypedLambdaArg(slot, schema, col)
    return LambdaArg(slot, comp_input.output_type_name, col)


class _Namer:
    def __init__(self):
        self._n = itertools.count(1)
        self._lists = itertools.count(1)

    def stage(self, kind: str) -> str:
        i = next(self._n)
        return {"attAccess": f"att_acc_{i}", "methodCall": f"method_call_{i}",
                "cmp": f"cmp_{i}", "bool": f"bool_{i}", "arith": f"arith_{i}",
                "native": f"native_{i}", "const": f"const_{i}"}[kind]

    def vlist(self, prefix: str) -> str:
        return f"{prefix}_{next(self._lists)}"


def _flatten_conjuncts(t: LambdaTerm) -> List[LambdaTerm]:
    if t.kind == "bool" and t.info.get("op") == "&&":
        return _flatten_conjuncts(t.inputs[0]) + _flatten_conjuncts(t.inputs[1])
    return [t]


class _Stream:
    """A (list_name, columns) cursor into the growing program."""

    def __init__(self, lst: str, cols: Tuple[str, ...]):
        self.lst = lst
        self.cols = cols


class _Emitter:
    """Emits APPLY chains for lambda terms onto a stream."""

    def __init__(self, prog: TCAPProgram, namer: _Namer, comp_name: str):
        self.prog = prog
        self.namer = namer
        self.comp = comp_name
        self.col_of: Dict[int, str] = {}

    def emit(self, term: LambdaTerm, s: _Stream, slot_cols: Dict[int, str],
             extra_info: Optional[Dict] = None) -> str:
        if term.uid in self.col_of and self.col_of[term.uid] in s.cols:
            return self.col_of[term.uid]
        if term.kind == "self":
            col = slot_cols[term.info["slot"]]
            self.col_of[term.uid] = col
            return col
        in_cols = [self.emit(sub, s, slot_cols, extra_info)
                   for sub in term.inputs]
        stage = self.namer.stage(term.kind)
        new_col = stage
        out_list = self.namer.vlist("W")
        info = {"type": term.kind}
        for k in ("attName", "methodName", "op", "onType", "name",
                  "pair_fields"):
            if k in term.info:
                info[k] = term.info[k]
        if term.kind == "native":
            info["fn"] = term.info["fn"]
        if term.kind == "const":
            info["value"] = term.info["value"]
        if extra_info:
            info.update(extra_info)
        self.prog.append(TCAPOp(out=out_list, out_cols=(*s.cols, new_col),
                                op="APPLY", in_list=s.lst,
                                apply_cols=tuple(in_cols), copy_cols=s.cols,
                                comp=self.comp, stage=stage, info=info))
        s.lst, s.cols = out_list, (*s.cols, new_col)
        self.col_of[term.uid] = new_col
        return new_col


def compile_graph(sink: Computation) -> TCAPProgram:
    prog = TCAPProgram()
    namer = _Namer()
    memo: Dict[int, Tuple[str, Tuple[str, ...]]] = {}

    def emit_filter(s: _Stream, mask_col: str, comp_name: str,
                    info: Optional[Dict] = None) -> None:
        keep = tuple(c for c in s.cols if c != mask_col)
        flt = namer.vlist("Flt")
        prog.append(TCAPOp(out=flt, out_cols=keep, op="FILTER", in_list=s.lst,
                           apply_cols=(mask_col,), copy_cols=keep,
                           comp=comp_name,
                           info={"type": "filter", **(info or {})}))
        s.lst, s.cols = flt, keep

    def rec(comp: Computation) -> Tuple[str, Tuple[str, ...]]:
        # memo by object identity: comp_id streams are per-NameScope, so ids
        # from different scopes may coincide within one mixed graph.
        if id(comp) in memo:
            return memo[id(comp)]
        out = _compile_one(comp)
        memo[id(comp)] = out
        return out

    def record_stream(comp_name: str, lst: str, cols: Tuple[str, ...]
                      ) -> Tuple[str, str]:
        """The single record column a downstream computation consumes.

        Grouped aggregations produce multi-column vector lists (key fields
        + named aggregate fields); chaining a Selection/Join/Agg/TopK off
        one packs those columns into one structured record column first —
        an elementwise ``pack`` APPLY whose field order is the AGG output
        order, matching the synthesized group schema."""
        if len(cols) == 1:
            return lst, cols[0]
        out = namer.vlist("Pck")
        col = f"pack_{out}"
        prog.append(TCAPOp(out=out, out_cols=(col,), op="APPLY",
                           in_list=lst, apply_cols=cols, copy_cols=(),
                           comp=comp_name, stage="pack",
                           info={"type": "pack", "fields": ",".join(cols)}))
        return out, col

    def _compile_one(comp: Computation) -> Tuple[str, Tuple[str, ...]]:
        if isinstance(comp, ScanSet):
            lst = namer.vlist("In")
            col = comp.set_name
            prog.append(TCAPOp(out=lst, out_cols=(col,), op="SCAN",
                               comp=comp.name,
                               info={"db": comp.db, "set": comp.set_name,
                                     "type": comp.type_name}))
            return lst, (col,)

        if isinstance(comp, (SelectionComp, MultiSelectionComp)):
            in_list, in_col = record_stream(comp.name, *rec(comp.inputs[0]))
            arg = _arg_for(comp.inputs[0], 0, in_col)
            em = _Emitter(prog, namer, comp.name)
            s = _Stream(in_list, (in_col,))
            slot_cols = {0: in_col}
            bcol = em.emit(comp.get_selection(arg), s, slot_cols)
            emit_filter(s, bcol, comp.name)
            pcol = em.emit(comp.get_projection(arg), s, slot_cols)
            out = namer.vlist("Out")
            kind = "FLATTEN" if isinstance(comp, MultiSelectionComp) else "APPLY"
            prog.append(TCAPOp(out=out, out_cols=(comp.name,), op=kind,
                               in_list=s.lst, apply_cols=(pcol,), copy_cols=(),
                               comp=comp.name,
                               stage="flatten" if kind == "FLATTEN" else "rename",
                               info={"type": kind.lower() if kind == "FLATTEN"
                                     else "rename"}))
            return out, (comp.name,)

        if isinstance(comp, JoinComp):
            return _compile_join(comp)

        if isinstance(comp, AggregateComp):
            in_list, in_col = record_stream(comp.name, *rec(comp.inputs[0]))
            arg = _arg_for(comp.inputs[0], 0, in_col)
            em = _Emitter(prog, namer, comp.name)
            s = _Stream(in_list, (in_col,))
            slot_cols = {0: in_col}
            key_names = tuple(comp.key_names)
            key_terms = comp.get_key_projections(arg)
            if len(key_terms) != len(key_names):
                raise ValueError(
                    f"{comp.name}: {len(key_terms)} key projections for "
                    f"{len(key_names)} key_names {key_names}")
            kcols = tuple(em.emit(t, s, slot_cols) for t in key_terms)
            # lower each named output onto accumulator columns: one per
            # sum/min/max, a summed int64 constant-one for count, and the
            # sum+count composite for mean (divided only at finalize, after
            # the partial-map shuffle merge — partial means never exist).
            acc_cols: List[str] = []
            combiners: List[str] = []
            finalize: List[str] = []
            out_names: List[str] = []
            for out_name, kind, term in comp.get_aggregates(arg):
                if kind not in AGG_KINDS:
                    raise ValueError(f"{comp.name}: unknown aggregate kind "
                                     f"{kind!r} for output {out_name!r}")
                out_names.append(out_name)
                if kind == "count":
                    acc_cols.append(em.emit(constant(np.int64(1)), s,
                                            slot_cols))
                    combiners.append("sum")
                    finalize.append(str(len(acc_cols) - 1))
                elif kind == "mean":
                    acc_cols.append(em.emit(term, s, slot_cols))
                    combiners.append("sum")
                    acc_cols.append(em.emit(constant(np.int64(1)), s,
                                            slot_cols))
                    combiners.append("sum")
                    finalize.append(f"{len(acc_cols) - 2}/"
                                    f"{len(acc_cols) - 1}")
                else:
                    acc_cols.append(em.emit(term, s, slot_cols))
                    combiners.append(kind)
                    finalize.append(str(len(acc_cols) - 1))
            out_cols = (*key_names, *out_names)
            if len(set(out_cols)) != len(out_cols):
                raise ValueError(f"{comp.name}: key and aggregate output "
                                 f"names must be distinct, got {out_cols}")
            if not out_names:
                raise ValueError(f"{comp.name}: at least one aggregate "
                                 "output is required")
            out = namer.vlist("Agg")
            # "out" records the user-facing result column names: column
            # names are canonicalized away by structural_signature, but AGG
            # output names are semantic (they name the collected columns),
            # so they must distinguish otherwise-identical plans in the
            # session plan cache.
            prog.append(TCAPOp(out=out, out_cols=out_cols, op="AGG",
                               in_list=s.lst,
                               apply_cols=(*kcols, *acc_cols),
                               copy_cols=(), comp=comp.name, stage="agg",
                               info={"type": "agg",
                                     "nkeys": str(len(kcols)),
                                     "combiners": ",".join(combiners),
                                     "finalize": ",".join(finalize),
                                     "out": ",".join(out_cols)}))
            return out, out_cols

        if isinstance(comp, TopKComp):
            in_list, in_col = record_stream(comp.name, *rec(comp.inputs[0]))
            arg = _arg_for(comp.inputs[0], 0, in_col)
            em = _Emitter(prog, namer, comp.name)
            s = _Stream(in_list, (in_col,))
            slot_cols = {0: in_col}
            scol = em.emit(comp.get_score(arg), s, slot_cols)
            pcol = em.emit(comp.get_payload(arg), s, slot_cols)
            out = namer.vlist("TopK")
            prog.append(TCAPOp(out=out, out_cols=("score", "payload"),
                               op="TOPK", in_list=s.lst,
                               apply_cols=(scol, pcol), copy_cols=(),
                               comp=comp.name, stage="topk",
                               info={"type": "topk", "k": str(comp.k)}))
            return out, ("score", "payload")

        raise TypeError(f"cannot compile computation {comp!r}")

    def _compile_join(comp: JoinComp) -> Tuple[str, Tuple[str, ...]]:
        n = comp.arity
        sides = [record_stream(comp.name, *rec(c)) for c in comp.inputs]
        side_streams = [_Stream(lst, (col,)) for (lst, col) in sides]
        record_col = {i: sides[i][1] for i in range(n)}
        args = [_arg_for(comp.inputs[i], i, record_col[i])
                for i in range(n)]
        sel = comp.get_selection(*args)
        conjuncts = _flatten_conjuncts(sel)

        key_pairs: List[Tuple[int, LambdaTerm, int, LambdaTerm]] = []
        residual: List[LambdaTerm] = []
        for c in conjuncts:
            if (c.kind == "cmp" and c.info.get("op") == "==" and
                    len(c.inputs) == 2):
                ls, rs = (c.inputs[0].depends_on_slots,
                          c.inputs[1].depends_on_slots)
                if len(ls) == 1 and len(rs) == 1 and ls != rs:
                    key_pairs.append((ls[0], c.inputs[0], rs[0], c.inputs[1]))
                    continue
            residual.append(c)
        if not key_pairs and n > 1:
            raise ValueError(
                f"{comp.name}: no equality conjuncts — cross joins are not "
                "supported (hide one in a native lambda only if intended)")

        # 1) Emit every key-term column in its slot's own pipeline.
        emitters = {i: _Emitter(prog, namer, comp.name) for i in range(n)}
        key_col: Dict[int, str] = {}  # term uid -> column name
        for (ls, lt, rs, rt) in key_pairs:
            key_col[lt.uid] = emitters[ls].emit(lt, side_streams[ls],
                                                {ls: record_col[ls]})
            key_col[rt.uid] = emitters[rs].emit(rt, side_streams[rs],
                                                {rs: record_col[rs]})

        # 2) Greedy join order: each step connects the joined set to one new
        #    slot; pairs within the joined set become residual checks.
        joined = {key_pairs[0][0]}
        pending = list(key_pairs)
        steps: List[Tuple[int, str, int, str]] = []  # (stream-key-col side info)
        while pending:
            for idx, (ls, lt, rs, rt) in enumerate(pending):
                if ls in joined and rs in joined:
                    residual.append(LambdaTerm("cmp", [lt, rt], {"op": "=="}))
                    pending.pop(idx)
                    break
                if ls in joined or rs in joined:
                    if rs in joined:  # normalize: left side already joined
                        ls, lt, rs, rt = rs, rt, ls, lt
                    steps.append((ls, key_col[lt.uid], rs, key_col[rt.uid]))
                    joined.add(rs)
                    pending.pop(idx)
                    break
            else:
                raise ValueError(f"{comp.name}: disconnected join graph")

        def hash_stream(s: _Stream, kcol: str, slot: int) -> str:
            hl = namer.vlist("Hsh")
            hcol = f"hash_{hl}"
            prog.append(TCAPOp(out=hl, out_cols=(*s.cols, hcol), op="HASH",
                               in_list=s.lst, apply_cols=(kcol,),
                               copy_cols=s.cols, comp=comp.name,
                               stage=f"hash_{slot}",
                               info={"type": "hash", "slot": str(slot)}))
            s.lst, s.cols = hl, (*s.cols, hcol)
            return hcol

        # 3) Left-deep chain of JOINs.
        first_ls = steps[0][0]
        stream = side_streams[first_ls]
        for (ls, lkey, rs, rkey) in steps:
            lh = hash_stream(stream, lkey, ls)
            rh = hash_stream(side_streams[rs], rkey, rs)
            keep_l = tuple(c for c in stream.cols if c != lh)
            keep_r = tuple(c for c in side_streams[rs].cols if c != rh)
            out = namer.vlist("Jnd")
            prog.append(TCAPOp(out=out, out_cols=(*keep_l, *keep_r), op="JOIN",
                               in_list=stream.lst, apply_cols=(lh,),
                               copy_cols=keep_l, in_list2=side_streams[rs].lst,
                               apply_cols2=(rh,), copy_cols2=keep_r,
                               comp=comp.name,
                               info={"type": "join", "build_slot": str(rs)}))
            stream = _Stream(out, (*keep_l, *keep_r))

        # 4) Re-check equality keys post-join (hash collisions), as the paper
        #    does after probing, then the residual predicate, then projection.
        em = _Emitter(prog, namer, comp.name)
        slot_cols = record_col
        for (ls, lt, rs, rt) in key_pairs:
            chk = em.emit(LambdaTerm("cmp", [lt, rt], {"op": "=="}), stream,
                          slot_cols, {"role": "collision_check"})
            emit_filter(stream, chk, comp.name, {"role": "collision_check"})
        for ci, c in enumerate(residual):
            extra = {"conjunct": str(ci),
                     "depends_slots": ",".join(map(str, c.depends_on_slots))}
            bc = em.emit(c, stream, slot_cols, extra)
            emit_filter(stream, bc, comp.name, extra)
        pcol = em.emit(comp.get_projection(*args), stream, slot_cols)
        out = namer.vlist("Out")
        prog.append(TCAPOp(out=out, out_cols=(comp.name,), op="APPLY",
                           in_list=stream.lst, apply_cols=(pcol,),
                           copy_cols=(), comp=comp.name, stage="rename",
                           info={"type": "rename"}))
        return out, (comp.name,)

    assert isinstance(sink, WriteSet), "graph must end in a WriteSet"
    in_list, in_cols = rec(sink.inputs[0])
    prog.append(TCAPOp(out=namer.vlist("Output"), out_cols=in_cols,
                       op="OUTPUT", in_list=in_list, apply_cols=in_cols,
                       copy_cols=(), comp=sink.name,
                       info={"type": "output", "db": sink.db,
                             "set": sink.set_name}))
    prog.validate()
    return prog
