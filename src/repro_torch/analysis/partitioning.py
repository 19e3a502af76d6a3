"""Pass 2 — partitioning-property propagation and redundant-exchange
detection (PL201 / PL202).

Both exchange families route by the *same* hash: the AGG exchange sends
each pre-aggregated group to ``stable_key_hash(key) % P``
(:meth:`~repro_torch.core.relops.AggMap.split_by_key_hash`) and the
hash-partition JOIN shuffle sends each row to ``hash_col(key col) % P``
(:func:`~repro_torch.core.relops.split_by_hash`), and ``hash_col`` is
bit-identical per element to ``stable_key_hash``. A stream placed by one
family therefore satisfies the other's placement — which is what lets
partitioning *facts* flow through joins instead of unconditionally dying.

A fact is a set of ordered key value-id tuples the stream is
hash-partitioned on; the pass threads facts forward:

* SCAN starts with no facts (pages are placed by load balance, not key);
* APPLY/FILTER/HASH/FLATTEN keep rows in place — facts survive;
* a broadcast JOIN keeps probe-side rows in place — probe facts survive
  (the build side is replicated, its facts do not);
* a hash-partition JOIN routes each side by its join-key hash. If a side
  already carries a single-key fact on exactly that value, its
  split+route exchange is the identity permutation — **PL202**, the
  side's exchange is elided (``join_elide``) and the side's whole fact
  set survives. Whether or not a side elides, the *output* is
  hash-partitioned on both join keys (rows land where their key hashes),
  so the join adds ``{(probe key,), (build key,)}`` to the outgoing
  facts — this is what a downstream AGG on the join key consumes;
* AGG: where the ordered key-id tuple is a member of the live fact set,
  its exchange is redundant (**PL201**, elided); either way the output
  carries the key-tuple fact;
* TOPK gathers to one rank — facts die.

Column *values* are tracked by structural value ids so a fact follows the
value, not the column name: an AGG key packed into a record column (the
``pack`` stage between chained aggregations, or the default join
projection's pair pack — threaded via the op's ``pair_fields``
provenance) and re-extracted by ``attAccess`` resolves back to the
original key's id.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, op_path
from repro_torch.core.relops import AggSpec
from repro_torch.core.tcap import TCAPProgram

__all__ = ["propagate_partitioning", "PartitioningResult"]

_NO_FACTS: FrozenSet[Tuple] = frozenset()

_SIDE_LABEL = {"L": "probe", "R": "build"}


class PartitioningResult:
    """``redundant``: AGG op indices whose exchange a live fact satisfies;
    ``join_elide``: JOIN op index -> sides ("L" probe / "R" build) whose
    shuffle a live fact satisfies; ``diagnostics``: one PL201/PL202 per
    elision; ``facts``: the surviving fact set (ordered key value-id
    tuples) per list name, for explain/debugging."""

    def __init__(self, redundant: Tuple[int, ...],
                 diagnostics: List[Diagnostic],
                 facts: Dict[str, FrozenSet[Tuple]],
                 join_elide: Optional[Dict[int, Tuple[str, ...]]] = None):
        self.redundant = redundant
        self.diagnostics = diagnostics
        self.facts = facts
        self.join_elide = dict(join_elide or {})


def _usable(v: Tuple) -> bool:
    # opaque values (native lambdas, futures) and edges the walk never
    # defined can't be proven equal to anything — never carry facts
    return v[0] not in ("opaque", "missing")


def propagate_partitioning(prog: TCAPProgram,
                           join_algo_by_index: Optional[Dict[int, str]]
                           = None) -> PartitioningResult:
    """``join_algo_by_index`` maps JOIN op index -> "broadcast" |
    "hash_partition" (from the physical plan). Without it every JOIN is
    assumed hash-partitioned — still productive: the hash shuffle itself
    creates join-key facts, and co-partitioned sides elide."""
    vid: Dict[Tuple[str, str], Tuple] = {}    # (list, col) -> value id
    fact: Dict[str, FrozenSet[Tuple]] = {}    # list -> key-vid tuples
    redundant: List[int] = []
    join_elide: Dict[int, Tuple[str, ...]] = {}
    diags: List[Diagnostic] = []

    def gv(lst: str, col: str) -> Tuple:
        # defensive: an edge the walk never defined still gets a stable,
        # per-column id (same column -> same value, so this stays sound)
        return vid.get((lst, col), ("missing", lst, col))

    def copy_vids(op) -> None:
        for c in op.copy_cols:
            vid[(op.out, c)] = gv(op.in_list, c)
        for c in op.copy_cols2:
            vid[(op.out, c)] = gv(op.in_list2, c)

    def att_of(base: Tuple, att: str) -> Tuple:
        # accessing a packed field resolves to the original value — the
        # chained-AGG / join-pair key path
        if base[0] == "pack" and att in base[1]:
            return base[2][base[1].index(att)]
        return ("att", base, att)

    def hash_key(lst: str, hash_col: str) -> Optional[Tuple]:
        # the value a HASH column was computed over, if trackable
        hv = gv(lst, hash_col)
        if hv[0] == "hash" and _usable(hv[1]):
            return hv[1]
        return None

    for i, op in enumerate(prog.ops):
        if op.op == "SCAN":
            vid[(op.out, op.out_cols[0])] = ("scan", i)
            fact[op.out] = _NO_FACTS
            continue
        if op.op == "APPLY":
            copy_vids(op)
            if (newc := op.new_cols):
                t = op.info.get("type")
                ins = tuple(gv(op.in_list, c) for c in op.apply_cols)
                if t == "rename":
                    v = ins[0]
                elif t == "attAccess":
                    v = att_of(ins[0], op.info["attName"])
                elif t == "pack":
                    names = tuple(op.info["fields"].split(","))
                    v = ("pack", names, ins)
                elif t == "const":
                    # repr, not the raw value: array-valued constants must
                    # not leak elementwise == into fact comparison
                    val = op.info["value"]
                    v = ("const", type(val).__name__, repr(val))
                elif t == "methodCall":
                    v = ("method", op.info["onType"],
                         op.info["methodName"], ins)
                elif t in ("cmp", "bool", "arith"):
                    v = (t, op.info.get("op"), ins)
                elif t == "native" and "pair_fields" in op.info:
                    # the default join projection: a native pack whose
                    # per-field provenance the front-end recorded — each
                    # output field is an attAccess on one input record
                    moves = tuple(tuple(m) for m in op.info["pair_fields"])
                    sides = (ins[0] if len(ins) > 0 else ("missing", "", ""),
                             ins[1] if len(ins) > 1 else ("missing", "", ""))
                    v = ("pack", tuple(m[0] for m in moves),
                         tuple(att_of(sides[m[1]], m[2]) for m in moves))
                else:  # native and anything future: a fresh opaque value
                    v = ("opaque", i)
                vid[(op.out, newc[0])] = v
            fact[op.out] = fact.get(op.in_list, _NO_FACTS)
        elif op.op in ("FILTER", "HASH"):
            copy_vids(op)
            if op.op == "HASH":
                vid[(op.out, op.new_cols[0])] = (
                    "hash", gv(op.in_list, op.apply_cols[0]))
            # filtering/annotating keeps every row in its partition
            fact[op.out] = fact.get(op.in_list, _NO_FACTS)
        elif op.op == "FLATTEN":
            copy_vids(op)
            vid[(op.out, op.out_cols[0])] = (
                "flat", gv(op.in_list, op.apply_cols[0]))
            # expanded rows inherit their source row's partition, and the
            # copied key values repeat in place — the fact survives
            fact[op.out] = fact.get(op.in_list, _NO_FACTS)
        elif op.op == "JOIN":
            copy_vids(op)
            algo = ((join_algo_by_index or {}).get(i, "hash_partition"))
            if algo == "broadcast":
                # probe rows never move; build side is replicated
                fact[op.out] = fact.get(op.in_list, _NO_FACTS)
            else:
                # both sides routed by hash_col(join key) % P — the same
                # hash family as stable_key_hash (bit-identical), so a
                # side already partitioned on exactly its join key needs
                # no exchange, and the output is partitioned on both keys
                lkv = hash_key(op.in_list, op.apply_cols[0])
                rkv = hash_key(op.in_list2, op.apply_cols2[0])
                out = set()
                if lkv is not None:
                    out.add((lkv,))
                if rkv is not None:
                    out.add((rkv,))
                sides: List[str] = []
                for side, kv, in_lst in (("L", lkv, op.in_list),
                                         ("R", rkv, op.in_list2)):
                    live = fact.get(in_lst, _NO_FACTS)
                    if kv is not None and (kv,) in live:
                        sides.append(side)
                        out |= live
                if sides:
                    join_elide[i] = tuple(sides)
                    diags.append(Diagnostic(
                        "PL202", "info",
                        "co-partitioned join: "
                        + " and ".join(_SIDE_LABEL[s] for s in sides)
                        + " side is already hash-partitioned on its join "
                        "key — the split+route exchange is the identity "
                        "permutation and is elided",
                        op_path(i, op)))
                fact[op.out] = frozenset(out)
        elif op.op == "AGG":
            spec = AggSpec.from_op(op)
            kvids = tuple(gv(op.in_list, c) for c in spec.key_cols(op))
            live = fact.get(op.in_list, _NO_FACTS)
            if kvids in live and all(_usable(v) for v in kvids):
                redundant.append(i)
                diags.append(Diagnostic(
                    "PL201", "info",
                    "redundant exchange: input is already hash-partitioned "
                    f"on {list(spec.key_names)} by stable_key_hash — the "
                    "AGG shuffle is the identity permutation and is elided",
                    op_path(i, op)))
            for kname, kv in zip(spec.key_names, kvids):
                vid[(op.out, kname)] = kv
            for name in spec.out_names:
                vid[(op.out, name)] = ("agg", i, name)
            # the exchange leaves (or elision keeps) every group on the
            # rank its key hashes to: the output carries the fact
            fact[op.out] = (frozenset({kvids})
                            if all(_usable(v) for v in kvids)
                            else _NO_FACTS)
        elif op.op == "TOPK":
            for c in op.out_cols:
                vid[(op.out, c)] = ("topk", i, c)
            fact[op.out] = _NO_FACTS  # global gather to one rank
        elif op.op == "OUTPUT":
            fact[op.out] = fact.get(op.in_list, _NO_FACTS)

    return PartitioningResult(tuple(redundant), diags, fact, join_elide)
