"""PlinyCompute's lambda calculus (paper §4).

A programmer does not write computations over data — they write *lambda term
construction functions* that build an expression tree describing the
computation. The built-in abstraction families are reproduced faithfully:

* :func:`make_lambda_from_member`  — attribute access on a record column
* :func:`make_lambda_from_method`  — registered vectorized "method" call
* :func:`make_lambda`              — opaque native function (the engine
  cannot optimize through it, exactly as in the paper)
* :func:`make_lambda_from_self`    — identity

Higher-order composition is via operator overloading on :class:`LambdaTerm`
(``==``, ``>``, ``&``, ``|``, ``~``, ``+``, ``-``, ``*`` …), each returning a
new term. Terms carry enough metadata (the TCAP key-value map) for the
rule-based optimizer to reason about them.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "LambdaArg", "TypedLambdaArg", "LambdaTerm", "UnknownColumnError",
    "make_lambda_from_member", "make_lambda_from_method", "make_lambda",
    "make_lambda_from_self", "constant", "register_method",
    "METHOD_REGISTRY",
]

_ids = itertools.count(1)

# (type_name, method_name) -> vectorized callable(column)->column.
# This is the template-metaprogramming analogue: each registered method IS the
# compiled pipeline stage for that type (paper §5.3).
METHOD_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register_method(type_name: str, method_name: str):
    """Register a vectorized method for a type (the catalog's .so shipping).

    The callable must be *elementwise*: row i of its output may depend only
    on row i of its input. The stage compiler relies on this to fuse method
    calls across deferred filters (values of surviving rows must not change
    when computed over a superset of rows); whole-column behavior belongs
    in an opaque :func:`make_lambda` native, which the engine never fuses
    across a filter.
    """
    def deco(fn):
        METHOD_REGISTRY[(type_name, method_name)] = fn
        return fn
    return deco


class UnknownColumnError(AttributeError):
    """A typed dataset was asked for a column its schema does not declare.

    Raised at graph-build time (while the lambda term tree is being
    constructed), naming the schema and its fields — instead of a late
    KeyError deep inside a kernel."""

    def __init__(self, attr: str, schema):
        self.attr = attr
        self.schema = schema
        fields = ", ".join(schema.fields) if schema is not None else "?"
        super().__init__(
            f"unknown column {attr!r} on typed records "
            f"{getattr(schema, 'type_name', '?')!r} — schema fields are: "
            f"[{fields}]")


class LambdaArg:
    """A placeholder for one input set of a Computation (``Handle<T> arg``).

    Internals live under underscore names (``_slot``/``_type_name``/
    ``_name``) with public property mirrors, so :class:`TypedLambdaArg`
    can resolve *every* non-underscore attribute against its schema without
    the engine tripping over its own accessors.
    """

    def __init__(self, slot: int, type_name: str, name: Optional[str] = None):
        self._slot = slot
        self._type_name = type_name
        self._name = name or f"in{slot}"

    slot = property(lambda self: self._slot)
    type_name = property(lambda self: self._type_name)
    name = property(lambda self: self._name)

    def term(self) -> "LambdaTerm":
        return LambdaTerm("self", [], {"slot": self._slot,
                                       "type": self._type_name},
                          args=(self,))

    def col(self, attr: str) -> "LambdaTerm":
        """Explicit column access: ``arg.col("name")``.

        Unlike the ``arg.<attr>`` sugar, this works for record fields
        shadowed by :class:`LambdaArg`'s real attributes — see
        :meth:`__getattr__`."""
        return make_lambda_from_member(self, attr)

    def __getattr__(self, attr: str) -> "LambdaTerm":
        """``arg.salary`` sugar for :func:`make_lambda_from_member`.

        Footgun (untyped args only): this only fires for attributes Python
        does NOT find on the object, so record fields named after a real
        LambdaArg attribute or method — ``name``, ``slot``, ``type_name``,
        ``term``, ``col`` — resolve to that attribute instead of a column
        access. Use :meth:`col` (``arg.col("name")``) or
        :func:`make_lambda_from_member` for those columns. Typed datasets
        (loaded with a :class:`~repro_torch.objectmodel.schema.Record` schema)
        don't have this problem: schema fields always win."""
        if attr.startswith("_"):
            raise AttributeError(attr)
        return make_lambda_from_member(self, attr)


class TypedLambdaArg(LambdaArg):
    """A lambda argument whose members resolve against a declared schema.

    ``arg.<field>`` is a column access for every schema field — including
    names that shadow LambdaArg attributes (``name``, ``slot``, ...), which
    kills the ``__getattr__`` footgun — and any non-field access raises
    :class:`UnknownColumnError` at graph-build time with the schema's
    fields in the message. That includes LambdaArg's own accessors
    (``name``/``slot``/``type_name``): on a typed arg every public
    attribute is a column, full stop — only :meth:`col` and :meth:`term`
    stay callable (the engine reaches internals through underscore names).
    """

    _PUBLIC_API = frozenset({"col", "term"})

    def __init__(self, slot: int, schema, name: Optional[str] = None):
        super().__init__(slot, schema.type_name, name)
        self._schema = schema

    def __getattribute__(self, attr: str):
        if not attr.startswith("_"):
            schema = object.__getattribute__(self, "__dict__").get("_schema")
            if schema is not None:
                if attr in schema.field_set:
                    return make_lambda_from_member(self, attr)
                if attr not in TypedLambdaArg._PUBLIC_API:
                    raise UnknownColumnError(attr, schema)
        return object.__getattribute__(self, attr)

    def __getattr__(self, attr: str):
        if attr.startswith("_"):
            raise AttributeError(attr)
        raise UnknownColumnError(attr, self.__dict__.get("_schema"))

    def col(self, attr: str) -> "LambdaTerm":
        """Explicit (validated) column access; equivalent to ``arg.<attr>``
        for typed args, kept for untyped-code compatibility."""
        return make_lambda_from_member(self, attr)


class LambdaTerm:
    """A node in the lambda-calculus expression tree."""

    def __init__(self, kind: str, inputs: List["LambdaTerm"], info: Dict[str, Any],
                 args: Tuple[LambdaArg, ...] = ()):
        self.kind = kind  # attAccess|methodCall|native|self|cmp|bool|arith|const
        self.inputs = inputs
        self.info = dict(info)
        self.uid = next(_ids)
        argset: List[LambdaArg] = list(args)
        for t in inputs:
            for a in t.args:
                if a not in argset:
                    argset.append(a)
        self.args: Tuple[LambdaArg, ...] = tuple(argset)

    # ------------------------------------------------------- composition
    def _binary(self, other, kind: str, op: str) -> "LambdaTerm":
        if not isinstance(other, LambdaTerm):
            other = constant(other)
        return LambdaTerm(kind, [self, other], {"op": op})

    # comparisons
    def __eq__(self, other):  # type: ignore[override]
        return self._binary(other, "cmp", "==")

    def __ne__(self, other):  # type: ignore[override]
        return self._binary(other, "cmp", "!=")

    def __gt__(self, other):
        return self._binary(other, "cmp", ">")

    def __ge__(self, other):
        return self._binary(other, "cmp", ">=")

    def __lt__(self, other):
        return self._binary(other, "cmp", "<")

    def __le__(self, other):
        return self._binary(other, "cmp", "<=")

    # booleans
    def __and__(self, other):
        return self._binary(other, "bool", "&&")

    def __or__(self, other):
        return self._binary(other, "bool", "||")

    def __invert__(self):
        return LambdaTerm("bool", [self], {"op": "!"})

    # arithmetic (reflected forms lift the python scalar to a constant
    # term, so e.g. ``1 - l.discount`` builds the same tree shape as
    # ``constant(1) - l.discount``)
    def __add__(self, other):
        return self._binary(other, "arith", "+")

    def __radd__(self, other):
        return constant(other)._binary(self, "arith", "+")

    def __sub__(self, other):
        return self._binary(other, "arith", "-")

    def __rsub__(self, other):
        return constant(other)._binary(self, "arith", "-")

    def __mul__(self, other):
        return self._binary(other, "arith", "*")

    def __rmul__(self, other):
        return constant(other)._binary(self, "arith", "*")

    def __truediv__(self, other):
        return self._binary(other, "arith", "/")

    def __rtruediv__(self, other):
        return constant(other)._binary(self, "arith", "/")

    __hash__ = object.__hash__  # __eq__ is overloaded; identity hashing

    # --------------------------------------------------------- metadata
    @property
    def depends_on_slots(self) -> Tuple[int, ...]:
        return tuple(sorted({a._slot for a in self.args}))

    def structural_key(self) -> Tuple:
        """Key for CSE: two terms with equal keys compute the same value
        (methodCalls are purely functional by the paper's contract)."""
        return (self.kind, tuple(sorted(self.info.items())
                                 if self.kind != "native" else [("uid", self.uid)]),
                tuple(i.structural_key() for i in self.inputs))

    def __repr__(self):
        return f"λ[{self.kind}:{self.info.get('op') or self.info.get('attName') or self.info.get('methodName') or ''}]"

    # -------------------------------------------------------- evaluation
    def evaluate(self, columns: Dict[int, Any]):
        """Vectorized evaluation against one column per input slot.

        The executor normally evaluates APPLY-by-APPLY; this direct evaluator
        is the semantics oracle used by the optimizer-equivalence tests.
        """
        return _eval(self, columns)


def _eval(t: LambdaTerm, columns: Dict[int, Any]):
    if t.kind == "self":
        return columns[t.info["slot"]]
    if t.kind == "const":
        return t.info["value"]
    if t.kind == "attAccess":
        rec = _eval(t.inputs[0], columns)
        return rec[t.info["attName"]]
    if t.kind == "methodCall":
        rec = _eval(t.inputs[0], columns)
        fn = METHOD_REGISTRY[(t.info["onType"], t.info["methodName"])]
        return fn(rec)
    if t.kind == "native":
        vals = [_eval(i, columns) for i in t.inputs]
        return t.info["fn"](*vals)
    if t.kind in ("cmp", "bool", "arith"):
        op = t.info["op"]
        if op == "!":
            return np.logical_not(_eval(t.inputs[0], columns))
        a, b = (_eval(i, columns) for i in t.inputs)
        return _APPLY_BINOP[op](a, b)
    raise ValueError(f"unknown lambda kind {t.kind}")


_APPLY_BINOP = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "&&": np.logical_and,
    "||": np.logical_or,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}


# ------------------------------------------------------------- factories
# NOTE: factories reach LambdaArg internals via underscore attributes and
# unbound class methods (``LambdaArg.term(arg)``) so that schema fields on a
# TypedLambdaArg can shadow every public accessor without breaking them.
def make_lambda_from_member(arg: LambdaArg, attr: str) -> LambdaTerm:
    schema = arg.__dict__.get("_schema")
    if schema is not None and attr not in schema.field_set:
        raise UnknownColumnError(attr, schema)
    return LambdaTerm("attAccess", [LambdaArg.term(arg)],
                      {"attName": attr, "onType": arg._type_name})


def make_lambda_from_method(arg: LambdaArg, method: str) -> LambdaTerm:
    if (arg._type_name, method) not in METHOD_REGISTRY:
        raise KeyError(f"method {method!r} not registered for type "
                       f"{arg._type_name!r} (register_method first — this "
                       "is the catalog's .so registration)")
    return LambdaTerm("methodCall", [LambdaArg.term(arg)],
                      {"methodName": method, "onType": arg._type_name})


def make_lambda(args: Sequence[LambdaArg] | LambdaArg, fn: Callable,
                name: str = "native") -> LambdaTerm:
    """Opaque native lambda — the engine cannot see inside (paper §4)."""
    if isinstance(args, LambdaArg):
        args = [args]
    return LambdaTerm("native", [LambdaArg.term(a) for a in args],
                      {"fn": fn, "name": name})


def make_lambda_from_self(arg: LambdaArg) -> LambdaTerm:
    return LambdaArg.term(arg)


def constant(value) -> LambdaTerm:
    return LambdaTerm("const", [], {"value": value})
