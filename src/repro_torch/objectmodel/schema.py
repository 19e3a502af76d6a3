"""Declarative typed record schemas — the "in the small" object model as a
typed front-end (paper §4, §6.3).

A :class:`Record` subclass declares a packed record layout field by field::

    class Order(Record):
        okey:  i64
        price: f64
        name:  S(16)
        parts: vector(i8, 32)

The metaclass compiles the annotations into a numpy structured dtype,
registers the type with the catalog (:data:`~repro_torch.objectmodel.handle
.GLOBAL_TYPES` — the paper's ".so shipping" analogue), and records the
class in a schema registry so the engine can resolve column accesses
against it *at graph-build time*: a typo'd field on a typed dataset raises
:class:`~repro_torch.core.lambdas.UnknownColumnError` naming the schema's fields
before anything executes, instead of failing deep inside a kernel.

The schema class is the canonical type argument everywhere a type name was
accepted before — ``session.create_set(Order)``, ``session.load(...,
Order)``, ``session.read(..., Order)``, ``ScanSet(db, set, Order)`` — and
plain string type names keep working for untyped sets.

:func:`record` builds a schema dynamically (shapes known only at runtime,
e.g. a per-dataset vector width); :func:`pair_schema` synthesizes the
record-pair schema of a join, which is what makes ``join(project=None)``
possible.
"""
from __future__ import annotations

import hashlib
import sys
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.objectmodel.handle import GLOBAL_TYPES

__all__ = [
    "Field", "Record", "RecordMeta", "record", "schema_for", "pair_schema",
    "pair_field_map", "group_schema",
    "i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64",
    "f32", "f64", "boolean", "S", "U", "vector",
]


class Field:
    """One typed field: a numpy scalar dtype plus an optional inner shape."""

    __slots__ = ("dtype", "shape")

    def __init__(self, dtype, shape: Tuple[int, ...] = ()):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)

    def descr(self):
        return (self.dtype, self.shape) if self.shape else self.dtype

    def __repr__(self):
        if self.shape:
            return f"{self.dtype.name}{list(self.shape)}"
        return self.dtype.name


i8, i16, i32, i64 = (Field(t) for t in (np.int8, np.int16, np.int32,
                                        np.int64))
u8, u16, u32, u64 = (Field(t) for t in (np.uint8, np.uint16, np.uint32,
                                        np.uint64))
f32, f64 = Field(np.float32), Field(np.float64)
boolean = Field(np.bool_)


def S(n: int) -> Field:
    """Fixed-width byte string (``S8`` etc.)."""
    return Field(f"S{int(n)}")


def U(n: int) -> Field:
    """Fixed-width unicode string."""
    return Field(f"U{int(n)}")


def vector(base: Union[Field, np.dtype, type], *shape) -> Field:
    """A shaped field: ``vector(f64, 3)`` or ``vector(i8, (4, 4))``."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    base_dt = base.dtype if isinstance(base, Field) else np.dtype(base)
    return Field(base_dt, tuple(shape))


# python scalar annotations accepted as sugar
_PY_SUGAR = {int: i64, float: f64, bool: boolean}

# type_name -> Record subclass (the schema registry; GLOBAL_TYPES holds the
# dtype side, this holds the class with field metadata)
_SCHEMAS: Dict[str, type] = {}


def _as_field(ann, owner: str, fname: str) -> Field:
    if isinstance(ann, Field):
        return ann
    if ann in _PY_SUGAR:
        return _PY_SUGAR[ann]
    try:
        return Field(ann)
    except TypeError:
        raise TypeError(
            f"{owner}.{fname}: cannot interpret annotation {ann!r} as a "
            "field type (use i64/f64/S(n)/vector(...) or a numpy dtype)")


def _resolve_annotations(ns: Mapping, module: str) -> Dict[str, object]:
    """Annotation values, evaluating postponed (string) annotations against
    the defining module's globals plus this module's field vocabulary."""
    ann = ns.get("__annotations__", {})
    out = {}
    mod_ns = getattr(sys.modules.get(module), "__dict__", {})
    for k, v in ann.items():
        if isinstance(v, str):
            v = eval(v, {**globals(), **mod_ns})  # noqa: S307 — schema DSL
        out[k] = v
    return out


class RecordMeta(type):
    def __new__(mcs, name, bases, ns, **kw):
        cls = super().__new__(mcs, name, bases, ns, **kw)
        if ns.get("_abstract", False):
            return cls
        fields: Dict[str, Field] = {}
        for fname, ann in _resolve_annotations(ns, ns.get("__module__",
                                                          "")).items():
            if fname.startswith("_"):
                raise ValueError(
                    f"{name}.{fname}: field names may not start with '_' "
                    "(reserved for the engine)")
            fields[fname] = _as_field(ann, name, fname)
        if not fields:
            raise ValueError(f"Record schema {name!r} declares no fields")
        type_name = ns.get("__type_name__") or name
        dtype = np.dtype([(f, ft.descr()) for f, ft in fields.items()])
        prior = _SCHEMAS.get(type_name)
        if prior is not None and prior.dtype != dtype:
            raise ValueError(
                f"schema {type_name!r} is already registered with a "
                f"different layout ({prior.dtype} vs {dtype})")
        cls.type_name = type_name
        cls.dtype = dtype
        cls.fields = tuple(fields)
        cls.field_set = frozenset(fields)
        cls.field_types = dict(fields)
        cls.type_code = GLOBAL_TYPES.register(type_name, dtype)
        _SCHEMAS[type_name] = cls
        return cls


class Record(metaclass=RecordMeta):
    """Base class for typed record schemas. Subclass with annotated fields;
    never instantiated — records live as packed numpy structured arrays."""

    _abstract = True
    # populated by the metaclass on concrete subclasses
    type_name: str
    dtype: np.dtype
    fields: Tuple[str, ...]
    field_set: frozenset
    field_types: Dict[str, Field]
    type_code: int

    def __init__(self):
        raise TypeError(
            f"{type(self).__name__} is a schema, not a container — build "
            f"packed records with {type(self).__name__}.empty(n) or .pack()")

    # ------------------------------------------------------- constructors
    @classmethod
    def empty(cls, n: int) -> np.ndarray:
        """``n`` zeroed packed records of this schema."""
        return np.zeros(int(n), cls.dtype)

    @classmethod
    def pack(cls, **columns) -> np.ndarray:
        """Pack named columns (one array-like per field) into records."""
        missing = cls.field_set - set(columns)
        extra = set(columns) - cls.field_set
        if missing or extra:
            raise ValueError(
                f"{cls.type_name}.pack(): "
                + (f"missing fields {sorted(missing)} " if missing else "")
                + (f"unknown fields {sorted(extra)} " if extra else "")
                + f"(schema fields: {list(cls.fields)})")
        n = len(np.asarray(columns[cls.fields[0]]))
        out = np.zeros(n, cls.dtype)
        for f in cls.fields:
            out[f] = columns[f]
        return out

    @classmethod
    def validate(cls, records: np.ndarray) -> np.ndarray:
        """Check a packed array against this schema (exact layout match)."""
        records = np.asarray(records)
        if records.dtype != cls.dtype:
            raise TypeError(
                f"records have dtype {records.dtype}, but schema "
                f"{cls.type_name!r} is {cls.dtype} — repack with "
                f"{cls.type_name}.pack(...) or fix the schema")
        return records

    @classmethod
    def describe(cls) -> str:
        body = "; ".join(f"{f}: {ft!r}" for f, ft in cls.field_types.items())
        return f"{cls.type_name}({body})"


def record(type_name: str, fields: Optional[Mapping[str, object]] = None,
           **kw_fields) -> type:
    """Build a schema dynamically: ``record("Point", x=vector(f64, dim))``.

    Re-declaring an identical layout under the same name returns the
    existing class (so helpers can call this per-use without churning the
    catalog); a conflicting layout raises.
    """
    spec = dict(fields or {}, **kw_fields)
    prior = _SCHEMAS.get(type_name)
    if prior is not None:
        candidate = np.dtype([(f, _as_field(a, type_name, f).descr())
                              for f, a in spec.items()])
        if prior.dtype == candidate:
            return prior
        raise ValueError(
            f"schema {type_name!r} is already registered with a different "
            f"layout ({prior.dtype} vs {candidate})")
    ns = {"__annotations__": dict(spec), "__module__": __name__,
          "__type_name__": type_name}
    return RecordMeta(type_name, (Record,), ns)


def schema_for(type_name) -> Optional[type]:
    """The registered schema class for a type name (or the class itself)."""
    if isinstance(type_name, type) and issubclass(type_name, Record):
        return type_name
    return _SCHEMAS.get(type_name)


def pair_field_map(left: type, right: type) -> Tuple[Tuple[str, int, str],
                                                     ...]:
    """The field mapping of ``left JOIN right`` as ``(dst, side, src)``
    triples (side 0 = left, 1 = right). Left fields keep their names; a
    right field colliding with a left one is prefixed with the right
    schema's (lowercased) type name. Single source of truth for both the
    pair dtype (:func:`pair_schema`) and the default join projection."""
    moves = [(f, 0, f) for f in left.fields]
    taken = set(left.fields)
    for f in right.fields:
        dst = f if f not in taken else f"{right.type_name.lower()}_{f}"
        if dst in taken:
            raise ValueError(
                f"pair schema {left.type_name}×{right.type_name}: cannot "
                f"disambiguate field {f!r} (both sides define "
                f"{dst!r} too) — pass an explicit project=")
        taken.add(dst)
        moves.append((dst, 1, f))
    return tuple(moves)


def group_schema(fields: Mapping[str, Field]) -> type:
    """Synthesize the record schema of a grouped-aggregation result (key
    fields followed by the named aggregate fields, in output order). The
    type name is derived deterministically from the field layout, so two
    structurally identical ``group_by().agg()`` queries share one schema
    class (``record()`` dedupes identical re-declarations) and repeated
    compilation never churns the catalog."""
    desc = ";".join(f"{n}:{f.dtype.str}{f.shape}" for n, f in fields.items())
    name = "Group_" + hashlib.md5(desc.encode()).hexdigest()[:10]
    return record(name, dict(fields))


def pair_schema(left: type, right: type) -> type:
    """The synthesized record-pair schema of ``left JOIN right`` (field
    layout per :func:`pair_field_map`) — the default ``join()``
    projection's output type."""
    sides = (left.field_types, right.field_types)
    fields = {dst: sides[side][src]
              for dst, side, src in pair_field_map(left, right)}
    return record(f"Pair_{left.type_name}_{right.type_name}", fields)
