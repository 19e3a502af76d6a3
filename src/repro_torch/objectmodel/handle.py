"""Offset-based Handles and the type catalog (paper §6.2, §6.3).

A :class:`Handle` stores ``(page_id, offset, type_code)`` — never a raw
address — so it survives movement of its page across processes. The
:class:`TypeRegistry` is the catalog-manager analogue: it maps type codes to
numpy dtypes (our "vTable lookup"); *simple* types encode their byte size and
need only a memmove, mirroring the paper's type-code bit split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.objectmodel.page import Page, PageAllocator

__all__ = ["Handle", "TypeRegistry", "make_object", "make_vector", "deref",
           "NULL_HANDLE", "HANDLE_DTYPE"]

# Wire format of a Handle when embedded inside page memory: 3x int64
# (page_id, offset, type_code) — offset pointers, process-relocatable.
HANDLE_DTYPE = np.dtype([("page", np.int64), ("offset", np.int64),
                         ("code", np.int64)])

_SIMPLE_BIT = 1 << 62  # high bit marks a simple (memmove-able) type


@dataclass(frozen=True)
class Handle:
    page: int
    offset: int
    code: int

    @property
    def is_null(self) -> bool:
        return self.page < 0

    def pack(self) -> np.ndarray:
        out = np.zeros(1, dtype=HANDLE_DTYPE)
        out[0] = (self.page, self.offset, self.code)
        return out

    @classmethod
    def unpack(cls, raw: np.ndarray) -> "Handle":
        r = raw.view(HANDLE_DTYPE)[0]
        return cls(int(r["page"]), int(r["offset"]), int(r["code"]))


NULL_HANDLE = Handle(-1, -1, -1)


class TypeRegistry:
    """Catalog of object types. ``register`` ships the ".so" (here: a dtype)."""

    def __init__(self) -> None:
        self._by_name: Dict[str, int] = {}
        self._dtypes: Dict[int, np.dtype] = {}
        self._names: Dict[int, str] = {}
        self._next = 1
        self.remote_fetches = 0  # catalog round-trips (for tests/benchmarks)

    def register(self, name: str, dtype: np.dtype, simple: bool = False) -> int:
        if name in self._by_name:
            return self._by_name[name]
        dt = np.dtype(dtype)
        code = self._next | (_SIMPLE_BIT if simple else 0)
        self._next += 1
        self._by_name[name] = code
        self._dtypes[code] = dt
        self._names[code] = name
        return code

    def dtype_of(self, code: int) -> np.dtype:
        return self._dtypes[code]

    def name_of(self, code: int) -> str:
        return self._names[code]

    def is_simple(self, code: int) -> bool:
        return bool(code & _SIMPLE_BIT)

    def lookup_or_fetch(self, code: int, remote: "TypeRegistry") -> np.dtype:
        """Local vTable lookup; on miss, fetch the definition from the master
        catalog (paper §6.3's .so shipping), then cache it."""
        if code in self._dtypes:
            return self._dtypes[code]
        self.remote_fetches += 1
        dt = remote.dtype_of(code)
        self._dtypes[code] = dt
        self._names[code] = remote.name_of(code)
        return dt


GLOBAL_TYPES = TypeRegistry()


def make_object(alloc: PageAllocator, code: int, value,
                registry: TypeRegistry = GLOBAL_TYPES,
                refcounted: bool = True) -> Handle:
    """``makeObject<T>()`` — in-place allocation on the active block."""
    page = alloc.active
    if page is None:
        raise RuntimeError("no active allocation block; call make_block() first")
    dt = registry.dtype_of(code)
    off = page.alloc(dt.itemsize, type_key=registry.name_of(code))
    page.view(off, dt, 1)[0] = value
    if not refcounted:
        page.disable_refcount(off)
    return Handle(page.page_id, off, code)


def make_vector(alloc: PageAllocator, code: int, values: Sequence,
                registry: TypeRegistry = GLOBAL_TYPES) -> Tuple[Handle, int]:
    """Allocate a contiguous Vector<T> in-place; returns (handle, count)."""
    page = alloc.active
    if page is None:
        raise RuntimeError("no active allocation block")
    dt = registry.dtype_of(code)
    n = len(values)
    off = page.alloc(dt.itemsize * max(1, n))
    v = page.view(off, dt, n)
    for i, x in enumerate(values):
        v[i] = x
    return Handle(page.page_id, off, code), n


def deref(alloc: PageAllocator, h: Handle, count: int = 1,
          registry: TypeRegistry = GLOBAL_TYPES) -> np.ndarray:
    """Dereference a Handle — a zero-copy typed view into its page."""
    if h.is_null:
        raise ValueError("null Handle dereference")
    page = alloc.page(h.page)
    return page.view(h.offset, registry.dtype_of(h.code), count)


def deep_copy(alloc: PageAllocator, h: Handle, count: int = 1,
              registry: TypeRegistry = GLOBAL_TYPES) -> Handle:
    """Cross-block assignment rule (paper §6.4): assigning a Handle that would
    point outside the active block deep-copies the target into it."""
    page = alloc.active
    assert page is not None
    if h.page == page.page_id:
        page.incref(h.offset)
        return h
    src = deref(alloc, h, count, registry)
    dt = registry.dtype_of(h.code)
    off = page.alloc(dt.itemsize * max(1, count), type_key=registry.name_of(h.code))
    page.view(off, dt, count)[:] = src
    return Handle(page.page_id, off, h.code)
