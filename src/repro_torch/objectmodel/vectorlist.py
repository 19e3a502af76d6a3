"""Vector lists — the unit of vectorized execution (paper §5.2).

A :class:`VectorList` is an ordered set of named, equal-length columns
(numpy on host, jax.Array inside jitted stages). Pipeline stages consume a
vector list and emit a new one that *shallow-copies* surviving columns and
appends freshly computed ones — exactly the paper's TCAP ``APPLY`` contract.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["VectorList"]


class VectorList:
    def __init__(self, columns: Mapping[str, np.ndarray] | None = None):
        self._cols: Dict[str, np.ndarray] = {}
        if columns:
            for k, v in columns.items():
                self.append(k, v)

    # ------------------------------------------------------------ basics
    def append(self, name: str, col) -> "VectorList":
        n = self.num_rows
        ln = col.shape[0] if hasattr(col, "shape") else len(col)
        if n is not None and ln != n:
            raise ValueError(
                f"column {name!r} has {ln} rows, vector list has {n}")
        self._cols[name] = col
        return self

    @property
    def num_rows(self):
        for v in self._cols.values():
            return v.shape[0] if hasattr(v, "shape") else len(v)
        return None

    @property
    def names(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str):
        return self._cols[name]

    def __len__(self) -> int:
        return len(self._cols)

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        return iter(self._cols.items())

    # --------------------------------------------------------- TCAP ops
    def project(self, names: Sequence[str]) -> "VectorList":
        """Shallow-copy the named columns into a new vector list."""
        out = VectorList()
        for n in names:
            out._cols[n] = self._cols[n]  # shallow — no data movement
        return out

    def extended(self, keep: Sequence[str], new_name: str, new_col) -> "VectorList":
        """The APPLY contract: keep columns (shallow) + append one new column."""
        out = self.project(keep)
        out.append(new_name, new_col)
        return out

    def filtered(self, mask, keep: Sequence[str]) -> "VectorList":
        """The FILTER contract: row-select the kept columns by a bool vector."""
        out = VectorList()
        for n in keep:
            out._cols[n] = self._cols[n][mask]
        return out

    def concat(self, other: "VectorList") -> "VectorList":
        out = VectorList()
        for n in self.names:
            out._cols[n] = np.concatenate([self._cols[n], other._cols[n]])
        return out

    def __repr__(self) -> str:
        cols = ", ".join(f"{k}:{tuple(v.shape) if hasattr(v,'shape') else len(v)}"
                         for k, v in self._cols.items())
        return f"VectorList({cols})"
