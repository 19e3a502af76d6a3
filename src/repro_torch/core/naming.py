"""Session-scoped fresh-name generation.

The seed used module-global counters (``_comp_ids`` in computations.py,
``_uid`` in apps/tpch.py) for computation and set names, so two sessions in
one process shared one numbering stream and could collide on store set
names. A :class:`NameScope` is a self-contained numbering domain: each
:class:`~repro_torch.core.session.Session` owns one, so naming is deterministic
per session and independent across sessions. A process-wide default scope
backs bare ``Computation`` construction outside any session (the stable
"systems programmer" layer keeps working unchanged).
"""
from __future__ import annotations

from typing import Dict

__all__ = ["NameScope", "default_scope"]


class NameScope:
    """A per-prefix counter domain for computation ids and set names."""

    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._ids = 0

    def next_id(self) -> int:
        self._ids += 1
        return self._ids

    def fresh(self, prefix: str) -> str:
        n = self._counts.get(prefix, 0) + 1
        self._counts[prefix] = n
        return f"{prefix}_{n}"


_DEFAULT = NameScope()


def default_scope() -> NameScope:
    return _DEFAULT
