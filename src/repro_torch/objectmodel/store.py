"""PagedStore — datasets as sets of pages (paper's distributed storage
manager, single-host realization with per-shard page lists).

A dataset is a named list of pages of packed records (one numpy structured
dtype per set). Scans hand out whole pages (zero-copy) which the executor
turns into vector lists. Spill/restore is a raw byte dump of the occupied
prefix — the on-disk format *is* the in-memory format.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.objectmodel.page import DEFAULT_PAGE_SIZE, AllocPolicy, Page

__all__ = ["PagedSet", "PagedStore"]


class PagedSet:
    """One stored dataset: a record dtype + the pages holding its records."""

    def __init__(self, name: str, dtype: np.dtype, page_size: int):
        self.name = name
        self.dtype = np.dtype(dtype)
        self.page_size = page_size
        self.pages: List[Page] = []
        self.counts: List[int] = []  # records per page

    @property
    def num_records(self) -> int:
        return sum(self.counts)

    def append_records(self, records: np.ndarray) -> None:
        """Pack records onto pages, filling the last partial page first."""
        records = np.ascontiguousarray(records, dtype=self.dtype)
        per_page = max(1, self.page_size // self.dtype.itemsize)
        i = 0
        while i < len(records):
            if not self.pages or self.counts[-1] >= per_page:
                self.pages.append(Page(len(self.pages), self.page_size,
                                       AllocPolicy.NO_REUSE))
                self.counts.append(0)
            page, cnt = self.pages[-1], self.counts[-1]
            take = min(per_page - cnt, len(records) - i)
            off = page.alloc(self.dtype.itemsize * take)
            page.view(off, self.dtype, take)[:] = records[i:i + take]
            self.counts[-1] += take
            i += take

    def scan(self) -> Iterator[np.ndarray]:
        """Yield each page's records as a zero-copy typed view."""
        for page, cnt in zip(self.pages, self.counts):
            yield page.view(0, self.dtype, cnt)

    def all_records(self) -> np.ndarray:
        chunks = list(self.scan())
        if not chunks:
            return np.empty(0, dtype=self.dtype)
        return np.concatenate(chunks)

    # ----------------------------------------------------- wire movement
    def to_payloads(self) -> List[Tuple[int, np.ndarray]]:
        """Spill-to-memory: each page's occupied prefix verbatim, as
        ``(record_count, payload_bytes)`` pairs. This *is* the wire format
        of the distributed exchange layer — the same byte dump
        :meth:`PagedStore.spill` writes to disk, minus the filesystem."""
        return [(cnt, page.payload())
                for page, cnt in zip(self.pages, self.counts)]

    @classmethod
    def from_payloads(cls, name: str, dtype: np.dtype,
                      payloads: Sequence[Tuple[int, np.ndarray]],
                      page_size: int = DEFAULT_PAGE_SIZE) -> "PagedSet":
        """Restore-from-memory: adopt received page bytes with no parsing
        (the counterpart of :meth:`PagedStore.restore` for wire transfers).
        Each payload buffer is adopted in place — offsets stay valid."""
        s = cls(name, dtype, page_size)
        for i, (cnt, raw) in enumerate(payloads):
            s.pages.append(Page.from_payload(i, raw, raw.nbytes,
                                             AllocPolicy.NO_REUSE))
            s.counts.append(cnt)
        return s


class PagedStore:
    """Named sets + spill-to-disk. Directory layout: <root>/<set>/<page>.bin"""

    def __init__(self, root: Optional[str] = None,
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.root = root
        self.page_size = page_size
        self.sets: Dict[str, PagedSet] = {}
        # names handed out (e.g. by Session.fresh_set_name) but not yet
        # backed by pages — shared here so sessions sharing this store
        # cannot both claim the same name before either writes.
        self.reserved_names: set = set()
        # bumped whenever catalog statistics change (sets created, records
        # appended, spills restored) — physical plans derived from these
        # statistics are cached against this counter and re-derived when it
        # moves. Direct PagedSet.append_records calls bypass it; all engine
        # writes go through send_data.
        self.stats_version = 0
        # per-set version counters (bumped with stats_version, but only
        # for the set that actually changed) — the shard catalog and the
        # warm `--serve` SETUP path key shard reuse on these, so a write
        # to one set never invalidates every other set's resident shards.
        self.set_versions: Dict[str, int] = {}

    def set_version(self, name: str) -> int:
        """The named set's change counter (0 if the set does not exist)."""
        return self.set_versions.get(name, 0)

    def _bump(self, name: str) -> None:
        self.stats_version += 1
        self.set_versions[name] = self.set_versions.get(name, 0) + 1

    def create_set(self, name: str, dtype: np.dtype,
                   page_size: Optional[int] = None) -> PagedSet:
        if name in self.sets:
            raise KeyError(f"set {name!r} exists")
        s = PagedSet(name, dtype, page_size or self.page_size)
        self.sets[name] = s
        self._bump(name)
        return s

    def get_set(self, name: str) -> PagedSet:
        return self.sets[name]

    def send_data(self, name: str, records: np.ndarray,
                  dtype: Optional[np.dtype] = None) -> PagedSet:
        """``sendData()`` — zero-pre-processing dispatch of packed records."""
        s = self.sets.get(name) or self.create_set(
            name, dtype if dtype is not None else records.dtype)
        s.append_records(records)
        self._bump(name)
        return s

    # ------------------------------------------------------------- spill
    def spill(self, name: str) -> int:
        """Write every page's occupied prefix verbatim; returns bytes written."""
        assert self.root, "store has no backing directory"
        s = self.sets[name]
        d = os.path.join(self.root, name)
        os.makedirs(d, exist_ok=True)
        total = 0
        meta = [str(s.dtype.descr if s.dtype.names else s.dtype.str)]
        for i, (page, cnt) in enumerate(zip(s.pages, s.counts)):
            payload = page.payload()
            with open(os.path.join(d, f"{i}.bin"), "wb") as f:
                f.write(payload.tobytes())
            meta.append(f"{i},{cnt},{payload.nbytes}")
            total += payload.nbytes
        with open(os.path.join(d, "META"), "w") as f:
            f.write("\n".join(meta))
        return total

    def restore(self, name: str, dtype: np.dtype) -> PagedSet:
        """Adopt spilled bytes as pages — no parsing, offsets stay valid."""
        assert self.root, "store has no backing directory"
        d = os.path.join(self.root, name)
        with open(os.path.join(d, "META")) as f:
            lines = f.read().splitlines()
        s = PagedSet(name, dtype, self.page_size)
        for line in lines[1:]:
            i, cnt, nbytes = (int(x) for x in line.split(","))
            raw = np.fromfile(os.path.join(d, f"{i}.bin"), dtype=np.uint8,
                              count=nbytes)
            s.pages.append(Page.from_payload(i, raw, self.page_size))
            s.counts.append(cnt)
        self.sets[name] = s
        self._bump(name)
        return s
