"""Page-as-a-heap allocation (paper §3, §6.4, Appendix B).

A :class:`Page` is a fixed-size contiguous buffer. All object allocation is
*in-place* on the active page via bump allocation; the occupied prefix of a
page can be moved across processes / to disk / onto a device **byte-for-byte**
with zero (de)serialization — PlinyCompute's "zero-cost data movement".

Three allocation policies (paper Appendix B):

* ``LIGHTWEIGHT_REUSE`` (default) — freed space goes into log2 size-class
  buckets and is scanned before bump-allocating fresh space.
* ``NO_REUSE`` — pure region allocation; frees are no-ops (fastest, may waste).
* ``RECYCLE`` — layered on lightweight-reuse: fixed-size objects of the same
  type are kept on a per-type free list and handed back verbatim.
"""
from __future__ import annotations

import enum
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["AllocPolicy", "Page", "PageAllocator", "OutOfPageMemory"]

DEFAULT_PAGE_SIZE = 1 << 20  # 1 MiB default allocation block (paper's example)
_ALIGN = 8


class AllocPolicy(enum.Enum):
    LIGHTWEIGHT_REUSE = "lightweight_reuse"
    NO_REUSE = "no_reuse"
    RECYCLE = "recycle"


class OutOfPageMemory(Exception):
    """Raised when the active allocation block is full (paper: the execution
    engine catches this and rolls a fresh page in)."""


def _bucket(nbytes: int) -> int:
    return max(0, int(math.ceil(math.log2(max(1, nbytes)))))


class Page:
    """A fixed-size allocation block backed by a single numpy byte buffer."""

    __slots__ = (
        "page_id",
        "size",
        "buf",
        "policy",
        "_bump",
        "_buckets",
        "_recycle",
        "live_objects",
        "refcounts",
        "pinned",
        "freed_bytes",
    )

    def __init__(self, page_id: int, size: int = DEFAULT_PAGE_SIZE,
                 policy: AllocPolicy = AllocPolicy.LIGHTWEIGHT_REUSE,
                 buf: Optional[np.ndarray] = None):
        if buf is not None and buf.nbytes != size:
            raise ValueError(f"backing buffer is {buf.nbytes} B, expected {size}")
        self.page_id = page_id
        self.size = size
        self.buf = buf if buf is not None else np.zeros(size, dtype=np.uint8)
        self.policy = policy
        self._bump = 0
        self._buckets: Dict[int, List[Tuple[int, int]]] = {}
        self._recycle: Dict[Tuple[str, int], List[int]] = {}
        self.live_objects = 0
        self.refcounts: Dict[int, int] = {}
        self.pinned = 0
        self.freed_bytes = 0

    # ------------------------------------------------------------- alloc
    def alloc(self, nbytes: int, type_key: Optional[str] = None) -> int:
        """Allocate ``nbytes`` on this page; returns the byte offset."""
        nbytes = max(1, nbytes)
        if self.policy is AllocPolicy.RECYCLE and type_key is not None:
            lst = self._recycle.get((type_key, nbytes))
            if lst:
                off = lst.pop()
                self.live_objects += 1
                self.refcounts[off] = 1
                return off
        if self.policy in (AllocPolicy.LIGHTWEIGHT_REUSE, AllocPolicy.RECYCLE):
            b = _bucket(nbytes)
            lst = self._buckets.get(b)
            if lst:
                for i, (off, sz) in enumerate(lst):
                    if sz >= nbytes:
                        lst.pop(i)
                        self.freed_bytes -= sz
                        self.live_objects += 1
                        self.refcounts[off] = 1
                        return off
        off = (self._bump + _ALIGN - 1) // _ALIGN * _ALIGN
        if off + nbytes > self.size:
            raise OutOfPageMemory(
                f"page {self.page_id}: need {nbytes} B at {off}, size {self.size}")
        self._bump = off + nbytes
        self.live_objects += 1
        self.refcounts[off] = 1
        return off

    def free(self, offset: int, nbytes: int, type_key: Optional[str] = None) -> None:
        """Deallocate (meaning depends on the page policy)."""
        if offset in self.refcounts:
            del self.refcounts[offset]
        self.live_objects = max(0, self.live_objects - 1)
        if self.policy is AllocPolicy.NO_REUSE:
            self.freed_bytes += nbytes
            return
        if self.policy is AllocPolicy.RECYCLE and type_key is not None:
            self._recycle.setdefault((type_key, nbytes), []).append(offset)
            return
        self._buckets.setdefault(_bucket(nbytes), []).append((offset, nbytes))
        self.freed_bytes += nbytes

    # ----------------------------------------------------------- refcount
    def incref(self, offset: int) -> None:
        if offset in self.refcounts:  # un-refcounted objects are skipped
            self.refcounts[offset] += 1

    def decref(self, offset: int, nbytes: int, type_key: Optional[str] = None) -> bool:
        """Returns True if the object was deallocated by this decref."""
        c = self.refcounts.get(offset)
        if c is None:
            return False
        if c <= 1:
            self.free(offset, nbytes, type_key)
            return True
        self.refcounts[offset] = c - 1
        return False

    def disable_refcount(self, offset: int) -> None:
        """ObjectPolicy::noRefCount — region semantics for this object."""
        self.refcounts.pop(offset, None)

    # --------------------------------------------------------------- view
    def view(self, offset: int, dtype: np.dtype, count: int = 1) -> np.ndarray:
        """Zero-copy typed view of page memory (the Handle dereference)."""
        dt = np.dtype(dtype)
        end = offset + dt.itemsize * count
        if end > self.size:
            raise IndexError(f"view [{offset}:{end}) outside page of {self.size} B")
        return self.buf[offset:end].view(dt)

    # ----------------------------------------------------------- movement
    def occupied_bytes(self) -> int:
        return self._bump

    def payload(self) -> np.ndarray:
        """The occupied prefix — what gets shipped, verbatim (zero-copy)."""
        return self.buf[: self._bump]

    @classmethod
    def from_payload(cls, page_id: int, payload: np.ndarray, size: int,
                     policy: AllocPolicy = AllocPolicy.LIGHTWEIGHT_REUSE) -> "Page":
        """Reconstruct a page at a receiving 'process' — no deserialization,
        the payload bytes are adopted as-is and offsets remain valid. When
        the payload already spans the full page (the wire-transfer case),
        its buffer is adopted without even a copy."""
        payload = payload.view(np.uint8)
        if payload.nbytes == size and payload.flags["C_CONTIGUOUS"]:
            buf = payload
        else:
            buf = np.zeros(size, dtype=np.uint8)
            buf[: payload.nbytes] = payload
        p = cls(page_id, size, policy, buf=buf)
        p._bump = int(payload.nbytes)
        return p

    @property
    def utilization(self) -> float:
        used = self._bump - self.freed_bytes
        return used / self.size if self.size else 0.0

    def reset(self) -> None:
        """Recycle the whole page as a fresh region (buffer-pool reuse)."""
        self._bump = 0
        self._buckets.clear()
        self._recycle.clear()
        self.refcounts.clear()
        self.live_objects = 0
        self.freed_bytes = 0


class PageAllocator:
    """Per-'thread' allocator: one *active* block plus inactive managed blocks
    (paper §6.4). ``make_block()`` is ``makeObjectAllocatorBlock()``."""

    def __init__(self, page_size: int = DEFAULT_PAGE_SIZE,
                 policy: AllocPolicy = AllocPolicy.LIGHTWEIGHT_REUSE):
        self.page_size = page_size
        self.policy = policy
        self._next_id = 0
        self.active: Optional[Page] = None
        self.inactive: Dict[int, Page] = {}
        self.reclaimed: List[int] = []  # ids of auto-deallocated blocks

    def make_block(self, size: Optional[int] = None,
                   policy: Optional[AllocPolicy] = None) -> Page:
        prev = self.active
        if prev is not None:
            if prev.live_objects > 0:
                self.inactive[prev.page_id] = prev  # becomes inactive, managed
            else:
                self.reclaimed.append(prev.page_id)
        page = Page(self._next_id, size or self.page_size, policy or self.policy)
        self._next_id += 1
        self.active = page
        return page

    def adopt(self, page: Page) -> None:
        """Register an inactive *un-managed* block (e.g. arrived off the wire)."""
        self.inactive[page.page_id] = page

    def page(self, page_id: int) -> Page:
        if self.active is not None and self.active.page_id == page_id:
            return self.active
        return self.inactive[page_id]

    def note_unreachable(self, page: Page) -> None:
        """Called when a managed block's live-object count hits zero."""
        if page.live_objects == 0 and page.page_id in self.inactive:
            del self.inactive[page.page_id]
            self.reclaimed.append(page.page_id)
