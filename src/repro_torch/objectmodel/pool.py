"""Buffer pool with pinning, LRU eviction, and zombie-page tracking
(paper §2, Appendix C).

Page lifetimes during pipelined execution:

* **input pages** — pinned while any vector list derived from them is in
  flight;
* the **live output page** — the active allocation block;
* **zombie output pages** — full pages holding output *and* intermediate
  data: cannot be flushed until the in-flight vector list drains (≤2 per
  pipeline, as proven in the paper);
* **zombie pages** — intermediate-only; flushed (dropped) when the vector
  list completes, never written back.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

from repro_torch.objectmodel.page import AllocPolicy, Page

__all__ = ["BufferPool", "PageState"]


class PageState:
    INPUT = "input"
    LIVE_OUTPUT = "live_output"
    ZOMBIE_OUTPUT = "zombie_output"  # output + intermediate: pinned, write back later
    ZOMBIE = "zombie"  # intermediate only: pinned, never written back
    CACHED = "cached"  # clean, evictable
    FREE = "free"


class BufferPool:
    """Fixed-frame buffer pool; eviction spills via a user callback."""

    def __init__(self, num_frames: int, page_size: int,
                 spill: Optional[Callable[[Page], None]] = None,
                 fetch: Optional[Callable[[int], Page]] = None):
        self.num_frames = num_frames
        self.page_size = page_size
        self._spill = spill
        self._fetch = fetch
        self._pages: Dict[int, Page] = {}
        self._state: Dict[int, str] = {}
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self._free: List[Page] = []
        self._next_id = 0
        self.evictions = 0
        self.spills = 0

    # ------------------------------------------------------------ frames
    def _frame(self) -> Page:
        if self._free:
            p = self._free.pop()
            p.reset()
            return p
        if len(self._pages) < self.num_frames:
            p = Page(self._next_id, self.page_size)
            self._next_id += 1
            return p
        victim_id = self._pick_victim()
        victim = self._pages.pop(victim_id)
        self._state.pop(victim_id)
        self._lru.pop(victim_id, None)
        self.evictions += 1
        if self._spill is not None:
            self._spill(victim)
            self.spills += 1
        victim.reset()
        victim.page_id = self._next_id
        self._next_id += 1
        return victim

    def _pick_victim(self) -> int:
        for pid in self._lru:  # oldest first
            if self._state.get(pid) == PageState.CACHED and self._pages[pid].pinned == 0:
                return pid
        raise RuntimeError(
            "buffer pool exhausted: all frames pinned "
            f"({collections.Counter(self._state.values())})")

    # -------------------------------------------------------------- API
    def get_page(self, state: str = PageState.LIVE_OUTPUT) -> Page:
        p = self._frame()
        self._pages[p.page_id] = p
        self._state[p.page_id] = state
        p.pinned = 1
        return p

    def page(self, page_id: int) -> Page:
        p = self._pages.get(page_id)
        if p is None:
            if self._fetch is None:
                raise KeyError(f"page {page_id} not resident and no fetch fn")
            p = self._fetch(page_id)  # page-in from storage (no deserialization)
            self._pages[page_id] = p
            self._state[page_id] = PageState.CACHED
            self._lru[page_id] = None
        self._lru.move_to_end(page_id, last=True) if page_id in self._lru else None
        return p

    def pin(self, page_id: int) -> Page:
        p = self.page(page_id)
        p.pinned += 1
        return p

    def unpin(self, page_id: int) -> None:
        p = self._pages[page_id]
        p.pinned = max(0, p.pinned - 1)
        if p.pinned == 0 and self._state.get(page_id) not in (
                PageState.ZOMBIE, PageState.ZOMBIE_OUTPUT):
            self._state[page_id] = PageState.CACHED
            self._lru[page_id] = None

    def mark(self, page_id: int, state: str) -> None:
        self._state[page_id] = state

    def state_of(self, page_id: int) -> str:
        return self._state[page_id]

    def flush_zombies(self) -> List[int]:
        """Vector list fully drained: zombie-output pages become writable
        output (CACHED); pure zombie pages are recycled."""
        flushed = []
        for pid, st in list(self._state.items()):
            if st == PageState.ZOMBIE_OUTPUT:
                self._state[pid] = PageState.CACHED
                self._pages[pid].pinned = 0
                self._lru[pid] = None
                flushed.append(pid)
            elif st == PageState.ZOMBIE:
                p = self._pages.pop(pid)
                self._state.pop(pid)
                self._lru.pop(pid, None)
                self._free.append(p)
                flushed.append(pid)
        return flushed

    def zombie_output_count(self) -> int:
        return sum(1 for s in self._state.values() if s == PageState.ZOMBIE_OUTPUT)

    @property
    def resident(self) -> int:
        return len(self._pages)
