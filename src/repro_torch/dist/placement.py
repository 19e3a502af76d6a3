"""Partition placement: which pages of which stored sets each worker owns.

Pages are placed greedily by byte load (each page, in storage order, to the
currently least-loaded worker — :func:`repro_torch.core.relops
.greedy_page_placement`), which degenerates to the old round-robin for
equal-size pages and keeps loads balanced under skew (``worker_stats``
exposed the imbalance; this closes the ROADMAP follow-up). The local
simulated executor partitions its scans with the *same* helper, so worker
``w``'s shard holds the same pages, in the same order, as local partition
``w`` — byte-identical results stay a structural property. Placement is
the *only* thing this module decides; the shard build shares the driver's
page objects by reference (zero-copy in-process, copy-on-write across a
fork), honoring the paper's zero-cost-movement story: a page is the unit
of ownership, never rows.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.relops import greedy_page_placement
from repro_torch.core.tcap import TCAPProgram
from repro_torch.objectmodel.store import PagedSet, PagedStore

__all__ = ["place_scans", "build_shard_store"]


def place_scans(prog: TCAPProgram, store: PagedStore, num_workers: int
                ) -> Dict[str, List[List[int]]]:
    """set name -> per-worker list of owned page indices (greedy
    least-loaded-by-bytes, ties to the lowest rank)."""
    placement: Dict[str, List[List[int]]] = {}
    for op in prog.ops:
        if op.op != "SCAN":
            continue
        name = op.info["set"]
        if name in placement:
            continue
        s = store.get_set(name)
        dest = greedy_page_placement(
            [c * s.dtype.itemsize for c in s.counts], num_workers)
        placement[name] = [[i for i, d in enumerate(dest) if d == w]
                           for w in range(num_workers)]
    return placement


def build_shard_store(store: PagedStore,
                      placement: Dict[str, List[List[int]]],
                      rank: int) -> PagedStore:
    """Worker ``rank``'s own PagedStore: one shard PagedSet per scanned set,
    holding (references to) the worker's pages only."""
    shard = PagedStore(page_size=store.page_size)
    for name, per_worker in placement.items():
        src = store.get_set(name)
        s = PagedSet(name, src.dtype, src.page_size)
        s.pages = [src.pages[i] for i in per_worker[rank]]
        s.counts = [src.counts[i] for i in per_worker[rank]]
        shard.sets[name] = s
    return shard
