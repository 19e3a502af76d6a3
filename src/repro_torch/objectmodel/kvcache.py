"""Host allocator of the paged KV cache (port of
``repro.objectmodel.kvcache``: ``KVCacheConfig`` and ``KVPageManager``).

Pages are fixed-size allocation blocks of a device pool, recycled through
per-shard free lists (never compacted). The allocator is numpy and plain
Python. The device side (``init_paged_state``, ``paged_append``,
``gather_paged_kv``) waits for the paged-attention slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["KVCacheConfig", "KVPageManager"]


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    max_seq_len: int
    page_size: int = 128  # tokens per KV page
    num_pages: int = 0  # paged layout pool size (global)
    num_shards: int = 1  # model-axis shards owning page sub-pools
    dtype: str = "bfloat16"

    @property
    def pages_per_seq(self) -> int:
        return (self.max_seq_len + self.page_size - 1) // self.page_size

    @property
    def pages_per_shard(self) -> int:
        if self.num_pages % max(1, self.num_shards):
            raise ValueError(f"{self.num_pages} pages do not split over "
                             f"{self.num_shards} shards")
        return self.num_pages // max(1, self.num_shards)


class KVPageManager:
    """Host allocator for the device page pool (the buffer-pool manager).

    Pages are placed round-robin across shards so each sequence's pages are
    spread evenly. Freed pages go on per-shard free lists (the recycling
    policy)."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        n = max(1, cfg.num_shards)
        self.free: List[List[int]] = [
            list(range(cfg.pages_per_shard))[::-1] for _ in range(n)]
        self.owned: Dict[int, List[Tuple[int, int]]] = {}  # seq -> [(shard, local)]
        self.written: Dict[int, int] = {}  # seq -> tokens written so far
        self.next_shard: Dict[int, int] = {}

    def pages_in_use(self) -> int:
        return sum(len(v) for v in self.owned.values())

    def allocate(self, seq: int, n_tokens: int) -> List[Tuple[int, int, int]]:
        """Reserve capacity for `n_tokens` MORE tokens beyond those written;
        returns new (shard, local_id, slot_index) placements."""
        cur = self.owned.setdefault(seq, [])
        written = self.written.setdefault(seq, 0)
        need_pages = -(-(written + n_tokens) // self.cfg.page_size) - len(cur)
        placed = []
        shard = self.next_shard.get(seq, 0)
        for _ in range(max(0, need_pages)):
            if not self.free[shard % len(self.free)]:
                # steal from the least-loaded shard (straggler mitigation)
                candidates = sorted(range(len(self.free)),
                                    key=lambda s: -len(self.free[s]))
                if not self.free[candidates[0]]:
                    raise MemoryError("KV page pool exhausted")
                shard = candidates[0]
            s = shard % len(self.free)
            local = self.free[s].pop()
            slot_index = sum(1 for (ps, _) in cur if ps == s)
            cur.append((s, local))
            placed.append((s, local, slot_index))
            shard += 1
        self.next_shard[seq] = shard
        return placed

    def advance(self, seq: int, n: int = 1) -> None:
        """Record that `n` tokens were appended to `seq`'s pages."""
        self.written[seq] = self.written.get(seq, 0) + n

    def tail_physical_page(self, seq: int) -> int:
        """Global page id receiving `seq`'s NEXT token (Handle resolution)."""
        idx = self.written.get(seq, 0) // self.cfg.page_size
        idx = min(idx, len(self.owned[seq]) - 1)
        s, local = self.owned[seq][idx]
        return s * self.cfg.pages_per_shard + local

    def release(self, seq: int) -> int:
        """Sequence finished: recycle all its pages; returns count."""
        pages = self.owned.pop(seq, [])
        for s, local in pages:
            self.free[s].append(local)
        self.next_shard.pop(seq, None)
        self.written.pop(seq, None)
        return len(pages)

    def build_tables(self, batch_seqs: List[int]) -> np.ndarray:
        """(shards, B, slots) local-id tables for the device."""
        cfg = self.cfg
        shards = max(1, cfg.num_shards)
        slots = -(-cfg.pages_per_seq // shards)
        t = np.full((shards, len(batch_seqs), slots), -1, np.int32)
        for b, seq in enumerate(batch_seqs):
            counters = [0] * shards
            for (s, local) in self.owned.get(seq, []):
                t[s, b, counters[s]] = local
                counters[s] += 1
        return t
