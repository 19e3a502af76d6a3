"""The paged KV cache (port of ``repro.objectmodel.kvcache``).

Pages are fixed-size allocation blocks of a device pool, recycled through
per-shard free lists (never compacted). The host allocator
(``KVPageManager``) is numpy and plain Python. The device side holds the
two layouts:

* ``dense``: ``(L, B, S_max, Kv, Hd)`` contiguous per sequence;
* ``paged``: a pool ``(L, P, page, Kv, Hd)`` plus per-shard block tables
  ``(shards, B, slots)`` of local page ids, -1 a hole; entry j of shard s
  holds a sequence's (j * shards + s)-th page. ``global_page_tables``
  turns them into the ``(B, slots * shards)`` global ids the
  paged-attention kernel follows.

The appends update the tensors in place (JAX returns new arrays) and
return the state with ``length + 1``. A write with nowhere to go is
dropped: past the end of a dense cache, or to a page id below 0 (an idle
serving slot, or a sequence past its pages).

A rank of a pool split over the sequence holds one shard: its sub-pool,
its row of the tables and, per entry, the sequence page the entry holds
(``KVPageManager.build_page_map``; round-robin, entry j of shard s holds
page j * shards + s, unless a page was stolen from another shard). Its
valid positions per row (``shard_lengths``) come from the pages it holds,
and it writes a token only where the tail page's global id names its
shard (``shard_tail``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["KVCacheConfig", "DenseKVCache", "PagedKVState", "KVPageManager",
           "PagedWrite", "init_dense_cache", "init_paged_state",
           "dense_append", "paged_append", "gather_paged_kv",
           "global_page_tables", "plan_paged_write", "tail_pages",
           "shard_lengths", "shard_tail", "write_paged", "write_token"]


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


class DenseKVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, Kv, Hd)
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32: tokens currently cached


class PagedKVState(NamedTuple):
    k_pages: torch.Tensor  # (L, P, page, Kv, Hd)
    v_pages: torch.Tensor
    # Per-shard tables: (shards, B, pages_per_seq_per_shard) LOCAL page ids,
    # -1 = hole. Entry j of shard s holds the sequence's (j*shards+s)-th page.
    block_tables: torch.Tensor
    length: torch.Tensor  # (B,) int32


def _dtype(cfg: KVCacheConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_dense_cache(cfg: KVCacheConfig, batch: int,
                     device=None) -> DenseKVCache:
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads,
             cfg.head_dim)
    return DenseKVCache(
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def init_paged_state(cfg: KVCacheConfig, batch: int,
                     device=None) -> PagedKVState:
    if cfg.num_pages <= 0:
        raise ValueError("the paged layout needs num_pages > 0")
    shape = (cfg.n_layers, cfg.num_pages, cfg.page_size, cfg.n_kv_heads,
             cfg.head_dim)
    shards = max(1, cfg.num_shards)
    slots = -(-cfg.pages_per_seq // shards)
    return PagedKVState(
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
        torch.full((shards, batch, slots), -1, dtype=torch.int32,
                   device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


# ---------------------------------------------------------------- appends
def write_token(cache: torch.Tensor, new: torch.Tensor,
                length: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> None:
    """cache[b, length[b]] = new[b] in place, for every b with
    0 <= length[b] < Smax (and ``keep[b]`` where given). Rows at or past
    the end are dropped, as JAX drops an out-of-range scatter: an idle
    serving slot keeps counting past Smax. cache: (B, Smax, ...); new:
    (B, ...)."""
    B, Smax = cache.shape[:2]
    b_idx = torch.arange(B, device=cache.device)
    pos = length.long().clamp(min=0, max=Smax - 1)
    ok = (length >= 0) & (length < Smax)
    if keep is not None:
        ok = ok & keep
    keep = ok.view(B, *([1] * (new.dim() - 1)))
    cache[b_idx, pos] = torch.where(keep, new.to(cache.dtype),
                                    cache[b_idx, pos])


def dense_append(cache: DenseKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> DenseKVCache:
    """Write one token per sequence at position ``length`` of every layer,
    in place. k_new/v_new: (L, B, Kv, Hd)."""
    for layer in range(k_new.shape[0]):
        write_token(cache.k[layer], k_new[layer], cache.length)
        write_token(cache.v[layer], v_new[layer], cache.length)
    return cache._replace(length=cache.length + 1)


class PagedWrite(NamedTuple):
    """Where one decode step writes each sequence's new token in a pool
    layer: row b goes to ``(page[b], slot[b])`` and carries the token of
    row ``src[b]``. A dropped row (page id below 0) is sent to the target
    of the first kept row with that row's token, so that no two rows write
    different values to one place in one scatter; with no kept row
    (``any_kept`` false) every row writes back what is there."""
    page: torch.Tensor  # (B,) int64
    slot: torch.Tensor  # (B,) int64
    src: torch.Tensor  # (B,) int64
    any_kept: torch.Tensor  # () bool


def plan_paged_write(physical_page: torch.Tensor, length: torch.Tensor,
                     page_size: int) -> PagedWrite:
    """The scatter of one step's tokens: sequence b writes position
    ``length[b]`` into slot ``length[b] % page_size`` of page
    ``physical_page[b]`` (its tail page, resolved on the host), or
    nowhere when that id is below 0. No host sync."""
    kept = physical_page >= 0
    first = kept.int().argmax()  # the first kept row (0 when none)
    slot = length.long() % page_size
    rows = torch.arange(kept.shape[0], device=kept.device)
    return PagedWrite(
        page=torch.where(kept, physical_page, physical_page[first]).long()
        .clamp(min=0),
        slot=torch.where(kept, slot, slot[first]),
        src=torch.where(kept, rows, first),
        any_kept=kept.any())


def write_paged(pages: torch.Tensor, new: torch.Tensor,
                plan: PagedWrite) -> None:
    """One pool layer's write, in place. pages: (P, page, Kv, Hd); new:
    (B, Kv, Hd)."""
    old = pages[plan.page, plan.slot]
    pages[plan.page, plan.slot] = torch.where(
        plan.any_kept, new[plan.src].to(pages.dtype), old)


def paged_append(state: PagedKVState, k_new: torch.Tensor,
                 v_new: torch.Tensor,
                 physical_page: torch.Tensor) -> PagedKVState:
    """Write one token per sequence into its current page, in every layer.

    ``physical_page``: (B,) int32 global page id of each sequence's tail page
    (resolved by the host page manager; below 0: the write is dropped).
    k_new/v_new: (L, B, Kv, Hd)."""
    plan = plan_paged_write(physical_page, state.length,
                            state.k_pages.shape[2])
    for layer in range(k_new.shape[0]):
        write_paged(state.k_pages[layer], k_new[layer], plan)
        write_paged(state.v_pages[layer], v_new[layer], plan)
    return state._replace(length=state.length + 1)


def global_page_tables(block_tables: torch.Tensor,
                       pages_per_shard: int) -> torch.Tensor:
    """(shards, B, slots) local ids -> (B, slots * shards) int32 global
    ids, -1 kept for a hole: entry ``j * shards + s`` is
    ``s * pages_per_shard + local`` of shard s's entry j."""
    shards, B, slots = block_tables.shape
    offset = (torch.arange(shards, dtype=torch.int32,
                           device=block_tables.device)
              * pages_per_shard).view(shards, 1, 1)
    glob = torch.where(block_tables >= 0, block_tables + offset,
                       torch.full_like(block_tables, -1))
    return glob.permute(1, 2, 0).reshape(B, slots * shards).contiguous()


def tail_pages(tables: torch.Tensor, length: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """(B,) int32 global id of the page that holds position ``length[b]``
    of each sequence, from its (B, max_pages) global table: -1 for a hole
    or past the table's end (where ``KVPageManager.tail_physical_page``
    clamps to the last page, the device drops the write). No host sync."""
    idx = (length // page_size).long()
    inside = idx < tables.shape[1]
    page = tables.gather(1, idx.clamp(max=tables.shape[1] - 1)[:, None])
    return torch.where(inside, page[:, 0], torch.full_like(page[:, 0], -1))


def shard_lengths(tables: torch.Tensor, seq_pages: torch.Tensor,
                  lengths: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B,) int32 valid positions of each row of a shard's local table
    (B, slots), given the sequence page each entry holds (``seq_pages``,
    -1 none) and the sequences' lengths: the end of the last entry that
    holds a token, ``j * page_size`` plus its tokens. A shard holds a
    sequence's pages in increasing order, and every page before the one
    that holds the last token is full, so the valid positions of a local
    row are a prefix of it (holes apart, which the kernel skips). No host
    sync."""
    held = torch.where(seq_pages >= 0, (
        lengths.long()[:, None] - seq_pages.long() * page_size).clamp(
            min=0, max=page_size), 0)  # each entry's tokens
    ends = torch.arange(tables.shape[1], device=tables.device) * page_size
    return torch.where(held > 0, ends + held, 0).amax(1).to(torch.int32)


def shard_tail(tables: torch.Tensor, seq_pages: torch.Tensor,
               lengths: torch.Tensor, page_size: int,
               first_page: int) -> torch.Tensor:
    """(B,) int32 global id of the page that takes position ``lengths[b]``
    where this shard holds it (``first_page``, the shard's first global
    id, plus the local id), else -1: only that shard writes the token. No
    host sync."""
    want = (lengths.long() // page_size)[:, None]
    hit = (seq_pages.long() == want) & (seq_pages >= 0) & (tables >= 0)
    local = tables.gather(1, hit.int().argmax(1, keepdim=True))[:, 0]
    return torch.where(hit.any(1), local + first_page,
                       torch.full_like(local, -1))


def gather_paged_kv(state: PagedKVState, cfg: KVCacheConfig, seq: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reassemble sequence ``seq``'s K/V from its pages (a hole reads as
    zeros). Returns an (L, S, Kv, Hd) pair, S = its length."""
    tables = global_page_tables(state.block_tables, cfg.pages_per_shard)[seq]
    held = (tables >= 0).view(1, -1, 1, 1, 1)
    ids = tables.long().clamp(min=0)
    n = int(state.length[seq])
    out = []
    for pool in (state.k_pages, state.v_pages):
        pages = torch.where(held, pool[:, ids], torch.zeros_like(pool[:, ids]))
        out.append(pages.flatten(1, 2)[:, :n])
    return out[0], out[1]


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
        return self._tables(batch_seqs)[0]

    def build_page_map(self, batch_seqs: List[int]) -> np.ndarray:
        """(shards, B, slots) int32: the sequence page (its place in the
        sequence, from 0) that each entry of ``build_tables`` holds, -1 for
        none; a shard's entries in increasing page order. Round-robin, entry
        j of shard s holds page j * shards + s; a page stolen from another
        shard sits where its shard's next entry is."""
        return self._tables(batch_seqs)[1]

    def _tables(self, batch_seqs: List[int]) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        cfg = self.cfg
        shards = max(1, cfg.num_shards)
        slots = -(-cfg.pages_per_seq // shards)
        t = np.full((shards, len(batch_seqs), slots), -1, np.int32)
        k = np.full_like(t, -1)
        for b, seq in enumerate(batch_seqs):
            counters = [0] * shards
            for i, (s, local) in enumerate(self.owned.get(seq, [])):
                t[s, b, counters[s]] = local
                k[s, b, counters[s]] = i
                counters[s] += 1
        return t, k
