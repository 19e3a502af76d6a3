"""Zero-copy token data pipeline on the object model (port of
``repro.data.pipeline``, the same code over the port's object model).

Token batches live on fixed-size pages as packed ``(tokens[seq+1], len)``
records (structure-of-arrays per page). A batch is a gather from the
pages' views into one host buffer, which the train loop hands to the
device as it is: no per-batch pickling or Python-object traversal (PC's
zero-cost data movement). Prefetching runs on a producer thread (the
live/zombie output page pattern), and sharded loading assigns pages to
data-parallel hosts round-robin with deterministic recovery offsets for
fault-tolerant restart. A consumer that leaves an iteration early
(``close()`` on it, as the train loop does when it restores a checkpoint)
stops its producer thread.
"""
from __future__ import annotations

import dataclasses
import threading
import queue as queue_mod
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.objectmodel.store import PagedSet, PagedStore

__all__ = ["TokenPageWriter", "TokenLoader", "make_lm_batches"]


def token_record_dtype(seq_len: int) -> np.dtype:
    return np.dtype([("tokens", np.int32, (seq_len + 1,)),
                     ("length", np.int32)])


class TokenPageWriter:
    """Packs token sequences onto pages (the ingest side)."""

    def __init__(self, store: PagedStore, set_name: str, seq_len: int):
        self.seq_len = seq_len
        self.dtype = token_record_dtype(seq_len)
        self.set = store.create_set(set_name, self.dtype)

    def add_document(self, ids: List[int]) -> int:
        """Chunks a document into fixed-length records; returns #records."""
        S = self.seq_len + 1
        n = 0
        for i in range(0, max(1, len(ids)), S):
            chunk = ids[i:i + S]
            if len(chunk) < 2:
                continue
            rec = np.zeros(1, self.dtype)
            rec["tokens"][0, :len(chunk)] = chunk
            rec["tokens"][0, len(chunk):] = -1  # pad -> masked in the loss
            rec["length"][0] = len(chunk)
            self.set.append_records(rec)
            n += 1
        return n


@dataclasses.dataclass
class _Shard:
    pages: List[int]  # page indices owned by this data shard
    cursor: int = 0  # recovery offset (records consumed)


class TokenLoader:
    """Sharded, prefetching batch iterator over a token PagedSet.

    `state()`/`restore()` expose the per-shard cursors so a restarted job
    resumes mid-epoch deterministically (checkpoint carries them)."""

    def __init__(self, pset: PagedSet, batch_size: int, shard: int = 0,
                 num_shards: int = 1, seed: int = 0, prefetch: int = 2):
        self.pset = pset
        self.B = batch_size
        self.shard = _Shard(pages=[i for i in range(len(pset.pages))
                                   if i % num_shards == shard])
        self.seed = seed
        self.prefetch = prefetch
        self._records: Optional[np.ndarray] = None

    def _materialize(self) -> np.ndarray:
        if self._records is None:
            views = [self.pset.pages[i].view(
                0, self.pset.dtype, self.pset.counts[i])
                for i in self.shard.pages]
            self._records = (np.concatenate(views) if views
                             else np.empty(0, self.pset.dtype))
        return self._records

    def state(self) -> Dict[str, int]:
        return {"cursor": self.shard.cursor, "seed": self.seed}

    def restore(self, st: Dict[str, int]) -> None:
        self.shard.cursor = int(st["cursor"])
        self.seed = int(st["seed"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        recs = self._materialize()
        n = len(recs)
        if n == 0:
            return
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(n)
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()  # the consumer has left the loop

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def producer():
            c = self.shard.cursor
            while c + self.B <= n:
                idx = order[c:c + self.B]
                batch_rec = recs[idx]  # gather from pages (views)
                tokens = batch_rec["tokens"]
                labels = tokens.copy()
                labels[tokens < 0] = -1
                if not put((c + self.B,
                            {"tokens": np.maximum(tokens, 0).astype(np.int32),
                             "labels": labels.astype(np.int32)})):
                    return
                c += self.B
            put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                cursor, batch = item
                self.shard.cursor = cursor  # recovery offset
                yield batch
        finally:  # a consumer that stops early (close()) stops the producer
            closed.set()
            t.join()


def make_lm_batches(store: PagedStore, set_name: str, text: str,
                    seq_len: int, batch_size: int, tokenizer=None,
                    repeat: int = 1) -> TokenLoader:
    """Convenience: text -> token pages -> loader (examples/tests)."""
    from repro_torch.data.tokenizer import ByteTokenizer
    tok = tokenizer or ByteTokenizer()
    w = TokenPageWriter(store, set_name, seq_len)
    for _ in range(repeat):
        w.add_document(tok.encode(text))
    return TokenLoader(w.set, batch_size)
