"""Synthetic dataset generators for benchmarks (paper §8 workloads)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["lm_tokens", "points", "lda_triples", "denormalized_tpch",
           "tpch_q1_lineitems"]


def lm_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
              ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # zipf-ish marginals so the loss has structure
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return rng.choice(vocab, size=(n_seqs, seq_len), p=p).astype(np.int32)


def points(n: int, dim: int, n_clusters: int = 10, seed: int = 0
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-mixture points (k-means / GMM benchmarks, paper §8.5)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (n_clusters, dim))
    labels = rng.integers(0, n_clusters, n)
    x = centers[labels] + rng.normal(0, 1, (n, dim))
    return x.astype(np.float64), labels


def lda_triples(n_docs: int, vocab: int, avg_words: int = 50, seed: int = 0
                ) -> np.ndarray:
    """(docID, wordID, count) triples — the paper's word-based LDA input."""
    rng = np.random.default_rng(seed)
    rows = []
    for d in range(n_docs):
        n_w = max(1, rng.poisson(avg_words))
        words = rng.integers(0, vocab, n_w)
        uniq, counts = np.unique(words, return_counts=True)
        rows.append(np.stack([np.full(len(uniq), d), uniq, counts], axis=1))
    out = np.concatenate(rows).astype(np.int64)
    rec = np.zeros(len(out), dtype=np.dtype(
        [("doc", np.int64), ("word", np.int64), ("count", np.int64)]))
    rec["doc"], rec["word"], rec["count"] = out[:, 0], out[:, 1], out[:, 2]
    return rec


def tpch_q1_lineitems(n: int, seed: int = 0) -> np.ndarray:
    """Lineitems with the TPC-H Q1 pricing columns (returnflag/linestatus
    marginals roughly matching the spec's generator: ~half of rows are
    shipped-and-open ``N``/``O``, returns split between ``A``/``R``).
    ``shipdate`` is days-since-epoch; Q1's cutoff predicate filters on it.
    Layout matches :class:`repro_torch.apps.tpch.LineitemQ1`."""
    rng = np.random.default_rng(seed)
    dt = np.dtype([("returnflag", "S1"), ("linestatus", "S1"),
                   ("qty", np.float64), ("extendedprice", np.float64),
                   ("discount", np.float64), ("tax", np.float64),
                   ("shipdate", np.int32)])
    rec = np.zeros(n, dt)
    ship = rng.integers(8000, 9500, n)  # ~1992-1996 in days-since-epoch
    open_order = ship > 8700
    rec["returnflag"] = np.where(open_order, b"N",
                                 rng.choice([b"A", b"R"], n))
    rec["linestatus"] = np.where(open_order, b"O", b"F")
    rec["qty"] = rng.integers(1, 51, n).astype(np.float64)
    rec["extendedprice"] = np.round(rng.uniform(900, 105_000, n), 2)
    rec["discount"] = np.round(rng.integers(0, 11, n) / 100.0, 2)
    rec["tax"] = np.round(rng.integers(0, 9, n) / 100.0, 2)
    rec["shipdate"] = ship
    return rec


def denormalized_tpch(n_customers: int, seed: int = 0):
    """Denormalized TPC-H-like objects (paper §8.4): customers with nested
    orders -> lineitems -> (supplier, part). Flattened to SoA records with
    repeat counts — the page-friendly layout of nested PC Objects."""
    rng = np.random.default_rng(seed)
    n_suppliers = max(10, n_customers // 100)
    n_parts = max(20, n_customers // 10)
    cust_dt = np.dtype([("custkey", np.int64), ("name", "S16"),
                        ("n_orders", np.int32)])
    line_dt = np.dtype([("custkey", np.int64), ("orderkey", np.int64),
                        ("suppkey", np.int64), ("partkey", np.int64),
                        ("qty", np.int32), ("price", np.float64)])
    customers = np.zeros(n_customers, cust_dt)
    customers["custkey"] = np.arange(n_customers)
    customers["name"] = [f"cust{i}".encode() for i in range(n_customers)]
    lines = []
    orderkey = 0
    for c in range(n_customers):
        n_orders = rng.integers(1, 6)
        customers["n_orders"][c] = n_orders
        for _ in range(n_orders):
            n_items = rng.integers(1, 8)
            rec = np.zeros(n_items, line_dt)
            rec["custkey"] = c
            rec["orderkey"] = orderkey
            rec["suppkey"] = rng.integers(0, n_suppliers, n_items)
            rec["partkey"] = rng.integers(0, n_parts, n_items)
            rec["qty"] = rng.integers(1, 50, n_items)
            rec["price"] = rng.uniform(1, 1000, n_items)
            lines.append(rec)
            orderkey += 1
    return customers, np.concatenate(lines), n_suppliers, n_parts
