"""The paper's §8.4 object analytics and TPC-H Q1 on the PyTorch port:
customers-per-supplier (a join and two aggregations) and top-k Jaccard
over denormalized TPC-H objects, and Q1's pricing summary, on the local
executor and on four thread workers, each byte-identical to the numpy
backend.

Run:  PYTHONPATH=src python examples/torch_tpch_analytics.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.apps.tpch import (LineitemQ1, customers_per_supplier,
                                   load_tpch, q1_pricing_summary,
                                   topk_jaccard)
from repro_torch.core import Session
from repro_torch.data.synthetic import denormalized_tpch, tpch_q1_lineitems


def entry_points(sess, cust, lines, n_parts):
    _, ln = load_tpch(sess.store, cust, lines, session=sess)
    cps = customers_per_supplier(sess.store, ln, n_parts, session=sess)
    query = np.unique(lines["partkey"][:40])
    ids, scores = topk_jaccard(sess.store, ln, n_parts, query, k=8,
                               session=sess)
    return cps, ids, scores


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cust, lines, n_supp, n_parts = denormalized_tpch(800, seed=4)
    q1_lines = tpch_q1_lineitems(400_000, seed=11)
    sessions = {"numpy": {"num_partitions": 4, "expr_backend": "numpy"},
                "torch": {"num_partitions": 4, "device": args.device},
                "torch x4 workers": {"backend": "workers", "num_workers": 4,
                                     "device": args.device}}
    base = None
    for name, kw in sessions.items():
        cps, ids, scores = entry_points(Session(**kw), cust, lines, n_parts)
        sess = Session(**kw)
        ds = sess.load("lineitem", q1_lines, LineitemQ1)
        t0 = time.perf_counter()
        q1 = q1_pricing_summary(sess.store, ds.set_name,
                                session=sess).collect()
        ms = (time.perf_counter() - t0) * 1e3
        got = (ids.tobytes(), scores.tobytes(),
               {c: np.asarray(v).tobytes() for c, v in q1.items()},
               {s: {c: v.tobytes() for c, v in cols.items()}
                for s, cols in cps.items()})
        base = base or got
        assert got == base, name
        print(f"[{name}] {len(cps)} suppliers; top-8 Jaccard "
              f"{ids.tolist()}; Q1 {len(q1['count_order'])} groups in "
              f"{ms:.0f} ms (host clock, first run); bytes as numpy's")


if __name__ == "__main__":
    main()
