"""Persistent query service tour: resident pool, shard catalog, tenants.

Run with ``PYTHONPATH=src python examples/torch_service_demo.py [--device
cpu]`` (the PyTorch port: the pool's queries run K1 and K2 on the card
unless ``--device cpu``). One QueryService hosts a 2-worker pool; the
demo walks the three pillars:

1. cold vs warm — the first query ships shard pages, the repeat scans
   in place (catalog hit, zero SETUP bytes);
2. worker-side ``write()`` — the result set materializes in the pool
   workers' stores and is read back in place, never round-tripping
   through the driver;
3. multi-tenancy — four client sessions submit concurrently over the
   same pool, isolated per query id, under admission control.

For a pool of external processes (true multi-host), swap
``launch="thread"`` for ``launch="connect"`` and start workers with
``python -m repro_torch.dist.worker --connect HOST:PORT --serve``.
"""
import argparse
import threading

import numpy as np

from repro_torch.core import Session, agg
from repro_torch.service import QueryService


def make_records(n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, np.dtype([("dept", np.int64),
                                 ("salary", np.int64)]))
    recs["dept"] = rng.integers(0, 32, n)
    recs["salary"] = rng.integers(30_000, 120_000, n)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    recs = make_records()
    with QueryService(num_workers=2, launch="thread",
                      device=args.device) as svc:
        svc.wait_ready()

        # -- 1. cold vs warm ------------------------------------------
        sess = Session.connect(svc)
        emps = sess.load("emps", recs, type_name="Emp")
        q = (emps.filter(lambda e: e.salary > 50_000)
                 .group_by("dept")
                 .agg(total=agg.sum("salary"), n=agg.count()))
        q.collect()
        print(f"cold query shipped {sess.executor.last_setup_bytes:,} "
              "shard bytes")
        q.collect()
        print(f"warm repeat shipped {sess.executor.last_setup_bytes:,} "
              "bytes (catalog hit: the pool scans in place)")

        # -- 2. worker-side write() -----------------------------------
        (emps.filter(lambda e: e.salary > 90_000)
             .select(lambda e: e.salary)
             .write("top_earners").collect())
        entry = svc.catalog.materialized("top_earners")
        print(f"write('top_earners'): {entry.total_rows} rows "
              f"materialized on the pool (per-rank {entry.per_rank_rows})"
              " — no output pages crossed the wire")
        field = entry.dtype.names[0]
        back = (sess.read("top_earners")
                    .select(lambda r: getattr(r, field)).collect())
        print(f"read back in place: {len(next(iter(back.values())))} rows, "
              f"{sess.executor.last_setup_bytes} setup bytes")

        # -- 3. four concurrent tenants -------------------------------
        def tenant(k):
            s = Session.connect(svc)
            e = s.load(f"emps_{k}", recs, type_name="Emp")
            r = (e.group_by("dept")
                  .agg(hi=agg.max("salary")).collect())
            print(f"  tenant {k}: {len(r['hi'])} groups")

        threads = [threading.Thread(target=tenant, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        print("\n-- explain footer --")
        print("\n".join(ln for ln in q.explain().splitlines()
                        if "service" in ln or "catalog" in ln
                        or "pool" in ln))
        print("\n-- accounting (last 3 runs) --")
        for run in svc.scheduler.accounting()[-3:]:
            print(f"  {run['qid']} name={run['name']!r} "
                  f"status={run['status']} "
                  f"predicted={run['predicted_bytes']:,.0f}B "
                  f"wall={run['wall_ms']:.1f}ms")


if __name__ == "__main__":
    main()
