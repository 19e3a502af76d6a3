"""Quickstart of the PyTorch port: one typed, fluent Dataset chain on the
local executor and on four workers, its fused stages through the
expression-core kernel (K1) and its pre-aggregation through the
segment-reduce kernel (K2) on the card, byte-identical to the numpy
backend.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default runs on the CUDA card; ``--device cpu`` runs the kernels'
plain versions).
"""
import argparse

import numpy as np

from repro_torch.core import Session, UnknownColumnError, agg
from repro_torch.kernels import ops
from repro_torch.objectmodel.schema import Record, S, i64


class Employee(Record):
    name: S(12)
    dept: S(8)
    salary: i64


def payroll(sess, emps):
    return (sess.load("employees", emps, Employee)
            .filter(lambda e: e.salary > 60_000)
            .filter(lambda e: e.salary < 140_000)
            .group_by("dept").agg(total=agg.sum("salary"), n=agg.count()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    emps = Employee.pack(
        name=[f"emp{i}".encode() for i in range(100_000)],
        dept=rng.choice([b"sales", b"eng", b"hr"], 100_000),
        salary=rng.integers(30_000, 150_000, 100_000))
    want = payroll(Session(num_partitions=4, expr_backend="numpy"),
                   emps).collect()
    for kw in ({"num_partitions": 4},
               {"backend": "workers", "num_workers": 4}):
        ops.reset_launch_counts()
        sess = Session(device=args.device, **kw)
        q = payroll(sess, emps)
        got = q.collect()
        for col in want:
            assert np.asarray(want[col]).tobytes() == \
                np.asarray(got[col]).tobytes(), col
        counts = ops.launch_counts()
        print(f"{kw}: byte-identical to numpy; K1 launches "
              f"{counts['expr_core']}, K2 {counts['segment_reduce']}")
    for dept, total in zip(got["dept"], got["total"]):
        print(f"  {dept.decode():5s}: {int(total):>14,}")
    try:
        sess.read("employees", Employee).filter(lambda e: e.salry > 0)
    except UnknownColumnError as e:
        print(f"build-time schema check: {e}")
    print("\n".join(q.explain().splitlines()[-3:]))


if __name__ == "__main__":
    main()
