"""``python -m repro_torch.analysis`` — the planlint self-check over the
bundled apps (port of ``python -m repro.analysis``).

Builds each app's characteristic plans on tiny synthetic inputs, runs the
analyzer over every plan (``Dataset.check()``), prints the structured
findings, and exits 1 if any plan carries an error-severity diagnostic.
Eager app paths (the linalg DSL, TPC-H top-k) additionally *execute*,
which routes every plan through the Session's analyzer gate — a gated
plan failing would surface here as the ValueError the gate raises.

``--json`` emits a machine-readable report instead (schema
``repro-planlint/1``: per plan the findings as ``{code, severity,
op_path, message}``, the inferred output schema, and the elided-exchange
op indices); the human progress lines move to stderr and the
exit-1-on-errors contract is unchanged.

The apps run on ``--expr-backend`` (default ``torch``) on ``--device``
(default the CUDA card; ``--device cpu`` runs the kernels' plain
versions).

CI runs this as the planlint job: the apps must stay analysis-clean at
error severity.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from repro_torch.analysis.diagnostics import AnalysisReport


def _report(name: str, rep: AnalysisReport, reports: list) -> None:
    reports.append((name, rep))
    print(f"-- {name}")
    print("   " + rep.format().replace("\n", "\n   "))


def _check_tpch(reports: list, kw: dict) -> None:
    from repro_torch.apps.tpch import q1_pricing_summary, topk_jaccard
    from repro_torch.core.session import Session
    from repro_torch.data.synthetic import denormalized_tpch, tpch_q1_lineitems

    sess = Session(num_partitions=2, **kw)
    lines = tpch_q1_lineitems(600, seed=3)
    ds = sess.load("lineitem", lines)
    q1 = q1_pricing_summary(sess.store, ds.set_name, session=sess)
    _report("tpch.q1_pricing_summary", q1.check(), reports)
    q1.collect()  # through the analyzer gate

    # second grouping over Q1's keys: the redundant-exchange elision shape
    from repro_torch.core.aggregates import agg
    chained = (q1.group_by("returnflag", "linestatus")
                 .agg(total=agg.sum("sum_qty")))
    _report("tpch.q1_regroup (elision)", chained.check(), reports)
    chained.collect()

    rng = np.random.default_rng(0)
    _, denorm_lines, _, n_parts = denormalized_tpch(40, seed=0)
    denorm = sess.load("lineitem_denorm", denorm_lines)
    topk_jaccard(sess.store, denorm.set_name, n_parts,
                 rng.integers(0, n_parts, 4), k=3, session=sess)
    print("-- tpch.topk_jaccard: executed through the analyzer gate")


def _check_ml(reports: list, kw: dict) -> None:
    from repro_torch.apps.ml import KMeans, point_schema
    from repro_torch.core.lambdas import make_lambda
    from repro_torch.core.session import Session
    from repro_torch.data.synthetic import points

    x, _labels = points(200, 4, n_clusters=3, seed=1)
    KMeans(k=3, iters=2, num_partitions=2, **kw).fit(x)
    print("-- ml.KMeans: executed (2 iterations)")

    # the k-means inner plan, lazily, so planlint sees the program the
    # tool iterates: native key/value projections feeding the aggregation
    sess = Session(num_partitions=2, **kw)
    schema = point_schema(x.shape[1])
    C = x[:3].copy()

    def closest(rows):
        return ((rows["x"][:, None] - C[None]) ** 2).sum(-1).argmin(1)

    def with_count(rows):
        return np.concatenate(
            [rows["x"], np.ones((len(rows["x"]), 1))], axis=1)

    step = (sess.load("points", schema.pack(x=x), schema)
                .aggregate(key=lambda a: make_lambda(a, closest, "getClose"),
                           value=lambda a: make_lambda(a, with_count,
                                                       "fromMe")))
    _report("ml.kmeans_step", step.check(), reports)
    step.collect()


def _check_linalg(reports: list, kw: dict) -> None:
    from repro_torch.apps.linalg import (LinAlgSession, _block_mul_fn,
                                   _flat_blocks, matrix_block_schema)
    from repro_torch.core.lambdas import make_lambda, make_lambda_from_member

    rng = np.random.default_rng(2)
    la = LinAlgSession(num_partitions=2, block_size=8, **kw)
    la.load("X", rng.normal(size=(24, 8)))
    la.load("y", rng.normal(size=(24, 1)))
    la.run("beta = (X '* X)^-1 %*% (X '* y)")
    print("-- linalg.normal_equations: executed through the analyzer gate")

    # the multiply plan (join on the inner block index + aggregation),
    # lazily, so its report is printed like the others
    schema = matrix_block_schema(la.bs)
    A = la.vars["X"]
    mul = _block_mul_fn(True, "c", la.bs)
    mm = (la.sess.read(A.set_name, schema)
            .join(la.sess.read(A.set_name, schema),
                  on=lambda a, b: (make_lambda_from_member(a, "r")
                                   == make_lambda_from_member(b, "r")),
                  project=lambda a, b: make_lambda([a, b], mul,
                                                   "blockMultiply"))
            .aggregate(key="key", value=_flat_blocks))
    _report("linalg.transpose_multiply", mm.check(), reports)
    mm.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable JSON report on stdout "
                         "(progress lines go to stderr)")
    ap.add_argument("--expr-backend", default="torch",
                    choices=("torch", "numpy", "interp"),
                    help="the apps' expression backend (default: torch)")
    ap.add_argument("--device", default=None,
                    help="where the torch backend's kernels run (default: "
                         "the CUDA card; 'cpu' runs their plain versions)")
    args = ap.parse_args(argv)
    kw = {"expr_backend": args.expr_backend, "device": args.device}

    reports: list = []
    with contextlib.ExitStack() as stack:
        if args.json:
            # keep stdout pure JSON for tools; the human run log (the
            # checks print as they execute) still lands on stderr
            stack.enter_context(contextlib.redirect_stdout(sys.stderr))
        for check in (_check_tpch, _check_ml, _check_linalg):
            check(reports, kw)
        n_err = sum(len(rep.errors()) for _, rep in reports)
        n_warn = sum(len(rep.warnings()) for _, rep in reports)
        n_info = sum(len(rep.infos()) for _, rep in reports)
        print(f"== planlint: {len(reports)} plans analyzed, {n_err} errors, "
              f"{n_warn} warnings, {n_info} infos ==")
    if args.json:
        doc = {"schema": "repro-planlint/1",
               "plans": [{"name": name, **rep.to_json_dict()}
                         for name, rep in reports],
               "counts": {"error": n_err, "warning": n_warn,
                          "info": n_info}}
        json.dump(doc, sys.stdout, indent=1)
        print()
    if n_err:
        for name, rep in reports:
            for d in rep.errors():
                print(f"ERROR {name}: {d.format()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
