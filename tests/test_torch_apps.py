"""The port's tools against the reference's, byte for byte: lilLinAlg's
multiply and Gram matrix (a join on the inner block index feeding a sum
of block products, the sum through the segment reduction on the torch
backend), k-means, GMM and LDA over a few iterations, the relational
paths of ``tests/test_exprc.py`` (aggregation with a native barrier,
top-k, both join algorithms, the TPC-H entry points), and the planlint
CLI over the port's apps — on the port's ``numpy`` and ``torch`` (CPU: the
kernels' plain versions) backends against the reference's ``numpy``."""
import contextlib
import io
import json

import numpy as np
import pytest

from relational_parity import assert_bytes_equal, backend_kw

PORT_BACKENDS = ("numpy", "torch")


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _each(run):
    """run(package's apps, its core, session kwargs) for the reference's
    numpy backend, then the port's numpy and torch backends."""
    import repro.apps as ref_apps
    import repro.core as ref
    import repro_torch.apps as port_apps
    import repro_torch.core as port
    out = [run(ref_apps, ref, {})]  # the reference defaults to numpy
    for be in PORT_BACKENDS:
        out.append(run(port_apps, port, backend_kw(be)))
    return out


# ------------------------------------------------------------ lilLinAlg
def test_linalg_matmul_and_gram_match_the_reference():
    """A (300x200) %*% B (200x150) and A '* A in blocks of 64."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(300, 200)), rng.normal(size=(200, 150))

    def run(apps, core, kw):
        la = apps.LinAlgSession(num_partitions=3, block_size=64, **kw)
        la.load("A", a)
        la.load("B", b)
        out = la.run("M = A %*% B\nG = A '* A")
        return {"M": la.fetch(out["M"]), "G": la.fetch(out["G"])}

    results = _each(run)
    assert_bytes_equal(results)
    np.testing.assert_allclose(results[0]["M"], a @ b, rtol=1e-10,
                               atol=1e-10)


def test_linalg_least_squares_and_nearest_neighbor_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(96, 8))
    y = x @ rng.normal(size=(8, 1))

    def run(apps, core, kw):
        la = apps.LinAlgSession(num_partitions=2, block_size=16, **kw)
        la.load("X", x)
        la.load("y", y)
        beta = la.fetch(la.run("beta = (X '* X)^-1 %*% (X '* y)")["beta"])
        ids, dist = la.nearest_neighbor(la.vars["X"], np.eye(8), x[5], k=3)
        return {"beta": beta, "ids": ids, "dist": dist}

    results = _each(run)
    assert_bytes_equal(results)
    assert results[0]["ids"][0] == 5


# ------------------------------------------------------------- ML tools
def test_kmeans_matches_the_reference():
    from repro.data.synthetic import points
    x, _ = points(2000, 8, n_clusters=5, seed=1)
    results = _each(lambda apps, core, kw: {
        "c": apps.KMeans(5, iters=3, num_partitions=3, **kw).fit(x)})
    assert_bytes_equal(results)


def test_gmm_matches_the_reference():
    from repro.data.synthetic import points
    x, _ = points(1200, 4, n_clusters=3, seed=2)

    def run(apps, core, kw):
        mu, var, pi = apps.GMM(3, iters=2, num_partitions=2, **kw).fit(x)
        return {"mu": mu, "var": var, "pi": pi}

    assert_bytes_equal(_each(run))


def test_lda_matches_the_reference():
    from repro.data.synthetic import lda_triples
    triples = lda_triples(40, 60, avg_words=20, seed=3)

    def run(apps, core, kw):
        theta, phi = apps.LDAGibbs(4, 60, iters=2, num_partitions=2,
                                   seed=0, **kw).fit(triples, 40)
        return {"theta": theta, "phi": phi}

    assert_bytes_equal(_each(run))


# ----------------------------------------- relational paths of test_exprc
def _trow(schema_mod):
    S, Record, f64, i64 = (schema_mod.S, schema_mod.Record, schema_mod.f64,
                           schema_mod.i64)
    return type("TRow", (Record,), {"__annotations__": {
        "a": i64, "b": i64, "c": f64, "tag": S(4)}})


def _rows(schema, n=300, seed=0):
    rng = np.random.default_rng(seed)
    return schema.pack(a=rng.integers(-100, 100, n),
                       b=rng.integers(-100, 100, n),
                       c=rng.normal(0, 10, n),
                       tag=rng.choice([b"x", b"y", b"z"], n))


def _schema_of(core):
    import repro.objectmodel.schema as ref_schema
    import repro_torch.objectmodel.schema as port_schema
    return ref_schema if core.__name__.startswith("repro.") else port_schema


@pytest.mark.parametrize("query", ["native_barrier_agg", "topk",
                                   "division"])
def test_agg_topk_native_barrier_and_division_match_the_reference(query):
    def run(apps, core, kw):
        TRow = _trow(_schema_of(core))
        sess = core.Session(num_partitions=3, **kw)
        ds = sess.load("t", _rows(TRow), TRow)
        if query == "native_barrier_agg":
            q = (ds.filter(lambda t: t.a > -90)
                   .aggregate(key=lambda t: t.tag,
                              value=lambda t: core.make_lambda(
                                  t, lambda rows: rows["a"] * rows["b"],
                                  "ab")))
        elif query == "topk":
            q = ds.top_k(7, score="c", payload="a")
        else:
            q = ds.select(lambda t: t.c / t.a)
        return q.collect()

    assert_bytes_equal(_each(run))


@pytest.mark.parametrize("threshold", [2 << 30, 0])
def test_join_matches_the_reference_under_both_algorithms(threshold):
    def run(apps, core, kw):
        schema = _schema_of(core)
        TRow = _trow(schema)
        Dim = schema.record("TDim", k=schema.i64, w=schema.i64)
        sess = core.Session(num_partitions=3,
                            broadcast_threshold_bytes=threshold, **kw)
        lds = sess.load("l", TRow.pack(a=np.arange(50) % 7,
                                       b=np.arange(50), c=np.zeros(50),
                                       tag=[b"l"] * 50), TRow)
        rds = sess.load("d", Dim.pack(k=np.arange(7), w=np.arange(7) * 10),
                        Dim)
        res = lds.join(rds, on=lambda t, d: t.a == d.k).collect()
        algo = ("broadcast_joins" if threshold else "hash_partition_joins")
        assert getattr(sess.last_stats, algo) == 1
        return res

    assert_bytes_equal(_each(run))


def test_tpch_entry_points_match_the_reference():
    from repro.data.synthetic import denormalized_tpch
    cust, lines, _n_supp, n_parts = denormalized_tpch(60, seed=7)
    q = np.unique(lines["partkey"][:24])

    def run(apps, core, kw):
        sess = core.Session(num_partitions=4, **kw)
        _, ln = apps.load_tpch(sess.store, cust, lines, session=sess)
        cps = apps.customers_per_supplier(sess.store, ln, n_parts,
                                          session=sess)
        ids, scores = apps.topk_jaccard(sess.store, ln, n_parts, q, k=9,
                                        session=sess)
        flat = {f"{s}:{c}": v for s, cols in cps.items()
                for c, v in cols.items()}
        return {**flat, "ids": ids, "scores": scores}

    assert_bytes_equal(_each(run))


# --------------------------------------------------------- planlint CLI
def _planlint(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, json.loads(out.getvalue()), err.getvalue()


def test_planlint_cli_over_the_ports_apps_matches_the_reference():
    from repro.analysis.__main__ import main as ref_main
    from repro_torch.analysis.__main__ import main
    ref_code, want, _ = _planlint(ref_main, ["--json"])
    for argv in (["--json", "--device", "cpu"],
                 ["--json", "--expr-backend", "numpy"]):
        code, got, log = _planlint(main, argv)
        assert code == ref_code == 0
        assert got["schema"] == "repro-planlint/1"
        assert got["counts"] == want["counts"]
        assert [p["name"] for p in got["plans"]] == [
            p["name"] for p in want["plans"]]
        assert got == want
        assert "planlint: 4 plans analyzed, 0 errors" in log
