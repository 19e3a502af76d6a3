"""The port's worker runtime against the reference's: every chain kind,
both join algorithms, the TPC-H entry points, the elision chains, TPC-H
Q1 and 1, 2 and 4 workers, over the thread, fork and socket transports,
on the port's ``numpy`` and ``torch`` (CPU: the kernels' plain versions)
backends — byte for byte against the reference's ``numpy`` workers, with
the same per-rank ``shuffle_bytes`` (the wire carries the reference's page
bytes). Fork x torch is refused at build time, as the reference refuses
fork x jax; torch x socket runs the thread-launched workers over real
TCP. Every query that forks or opens a socket runs under a deadline."""
import threading
import time

import numpy as np
import pytest

from relational_parity import (assert_bytes_equal, backend_kw,
                               fork_available, rank_shuffle_bytes,
                               transport_kw, within)

TRANSPORTS = ["thread", "fork", "socket"]
BACKENDS = ["numpy", "torch"]

EMP_DT = np.dtype([("ename", "S8"), ("dept", np.int64),
                   ("salary", np.int64)])
DEP_DT = np.dtype([("deptkey", np.int64), ("rank", np.int64)])
N_DEPTS = 5


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _cores():
    import repro.core as ref
    import repro_torch.core as port
    return ref, port


def _emps(n=700, seed=3):
    rng = np.random.default_rng(seed)
    emps = np.zeros(n, EMP_DT)
    emps["ename"] = [f"e{i}".encode() for i in range(n)]
    emps["dept"] = rng.integers(0, N_DEPTS, n)
    emps["salary"] = rng.integers(30_000, 120_000, n)
    deps = np.zeros(N_DEPTS, DEP_DT)
    deps["deptkey"] = np.arange(N_DEPTS)
    deps["rank"] = np.arange(N_DEPTS) + 1
    return emps, deps


def _chain(core, kind, e, d):
    """One chain of ``tests/test_dist.py``, built with ``core``'s lambdas
    and aggregates (the reference's or the port's)."""
    if kind == "filter_select":
        return (e.filter(lambda r: r.salary > 60_000)
                 .select(lambda r: r.salary))
    if kind == "join":
        return e.join(d, on=lambda r, s: r.dept == s.deptkey,
                      project=lambda r, s: core.make_lambda(
                          [r, s], lambda er, dr:
                          er["salary"] + 1000 * dr["rank"], "bonus"))
    if kind == "agg":
        return (e.filter(lambda r: r.salary > 40_000)
                 .aggregate(key="dept", value="salary"))
    if kind == "group_agg":
        return (e.group_by("dept")
                 .agg(total=core.agg.sum("salary"), n=core.agg.count(),
                      lo=core.agg.min("salary"),
                      avg=core.agg.mean("salary")))
    if kind == "topk":
        return e.top_k(9, score="salary", payload="ename")
    if kind == "regroup":
        return (e.group_by("dept")
                 .agg(total=core.agg.sum("salary"), n=core.agg.count())
                 .group_by("dept")
                 .agg(t=core.agg.sum("total"), m=core.agg.mean("total")))
    raise AssertionError(kind)


def _load(core, emps, deps, **kw):
    sess = core.Session(**kw)
    return (sess, sess.load("emps", emps, type_name="Emp"),
            sess.load("deps", deps, type_name="Dep"))


def _parity(kinds, *, num_workers=3, expr_backend, worker_kind,
            **common):
    """Each chain of ``kinds`` on the reference's numpy thread workers and
    on the port's workers of one transport and backend: the same bytes
    and the same per-rank shuffle bytes. Returns both sessions and the
    port's last result."""
    ref, port = _cores()
    kw = transport_kw(worker_kind, expr_backend)
    emps, deps = _emps()
    rs, re_, rd = _load(ref, emps, deps, backend="workers",
                        num_workers=num_workers, expr_backend="numpy",
                        **common)
    ps, pe, pd = _load(port, emps, deps, backend="workers",
                       num_workers=num_workers, **kw, **common)
    for kind in kinds:
        want = _chain(ref, kind, re_, rd).collect()
        got = within(_chain(port, kind, pe, pd).collect)
        assert_bytes_equal([want, got])
        assert rank_shuffle_bytes(ps) == rank_shuffle_bytes(rs), kind
        assert ps.executor.stats.shuffle_bytes \
            == rs.executor.stats.shuffle_bytes
    return rs, ps, got


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
@pytest.mark.parametrize("kind", ["filter_select", "join", "agg",
                                  "group_agg", "topk"])
def test_fluent_chain_matches_the_reference(kind, expr_backend,
                                            worker_kind):
    _parity([kind], expr_backend=expr_backend, worker_kind=worker_kind)


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
@pytest.mark.parametrize("threshold,algo_counter", [
    (2 << 30, "broadcast_joins"),
    (0, "hash_partition_joins"),
])
def test_both_join_algorithms_match_the_reference(threshold, algo_counter,
                                                  expr_backend,
                                                  worker_kind):
    _, ps, _ = _parity(["join"], expr_backend=expr_backend,
                     worker_kind=worker_kind,
                     broadcast_threshold_bytes=threshold)
    assert getattr(ps.executor.stats, algo_counter) == 1
    assert ps.executor.stats.shuffle_bytes > 0
    assert sum(rank_shuffle_bytes(ps)) == ps.executor.stats.shuffle_bytes


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
@pytest.mark.parametrize("N", [1, 2, 4])
def test_worker_counts_match_the_reference(N, expr_backend, worker_kind):
    """N in {1, 2, 4}, the single worker included (every exchange a
    self-loop but the OUTPUT gather), on the shuffle-heavy join chain
    (and at N = 1 the aggregation and top-k too)."""
    kinds = ["join", "agg", "topk"] if N == 1 else ["join"]
    _, ps, _ = _parity(kinds, num_workers=N, expr_backend=expr_backend,
                    worker_kind=worker_kind, broadcast_threshold_bytes=0)
    assert ps.executor.P == N == len(ps.executor.worker_stats)


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
def test_tpch_entry_points_match_the_reference(expr_backend, worker_kind):
    """``customers_per_supplier`` (a join and two aggregations) and
    ``topk_jaccard`` (top-k over a native score) over the denormalized
    TPC-H sets, on 4 workers."""
    from repro.apps import tpch as rt
    from repro.core import Session as RefSession
    from repro.data.synthetic import denormalized_tpch
    from repro_torch.apps import tpch as pt
    from repro_torch.core import Session
    kw = transport_kw(worker_kind, expr_backend)
    cust, lines, _n_supp, n_parts = denormalized_tpch(160, seed=2)
    q = np.unique(lines["partkey"][:32])
    out = []
    for app, sess in ((rt, RefSession(backend="workers", num_workers=4,
                                      expr_backend="numpy")),
                      (pt, Session(backend="workers", num_workers=4,
                                   **kw))):
        _, ln = app.load_tpch(sess.store, cust, lines, session=sess)
        cps = within(lambda: app.customers_per_supplier(
            sess.store, ln, n_parts, session=sess))
        cps_bytes = rank_shuffle_bytes(sess)
        ids, scores = within(lambda: app.topk_jaccard(
            sess.store, ln, n_parts, q, k=12, session=sess))
        out.append((cps, cps_bytes, ids, scores,
                    rank_shuffle_bytes(sess)))
    (cps_r, cb_r, ids_r, sc_r, tb_r), (cps_p, cb_p, ids_p, sc_p, tb_p) = out
    assert set(cps_r) == set(cps_p)
    for supp in cps_r:
        assert_bytes_equal([cps_r[supp], cps_p[supp]])
    assert ids_r.tobytes() == ids_p.tobytes()
    assert sc_r.tobytes() == sc_p.tobytes()
    assert (cb_p, tb_p) == (cb_r, tb_r)


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
def test_elision_chain_matches_the_reference(expr_backend, worker_kind):
    """The re-grouped aggregate: every rank skips the second exchange in
    lockstep, byte-identical to the reference and to the unelided plan."""
    _, port = _cores()
    _, ps, got = _parity(["regroup"], expr_backend=expr_backend,
                         worker_kind=worker_kind)
    assert all(st.exchanges_elided == 1 for st in ps.executor.worker_stats)
    off, oe, od = _load(port, *_emps(), backend="workers", num_workers=3,
                        elide_exchanges=False,
                        **transport_kw(worker_kind, expr_backend))
    assert_bytes_equal([got, within(_chain(port, "regroup", oe,
                                           od).collect)])
    assert all(st.exchanges_elided == 0 for st in off.executor.worker_stats)


def _join_regrouped(core, e, d):
    return (e.group_by("dept")
             .agg(total=core.agg.sum("salary"), n=core.agg.count())
             .join(d, on=lambda a, b: a.dept == b.deptkey)
             .group_by("dept")
             .agg(t=core.agg.sum("total"), r=core.agg.max("rank")))


def _records(schema_mod):
    """EmpR and DepR as typed records of one package (the default pair
    projection needs record classes on both sides)."""
    S, Record, i64 = schema_mod.S, schema_mod.Record, schema_mod.i64
    emp = type("EmpR", (Record,), {"__annotations__": {
        "ename": S(8), "dept": i64, "salary": i64}})
    dep = type("DepR", (Record,), {"__annotations__": {
        "deptkey": i64, "rank": i64}})
    return emp, dep


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
def test_join_elision_chain_matches_the_reference(expr_backend,
                                                  worker_kind):
    """AGG -> JOIN on the group key -> AGG under forced hash partitioning:
    both later exchanges elided on every rank, the bytes the reference's."""
    import repro.objectmodel.schema as ref_schema
    import repro_torch.objectmodel.schema as port_schema
    ref, port = _cores()
    kw = transport_kw(worker_kind, expr_backend)
    emps, deps = _emps()
    results = []
    for core, schema, skw in ((ref, ref_schema, {"expr_backend": "numpy"}),
                              (port, port_schema, kw)):
        EmpR, DepR = _records(schema)
        sess = core.Session(backend="workers", num_workers=3,
                            broadcast_threshold_bytes=0, **skw)
        q = _join_regrouped(core, sess.load("emps", emps, EmpR),
                            sess.load("deps", deps, DepR))
        results.append((within(q.collect), sess))
    (want, rs), (got, ps) = results
    assert_bytes_equal([want, got])
    assert rank_shuffle_bytes(ps) == rank_shuffle_bytes(rs)
    assert all(st.exchanges_elided == 2 for st in ps.executor.worker_stats)


@pytest.mark.parametrize("worker_kind", TRANSPORTS)
@pytest.mark.parametrize("expr_backend", BACKENDS)
def test_q1_over_four_workers_matches_the_reference(expr_backend,
                                                    worker_kind):
    """TPC-H Q1 over 4 workers: the reference's numpy workers' bytes and
    per-rank shuffle bytes, and its local executor's bytes."""
    from repro.apps.tpch import LineitemQ1 as RefQ1
    from repro.apps.tpch import q1_pricing_summary as ref_q1
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.data.synthetic import tpch_q1_lineitems
    ref, port = _cores()
    kw = transport_kw(worker_kind, expr_backend)
    lines = tpch_q1_lineitems(30_000, seed=11)
    out = []
    for core, q1, schema, skw in (
            (ref, ref_q1, RefQ1, {"num_partitions": 4,
                                  "expr_backend": "numpy"}),
            (ref, ref_q1, RefQ1, {"backend": "workers", "num_workers": 4,
                                  "expr_backend": "numpy"}),
            (port, q1_pricing_summary, LineitemQ1,
             {"backend": "workers", "num_workers": 4, **kw})):
        sess = core.Session(**skw)
        ds = sess.load("lineitem", lines, schema)
        out.append((within(q1(sess.store, ds.set_name,
                              session=sess).collect), sess))
    (local, _), (want, rs), (got, ps) = out
    assert_bytes_equal([local, want, got])
    assert rank_shuffle_bytes(ps) == rank_shuffle_bytes(rs)
    assert int(np.asarray(got["count_order"]).sum()) == int(
        (lines["shipdate"] <= 9400).sum())


def test_workers_on_the_torch_backend_run_the_plain_kernels_on_the_cpu():
    from repro_torch.core import Session
    from repro_torch.kernels import ops
    _, port = _cores()
    emps, deps = _emps()
    sess, e, d = _load(port, emps, deps, backend="workers", num_workers=2,
                       expr_backend="torch", device="cpu")
    assert sess.executor.device.type == "cpu"
    ops.reset_launch_counts()
    _chain(port, "group_agg", e, d).collect()
    assert sum(ops.launch_counts().values()) == 0  # CPU: plain versions
    text = _chain(port, "agg", e, d).explain()
    assert "workers x2 via thread" in text
    assert "per-worker shuffle_bytes" in text and "expr=torch" in text
    assert Session(backend="workers", num_workers=2,
                   expr_backend="numpy").executor.device is None


@pytest.mark.parametrize("kind", ["thread", "fork"])
def test_worker_failure_surfaces_as_driver_error(kind):
    from repro_torch.core import Session, make_lambda
    if kind == "fork" and not fork_available():
        pytest.skip("fork start method unavailable")
    sess = Session(backend="workers", num_workers=2, worker_kind=kind,
                   **backend_kw("numpy" if kind == "fork" else "torch"))
    emps, _ = _emps(40)
    ds = sess.load("emps", emps, type_name="Emp")

    def boom(rows):
        if rows["dept"].min() % 2 == 0:  # only one worker's shard dies
            raise RuntimeError("kernel exploded")
        return rows["salary"]

    bad = (ds.select(lambda r: make_lambda(r, boom, "boom"))
             .aggregate(key=None, value=None))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker .* failed"):
        within(bad.collect, 30)
    assert time.monotonic() - t0 < 15
    if kind == "thread":
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("pc-worker") and t.is_alive()]


def test_fork_large_shuffle_does_not_deadlock():
    """Per-destination shuffle messages beyond the OS pipe buffer: the
    star router keeps draining while it forwards."""
    _, port = _cores()
    if not fork_available():
        pytest.skip("fork start method unavailable")
    n = 120_000
    rng = np.random.default_rng(5)
    emps = np.zeros(n, EMP_DT)
    emps["ename"] = b"x"
    emps["dept"] = rng.integers(0, N_DEPTS, n)
    emps["salary"] = rng.integers(0, 1 << 40, n)
    _, deps = _emps(1)
    ws, we, wd = _load(port, emps, deps, backend="workers", num_workers=4,
                       worker_kind="fork", expr_backend="numpy",
                       broadcast_threshold_bytes=0)
    result = within(_chain(port, "join", we, wd).collect, 120)
    assert len(next(iter(result.values()))) == n
    assert ws.executor.stats.shuffle_bytes > 4 * 65536


def test_session_backend_validation():
    from repro_torch.core import NaiveExecutor, Session
    cpu = backend_kw("torch")
    with pytest.raises(ValueError, match="unknown backend"):
        Session(backend="cluster", **cpu)
    with pytest.raises(ValueError, match="num_workers only applies"):
        Session(num_workers=2, **cpu)
    with pytest.raises(ValueError, match="disagree"):
        Session(backend="workers", num_partitions=8, num_workers=4, **cpu)
    assert Session(backend="workers", num_partitions=3,
                   **cpu).executor.P == 3
    with pytest.raises(ValueError, match="chooses its own executor"):
        Session(backend="workers", executor_cls=NaiveExecutor, **cpu)
    with pytest.raises(ValueError, match="unknown worker_kind"):
        Session(backend="workers", worker_kind="carrier-pigeon", **cpu)
    # the torch backend cannot cross the fork that spawns the default
    # socket workers (the port's default backend, so the default socket
    # launch is refused): the message names the thread-launched plane
    for kw in (cpu, {}):
        with pytest.raises(ValueError, match="socket_launch='thread'"):
            Session(backend="workers", worker_kind="socket", **kw)
    with pytest.raises(ValueError, match="worker_kind='thread'"):
        Session(backend="workers", worker_kind="fork", **cpu)
    s = Session(backend="workers", worker_kind="socket",
                socket_launch="thread", **cpu)
    assert s.executor.socket_launch == "thread"
    assert s.executor.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown socket_launch"):
        Session(backend="workers", worker_kind="socket",
                socket_launch="udp", expr_backend="numpy")
    with pytest.raises(ValueError, match="only apply to"):
        Session(backend="workers", worker_kind="thread",
                socket_launch="thread", **cpu)
    with pytest.raises(ValueError, match="explicit num_workers"):
        Session(backend="workers", worker_kind="socket",
                socket_launch="connect", socket_addr=("127.0.0.1", 5555),
                **cpu)
    with pytest.raises(ValueError, match="nonzero port"):
        Session(backend="workers", worker_kind="socket", num_workers=2,
                socket_launch="connect", **cpu)
