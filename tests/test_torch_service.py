"""The port's persistent query service against the reference's (twins of
``tests/test_service.py``): warm scans in place (zero SETUP bytes), four
concurrent client sessions on one pool, worker-side ``write()``,
admission control, worker death and self-healing, and the fork and
external ``--serve`` launches — each answer byte-identical to the
reference's ``numpy`` service, with the same per-rank ``shuffle_bytes`` and
SETUP bytes, on the port's ``numpy`` and ``torch`` (CPU) backends. Every
wait on a socket or a thread has its own timeout."""
import os
import socket as socket_mod
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from relational_parity import (assert_bytes_equal, backend_kw,
                               fork_available, rank_shuffle_bytes, within)

EMP_DT = np.dtype([("ename", "S8"), ("dept", np.int64),
                   ("salary", np.int64)])
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _emps(n=700, seed=3):
    rng = np.random.default_rng(seed)
    emps = np.zeros(n, EMP_DT)
    emps["ename"] = [f"e{i}".encode() for i in range(n)]
    emps["dept"] = rng.integers(0, 5, n)
    emps["salary"] = rng.integers(30_000, 120_000, n)
    return emps


def _chain(core, e):
    return (e.filter(lambda r: r.salary > 50_000)
             .group_by("dept")
             .agg(total=core.agg.sum("salary"), n=core.agg.count(),
                  lo=core.agg.min("salary")))


def _kill_conn(svc, rank):
    svc._conns[rank].shutdown(socket_mod.SHUT_RDWR)


def _service(expr_backend="torch", **kw):
    from repro_torch.service import QueryService
    return QueryService(num_workers=2, launch="thread",
                        **backend_kw(expr_backend), **kw)


@pytest.fixture()
def pool(request):
    with _service(getattr(request, "param", "torch")) as svc:
        svc.wait_ready(30)
        yield svc


@pytest.fixture(scope="module")
def reference():
    """The reference's numpy service over the same data: (result of the
    chain cold, warm, per-rank shuffle bytes, cold SETUP bytes)."""
    import repro.core as ref
    from repro.service import QueryService
    with QueryService(num_workers=2, launch="thread",
                      expr_backend="numpy") as svc:
        svc.wait_ready(30)
        sess = ref.Session.connect(svc)
        q = _chain(ref, sess.load("emps", _emps(), type_name="Emp"))
        cold = within(q.collect)
        setup = sess.executor.last_setup_bytes
        warm = within(q.collect)
        yield cold, warm, rank_shuffle_bytes(sess), setup


# --------------------------------------------------- warm-path locality
@pytest.mark.parametrize("pool", ["numpy", "torch"], indirect=True)
def test_cold_then_warm_match_the_reference(pool, reference):
    import repro_torch.core as port
    ref_cold, ref_warm, ref_sb, ref_setup = reference
    sess = port.Session.connect(pool)
    q = _chain(port, sess.load("emps", _emps(), type_name="Emp"))
    cold = within(q.collect)
    assert sess.executor.last_setup_bytes == ref_setup > 0
    warm = within(q.collect)
    assert sess.executor.last_setup_bytes == 0
    assert_bytes_equal([ref_cold, ref_warm, cold, warm])
    assert rank_shuffle_bytes(sess) == ref_sb


def test_catalog_hits_and_holdings_track_reuse(pool):
    import repro_torch.core as port
    sess = port.Session.connect(pool)
    q = sess.load("emps", _emps(300), type_name="Emp").select(
        lambda r: r.salary)
    within(q.collect)
    snap0 = pool.catalog.snapshot()
    assert snap0["holdings"] > 0
    within(q.collect)
    assert pool.catalog.snapshot()["hits"] == snap0["hits"] + pool.P


def test_write_invalidates_only_that_set(pool):
    import repro_torch.core as port
    sess = port.Session.connect(pool)
    a = sess.load("a", _emps(200, seed=1), type_name="Emp")
    b = sess.load("b", _emps(200, seed=2), type_name="Emp")
    qa, qb = a.select(lambda r: r.salary), b.select(lambda r: r.salary)
    within(qa.collect), within(qb.collect), within(qa.collect)
    assert sess.executor.last_setup_bytes == 0
    pool.store.send_data(b._node.set_name, _emps(10, seed=9))
    within(qa.collect)
    assert sess.executor.last_setup_bytes == 0
    within(qb.collect)
    assert sess.executor.last_setup_bytes > 0


# ------------------------------------------------------- multi-tenancy
@pytest.mark.parametrize("pool", ["numpy", "torch"], indirect=True)
def test_four_concurrent_sessions_on_two_worker_pool(pool, reference):
    import repro_torch.core as port
    expected = reference[0]
    results, errors = {}, []
    barrier = threading.Barrier(4)

    def client(k):
        try:
            sess = port.Session.connect(pool)
            e = sess.load(f"emps{k}", _emps(), type_name="Emp")
            barrier.wait(timeout=30)
            for _ in range(2):  # cold then warm, under contention
                results[k] = _chain(port, e).collect()
        except Exception as ex:  # noqa: BLE001 - surfaced below
            errors.append((k, ex))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    assert_bytes_equal([expected] + [results[k] for k in range(4)])
    assert pool.queries_run >= 8
    assert pool.scheduler.load()["running"] == 0


def test_sessions_share_service_store(pool):
    from repro_torch.core import Session
    from repro_torch.objectmodel.store import PagedStore
    s1, s2 = Session.connect(pool), Session.connect(pool)
    assert s1.store is pool.store and s2.store is pool.store
    assert s1.executor.device == pool.device
    with pytest.raises(ValueError, match="share the QueryService's store"):
        Session(backend="service", service=pool, store=PagedStore())


# --------------------------------------------------- worker-side write()
@pytest.mark.parametrize("pool", ["numpy", "torch"], indirect=True)
def test_write_materializes_on_workers_not_driver(pool):
    import repro.core as ref
    import repro_torch.core as port
    emps = _emps(500, seed=5)
    sess = port.Session.connect(pool)
    e = sess.load("emps", emps, type_name="Emp")
    out = (e.filter(lambda r: r.salary > 60_000)
            .select(lambda r: r.salary).write("svc_rich"))
    assert within(out.collect) == {}
    ment = pool.catalog.materialized("svc_rich")
    assert ment is not None and not ment.lost
    stored = pool.store.sets["svc_rich"]
    assert stored.num_records == ment.total_rows and not stored.pages
    field = ment.dtype.names[0]
    back = within(sess.read("svc_rich")
                  .select(lambda r: getattr(r, field)).collect)
    assert sess.executor.last_setup_bytes == 0
    local = ref.Session(num_partitions=2)
    expected = (local.load("emps", emps, type_name="Emp")
                     .filter(lambda r: r.salary > 60_000)
                     .select(lambda r: r.salary).collect())
    got, want = next(iter(back.values())), next(iter(expected.values()))
    assert ment.total_rows == len(want)
    assert np.sort(got).tobytes() == np.sort(want).tobytes()


def test_write_of_empty_result_fails_cleanly(pool):
    import repro_torch.core as port
    sess = port.Session.connect(pool)
    e = sess.load("emps", _emps(50), type_name="Emp")
    bad = (e.filter(lambda r: r.salary > 10_000_000)
            .select(lambda r: r.salary).write("svc_empty"))
    with pytest.raises(ValueError, match="no rows on any worker"):
        within(bad.collect)


# ---------------------------------------------------- admission control
def test_admission_rejects_query_that_never_fits():
    import repro_torch.core as port
    from repro_torch.service import QueryRejected
    with _service(worker_budget_bytes=64) as svc:
        svc.wait_ready(30)
        e = port.Session.connect(svc).load("emps", _emps(400),
                                           type_name="Emp")
        with pytest.raises(QueryRejected, match="never be admitted"):
            within(e.select(lambda r: r.salary).collect)
        assert svc.scheduler.load() == {"running": 0, "queued": 0,
                                        "reserved_bytes": 0}


def test_scheduler_fifo_fairness_timeout_and_overflow():
    from repro_torch.service import (AdmissionScheduler, QueryRejected,
                                     QueryTimeout)
    sched = AdmissionScheduler(worker_budget_bytes=100, max_concurrent=4)
    sched.admit("big", 90)
    t0 = time.monotonic()
    with pytest.raises(QueryTimeout, match="not admitted"):
        sched.admit("waiter", 50, timeout=0.3)
    assert 0.2 < time.monotonic() - t0 < 5
    sched.release("big")
    assert sched.admit("now-fits", 50, timeout=1.0).status == "running"
    sched.release("now-fits", observed_bytes=10.0, wall_ms=1.0)
    assert {r["qid"]: r["status"] for r in sched.accounting()}[
        "now-fits"] == "ok"

    sched = AdmissionScheduler(max_concurrent=1, max_queue=1)
    sched.admit("running", 1)
    done = threading.Event()

    def waiter():
        try:
            sched.admit("queued", 1, timeout=10)
            sched.release("queued")
        finally:
            done.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    for _ in range(500):
        if sched.load()["queued"] == 1:
            break
        time.sleep(0.01)
    with pytest.raises(QueryRejected, match="queue is full"):
        sched.admit("overflow", 1, timeout=0.1)
    sched.release("running")
    assert done.wait(timeout=10)
    t.join(timeout=10)


def test_footprint_model_and_estimate_match_the_reference():
    import repro.core as ref
    import repro_torch.core as port
    from repro.analysis.footprint import estimate_plan_footprint as ref_fp
    from repro_torch.analysis.footprint import estimate_plan_footprint
    from repro_torch.service import FootprintModel
    m = FootprintModel(alpha=0.5)
    assert m.corrected("k", 1000.0) == 1000.0
    m.observe("k", 1000.0, 2000.0)
    assert m.corrected("k", 1000.0) == pytest.approx(2000.0)
    m.observe("k", 1000.0, 1000.0)
    assert m.corrected("k", 1000.0) == pytest.approx(1500.0)
    got = []
    for core, fp in ((ref, ref_fp), (port, estimate_plan_footprint)):
        sess = core.Session(num_partitions=2, expr_backend="numpy")
        prints = []
        for n in (100, 1000):
            ds = sess.load(f"t{n}", _emps(n), type_name="Emp")
            prog = sess._compile(ds.select(lambda r: r.salary))
            f = fp(prog, sess.store, num_partitions=2)
            prints.append((f.total_bytes, f.scan_bytes,
                           f.per_worker_bytes))
        got.append(prints)
    assert got[0] == got[1]
    assert got[1][1][1] > got[1][0][1] > 0


# ------------------------------------------------------ fault handling
def test_worker_death_evicts_catalog_and_replaces_worker(pool):
    import repro_torch.core as port
    from repro_torch.obs.metrics import METRICS
    sess = port.Session.connect(pool)
    e = sess.load("emps", _emps(500), type_name="Emp")
    q = e.select(lambda r: r.salary)
    expected = within(q.collect)
    within(e.select(lambda r: r.dept).write("svc_mat").collect)
    assert not pool.catalog.materialized("svc_mat").lost
    died0 = METRICS.counter("service.workers.died.total")
    _kill_conn(pool, 0)
    deadline = time.monotonic() + 15
    while (time.monotonic() < deadline
           and not pool.catalog.materialized("svc_mat").lost):
        time.sleep(0.05)
    assert pool.catalog.materialized("svc_mat").lost
    assert pool.catalog.lookup(0, e._node.set_name) is None
    assert METRICS.counter("service.workers.died.total") > died0
    pool.wait_ready(30)
    assert_bytes_equal([expected, within(q.collect)])
    field = pool.catalog.materialized("svc_mat").dtype.names[0]
    with pytest.raises(RuntimeError, match="lost"):
        within(sess.read("svc_mat")
               .select(lambda r: getattr(r, field)).collect)


def test_worker_death_errors_only_inflight_queries(pool):
    import queue as queue_mod
    import repro_torch.core as port
    collector = queue_mod.SimpleQueue()
    pool._collectors["inflight"] = collector
    try:
        _kill_conn(pool, 1)
        _src, tag, msg = collector.get(timeout=15)
        assert tag == "error" and "rank 1 died" in msg
    finally:
        pool._collectors.pop("inflight", None)
    pool.wait_ready(30)
    e = port.Session.connect(pool).load("emps", _emps(200),
                                        type_name="Emp")
    assert len(next(iter(within(e.select(lambda r: r.salary)
                                .collect).values()))) == 200


# ------------------------------------------------- config + capability
def test_service_backend_validation():
    from repro_torch.core import Session
    from repro_torch.service import QueryService
    with pytest.raises(ValueError, match="pass service="):
        Session(backend="service", **backend_kw("torch"))
    svc = _service()  # not started: config-only checks
    with pytest.raises(ValueError, match="pool size is fixed"):
        Session(backend="service", service=svc, num_workers=4)
    with pytest.raises(ValueError, match="worker_kind is fixed"):
        Session(backend="service", service=svc, worker_kind="thread")
    with pytest.raises(ValueError, match="fixed by the QueryService"):
        Session(backend="service", service=svc, socket_launch="fork")
    with pytest.raises(ValueError, match="only applies to"):
        Session(backend="local", service=svc, **backend_kw("torch"))
    with pytest.raises(ValueError, match="unknown service launch"):
        QueryService(num_workers=2, launch="carrier-pigeon")
    # the port's torch backend (its default) cannot cross the fork that
    # spawns a forked pool, as the reference's jax backend cannot
    for kw in ({}, backend_kw("torch")):
        with pytest.raises(ValueError,
                           match="cannot run expr_backend='torch'"):
            QueryService(num_workers=2, launch="fork", **kw)
    assert QueryService(num_workers=2, launch="fork",
                        expr_backend="numpy").device is None
    assert svc.device.type == "cpu"


def test_service_refuses_native_lambdas_for_every_launch(pool):
    import repro_torch.core as port
    e = port.Session.connect(pool).load("emps", _emps(50), type_name="Emp")
    bad = e.select(lambda r: port.make_lambda(
        r, lambda rows: rows["salary"], "x"))
    with pytest.raises(ValueError, match="native"):
        bad.collect()


def test_submit_requires_started_service_and_stop_is_idempotent():
    import repro_torch.core as port
    svc = _service()
    e = port.Session.connect(svc).load("emps", _emps(20), type_name="Emp")
    with pytest.raises(RuntimeError, match="not running"):
        e.select(lambda r: r.salary).collect()
    svc.start()
    svc.wait_ready(30)
    threads = list(svc._threads)
    svc.stop()
    svc.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(c is None for c in svc._conns)


# ------------------------------------------------------- observability
def test_explain_shows_service_footer_metrics_and_accounting(pool):
    import repro_torch.core as port
    from repro_torch.obs.metrics import METRICS
    sess = port.Session.connect(pool)
    q = sess.load("emps", _emps(200), type_name="Emp").select(
        lambda r: r.salary)
    within(q.collect)
    within(q.collect)
    text = q.explain()
    assert "service pool x2 via thread" in text and "expr=torch" in text
    assert "== service:" in text and "catalog: shards=" in text
    assert "setup_bytes(last)=0" in text
    snap = METRICS.snapshot()
    for name in ("service.queries.total", "service.queries.admitted.total",
                 "catalog.hits.total"):
        assert snap["counters"].get(name, 0) > 0, name
    assert snap["gauges"].get("service.pool.workers") == 2
    runs = pool.scheduler.accounting()
    assert runs and runs[-1]["status"] == "ok"
    assert runs[-1]["predicted_bytes"] > 0
    assert runs[-1]["observed_bytes"] is not None


# ------------------------------------------- other pool launch modes
def test_fork_launch_matches_the_reference(reference):
    import repro_torch.core as port
    from repro_torch.service import QueryService
    if not fork_available():
        pytest.skip("fork start method unavailable")
    with QueryService(num_workers=2, launch="fork",
                      expr_backend="numpy") as svc:
        svc.wait_ready(30)
        sess = port.Session.connect(svc)
        q = _chain(port, sess.load("emps", _emps(), type_name="Emp"))
        assert_bytes_equal([reference[0], within(q.collect)])
        assert sess.executor.last_setup_bytes > 0
        assert_bytes_equal([reference[0], within(q.collect)])
        assert sess.executor.last_setup_bytes == 0


def test_connect_launch_external_serve_workers(reference):
    """External ``python -m repro_torch.dist.worker --connect ... --serve
    --device cpu`` processes join a torch-backend pool (told so in their
    WELCOME) and serve it until its BYE."""
    import repro_torch.core as port
    from repro_torch.service import QueryService
    env = {**os.environ,
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
    with QueryService(num_workers=2, launch="connect",
                      **backend_kw("torch")) as svc:
        host, port_no = svc.advertised
        workers = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist.worker",
             "--connect", f"{host}:{port_no}", "--serve", "--device",
             "cpu", "--retry-seconds", "2"], env=env) for _ in range(2)]
        try:
            svc.wait_ready(60)
            sess = port.Session.connect(svc)
            q = _chain(port, sess.load("emps", _emps(), type_name="Emp"))
            assert_bytes_equal([reference[0], within(q.collect)])
            assert sess.executor.last_setup_bytes > 0
            assert_bytes_equal([reference[0], within(q.collect)])
            assert sess.executor.last_setup_bytes == 0
            assert rank_shuffle_bytes(sess) == reference[2]
            svc.stop()
            for p in workers:
                assert p.wait(timeout=60) == 0
        finally:
            for p in workers:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)


@pytest.mark.parametrize("pool", ["numpy", "torch"], indirect=True)
def test_q1_through_the_service_matches_the_reference(pool):
    from repro.apps.tpch import LineitemQ1 as RefQ1
    from repro.apps.tpch import q1_pricing_summary as ref_q1
    from repro.core import Session as RefSession
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.data.synthetic import tpch_q1_lineitems
    lines = tpch_q1_lineitems(20_000, seed=4)
    rs = RefSession(backend="workers", num_workers=2, expr_backend="numpy")
    rd = rs.load("lineitem", lines, RefQ1)
    want = ref_q1(rs.store, rd.set_name, session=rs).collect()
    sess = Session.connect(pool)
    ds = sess.load("lineitem", lines, LineitemQ1)
    got = within(q1_pricing_summary(sess.store, ds.set_name,
                                    session=sess).collect)
    assert_bytes_equal([want, got])
    assert rank_shuffle_bytes(sess) == rank_shuffle_bytes(rs)
