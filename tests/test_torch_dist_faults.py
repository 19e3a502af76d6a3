"""The port's socket transport under faults, against the reference's
behaviour (twins of ``tests/test_dist_faults.py``): a worker process that
dies mid-shuffle and a worker that raises unwind the query inside the
deadline; truncated, corrupt and implausible frames raise a clean
``ProtocolError``; external ``python -m repro_torch.dist.worker
--connect`` processes (on the torch backend with ``--device cpu``) give
the reference's bytes, retain their shards across ``--serve``
reconnects, and route string keys alike under different hash salts.
Every socket, join and wait here has its own timeout."""
import multiprocessing
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from relational_parity import (assert_bytes_equal, backend_kw,
                               fork_available, rank_shuffle_bytes, within)

EMP_DT = np.dtype([("dept", np.int64), ("salary", np.int64)])
DEP_DT = np.dtype([("deptkey", np.int64), ("rank", np.int64)])
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _data(n=600, seed=5):
    rng = np.random.default_rng(seed)
    emps = np.zeros(n, EMP_DT)
    emps["dept"] = rng.integers(0, 5, n)
    emps["salary"] = rng.integers(1, 1000, n)
    deps = np.zeros(5, DEP_DT)
    deps["deptkey"] = np.arange(5)
    deps["rank"] = np.arange(5) + 1
    return emps, deps


# ------------------------------------------------------- dead peer abort
def test_killed_worker_mid_shuffle_unwinds_surviving_peers():
    from repro_torch.core import Session, make_lambda
    from repro_torch.objectmodel.store import PagedStore
    if not fork_available():
        pytest.skip("fork start method unavailable")
    emps, deps = _data()
    sess = Session(store=PagedStore(page_size=1024), backend="workers",
                   num_workers=3, worker_kind="socket",
                   broadcast_threshold_bytes=0, expr_backend="numpy")
    e = sess.load("emps", emps, type_name="Emp")
    d = sess.load("deps", deps, type_name="Dep")

    def kill_pred(rows):
        if multiprocessing.current_process().name == "pc-worker-1":
            os._exit(1)
        return rows["salary"] > 0

    bad = (e.filter(lambda r: make_lambda(r, kill_pred, "keep"))
            .join(d, on=lambda r, s: r.dept == s.deptkey,
                  project=lambda r, s: make_lambda(
                      [r, s], lambda a, b: a["salary"] * b["rank"], "w")))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 1 .*(failed|died)"):
        within(bad.collect, 30)
    assert time.monotonic() - t0 < 15
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("pc-worker") and p.is_alive()]


@pytest.mark.parametrize("expr_backend", ["numpy", "torch"])
def test_worker_error_aborts_socket_query_within_deadline(expr_backend):
    """A worker raising over its own connection: driver error + ABORT
    inside the deadline (fork-launched on numpy, thread-launched over
    real TCP on torch)."""
    from repro_torch.core import Session, make_lambda
    from repro_torch.objectmodel.store import PagedStore
    if expr_backend == "numpy" and not fork_available():
        pytest.skip("fork start method unavailable")
    launch = "thread" if expr_backend == "torch" else "fork"
    sess = Session(store=PagedStore(page_size=1024), backend="workers",
                   num_workers=3, worker_kind="socket", socket_launch=launch,
                   **backend_kw(expr_backend))
    ds = sess.load("emps", _data(200)[0], type_name="Emp")

    def boom(rows):
        name = (threading.current_thread().name if launch == "thread"
                else multiprocessing.current_process().name)
        if name == "pc-worker-2":
            raise RuntimeError("kernel exploded")
        return rows["salary"]

    bad = (ds.select(lambda r: make_lambda(r, boom, "boom"))
             .aggregate(key=None, value=None))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 2 failed"):
        within(bad.collect, 30)
    assert time.monotonic() - t0 < 15


# --------------------------------------------------- framing fault paths
def _tcp_pair():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname(), timeout=10)
    b, _ = lst.accept()
    lst.close()
    b.settimeout(10)  # a framing bug must fail the test, not hang it
    return a, b


def _one_frame_bytes(protocol, vectorlist, n_rows=100, tag="3:L"):
    msg = [protocol.encode_batch(vectorlist.VectorList(
        {"x": np.arange(n_rows, dtype=np.int64)}))]
    return b"".join(bytes(b)
                    for b in protocol.frame_buffers(0, 1, tag, msg))


def _modules():
    import repro.dist.protocol as rp
    import repro.objectmodel.vectorlist as rv
    import repro_torch.dist.protocol as pp
    import repro_torch.objectmodel.vectorlist as pv
    return (rp, rv), (pp, pv)


def test_frames_are_the_reference_bytes_and_decode_across():
    (rp, rv), (pp, pv) = _modules()
    for n in (0, 8, 100, 70_000):
        blob = _one_frame_bytes(pp, pv, n)
        assert blob == _one_frame_bytes(rp, rv, n)
        (src, dst, tag, msg), off = rp.decode_frame(blob)
        assert (src, dst, tag, off) == (0, 1, "3:L", len(blob))
        assert np.array_equal(np.asarray(rp.decode_batch(msg[0])["x"]),
                              np.arange(n))


@pytest.mark.parametrize("cut,match", [(7, "truncated"), (None,
                                                          "truncated")])
def test_truncated_frame_raises_clean_protocol_error(cut, match):
    _, (pp, pv) = _modules()
    a, b = _tcp_pair()
    blob = _one_frame_bytes(pp, pv)
    # body cut mid-payload, or dead inside the length prefix
    a.sendall(blob[:len(blob) - cut] if cut else blob[:5])
    a.close()
    with pytest.raises(pp.ProtocolError, match=match):
        pp.read_frame(b)
    b.close()


def test_valid_frame_then_truncation_is_not_misframed():
    _, (pp, pv) = _modules()
    a, b = _tcp_pair()
    good = _one_frame_bytes(pp, pv, 64, tag="7:R")
    bad = _one_frame_bytes(pp, pv, 32)
    a.sendall(good + bad[:len(bad) // 2])
    a.close()
    src, dst, tag, msg = pp.read_frame(b)
    assert (src, dst, tag) == (0, 1, "7:R")
    assert np.array_equal(np.asarray(pp.decode_batch(msg[0])["x"]),
                          np.arange(64))
    with pytest.raises(pp.ProtocolError, match="truncated"):
        pp.read_frame(b)
    b.close()


def test_garbage_magic_and_implausible_lengths_fail_fast():
    _, (pp, _) = _modules()
    a, b = _tcp_pair()
    a.sendall(b"HTTP/1.1 200 OK\r\n" + b"\x00" * 32)
    a.close()
    with pytest.raises(pp.ProtocolError, match="magic"):
        pp.read_frame(b)
    b.close()
    bogus = pp._PREFIX.pack(pp.PROTO_MAGIC, 16, 1 << 50)
    with pytest.raises(pp.ProtocolError, match="implausible"):
        pp.decode_frame(bogus + b"\x00" * 64)
    with pytest.raises(pp.ProtocolError, match="implausible"):
        pp.decode_frame(pp._PREFIX.pack(pp.PROTO_MAGIC, 0, 0))
    junk = b"\x93\x13\x37" * 5
    with pytest.raises(pp.ProtocolError, match="header"):
        pp.decode_frame(pp._PREFIX.pack(pp.PROTO_MAGIC, len(junk), 0)
                        + junk)


def test_corrupt_length_below_cap_fails_on_short_read_not_oom():
    _, (pp, _) = _modules()
    a, b = _tcp_pair()
    a.sendall(pp._PREFIX.pack(pp.PROTO_MAGIC, 4, 1 << 38) + b"\x80\x04N."
              + b"\x00" * 100)
    a.close()
    t0 = time.monotonic()
    with pytest.raises(pp.ProtocolError, match="truncated"):
        pp.read_frame(b)
    assert time.monotonic() - t0 < 5
    b.close()


def test_clean_eof_at_frame_boundary_reads_as_none():
    _, (pp, pv) = _modules()
    a, b = _tcp_pair()
    a.sendall(_one_frame_bytes(pp, pv, 8))
    a.close()
    assert pp.read_frame(b) is not None
    assert pp.read_frame(b) is None
    b.close()


# ------------------------------------------------- external workers (TCP)
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _external_workers(port, n, *extra, seeds=None):
    """n ``python -m repro_torch.dist.worker --connect`` processes on the
    CPU (the torch backend's plain kernels)."""
    procs = []
    for k in range(n):
        env = {**os.environ,
               "PYTHONPATH": SRC + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        if seeds:
            env["PYTHONHASHSEED"] = seeds[k]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist.worker",
             "--connect", f"127.0.0.1:{port}", "--device", "cpu",
             "--retry-seconds", "30", *extra], env=env))
    return procs


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def _group_query(core, e):
    return (e.filter(lambda r: r.salary > 500)
             .group_by("dept")
             .agg(total=core.agg.sum("salary"), n=core.agg.count(),
                  avg=core.agg.mean("salary")))


def _reference_workers(make, recs, name="emps", type_name="Emp"):
    import repro.core as ref
    sess = ref.Session(backend="workers", num_workers=2,
                       expr_backend="numpy")
    want = make(ref, sess.load(name, recs, type_name=type_name)).collect()
    return want, rank_shuffle_bytes(sess)


def test_external_connect_workers_byte_identical():
    """A connect-mode driver on the torch backend plus two external
    worker processes on ``--device cpu``: the reference's bytes and
    per-rank shuffle bytes, and the workers exit cleanly."""
    import repro_torch.core as port
    emps, _ = _data(800, seed=7)
    want, want_sb = _reference_workers(_group_query, emps)
    tcp = _free_port()
    ws = port.Session(backend="workers", num_workers=2,
                      worker_kind="socket", socket_launch="connect",
                      socket_addr=("127.0.0.1", tcp), **backend_kw("torch"))
    we = ws.load("emps", emps, type_name="Emp")
    workers = _external_workers(tcp, 2)
    try:
        got = within(_group_query(port, we).collect, 90)
        for p in workers:
            assert p.wait(timeout=30) == 0
    finally:
        _reap(workers)
    assert_bytes_equal([want, got])
    assert rank_shuffle_bytes(ws) == want_sb


def test_serve_reconnect_ships_zero_shard_bytes():
    """Warm ``--serve`` reconnect: the retained shard is named by version
    (zero shard bytes on the wire), the repeat stays the reference's
    bytes, and an append re-ships."""
    import repro_torch.core as port
    emps, _ = _data(800, seed=13)
    want, _ = _reference_workers(_group_query, emps)
    tcp = _free_port()
    ws = port.Session(backend="workers", num_workers=2,
                      worker_kind="socket", socket_launch="connect",
                      socket_addr=("127.0.0.1", tcp), expr_backend="numpy")
    we = ws.load("emps", emps, type_name="Emp")
    workers = _external_workers(tcp, 2, "--serve")
    try:
        cold = within(_group_query(port, we).collect, 90)
        assert ws.executor.last_setup_bytes > 0
        warm = within(_group_query(port, we).collect, 60)
        assert ws.executor.last_setup_bytes == 0
        assert_bytes_equal([want, cold, warm])
        ws.store.send_data(we._node.set_name, emps[:16])
        within(_group_query(port, we).collect, 60)
        assert ws.executor.last_setup_bytes > 0
    finally:
        _reap(workers)


def test_connect_workers_string_keys_stable_across_hash_salts():
    import repro_torch.core as port
    rng = np.random.default_rng(9)
    dt = np.dtype([("name", "S8"), ("v", np.int64)])
    recs = np.zeros(800, dt)
    names = np.array([f"key{i}".encode() for i in range(37)])
    recs["name"] = names[rng.integers(0, 37, 800)]
    recs["v"] = rng.integers(0, 1000, 800)

    def q(core, e):
        return e.group_by("name").agg(total=core.agg.sum("v"),
                                      n=core.agg.count())

    want, _ = _reference_workers(q, recs, "t", "T")
    tcp = _free_port()
    ws = port.Session(backend="workers", num_workers=2,
                      worker_kind="socket", socket_launch="connect",
                      socket_addr=("127.0.0.1", tcp), expr_backend="numpy")
    we = ws.load("t", recs, type_name="T")
    workers = _external_workers(tcp, 2, seeds=("0", "12345"))
    try:
        got = within(q(port, we).collect, 90)
        for p in workers:
            assert p.wait(timeout=30) == 0
    finally:
        _reap(workers)
    assert len(np.asarray(got["name"])) == 37
    assert_bytes_equal([want, got])


def test_connect_mode_refuses_unpicklable_native_lambdas():
    import repro_torch.core as port
    ws = port.Session(backend="workers", num_workers=2,
                      worker_kind="socket", socket_launch="connect",
                      socket_addr=("127.0.0.1", _free_port()),
                      **backend_kw("torch"))
    we = ws.load("emps", np.zeros(10, EMP_DT), type_name="Emp")
    bad = we.select(lambda r: port.make_lambda(
        r, lambda rows: rows["salary"], "x"))
    with pytest.raises(ValueError, match="native"):
        bad.collect()


def test_invalid_destination_frame_fails_query_cleanly():
    import repro_torch.core as port
    from repro_torch.dist.driver import DistributedExecutor
    from repro_torch.dist.protocol import (ProtocolError, read_frame,
                                           write_frame)
    from repro_torch.dist.worker import connect_worker
    from repro_torch.objectmodel.store import PagedStore
    tcp = _free_port()
    store = PagedStore()
    store.send_data("emps", np.zeros(10, EMP_DT))
    ex = DistributedExecutor(store, num_workers=1, worker_kind="socket",
                             socket_launch="connect",
                             socket_addr=("127.0.0.1", tcp),
                             socket_accept_timeout=15.0,
                             expr_backend="numpy")
    ds = (port.Session(num_partitions=1, expr_backend="numpy")
          .read("emps", "Emp")
          .filter(lambda r: r.salary >= 0).select(lambda r: r.salary))

    def rogue():
        sock, _w = connect_worker(("127.0.0.1", tcp), retry_seconds=10.0)
        sock.settimeout(15)
        try:
            read_frame(sock)  # SETUP: discarded, not a real worker
            write_frame(sock, 0, 5, "0:bogus", None)  # dst outside P=1
            read_frame(sock)
        except (ProtocolError, OSError):
            pass
        finally:
            sock.close()

    t = threading.Thread(target=rogue, daemon=True)
    t.start()
    with pytest.raises(RuntimeError, match="invalid destination"):
        within(lambda: ex.execute(ds._build_sink()), 30)
    t.join(timeout=15)


def test_rendezvous_times_out_when_workers_never_come():
    import repro_torch.core as port
    from repro_torch.dist.driver import DistributedExecutor
    from repro_torch.objectmodel.store import PagedStore
    store = PagedStore()
    store.send_data("emps", np.zeros(10, EMP_DT))
    ex = DistributedExecutor(store, num_workers=2, worker_kind="socket",
                             socket_launch="connect",
                             socket_addr=("127.0.0.1", _free_port()),
                             socket_accept_timeout=2.0, device="cpu")
    ds = port.Session(num_partitions=2, expr_backend="numpy").read(
        "emps", "Emp")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rendezvous timed out"):
        within(lambda: ex.execute(ds.filter(lambda r: r.salary > 0)
                                  .select(lambda r: r.salary)
                                  ._build_sink()), 30)
    assert time.monotonic() - t0 < 10


def test_socket_runtime_shutdown_is_idempotent():
    from repro_torch.dist.driver import _SocketRuntime
    rt = _SocketRuntime(2, "thread", ("127.0.0.1", 0), 5.0)
    host, port = rt.open()
    c = socket.create_connection((host, port), timeout=10)
    rt._conns = [c]
    rt.shutdown()
    assert rt._closed and rt._conns == [] and rt._listener is None
    rt.shutdown()
    rt.shutdown()
    rt.open()
    assert not rt._closed
    rt.shutdown()
    rt.shutdown()


def test_worker_cli_refuses_a_bad_address_and_an_absent_driver():
    from repro_torch.dist.worker import main
    with pytest.raises(SystemExit):
        main(["--connect", "nohost"])
    assert main(["--connect", f"127.0.0.1:{_free_port()}",
                 "--retry-seconds", "0.5", "--device", "cpu"]) == 1
