"""Shared helpers of the relational parity suites
(``tests/test_torch_{relational,exprc,groupby,dist,dist_faults,service,
apps,threads}.py``): the port's sessions
on the CPU, and byte comparisons of ``collect()`` results.

The reference's ``jax`` expression backend needs
``jax.experimental.enable_x64``, which JAX 0.9.0 does not have, so the port
is held against the reference's ``numpy`` (and ``interp``) backends."""
import numpy as np

PORT_BACKENDS = ("interp", "numpy", "torch")


def port_session(expr_backend="numpy", **kw):
    """A session of the port; its torch backend on the CPU, where the
    kernels' plain versions run."""
    from repro_torch.core import Session
    if expr_backend == "torch":
        kw.setdefault("device", "cpu")
    return Session(expr_backend=expr_backend, **kw)


def assert_bytes_equal(results):
    """Every result has the first's columns, dtypes, shapes and bytes."""
    ref = results[0]
    for other in results[1:]:
        assert set(ref) == set(other)
        for col in ref:
            x, y = np.asarray(ref[col]), np.asarray(other[col])
            assert x.dtype == y.dtype, col
            assert x.shape == y.shape, col
            assert x.tobytes() == y.tobytes(), col


# ------------------------------------------ the workers and the service
# (tests/test_torch_{dist,dist_faults,service,apps}.py)
def fork_available() -> bool:
    import multiprocessing
    import sys
    return (sys.platform != "win32"
            and "fork" in multiprocessing.get_all_start_methods())


def backend_kw(expr_backend):
    """A port's session arguments for one expression backend: the torch
    backend on the CPU, where the kernels' plain versions run."""
    return ({"expr_backend": "torch", "device": "cpu"}
            if expr_backend == "torch" else {"expr_backend": expr_backend})


def transport_kw(worker_kind, expr_backend="numpy"):
    """Session arguments for one transport of the port, skipping what the
    platform or the build-time rules rule out: fork workers and the
    default fork-launched socket workers need the fork start method; the
    torch backend cannot cross a fork, so torch x socket rides the
    thread-launched data plane and torch x fork is refused at build time
    (as the reference's jax backend is)."""
    import pytest
    kw = {"worker_kind": worker_kind, **backend_kw(expr_backend)}
    if worker_kind == "fork":
        if expr_backend == "torch":
            pytest.skip("worker_kind='fork' x torch refused at build time")
        if not fork_available():
            pytest.skip("fork start method unavailable")
    if worker_kind == "socket":
        if expr_backend == "torch":
            kw["socket_launch"] = "thread"
        elif not fork_available():
            pytest.skip("fork start method unavailable (socket workers "
                        "are fork-launched by default)")
    return kw


def rank_shuffle_bytes(sess):
    """Each rank's measured shuffle bytes of a workers session's last
    query."""
    return [w.shuffle_bytes for w in sess.executor.worker_stats]


def within(fn, seconds=60.0):
    """fn() in a daemon thread, its result; fails the test (rather than
    hang the suite) when it has not returned within ``seconds``."""
    import threading
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]
