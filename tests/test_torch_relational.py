"""The port's relational engine on its local path against the reference:
TPC-H Q1 through the Session API on the port's ``interp``, ``numpy`` and
``torch`` (CPU: the kernels' plain versions) backends, byte for byte
against the reference's ``numpy`` backend, with the same shuffle bytes,
elided exchanges, structural signature and optimized TCAP text; the
object model's page bytes; and the entry points' refusals."""
import types

import numpy as np
import pytest

from relational_parity import PORT_BACKENDS, assert_bytes_equal, port_session


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _q1_reference(lines, parts):
    from repro.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro.core import Session
    sess = Session(num_partitions=parts, expr_backend="numpy")
    ds = sess.load("lineitem", lines, LineitemQ1)
    q = q1_pricing_summary(sess.store, ds.set_name, session=sess)
    return sess, q, q.collect()


def _q1_port(lines, parts, backend):
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    sess = port_session(backend, num_partitions=parts)
    ds = sess.load("lineitem", lines, LineitemQ1)
    q = q1_pricing_summary(sess.store, ds.set_name, session=sess)
    return sess, q, q.collect()


def _plan_text(sess, q):
    """The structural signature and the optimized TCAP text of a query."""
    from repro.core.tcap import structural_signature as ref_sig
    from repro_torch.core.tcap import structural_signature as port_sig
    prog = sess._compile(q)
    sig = (port_sig if type(sess).__module__.startswith("repro_torch")
           else ref_sig)(prog)
    return repr(sig), sess._entry_for(q).optimized.to_text()


@pytest.mark.parametrize("rows", [3000, 50000])
@pytest.mark.parametrize("parts", [3, 4])
def test_q1_byte_identical_to_the_reference(rows, parts):
    from repro.data.synthetic import tpch_q1_lineitems as ref_lines
    from repro_torch.data.synthetic import tpch_q1_lineitems
    lines = tpch_q1_lineitems(rows, seed=rows)
    assert lines.tobytes() == ref_lines(rows, seed=rows).tobytes()
    ref_sess, ref_q, want = _q1_reference(lines, parts)
    ref_plan = _plan_text(ref_sess, ref_q)
    for backend in PORT_BACKENDS:
        sess, q, got = _q1_port(lines, parts, backend)
        assert_bytes_equal([want, got])
        for stat in ("shuffle_bytes", "exchanges_elided", "rows_scanned",
                     "rows_output", "pages_scanned"):
            assert (getattr(sess.last_stats, stat)
                    == getattr(ref_sess.last_stats, stat)), (backend, stat)
        assert _plan_text(sess, q) == ref_plan, backend
    assert int(np.asarray(want["count_order"]).sum()) == int(
        (lines["shipdate"] <= 9400).sum())


def test_q1_on_the_torch_backend_runs_the_plain_kernels_on_the_cpu():
    from repro_torch.data.synthetic import tpch_q1_lineitems
    from repro_torch.kernels import ops
    lines = tpch_q1_lineitems(20000, seed=1)
    ops.reset_launch_counts()
    sess, q, _ = _q1_port(lines, 4, "torch")
    assert sum(ops.launch_counts().values()) == 0  # CPU: plain versions
    assert sess.executor.device.type == "cpu"
    text = q.explain()
    assert "expr=torch" in text and "shuffle" in text


def test_loaded_pages_serialize_to_the_reference_bytes():
    from repro.objectmodel import PagedStore as RefStore
    from repro_torch.data.synthetic import tpch_q1_lineitems
    from repro_torch.objectmodel import PagedStore
    lines = tpch_q1_lineitems(70000, seed=3)
    ref, port = RefStore(), PagedStore()
    ref.send_data("lineitem", lines)
    port.send_data("lineitem", lines)
    want = ref.get_set("lineitem").to_payloads()
    got = port.get_set("lineitem").to_payloads()
    assert len(got) == len(want) > 1
    assert [(n, p.tobytes()) for n, p in got] == [
        (n, p.tobytes()) for n, p in want]


def test_torch_session_without_a_device_raises_when_there_is_no_card(torch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.core import Session
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()  # expr_backend="torch" is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(expr_backend="torch")
    for host in ("numpy", "interp"):  # the host backends need none
        assert Session(expr_backend=host).executor.device is None


def test_unported_backends_and_fork_rules_refuse():
    """The reference's ``jax`` expression backend is not the port's (the
    port's device backend is ``torch``), and the fork rules name torch and
    CUDA; the workers and service backends are ported
    (``tests/test_torch_{dist,service}.py``)."""
    from repro_torch.analysis.capability import worker_config_violation
    from repro_torch.core import Session
    from repro_torch.dist.driver import DistributedExecutor
    from repro_torch.service.service import ServiceExecutor
    with pytest.raises(ValueError, match="unknown expr_backend"):
        Session(expr_backend="jax")
    for kind, launch in (("fork", None), ("socket", "fork")):
        msg = worker_config_violation(2, "torch", kind, launch, None)
        assert "expr_backend='torch'" in msg and "CUDA" in msg
    assert worker_config_violation(2, "jax", "fork", None, None) \
        .startswith("unknown expr_backend")
    service = types.SimpleNamespace(
        store=None, expr_backend="numpy", device=None, P=2,
        vector_rows=8192, broadcast_threshold=2 << 30, launch="thread")
    assert isinstance(Session(backend="service", service=service).executor,
                      ServiceExecutor)
    assert isinstance(Session(backend="workers", num_workers=2,
                              expr_backend="numpy").executor,
                      DistributedExecutor)
