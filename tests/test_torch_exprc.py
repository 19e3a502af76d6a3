"""The port's expression compiler against the reference: the fixed sampled
term trees of ``tests/test_exprc.py`` (not its property tests, which fail
on the reference) through the port's three backends, byte for byte
against the reference's ``interp`` and ``numpy`` backends; the torch
backend's schedule against the reference's ``schedule_jax_run``, status
for status; the expression core's plain version over every (op, dtype
pair) numpy computes, against numpy's bytes; and the kernel cache."""
import itertools
import warnings

import numpy as np
import pytest

from exprc_trees import collect_tree_query, sample_query
from relational_parity import PORT_BACKENDS, assert_bytes_equal, port_session


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _schemas():
    """The reference's and the port's ``TRow`` of tests/test_exprc.py (one
    layout, so one set of records)."""
    from repro.objectmodel.schema import Record as RefRecord
    from repro.objectmodel.schema import S as RS, f64 as rf64, i64 as ri64
    from repro_torch.objectmodel.schema import S, Record, f64, i64

    class TRow(RefRecord):
        a: ri64
        b: ri64
        c: rf64
        tag: RS(4)

    class PortTRow(Record):
        __type_name__ = "TRow"
        a: i64
        b: i64
        c: f64
        tag: S(4)

    return TRow, PortTRow


def _rows(schema, n=300, seed=0):
    rng = np.random.default_rng(seed)
    return schema.pack(a=rng.integers(-100, 100, n),
                       b=rng.integers(-100, 100, n),
                       c=rng.normal(0, 10, n),
                       tag=rng.choice([b"x", b"y", b"z"], n))


def _port_session_cls(num_partitions, expr_backend):
    return port_session(expr_backend, num_partitions=num_partitions)


@pytest.mark.parametrize("case", range(12))
def test_sampled_term_trees_byte_identical_to_the_reference(case):
    """tests/test_exprc.py's deterministic sample (seed 42, 12 cases), each
    case one test here."""
    from repro.core import Session
    ref_schema, schema = _schemas()
    rng = np.random.default_rng(42)
    for _ in range(case + 1):
        preds, proj = sample_query(rng)
        n = int(rng.integers(0, 250))
        parts = int(rng.integers(1, 5))
    records = _rows(schema, n, seed=case)
    want = collect_tree_query(Session, records, ref_schema,
                              ("interp", "numpy"), preds, proj, parts)
    got = collect_tree_query(_port_session_cls, records, schema,
                             PORT_BACKENDS, preds, proj, parts)
    assert_bytes_equal(want + got)


def _fused_stages(steps):
    from repro_torch.core.exprc import FusedStage
    return [s for s in steps if isinstance(s, FusedStage)]


@pytest.mark.parametrize("case", range(12))
def test_torch_schedule_matches_the_reference_jax_schedule(case):
    """Every fused run of the sampled trees' optimized plans gets from
    ``schedule_torch_run`` the reference's ``schedule_jax_run`` statuses
    and dtypes, raw and hoisted, at the input dtypes it ran with."""
    from exprc_trees import build_term
    from repro.core import Session
    from repro.core.exprc import FusedStage as RefStage
    from repro.core.exprc import build_steps as ref_steps
    from repro.core.exprc import schedule_jax_run
    from repro_torch.core.exprc import schedule_torch_run
    ref_schema, schema = _schemas()
    rng = np.random.default_rng(42)
    for _ in range(case + 1):
        preds, proj = sample_query(rng)
        n = int(rng.integers(0, 250))
        parts = int(rng.integers(1, 5))
    n = max(n, 1)  # a run with rows records its input dtypes

    def query(sess, sch):
        ds = sess.load("t", _rows(schema, n, seed=case), sch)
        for p in preds:
            ds = ds.filter(lambda t, _p=p: build_term(_p, t))
        ds = ds.select(lambda t: build_term(proj, t))
        with np.errstate(all="ignore"):
            ds.collect()
        return sess._entry_for(ds)

    port = query(port_session("torch", num_partitions=parts), schema)
    ref = query(Session(num_partitions=parts), ref_schema)
    assert ref.optimized.to_text() == port.optimized.to_text()
    ran = _fused_stages(port.steps)
    expected = [s for s in ref_steps(ref.optimized, "jax")
                if isinstance(s, RefStage)]
    assert len(ran) == len(expected)
    for stage, ref_stage in zip(ran, expected):
        for dsig in stage._kern:
            arrays = [np.zeros(0, dt) for dt in dsig]
            for hoist in (False, True):
                assert schedule_torch_run(stage.ir, arrays, hoist) == \
                    schedule_jax_run(ref_stage.ir, arrays, hoist)


_UFUNCS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
           "+": np.add, "-": np.subtract, "*": np.multiply,
           "/": np.true_divide, "&&": np.logical_and, "||": np.logical_or}
_DTYPES = ["?", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4",
           "f8"]


def _values(rng, dt, n):
    """Random values of dt with its edge values (extremes, 0, +-0.0,
    +-inf, NaN); a NaN only meets NaNs of its own bits (numpy's choice
    between two different NaNs depends on its code path)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        v = np.where(rng.random(n) < 0.3, rng.integers(
            -3 if dt.kind == "i" else 0, 4, n).astype(dt), v)
        edge = np.array([info.min, info.max, 0, 1, info.max - 1], dt)
    else:
        with np.errstate(over="ignore"):
            v = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-5, 6, n)).astype(dt)
        v = np.where(rng.random(n) < 0.2, rng.integers(-3, 4, n).astype(dt),
                     v)
        edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0,
                         float(np.finfo(dt).tiny), float(np.finfo(dt).max)]
                        ).astype(dt)
    v[:len(edge)] = edge
    return v


@pytest.mark.parametrize("op", list(_UFUNCS) + ["!"])
def test_expr_core_plain_version_gives_numpy_bytes(torch, op):
    """Every dtype pair numpy computes ``op`` for (every dtype for !)."""
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    from repro_torch.kernels.transfer import to_device
    rng = np.random.default_rng(sum(map(ord, op)))
    n, cases = 96, 0
    pairs = ([(d, d) for d in _DTYPES] if op == "!"
             else itertools.product(_DTYPES, _DTYPES))
    for da, db in pairs:
        a, b = _values(rng, da, n), _values(rng, db, n)
        try:
            with np.errstate(all="ignore"), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = (np.logical_not(a) if op == "!"
                        else _UFUNCS[op](a, b))
        except TypeError:  # numpy refuses it (bool - bool)
            continue
        ins = (0,) if op == "!" else (0, 1)
        prog = ec.encode([(op, 2, ins)],
                         {0: a.dtype, 1: b.dtype, 2: want.dtype},
                         list(ins), [2])
        got, = ops.expr_core(prog, to_device([a, b][:len(ins)],
                                             torch.device("cpu")), n)
        assert got.numpy().view(want.dtype).tobytes() == want.tobytes(), \
            (da, op, db)
        cases += 1
    assert cases >= 12


def test_expr_core_constant_inputs_and_refusals(torch):
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    a = np.array([1.5, -2.0, np.nan, 4.0])
    k = np.array([3], np.int64)  # a constant, one value for every row
    dts = {0: a.dtype, 1: k.dtype, 2: np.dtype(bool), 3: a.dtype}
    prog = ec.encode([("<", 2, (0, 1)), ("*", 3, (0, 1))], dts, [0, 1],
                     [2, 3])
    lt, prod = ops.expr_core(prog, [torch.from_numpy(a),
                                    torch.from_numpy(k)], 4)
    assert lt.tolist() == [True, True, False, False]
    assert prod.numpy().tobytes() == (a * 3).tobytes()
    with pytest.raises(TypeError, match="recorded"):
        ec.encode([("+", 2, (0, 1))], {0: a.dtype, 1: k.dtype,
                                        2: np.dtype(np.int64)}, [0, 1], [2])
    with pytest.raises(TypeError, match="takes the native"):
        ec.encode([("+", 2, (0, 1))], {0: np.dtype(np.complex128),
                                        1: k.dtype, 2: a.dtype}, [0, 1], [2])
    with pytest.raises(ValueError, match="CUDA"):
        ec.expr_core(prog, [torch.from_numpy(a), torch.from_numpy(k)], 4)


def test_kernel_cache_distinguishes_const_dtypes_on_torch():
    from repro_torch.core import constant, reset_kernel_cache
    _, schema = _schemas()
    reset_kernel_cache()
    outs = []
    for k in (2, 2.0):
        sess = port_session("torch", num_partitions=2)
        ds = sess.load("t", _rows(schema, 16), schema)
        outs.append(ds.select(
            lambda t, _k=k: t.col("a") * constant(_k)).to_numpy())
    assert outs[0].dtype == np.int64
    assert outs[1].dtype == np.float64


def test_kernel_cache_shared_across_sessions_and_devices():
    from repro_torch.core import kernel_cache_info, reset_kernel_cache
    _, schema = _schemas()
    reset_kernel_cache()

    def run():
        sess = port_session("torch", num_partitions=2)
        ds = sess.load("t", _rows(schema, 64), schema)
        return (ds.filter(lambda t: t.a > 0)
                  .select(lambda t: t.a + t.b).collect())

    first = run()
    info = kernel_cache_info()
    assert info["misses"] >= 1 and info["capacity"] == 512
    assert_bytes_equal([first, run()])  # second session: kernel cache warm
    again = kernel_cache_info()
    assert again["misses"] == info["misses"] and again["hits"] >= 1
