"""The port's grouped aggregation against the reference: the fixed queries
of ``tests/test_groupby.py`` (multi-aggregate, empty input and empty
groups, a single row, a constant key, boolean indicators, the legacy
``aggregate()`` wrapper, its sampled random key/value/combiner sets)
through the port's three backends, byte for byte against the reference's
``numpy`` backend; and the segment reduction's plain version (K2's)
against ``np.add.at`` / ``np.minimum.at`` / ``np.maximum.at``."""
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


def _schemas():
    """The reference's and the port's ``GRow`` of tests/test_groupby.py."""
    from repro.objectmodel.schema import Record as RefRecord
    from repro.objectmodel.schema import S as RS, f64 as rf64, i64 as ri64
    from repro_torch.objectmodel.schema import S, Record, f64, i64

    class GRow(RefRecord):
        k1: ri64
        k2: RS(2)
        v1: rf64
        v2: ri64

    class PortGRow(Record):
        __type_name__ = "GRow"
        k1: i64
        k2: S(2)
        v1: f64
        v2: i64

    return GRow, PortGRow


def _rows(n=400, seed=0):
    _, schema = _schemas()
    rng = np.random.default_rng(seed)
    return schema.pack(k1=rng.integers(0, 7, n),
                       k2=rng.choice([b"aa", b"bb", b"cc"], n),
                       v1=rng.normal(0, 100, n),
                       v2=rng.integers(-50, 50, n))


def _collect_both(build, records, parts=3):
    """``build(ds, agg, constant)`` on the reference's numpy backend and on
    the port's three backends; asserts the four results byte-identical and
    returns the reference's."""
    import repro.core as ref_core
    import repro_torch.core as port_core
    ref_schema, schema = _schemas()
    sess = ref_core.Session(num_partitions=parts, expr_backend="numpy")
    results = [build(sess.load("g", records, ref_schema), ref_core.agg,
                     ref_core.constant).collect()]
    for be in PORT_BACKENDS:
        sess = port_session(be, num_partitions=parts)
        results.append(build(sess.load("g", records, schema), port_core.agg,
                             port_core.constant).collect())
    assert_bytes_equal(results)
    return results[0]


def test_multi_aggregate_matrix_byte_identical():
    r = _collect_both(
        lambda ds, agg, _: (ds.filter(lambda g: g.v2 > -40)
                              .group_by("k1", "k2")
                              .agg(total=agg.sum("v1"), lo=agg.min("v1"),
                                   hi=agg.max("v1"), n=agg.count(),
                                   avg_v2=agg.mean("v2"),
                                   rev=agg.sum(lambda g: g.v1 * g.v2))),
        _rows())
    assert sorted(r) == ["avg_v2", "hi", "k1", "k2", "lo", "n", "rev",
                         "total"]


def test_segment_reduction_of_the_reference_case_byte_identical():
    """The reference's forced device-reducer case (test_groupby.py),
    whose own path needs the jax backend."""
    _collect_both(
        lambda ds, agg, _: ds.group_by("k1", "k2").agg(
            s=agg.sum("v1"), lo=agg.min("v1"), hi=agg.max("v2"),
            m=agg.mean("v1"), n=agg.count()),
        _rows(500, seed=8))


def test_empty_input_and_empty_groups():
    r = _collect_both(
        lambda ds, agg, _: ds.group_by("k1").agg(n=agg.count(),
                                                 s=agg.sum("v1")),
        _rows(0))
    assert all(len(np.asarray(v)) == 0 for v in r.values())
    r = _collect_both(
        lambda ds, agg, _: (ds.filter(lambda g: g.v2 > 10_000)
                              .group_by("k1").agg(n=agg.count())),
        _rows(64))
    assert all(len(np.asarray(v)) == 0 for v in r.values())


def test_single_row_and_constant_key_global_aggregate():
    r = _collect_both(
        lambda ds, agg, _: ds.group_by("k1").agg(n=agg.count(),
                                                 m=agg.mean("v1")),
        _rows(1, seed=3))
    assert np.asarray(r["n"]).tolist() == [1]
    records = _rows(128, seed=4)
    r = _collect_both(
        lambda ds, agg, constant: (ds.group_by(lambda g: constant(0))
                                     .agg(total=agg.sum("v2"),
                                          n=agg.count())),
        records)
    assert np.asarray(r["total"]).tolist() == [records["v2"].sum()]


def test_boolean_indicator_sum_counts_not_saturates(torch):
    r = _collect_both(
        lambda ds, agg, _: (ds.group_by("k1")
                              .agg(pos=agg.sum(lambda g: g.v1 > 0),
                                   frac=agg.mean(lambda g: g.v1 > 0))),
        _rows(200, seed=6))
    assert np.asarray(r["pos"]).dtype == np.int64
    from repro_torch.core.relops import device_segment_reducer
    red = device_segment_reducer(("sum",), torch.device("cpu"))
    out, = red(np.array([0, 0, 1]), 2, [np.array([True, True, False])])
    assert out.dtype == np.int64 and out.tolist() == [2, 0]
    assert red(np.array([0]), 1, [np.array([b"x"])]) is None  # not numeric


@pytest.mark.parametrize("combiner", ["sum", "min", "max"])
def test_legacy_aggregate_wrapper_byte_identical(combiner):
    _collect_both(
        lambda ds, agg, _: ds.aggregate(key="k1", value="v1",
                                        combiner=combiner),
        _rows())


@pytest.mark.parametrize("case", range(8))
def test_sampled_random_key_value_combiner_sets(case):
    """tests/test_groupby.py's deterministic sample (seed 9, 8 cases), each
    case one test here."""
    rng = np.random.default_rng(9)
    all_kinds = ["sum", "min", "max", "count", "mean"]
    for c in range(case + 1):
        keys = (["k1"], ["k2"], ["k1", "k2"])[c % 3]
        n_outs = int(rng.integers(1, 5))
        outs = [(all_kinds[int(rng.integers(0, 5))],
                 ("v1", "v2")[int(rng.integers(0, 2))])
                for _ in range(n_outs)]
        n = int(rng.integers(0, 150))

    def build(ds, agg, _):
        named = {f"o{i}": (getattr(agg, k)(v) if k != "count"
                           else agg.count()) for i, (k, v) in enumerate(outs)}
        return ds.group_by(*keys).agg(**named)

    _collect_both(build, _rows(n, seed=case), parts=2)


def _segment_values(rng, dt, rows):
    """Values of dt: random, and for floats NaN (one kind), +-0.0 and +inf
    (no -inf: inf - inf makes a NaN whose bits then meet other NaNs, where
    numpy's choice depends on its code path)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.random(rows) < 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, rows, dtype=dt, endpoint=True)
    v = (rng.standard_normal(rows)
         * rng.choice([1e-3, 1.0, 1e3], rows)).astype(dt)
    k = rng.random(rows)
    v[k < 0.01] = np.nan
    v[(k >= 0.01) & (k < 0.03)] = 0.0
    v[(k >= 0.03) & (k < 0.05)] = -0.0
    v[(k >= 0.05) & (k < 0.06)] = np.inf
    return v


def _check_segment_reduce(torch, rng, groups, rows, vals):
    """One K2 call per combiner over ``vals`` (one column each) through
    ``ops.segment_reduce`` (the plain version on the CPU), against numpy's
    indexed loops."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import acc_dtype
    from repro_torch.kernels.transfer import to_device
    inv = rng.integers(0, groups, rows).astype(np.int64)
    inv[:groups] = rng.permutation(groups)
    for comb in ("sum", "min", "max"):
        flat = to_device([inv] + vals, torch.device("cpu"))
        got = ops.segment_reduce(
            flat[0], groups, [t.reshape(v.shape) for t, v in
                              zip(flat[1:], vals)],
            [v.dtype for v in vals], [comb] * len(vals))
        for g, v in zip(got, vals):
            acc = acc_dtype(v.dtype, comb)
            shape = (groups,) + v.shape[1:]
            if comb == "sum":
                want = np.zeros(shape, acc)
                np.add.at(want, inv, v)
            else:
                want = np.full(shape, np.inf if comb == "min" else -np.inf)
                with np.errstate(invalid="ignore"):
                    (np.minimum if comb == "min"
                     else np.maximum).at(want, inv, v)
            assert g.numpy().view(acc).tobytes() == want.tobytes(), \
                (groups, comb, v.dtype, v.shape)


@pytest.mark.parametrize("dtype", ["?", "i1", "i2", "i4", "i8", "u1", "u2",
                                   "u4", "u8", "f2", "f4", "f8"])
def test_segment_reduce_plain_version_gives_numpy_bytes(torch, dtype):
    """K2's plain version, sum / min / max at 1, 3 and 500 groups, one
    column and a (rows, 3) one, against numpy's indexed loops."""
    rng = np.random.default_rng(7)
    for groups, rows in ((1, 300), (3, 5000), (500, 4000)):
        _check_segment_reduce(torch, rng, groups, rows, [
            _segment_values(rng, dtype, rows),
            _segment_values(rng, dtype, 3 * rows).reshape(rows, 3)])


@pytest.mark.parametrize("groups", [3, 10_000])
def test_segment_reduce_plain_version_on_the_chip_smoke_matrix(torch,
                                                               groups):
    """chip_smoke.py's K2 cases: float64 with NaN and +-0.0, int32 (the
    sums wrap), bool (summed into int64), a (rows, 3) float32 column."""
    rng = np.random.default_rng(groups)
    rows = 30_000
    _check_segment_reduce(torch, rng, groups, rows, [
        _segment_values(rng, "f8", rows),
        rng.integers(-2**31, 2**31 - 1, rows, dtype=np.int32),
        rng.random(rows) < 0.5,
        rng.standard_normal((rows, 3)).astype(np.float32)])
