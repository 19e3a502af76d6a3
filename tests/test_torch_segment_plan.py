"""K2's plan and plain versions on the CPU, held to the reference's host
scatter (``repro.core.relops._COMBINE``: ``np.add.at``, ``np.minimum.at``,
``np.maximum.at``): the radix sort plan (``sort_plan``,
``sort_order_ref``) against a stable argsort at 3, 2^20 + 1 and ~2.4 M
groups; the two-level min / max combine (``fold_pieces_ref``) at random
piece boundaries over +-0.0 ties and NaN; ``segment_reduce_ref`` at many
groups and at groups longer than a piece; and the staging buffer's
packing of a partition's batches against ``np.concatenate``."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def torch():
    return pytest.importorskip("torch")


def _group_ids(rng, rows, n, dropped=0.0):
    """rows ids in [0, n), every group hit when rows allow; a share
    ``dropped`` outside [0, n) (-1, n, n + 7), which the scatter drops."""
    inv = rng.integers(0, n, rows).astype(np.int64)
    inv[:min(n, rows)] = rng.permutation(n)[:min(n, rows)]
    out = rng.random(rows) < dropped
    inv[out] = rng.choice([-1, n, n + 7], int(out.sum()))
    return inv


@pytest.mark.parametrize("n", [3, 2**20 + 1, 2_400_000])
def test_radix_plan_is_a_stable_argsort(torch, n):
    """The plan's passes cover the keys with digits of at most 11 bits
    and counts of at most MAX_COUNTS, keep 1,024 warps or more (a warp for
    every 512 rows below), and their plain version orders the rows as a
    stable argsort of the keys (a dropped row as key n, last)."""
    from repro_torch.kernels import segment_reduce as sr
    rng = np.random.default_rng(n)
    rows = max(50_000, n + n // 4)
    inv = _group_ids(rng, rows, n, dropped=0.01)
    plan = sr.sort_plan(rows, n)
    assert plan.bits <= sr.MAX_DIGIT_BITS
    assert plan.passes * plan.bits >= n.bit_length()
    assert plan.counts <= sr.MAX_COUNTS
    assert plan.chunks >= min(rows // (2 * sr.ROWS_PER_CHUNK), 1024)
    assert plan.chunks * plan.chunk >= rows
    assert plan.passes == (1 if n == 3 else 2)
    order, starts = sr.sort_order_ref(torch.from_numpy(inv), n, plan)
    keys = np.where((inv >= 0) & (inv < n), inv, n)
    want = np.argsort(keys, kind="stable")
    assert np.array_equal(order.numpy(), want)
    assert np.array_equal(starts.numpy(),
                          np.searchsorted(keys[want], np.arange(n + 1)))


def _tie_values(rng, shape, neg_inf=True):
    """float64 values full of ties: +-0.0, a few small integers, +inf
    (and -inf) and NaN of one kind (numpy keeps either of two different
    NaNs by its code path, so a sum gets no -inf: inf - inf makes the
    default NaN)."""
    v = rng.choice([0.0, -0.0, 1.0, -1.0, 2.0, np.inf]
                   + ([-np.inf] if neg_inf else []), shape)
    v[rng.random(shape) < 0.002] = np.nan
    return v


@pytest.mark.parametrize("comb", ["min", "max"])
def test_two_level_min_max_combine_gives_numpy_bytes(torch, comb):
    """fold_pieces_ref: each run between random cuts folded alone, the
    partials combined left to right, equals numpy's loop over the whole
    group bit for bit (the first NaN, else the later of equal values,
    -0.0 against +0.0 too)."""
    from repro.core.relops import _COMBINE
    from repro_torch.kernels.segment_reduce import fold_pieces_ref
    rng = np.random.default_rng(5)
    for _ in range(40):
        rows = int(rng.integers(1, 3000))
        seg = _tie_values(rng, (rows, 3))
        if rng.random() < 0.5:
            seg[rng.random((rows, 3)) < 0.5] = np.nan  # NaN in most pieces
        cuts = sorted(rng.choice(rows, int(rng.integers(0, 12))).tolist())
        got = fold_pieces_ref(torch.from_numpy(seg), comb, cuts)
        with np.errstate(invalid="ignore"):
            want = _COMBINE[comb](None, np.zeros(rows, np.int64), seg, 1)[0]
        assert got.numpy().tobytes() == want.tobytes(), (rows, cuts)


def _columns(rng, rows):
    f64 = rng.standard_normal(rows) * 10.0 ** rng.integers(-3, 4, rows)
    f64[rng.random(rows) < 0.01] = np.nan
    f64[rng.random(rows) < 0.02] = 0.0
    f64[rng.random(rows) < 0.02] = -0.0
    return [f64, rng.integers(-2**31, 2**31 - 1, rows, dtype=np.int32),
            rng.random(rows) < 0.5,
            _tie_values(rng, (rows, 2), neg_inf=False).astype(np.float32),
            rng.integers(0, 2**64 - 1, rows, dtype=np.uint64)]


@pytest.mark.parametrize("n,rows", [(2**20 + 1, 1_500_000), (3, 40_000)])
def test_segment_reduce_plain_version_at_many_and_long_groups(torch, n,
                                                              rows):
    """segment_reduce_ref over 2^20 + 1 groups (two radix passes) and over
    3 groups of ~13,000 rows (min / max in pieces), with dropped rows:
    the reference's host scatter's bytes, every column and combiner."""
    from repro.core.relops import _COMBINE
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels.transfer import to_device
    rng = np.random.default_rng(n)
    inv = _group_ids(rng, rows, n, dropped=0.001)
    kept = (inv >= 0) & (inv < n)
    vals = _columns(rng, rows)
    for comb in ("sum", "min", "max"):
        flat = to_device([inv] + vals, torch.device("cpu"))
        got = sr.segment_reduce_ref(
            flat[0], n, [t.reshape(v.shape) for t, v in zip(flat[1:], vals)],
            [v.dtype for v in vals], [comb] * len(vals))
        for g, v in zip(got, vals):
            with np.errstate(invalid="ignore", over="ignore"):
                want = _COMBINE[comb](None, inv[kept], v[kept], n)
            acc = sr.acc_dtype(v.dtype, comb)
            assert want.dtype == acc
            assert g.numpy().view(acc).tobytes() == want.tobytes(), \
                (comb, v.dtype, v.shape)


def test_staging_packs_batches_as_concatenate(torch):
    """Staging.pack: each column from its parts (a partition's batches,
    1-D and 2-D, every holder width) gives np.concatenate's bytes, at
    16-byte aligned offsets, and a reused buffer grows only when asked
    for more."""
    from repro_torch.kernels.transfer import Staging, torch_dtype
    rng = np.random.default_rng(3)
    stage = Staging(pinned=False)
    for rounds in range(3):
        sizes = rng.integers(0, 900, 4)
        columns = [
            [rng.integers(0, 5, s).astype(np.int64) for s in sizes],
            [rng.standard_normal(s) for s in sizes],
            [rng.random(s) < 0.5 for s in sizes],
            [rng.integers(0, 2**64 - 1, s, dtype=np.uint64) for s in sizes],
            [rng.standard_normal((s, 3)).astype(np.float16) for s in sizes],
            [rng.integers(-99, 99, s).astype(np.int8)[::-1] for s in sizes],
        ]
        views, total = stage.pack(columns)
        assert stage.buf.numel() >= total
        for parts, view in zip(columns, views):
            want = np.concatenate(parts)
            assert view.dtype == torch_dtype(want.dtype)
            assert view.data_ptr() % 16 == 0
            assert view.numpy().tobytes() == want.tobytes()
    size = stage.buf.numel()
    stage.pack([[np.zeros(10)]])
    assert stage.buf.numel() == size
    stage.pack([[np.zeros(size)]])
    assert stage.buf.numel() >= 8 * size
    with pytest.raises(TypeError, match="one dtype"):
        stage.pack([[np.zeros(3), np.zeros(3, np.float32)]])
