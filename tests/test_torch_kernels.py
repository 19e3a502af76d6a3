"""The port's kernel entries against the reference's, on the CPU.

``repro_torch.kernels.ops`` takes each kernel's plain version for CPU
tensors. ``repro.kernels.ops.flash_attention`` runs the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it; ``moe_gather`` is held
against the reference's oracle ``repro.kernels.ref.moe_gather_ref``, bit
for bit (the reference's Pallas ``moe_gather`` does not run in interpret
mode on this JAX). The same numpy-seeded inputs go through both.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 for attention, exact for the gather. The CUDA kernels themselves
are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _inputs(torch, B, S, T, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (1, 100, 100, 4, 4, 32, True),    # ragged vs the block size
    (2, 128, 128, 4, 2, 64, True),    # GQA
    (2, 64, 192, 8, 2, 16, False),    # T != S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(torch, B, S, T, H, K, hd, causal,
                                           dtype):
    from repro_torch.kernels import ops
    (jq, jk, jv), (tq, tk, tv) = _inputs(torch, B, S, T, H, K, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    _, (q, k, v) = _inputs(torch, 1, 8, 8, 2, 1, 16, "float32")
    x, ids, keep = torch.zeros(4, 8), torch.zeros(6, dtype=torch.int32), \
        torch.ones(6, dtype=torch.bool)
    scan = [torch.zeros(s) for s in ((1, 5, 8), (8, 4), (1, 5, 4), (1, 5, 4),
                                     (1, 5, 8))]
    pages = torch.zeros(3, 4, 1, 16)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.moe_gather(x, ids, keep)
    ops.ssm_scan(*scan)
    ops.paged_attention(q[:, 0], pages, pages, tables, lengths)
    ops.paged_attention_partial(q[:, 0], pages, pages, tables, lengths)
    assert ops.launch_counts() == {"flash_attention": 0, "paged_attention": 0,
                                   "paged_attention_partial": 0,
                                   "moe_gather": 0, "moe_gather_bwd": 0,
                                   "ssm_scan": 0, "ssm_scan_bwd": 0,
                                   "expr_core": 0, "segment_reduce": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)  # the kernel wrapper never runs CPU
    with pytest.raises(ValueError, match="CUDA"):
        moe_dispatch.moe_gather(x, ids, keep)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan(*scan)
    assert fa.LAUNCHES.count == 0 == moe_dispatch.LAUNCHES.count
    assert ss.LAUNCHES.count == 0


@pytest.mark.parametrize("shapes", [
    ((1, 8, 3, 16), (1, 8, 2, 16)),   # H % K != 0
    ((1, 8, 2, 16), (2, 8, 1, 16)),   # batch differs
    ((1, 8, 2, 16), (1, 8, 1, 32)),   # head dim differs
    ((8, 2, 16), (8, 1, 16)),         # not 4-d
])
def test_flash_attention_rejects_mismatched_shapes(torch, shapes):
    from repro_torch.kernels import ops
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)


def _bits(a):
    """The raw bits of a float array (bf16 or f32), so -0.0 != 0.0."""
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("T,d,S", [(64, 48, 40), (128, 16, 128), (10, 8, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_matches_reference_oracle(torch, T, d, S, dtype):
    """Unkept slots hold -1 as the model's dispatch leaves them; kept ids
    out of range are clamped as the reference's gather clamps them."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, d), dtype=np.float32)
    x[0, 0] = -0.0
    ids = rng.integers(0, T, S).astype(np.int32)
    keep = rng.random(S) < 0.7
    ids[~keep] = -1
    ids[np.flatnonzero(keep)[:2]] = [T + 3, -5]
    want = jref.moe_gather_ref(jnp.asarray(x).astype(jnp.dtype(dtype)),
                               jnp.asarray(ids), jnp.asarray(keep))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for fn in (ref.moe_gather_ref, ops.moe_gather):
        got = fn(tx, torch.from_numpy(ids), torch.from_numpy(keep))
        assert got.dtype == tx.dtype and got.shape == (S, d)
        bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        np.testing.assert_array_equal(bits.numpy(), _bits(want))


@pytest.mark.parametrize("shapes", [
    ((4, 8), (6,), (5,)),     # keep and token_ids differ
    ((4, 8), (6, 1), (6, 1)),  # ids not 1-d
    ((32,), (6,), (6,)),      # x not 2-d
    ((0, 8), (6,), (6,)),     # no rows to gather from
])
def test_moe_gather_rejects_mismatched_shapes(torch, shapes):
    from repro_torch.kernels import ops
    xs, ids, keep = shapes
    with pytest.raises(ValueError):
        ops.moe_gather(torch.zeros(xs), torch.zeros(ids, dtype=torch.int32),
                       torch.ones(keep, dtype=torch.bool))


def _scan_inputs(Bt, L, di, N, seed=3):
    """tests/test_kernels.py's distribution, numpy-seeded: dt = 0.1
    softplus(normal), A = -exp(0.3 normal), B, C, x standard normal."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, di)))) * 0.1
    A = -np.exp(rng.standard_normal((di, N)) * 0.3)
    B, C = rng.standard_normal((2, Bt, L, N))
    x = rng.standard_normal((Bt, L, di))
    return [a.astype(np.float32) for a in (dt, A, B, C, x)]


@pytest.mark.parametrize("Bt,L,di,N,bd", [
    (2, 33, 64, 8, 32), (1, 64, 128, 16, 128), (3, 16, 32, 4, 16),
    (2, 45, 64, 16, 64),  # L not a multiple of the kernel's 16-step chunk
])
def test_ssm_scan_matches_reference(torch, Bt, L, di, N, bd):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops, ref
    arrs = _scan_inputs(Bt, L, di, N)
    dt, A, B, C, x = (jnp.asarray(a) for a in arrs)
    pallas = np.asarray(jops.ssm_scan(dt, A, B, C, x, block_d=bd))
    oracle = np.stack([np.asarray(jref.ssm_scan_ref(dt[b], A, B[b], C[b],
                                                    x[b]))
                       for b in range(Bt)])
    for fn in (ref.ssm_scan_ref, ops.ssm_scan):
        got = fn(*(torch.from_numpy(a) for a in arrs))
        assert got.dtype == torch.float32 and got.shape == (Bt, L, di)
        for want in (pallas, oracle):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("shapes", [
    ((1, 5, 8), (8, 4), (1, 5, 4), (1, 5, 4), (1, 5, 7)),  # x vs dt
    ((1, 5, 8), (7, 4), (1, 5, 4), (1, 5, 4), (1, 5, 8)),  # A's di
    ((1, 5, 8), (8, 4), (1, 5, 3), (1, 5, 3), (1, 5, 8)),  # B's N vs A's
    ((1, 5, 8), (8, 4), (1, 5, 4), (1, 6, 4), (1, 5, 8)),  # C vs B
    ((5, 8), (8, 4), (5, 4), (5, 4), (5, 8)),              # no batch dim
])
def test_ssm_scan_rejects_mismatched_shapes(torch, shapes):
    from repro_torch.kernels import ops
    with pytest.raises(ValueError):
        ops.ssm_scan(*(torch.zeros(s) for s in shapes))
