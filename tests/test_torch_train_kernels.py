"""The plain backwards of the port's two training kernels against the
reference's autodiff, on the CPU.

``ref.moe_gather_bwd_ref`` is what the CUDA ``moe_gather_bwd`` computes
(each token's kept slots added in increasing slot order in float32,
rounded once); ``ref.ssm_scan_bwd_ref`` is the reverse-time scan that the
CUDA ``ssm_scan_bwd`` runs. Each is held against ``jax.grad`` through the
reference's oracle (``repro.kernels.ref.moe_gather_ref``,
``repro.kernels.ref.ssm_scan_ref``) on numpy-seeded inputs: ragged slot
counts, dropped slots and ids out of range for the gather; strided B and
C (column slices of one projection, as ``mamba_apply`` passes them) and a
state count below 16 for the scan. Tolerances, float32: the gather's
gradient adds at most a few rows per token, in another order in XLA's
scatter-add: 1e-6 of the largest value; the scan's gradients are long
sequential sums taken in the same order on both sides but rounded at
other places: 1e-5 of each output's largest value. On the CPU the port's
``ops`` entries differentiate through the plain forward versions; they
are held against the plain backwards too (the kernels' contract on the
card, checked by tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _gather_inputs(T, d, S, n_kept, seed, bad_ids=False):
    """S slots, n_kept of them kept (ids drawn with repeats, at most
    ceil(n_kept / T) a token), the rest -1 or, with ``bad_ids``, ids out of
    range that keep clamps away."""
    rng = np.random.default_rng(seed)
    ids = np.full(S, -1, np.int32)
    slots = rng.choice(S, n_kept, replace=False)
    ids[slots] = rng.permutation(np.resize(np.arange(T), n_kept))
    keep = ids >= 0
    if bad_ids:
        ids[~keep] = rng.integers(T, 2 * T, (~keep).sum())
    g = rng.standard_normal((S, d)).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    return x, ids, keep, g


@pytest.mark.parametrize("T,d,S,n_kept,bad_ids", [
    (16, 8, 40, 32, False),    # top-2 of 16 tokens into 40 slots
    (16, 8, 37, 20, False),    # ragged S, 12 slots dropped
    (10, 5, 64, 40, True),     # 4 slots a token, unkept ids out of range
    (50, 16, 7, 7, False),     # most tokens have no slot
    (8, 4, 30, 0, False),      # nothing kept
])
def test_moe_gather_bwd_ref_matches_jax_grad(torch, T, d, S, n_kept,
                                             bad_ids):
    from repro_torch.kernels import ops, ref
    x, ids, keep, g = _gather_inputs(T, d, S, n_kept, seed=T + S)
    want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jref.moe_gather_ref(xx, jnp.asarray(ids),
                                               jnp.asarray(keep))
                           * jnp.asarray(g)))(jnp.asarray(x)))
    tids, tkeep, tg = (torch.from_numpy(a) for a in (ids, keep, g))
    got = ref.moe_gather_bwd_ref(tg, tids, tkeep, T)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    # the port's entry on the CPU: autograd through the plain forward
    tx = torch.from_numpy(x).requires_grad_(True)
    dx, = torch.autograd.grad(ops.moe_gather(tx, tids, tkeep), tx, tg)
    assert torch.equal(dx, got)


def test_moe_gather_bwd_ref_sums_in_slot_order_in_float32(torch):
    """bf16 rows added in float32 in increasing slot order, rounded once:
    three slots of one token whose bf16 running sum would lose the small
    middle term."""
    from repro_torch.kernels import ref
    g = torch.tensor([[1.0], [2.0 ** -9], [2.0 ** -9], [5.0]],
                     dtype=torch.bfloat16)
    ids = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    keep = torch.tensor([True, True, True, True])
    got = ref.moe_gather_bwd_ref(g, ids, keep, 2)
    want = (torch.tensor([1.0 + 2.0 ** -8, 5.0])).to(torch.bfloat16)
    assert torch.equal(got[:, 0], want)
    order, offsets = ref.gather_inverse(ids, keep, 2)
    assert order.tolist()[:4] == [0, 1, 2, 3] and offsets.tolist() == [0, 3,
                                                                        4]


def _scan_inputs(Bt, L, di, N, seed):
    """tests/test_kernels.py's distribution: dt = 0.1 softplus(normal), A =
    -exp(0.3 normal), B, C, x and g standard normal; B and C the columns
    R .. R+N and R+N .. R+2N of one (Bt, L, R + 2N) projection."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, di)))) * 0.1
    A = -np.exp(rng.standard_normal((di, N)) * 0.3)
    proj = rng.standard_normal((Bt, L, 5 + 2 * N))
    x, g = rng.standard_normal((2, Bt, L, di))
    return [a.astype(np.float32) for a in (dt, A, proj, x, g)]


@pytest.mark.parametrize("Bt,L,di,N", [
    (2, 33, 24, 8), (1, 64, 40, 16), (3, 17, 5, 4), (2, 1, 8, 16)])
def test_ssm_scan_bwd_ref_matches_jax_grad(torch, Bt, L, di, N):
    from repro_torch.kernels import ops, ref
    dt, A, proj, x, g = _scan_inputs(Bt, L, di, N, seed=L + di)

    def loss(dt, A, proj, x):
        B, C = proj[..., 5:5 + N], proj[..., 5 + N:]
        y = jnp.stack([jref.ssm_scan_ref(dt[b], A, B[b], C[b], x[b])
                       for b in range(Bt)])
        return jnp.sum(y * jnp.asarray(g))

    jd = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (dt, A, proj, x)))
    jd = [np.asarray(a) for a in jd]
    want = {"ddt": jd[0], "dA": jd[1], "dB": jd[2][..., 5:5 + N],
            "dC": jd[2][..., 5 + N:], "dx": jd[3]}
    tproj = torch.from_numpy(proj)
    tB, tC = tproj[..., 5:5 + N], tproj[..., 5 + N:]  # strided views
    args = [torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
            torch.from_numpy(x)]
    got = ref.ssm_scan_bwd_ref(*args, torch.from_numpy(g))
    for name, t in zip(("ddt", "dA", "dB", "dC", "dx"), got):
        w = want[name]
        assert t.shape == w.shape and t.is_contiguous()
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    # the port's entry on the CPU: autograd through the plain forward,
    # into the projection through B's and C's strides
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (dt, A, proj, x)]
    lp = leaves[2]
    y = ops.ssm_scan(leaves[0], leaves[1], lp[..., 5:5 + N],
                     lp[..., 5 + N:], leaves[3])
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(auto[2][..., 5:5 + N].numpy(),
                               got[2].numpy(), rtol=0,
                               atol=1e-5 * np.abs(want["dB"]).max())
    assert not auto[2][..., :5].any()  # dt_low's columns get nothing here


def test_flash_and_paged_attention_refuse_a_gradient(torch):
    """P1 and P2 have no backward kernel: asked for a gradient they raise
    on either device, and serve as before under no_grad."""
    from repro_torch.kernels import ops
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    k = v = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.flash_attention(q, k, v)
    pages = torch.zeros((2, 4, 2, 16))
    tables = torch.zeros((1, 1), dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.paged_attention(q[:, 0], pages, pages, tables, lengths)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape
        assert ops.paged_attention(q[:, 0], pages, pages, tables,
                                   lengths).shape == (1, 2, 16)
