"""The plain backwards of the port's two training kernels against the
reference's autodiff, on the CPU.

``ref.moe_gather_bwd_ref`` is what the CUDA ``moe_gather_bwd`` computes
(each token's kept slots, read from a (T, k) map of slots, added in
increasing slot order in float32, rounded once); ``ref.ssm_scan_bwd_ref``
is the reverse-time scan that the CUDA ``ssm_scan_bwd`` runs, from the
checkpoints (the state every 8 steps) that the checkpointing forward
keeps (``ref.ssm_scan_checkpointed_ref``). Each is held against
``jax.grad`` through the reference's oracle
(``repro.kernels.ref.moe_gather_ref``, ``repro.kernels.ref.ssm_scan_ref``)
on numpy-seeded inputs: ragged slot counts, dropped slots and ids out of
range for the gather; strided B and C (column slices of one projection, as
``mamba_apply`` passes them) and a state count below 16 for the scan. The
map that ``moe_apply`` hands over is held against the grouping of
``ref.gather_inverse``, and the checkpoints against the reference scan's
states. Tolerances, float32: the gather's gradient adds at most a few rows
per token, in another order in XLA's scatter-add: 1e-6 of the largest
value; the scan's gradients are long sequential sums taken in the same
order on both sides but rounded at other places: 1e-5 of each output's
largest value, and the states 1e-5 of their largest. On the CPU the port's
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
    slots = ref.gather_slots(tids, tkeep, T)
    got = ref.moe_gather_bwd_ref(tg, slots)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    # the port's entry on the CPU: autograd through the plain forward,
    # with and without the map
    for kw in ({}, {"slots": slots}):
        tx = torch.from_numpy(x).requires_grad_(True)
        dx, = torch.autograd.grad(ops.moe_gather(tx, tids, tkeep, **kw), tx,
                                  tg)
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
    slots = ref.gather_slots(ids, keep, 2)
    assert slots.tolist() == [[0, 1, 2], [3, 4, 4]]  # S = 4: skipped
    got = ref.moe_gather_bwd_ref(g, slots)
    want = (torch.tensor([1.0 + 2.0 ** -8, 5.0])).to(torch.bfloat16)
    assert torch.equal(got[:, 0], want)
    order, offsets = ref.gather_inverse(ids, keep, 2)
    assert order.tolist()[:4] == [0, 1, 2, 3] and offsets.tolist() == [0, 3,
                                                                        4]
    # today's order in bf16, bit for bit: a dropped slot between two kept
    # ones and the slots given in another row order change nothing
    gapped = torch.tensor([[0, 4, 1, 2], [4, 3, 4, 4]])
    assert torch.equal(ref.moe_gather_bwd_ref(g, gapped).view(torch.int16),
                       got.view(torch.int16))


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


@pytest.mark.parametrize("T,d,S,n_kept,bad_ids", [
    (16, 8, 40, 32, False), (16, 8, 37, 20, False), (10, 5, 64, 40, True),
    (50, 16, 7, 7, False), (8, 4, 30, 0, False)])
def test_gather_slots_lists_what_gather_inverse_groups(torch, T, d, S,
                                                       n_kept, bad_ids):
    """The map built from ids and keep flags: row t holds the kept slots
    that ``gather_inverse`` groups under token t, in its order, then S."""
    from repro_torch.kernels import ref
    _, ids, keep, _ = _gather_inputs(T, d, S, n_kept, seed=T + S,
                                     bad_ids=bad_ids)
    tids, tkeep = torch.from_numpy(ids), torch.from_numpy(keep)
    slots = ref.gather_slots(tids, tkeep, T)
    order, offsets = ref.gather_inverse(tids, tkeep, T)
    assert slots.dtype == torch.int64 and slots.shape[0] == T
    for t in range(T):
        row = slots[t].tolist()
        mine = order[offsets[t]:offsets[t + 1]].tolist()
        assert row == mine + [S] * (slots.shape[1] - len(mine))


def test_moe_apply_hands_over_the_slots_gather_inverse_groups(torch):
    """reduced_config qwen2-moe routing with its capacity cut so that slots
    are dropped: the (T, k) map ``moe_apply`` gives ``ops.moe_gather``
    lists, for each token, exactly the kept slots that ``gather_inverse``
    groups under it, in the same order, dropped ones at S = E * C."""
    import dataclasses

    from repro.configs import get_arch as jget_arch
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.kernels import ref
    from repro_torch.models import Ctx, moe
    cfg = dataclasses.replace(reduced_config(get_arch("qwen2_moe")),
                              capacity_factor=0.25)
    assert jget_arch("qwen2_moe").n_experts == get_arch("qwen2_moe").n_experts
    rng = np.random.default_rng(7)
    p = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape),
                                                 dtype=np.float32) * 0.1)
         for k, v in moe.moe_defs(cfg).items() if not isinstance(v, dict)}
    for k, v in moe.moe_defs(cfg).items():
        if isinstance(v, dict):
            p[k] = {kk: torch.from_numpy(rng.standard_normal(
                tuple(vv.shape), dtype=np.float32) * 0.1)
                for kk, vv in v.items()}
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model),
                                             dtype=np.float32))
    seen = {}
    real = moe.kops.moe_gather

    def record(xt, token_ids, keep, slots=None):
        seen.update(token_ids=token_ids, keep=keep, slots=slots)
        return real(xt, token_ids, keep, slots=slots)

    moe.kops.moe_gather = record
    try:
        moe.moe_apply(cfg, p, x, Ctx())
    finally:
        moe.kops.moe_gather = real
    T, S = x.shape[0] * x.shape[1], seen["token_ids"].shape[0]
    slots = seen["slots"]
    assert slots.shape == (T, cfg.top_k) and slots.dtype == torch.int64
    assert (slots == S).any(), "no slot was dropped"
    order, offsets = ref.gather_inverse(seen["token_ids"], seen["keep"], T)
    for t in range(T):
        row = slots[t]
        assert row[row < S].tolist() == \
            order[offsets[t]:offsets[t + 1]].tolist()
    assert torch.equal(ref.gather_slots(seen["token_ids"], seen["keep"], T)
                       .sort(1).values[:, :cfg.top_k], slots.sort(1).values)


@pytest.mark.parametrize("Bt,L,di,N", [
    (2, 33, 24, 8), (1, 64, 40, 16), (3, 17, 5, 4), (2, 1, 8, 16),
    (1, 50, 6, 3)])
def test_ssm_scan_checkpointed_ref_keeps_the_states_every_8_steps(
        torch, Bt, L, di, N):
    """ck[:, k] is the state before step 8 k (the kernels' spacing,
    ``ssm_scan.BWD_CHUNK``): bit for bit the port's plain loop's, and
    within 1e-5 of the reference scan's, read from
    ``repro.kernels.ref.ssm_scan_ref`` with C a unit vector (y_t[c] is then
    h_t[c, n]); y is ``ssm_scan_ref``'s bits; L ragged against 8."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    dt, A, proj, x, _ = _scan_inputs(Bt, L, di, N, seed=L + di)
    B = proj[..., 5:5 + N]
    args = [torch.from_numpy(a) for a in (dt, A)] + \
        [torch.from_numpy(B), torch.from_numpy(proj[..., 5 + N:]),
         torch.from_numpy(x)]
    y, ck = ref.ssm_scan_checkpointed_ref(*args)
    every = ss.BWD_CHUNK
    assert every == 8
    assert ck.shape == (Bt, -(-L // every), di, N) \
        and ck.dtype == torch.float32
    assert torch.equal(y, ref.ssm_scan_ref(*args))
    h = torch.zeros((Bt, di, N))
    tdt, tA, tB, tx = (torch.from_numpy(a) for a in (dt, A, B, x))
    states = []
    for t in range(L):
        states.append(h)
        h = torch.exp(tdt[:, t, :, None] * tA) * h + \
            (tdt[:, t, :, None] * tx[:, t, :, None]) * tB[:, t, None, :]
    assert torch.equal(ck, torch.stack(states[::every], 1))
    # the reference's states after each step: y with C = e_n
    for n in range(N):
        unit = np.zeros((L, N), np.float32)
        unit[:, n] = 1.0
        after = np.stack([np.asarray(jref.ssm_scan_ref(
            jnp.asarray(dt[b]), jnp.asarray(A), jnp.asarray(B[b]),
            jnp.asarray(unit), jnp.asarray(x[b]))) for b in range(Bt)])
        before = np.concatenate([np.zeros((Bt, 1, di), np.float32),
                                 after[:, :-1]], 1)  # (Bt, L, di)
        want = before[:, ::every]
        got = ck[..., n].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
            1.0, np.abs(want).max()), err_msg=f"state {n}")


@pytest.mark.parametrize("Bt,L,di,N", [
    (2, 33, 24, 8), (1, 64, 40, 16), (3, 17, 5, 4), (2, 1, 8, 16)])
def test_ssm_scan_bwd_ref_from_checkpoints_matches_jax_grad(torch, Bt, L,
                                                            di, N):
    """``ssm_scan_bwd_ref`` given the checkpointing forward's checkpoints:
    within 1e-5 of each output's largest value against ``jax.grad``, and
    the bits of the call that computes them itself."""
    from repro_torch.kernels import ref
    dt, A, proj, x, g = _scan_inputs(Bt, L, di, N, seed=L + di)

    def loss(dt, A, proj, x):
        B, C = proj[..., 5:5 + N], proj[..., 5 + N:]
        y = jnp.stack([jref.ssm_scan_ref(dt[b], A, B[b], C[b], x[b])
                       for b in range(Bt)])
        return jnp.sum(y * jnp.asarray(g))

    jd = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (dt, A, proj, x)))
    jd = [np.asarray(a) for a in jd]
    want = [jd[0], jd[1], jd[2][..., 5:5 + N], jd[2][..., 5 + N:], jd[3]]
    tproj = torch.from_numpy(proj)
    args = [torch.from_numpy(dt), torch.from_numpy(A), tproj[..., 5:5 + N],
            tproj[..., 5 + N:], torch.from_numpy(x)]
    _, ck = ref.ssm_scan_checkpointed_ref(*args)
    got = ref.ssm_scan_bwd_ref(*args, torch.from_numpy(g), ck=ck)
    itself = ref.ssm_scan_bwd_ref(*args, torch.from_numpy(g))
    for name, t, w, same in zip(("ddt", "dA", "dB", "dC", "dx"), got, want,
                                itself):
        assert t.shape == w.shape and torch.equal(t, same), name
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_scan_bwd_plan_and_the_restated_bounds(torch):
    """``bwd_plan``: 4 lanes, 128 channels a block where that gives at
    least half the SMs a block (jamba's Bt = 1, di = 16,384: 128 blocks on
    132 SMs), else 32; the source's shared-memory sizes; a refusal for a
    count with no instance. The bounds at jamba's full Mamba shape (the
    backward given the checkpoints kept every 8 steps: 1.88 GB, bytes;
    without them, the function's own minimum: 1.35 GB) and at qwen2-moe's
    float32 training dispatch (the map replaces ids and keep flags)."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import bounds
    jamba = ss.bwd_plan(1, 16384, 132)
    assert (jamba.lanes, jamba.channels, jamba.chunk, jamba.stages) == \
        (4, 128, 8, 3)
    assert ss.bwd_plan(1, 8448, 132).channels == 128  # 66 blocks
    assert ss.bwd_plan(1, 8320, 132).channels == 32   # 65
    assert ss.bwd_plan(4, 128, 132).channels == 32    # the reduced jamba
    # 128 channels: a ring of 3 x (dt, x, g 4 KB each, the checkpoint 8 KB,
    # B and C rows 512 B each), ddt/dx tiles 16 KB, dB/dC sums 32 KB,
    # barriers 24 B
    assert jamba.smem_bytes == 128 + 3 * 21504 + 16384 + 32768 + 24
    assert ss.bwd_plan(4, 128, 132).smem_bytes == \
        128 + 3 * 6144 + 4096 + 8192 + 24
    assert ss.bwd_plan(1, 16384, 132, channels=32) == \
        ss.bwd_plan(4, 128, 132)
    with pytest.raises(ValueError, match="no backward instance"):
        ss.bwd_plan(1, 16384, channels=64)
    assert ss.checkpoint_shape(1, 4096, 16384, 16) == (1, 512, 16384, 16)
    assert bounds.checkpoint_bytes(1, 4096, 16384, 16) == 536870912
    ms, by = bounds.scan_bwd_bound_ms(1, 4096, 16384, 16)
    nbytes = 4 * (5 * 4096 * 16384 + 4 * 4096 * 16 + 2 * 16384 * 16) \
        + 536870912
    assert by == "bytes" and nbytes == 1_882_193_920
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert ms == pytest.approx(0.5618, abs=1e-4)
    own, by = bounds.scan_bwd_bound_ms(1, 4096, 16384, 16, checkpoints=False)
    assert by == "bytes" and own == pytest.approx(
        1e3 * (nbytes - 536870912) / 3.35e12)
    assert own == pytest.approx(0.4016, abs=1e-4)
    fwd, by = bounds.scan_bound_ms(1, 4096, 16384, 16)
    assert by == "operations" and fwd + own == pytest.approx(0.6580, abs=1e-4)
    ms, by = bounds.gather_bwd_bound_ms(16400, 4100, 2048, 4, 4)
    assert by == "bytes" and ms == pytest.approx(
        1e3 * (16400 * 2048 * 4 + 4100 * 4 * 8 + 4100 * 2048 * 4) / 3.35e12)
    assert ms == pytest.approx(0.0502, abs=1e-4)
    fwd, _ = bounds.scan_bound_ms(1, 4096, 16384, 16, checkpoints=True)
    assert fwd == pytest.approx(1e3 * (4 * (3 * 4096 * 16384 + 2 * 4096
                                            * 16 + 16384 * 16)
                                       + 536870912) / 3.35e12)


def test_moe_gather_refuses_a_map_of_another_shape(torch):
    from repro_torch.kernels import ops
    x = torch.zeros((4, 8))
    ids = torch.zeros(6, dtype=torch.int32)
    keep = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError, match="slots"):
        ops.moe_gather(x, ids, keep, slots=torch.zeros((3, 2),
                                                       dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        ops.moe_gather(x, ids, keep, slots=torch.zeros((4, 2),
                                                       dtype=torch.int32))


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
