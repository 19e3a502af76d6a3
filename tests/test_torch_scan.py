"""The scan kernel's arithmetic against the reference's, on the CPU.

``repro_torch.kernels.ref.ssm_scan_ex2_ref`` is what the CUDA scan
computes, in plain PyTorch: the decay as ``exp2(dt * (A * log2 e))`` and
y summed over the states in the kernel's order (each lane's run of states
in order, then the lanes' parts as its reduce-scatter adds them). It is
held against the reference's Pallas ``ssm_scan`` (interpret mode, as
tests/test_torch_kernels.py runs it) and against the oracle
``repro.kernels.ref.ssm_scan_ref``, at atol=rtol=1e-5, the tolerance of
tests/test_kernels.py, on the same numpy-seeded inputs: the small shapes
of ``test_ssm_scan_matches_reference`` and one of 1,024 steps where
rounding accumulates. The wrapper's plan and its TMA test, which decide
the launch and the copies on the card, are plain Python and are held
here too."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro.kernels import ref as jref


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _scan_inputs(Bt, L, di, N, seed=3):
    """tests/test_kernels.py's distribution, numpy-seeded: dt = 0.1
    softplus(normal), A = -exp(0.3 normal), B, C, x standard normal."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, di)))) * 0.1
    A = -np.exp(rng.standard_normal((di, N)) * 0.3)
    B, C = rng.standard_normal((2, Bt, L, N))
    x = rng.standard_normal((Bt, L, di))
    return [a.astype(np.float32) for a in (dt, A, B, C, x)]


SHAPES = [  # (Bt, L, di, N, the Pallas kernel's block_d)
    (2, 33, 64, 8, 32), (1, 64, 128, 16, 128), (3, 16, 32, 4, 16),
    (2, 45, 64, 16, 64),
    (1, 1024, 64, 16, 64),  # long: rounding accumulates over 1,024 steps
]


@pytest.mark.parametrize("Bt,L,di,N,bd", SHAPES)
@pytest.mark.parametrize("lanes", [2, 4])
def test_ssm_scan_ex2_ref_matches_reference(torch, Bt, L, di, N, bd, lanes):
    from repro_torch.kernels import ref
    arrs = _scan_inputs(Bt, L, di, N)
    dt, A, B, C, x = (jnp.asarray(a) for a in arrs)
    pallas = np.asarray(jops.ssm_scan(dt, A, B, C, x, block_d=bd))
    oracle = np.stack([np.asarray(jref.ssm_scan_ref(dt[b], A, B[b], C[b],
                                                    x[b]))
                       for b in range(Bt)])
    got = ref.ssm_scan_ex2_ref(*(torch.from_numpy(a) for a in arrs),
                               lanes=lanes)
    assert got.dtype == torch.float32 and got.shape == (Bt, L, di)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ssm_scan_ex2_ref_sums_the_lanes_in_the_kernels_order(torch):
    """With lanes parts p_q (states 16/lanes * q onwards, summed in
    order), y is p0 + p1 at 2 lanes and (p0 + p2) + (p1 + p3) at 4; a
    state count below 16 is zero-padded, as the kernel pads it."""
    from repro_torch.kernels import ref
    dt, A, B, C, x = (torch.from_numpy(a)
                      for a in _scan_inputs(1, 3, 5, 12, seed=1))
    A2 = A * torch.tensor(ref.LOG2E, dtype=torch.float32)
    h = torch.zeros(1, 5, 12)
    for t in range(3):
        h = torch.exp2(dt[:, t, :, None] * A2) * h \
            + (dt[:, t, :, None] * x[:, t, :, None]) * B[:, t, None, :]
    hc = torch.nn.functional.pad(h * C[:, 2, None, :], (0, 4))

    def part(lo, n):
        acc = hc[..., lo]
        for j in range(lo + 1, lo + n):
            acc = acc + hc[..., j]
        return acc

    two = part(0, 8) + part(8, 8)
    four = (part(0, 4) + part(8, 4)) + (part(4, 4) + part(12, 4))
    for lanes, want in ((2, two), (4, four)):
        got = ref.ssm_scan_ex2_ref(dt, A, B, C, x, lanes=lanes)[:, 2]
        assert torch.equal(got, want)


def test_ssm_scan_ex2_ref_refuses_what_the_kernel_cannot_hold(torch):
    from repro_torch.kernels import ref
    dt, A, B, C, x = (torch.from_numpy(a)
                      for a in _scan_inputs(1, 4, 8, 17))
    with pytest.raises(ValueError, match="16"):
        ref.ssm_scan_ex2_ref(dt, A, B, C, x)
    with pytest.raises(ValueError, match="lanes"):
        ref.ssm_scan_ex2_ref(dt, A[:, :4], B[..., :4], C[..., :4], x,
                             lanes=3)


@pytest.mark.parametrize("lanes", [2, 4])
def test_scan_plan_is_the_kernels_instance(torch, lanes):
    """32 channels a block, 32 steps a chunk, 3 stages: 128 bytes of
    alignment, 3 x 12 KB of dt/x/B/C, two 4 KB y tiles, 6 mbarriers --
    45,232 bytes, so four blocks fit an SM (jamba's 512 blocks at Bt=1 are
    resident at once on 132 SMs)."""
    from repro_torch.kernels import ssm_scan as ss
    p = ss.plan(1, 16384, 132, lanes)
    assert p == ss.ScanPlan(lanes, 32, 32, 3, 45_232)
    assert 4 * (p.smem_bytes + 1024) <= 228 * 1024
    assert -(-16384 // p.channels) <= 4 * 132


@pytest.mark.parametrize("Bt,di,n_sm,lanes", [
    (1, 16384, 132, 2),  # jamba prefill: 512 blocks, ~3.9 an SM
    (2, 3000, 132, 4),   # 188 blocks, ~1.4 an SM: more warps a block
    (1, 12672, 132, 2),  # 396 blocks: 3 an SM
    (1, 12640, 132, 4),  # 395 blocks
    (4, 4096, 78, 2),    # 512 blocks on a smaller card
])
def test_scan_plan_chooses_lanes_from_the_grid(torch, Bt, di, n_sm, lanes):
    from repro_torch.kernels import ssm_scan as ss
    assert ss.plan(Bt, di, n_sm).lanes == lanes


def test_scan_plan_refuses_other_lane_counts(torch):
    from repro_torch.kernels import ssm_scan as ss
    for lanes in (1, 3, 8):
        with pytest.raises(ValueError, match="lanes"):
            ss.plan(1, 64, 132, lanes)


@pytest.mark.parametrize("R,N,di,ready", [
    (512, 16, 16384, True),  # jamba: rows of 2,176 bytes, 2,048-byte offset
    (24, 16, 160, True),     # rows of 224 bytes, offset 96
    (23, 16, 99, False),     # rows of 220 bytes, offset 92
    (24, 5, 100, False),     # N = 5: rows of 136 bytes, C at offset 116
])
def test_scan_tma_test_on_projection_slices(torch, R, N, di, ready):
    """B and C as mamba_apply passes them, column slices of the x_proj
    output (Bt, L, R + 2N): TMA reads them in place only when their base
    and row stride are whole 16-byte words."""
    from repro_torch.kernels import ssm_scan as ss
    proj = torch.zeros(2, 7, R + 2 * N)
    B, C = proj[..., R:R + N], proj[..., R + N:]
    assert ss.tma_ready(B) == ss.tma_ready(C) == ready
    x = torch.zeros(2, 7, di)
    assert ss.tma_ready(x) == (di % 4 == 0)


def test_scan_tma_test_ignores_strides_of_extent_one(torch):
    """A dimension of extent 1 is never stepped, so its stride does not
    count: (1, L, w) with any batch stride and (Bt, 1, w) with any time
    stride are read in place where the other strides allow."""
    from repro_torch.kernels import ssm_scan as ss
    assert not ss.tma_ready(torch.zeros(2, 3, 5))
    assert ss.tma_ready(torch.zeros(2, 3, 8))
    one = torch.zeros(1, 3, 8)[:, :, :5]  # batch stride 24, time stride 8
    assert ss.tma_ready(one)
    assert ss.tma_ready(torch.zeros(3, 1, 8)[:, :, :5])
    assert not ss.tma_ready(torch.zeros(3, 1, 5))
