"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips (from inside the test, never
at collection) when ``torch.cuda.is_available()`` is false.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 for flash attention (the kernel rounds the softmax weights to
bf16 before P@V, as the model's plain path does); none for ``moe_gather``,
a copy held bit for bit; 1e-5 for ``ssm_scan``, as tests/test_kernels.py
holds the Pallas scan (float32; the kernel fuses multiply-adds and sums
the N states in another order than the plain version); 2e-5 in float32
and 2e-2 in bfloat16 for ``paged_attention``, as tests/test_kernels.py
holds the Pallas kernel (online softmax against the plain full softmax).
The training kernels: ``moe_gather_bwd`` bit for bit against its plain
version (both add a token's slots, read from a (T, k) map, in slot order in
float32); ``ssm_scan_bwd`` within 1e-4 of each output's largest value
against its plain reverse scan (the kernel decays by ex2 and sums over
channels in another order), at each instance, given the checkpointing
forward's checkpoints or not; both give the same bits twice, and through
autograd the direct call's bits with one launch of each kernel."""
import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def torch():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _qkv(torch, B, S, T, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    return mk(B, S, H, hd), mk(B, T, K, hd), mk(B, T, K, hd)


CASES = [
    (2, 128, 128, 4, 2, 64),
    (1, 100, 100, 4, 4, 32),   # ragged vs the tile size
    (2, 64, 192, 8, 2, 16),    # T != S
    (1, 256, 256, 2, 1, 128),  # MQA
    (1, 1000, 1000, 8, 2, 128),
    (3, 7, 300, 6, 3, 64),
    (1, 300, 5, 4, 1, 16),     # T shorter than one tile
    (1, 640, 640, 16, 16, 128),  # MHA (G=1), qwen2-moe's heads
    # the head dims of phi3-mini (96), nemotron-4-340b (192), gemma-7b (256)
    (1, 300, 300, 8, 2, 96),     # GQA, S ragged against the 128-row tiles
    (1, 100, 20, 4, 4, 96),      # T shorter than one kv tile (128)
    (2, 200, 200, 12, 4, 192),   # GQA, ragged against the 64-row kv tiles
    (1, 70, 40, 4, 1, 192),      # T shorter than one kv tile (64)
    (1, 333, 333, 4, 2, 256),    # GQA, ragged
    (1, 130, 50, 2, 2, 256),     # MHA, T shorter than one kv tile
    (1, 300, 300, 12, 2, 128),   # G=6 (internvl2-26b's 48/8 grouping)
    (8, 448, 448, 12, 12, 64),   # whisper-small's decoder: S=448, ragged
]


@pytest.mark.parametrize("B,S,T,H,K,hd", CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(torch, B, S, T, H, K, hd, causal, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    dt = getattr(torch, dtype)
    q, k, v = _qkv(torch, B, S, T, H, K, hd, dt)
    before = fa.LAUNCHES.count
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    assert out.dtype == dt and out.shape == q.shape
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("hd", [64, 96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_inputs(torch, dtype, hd):
    """q, k, v as views of the fused projection (B,S,(H+2K)*hd): no copies
    in the wrapper, the kernel walks the strides (the bf16 kernel's tensor
    maps are encoded from them)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    B, S, H, K = 2, 130, 8, 2
    rng = np.random.default_rng(1)
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * K, hd), dtype=np.float32)).to("cuda",
                                                    getattr(torch, dtype))
    q, k, v = fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:]
    assert not q.is_contiguous()
    out = ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


def test_flash_kernel_refuses_what_it_does_not_take(torch):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(torch, 1, 16, 16, 2, 1, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    q48, k48, v48 = _qkv(torch, 1, 16, 16, 2, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q48, k48, v48)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 3).contiguous().transpose(1, 3),
                               k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu())


def test_flash_kernel_entry_refuses_a_plan_not_its_own(torch):
    """The C entry holds the wrapper's plan against its instance's and
    returns an error (no launch) when they differ."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(torch, 1, 128, 128, 2, 1, 128, torch.bfloat16)
    out = torch.empty_like(q)
    fn = fa.build().repro_flash_attention_fwd
    good = fa.plan(128, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (good._replace(kv_tile=64), good._replace(stages=2),
                good._replace(smem_bytes=good.smem_bytes - 8),
                fa.plan(128, torch.float32)):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 1, 128, 128, 2, 1, 128, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], 1, 1, 128 ** -0.5,
                 *bad, stream)
        assert err != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("H,K,hd", [(32, 32, 96), (96, 8, 192),
                                    (16, 16, 256), (48, 8, 128)])
def test_flash_kernel_at_wide_head_prefill_shapes(torch, H, K, hd):
    """phi3-mini's, nemotron-4-340b's, gemma-7b's and internvl2-26b's
    heads at S=T=2048."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    q, k, v = _qkv(torch, 1, 2048, 2048, H, K, hd, torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_at_the_moe_prefill_shape(torch):
    """qwen2-moe's attention at prefill: MHA, H=K=16 (G=1), S=T=4096."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    q, k, v = _qkv(torch, 1, 4096, 4096, 16, 16, 128, torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


def _gather_inputs(torch, T, d, S, dtype, kept=0.8, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32)).to(
        "cuda", dtype)
    keep = rng.random(S) < kept
    ids = np.where(keep, rng.integers(0, T, S), -1).astype(np.int32)
    return (x, torch.from_numpy(ids).to("cuda"),
            torch.from_numpy(keep).to("cuda"))


def _same_bits(torch, got, want):
    view = torch.int16 if got.element_size() == 2 else torch.int32
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("T,d,S", [
    (4096, 2048, 20_640),  # qwen2-moe prefill: 60 experts x capacity 344
    (4, 2048, 480),        # qwen2-moe decode at batch 4: capacity 8
    (64, 48, 40), (128, 16, 128), (10, 8, 7),  # tests/test_kernels.py grid
    (33, 7, 100),          # rows not 16-byte aligned: element copies
    (5, 1, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_kernel_matches_plain(torch, T, d, S, dtype):
    from repro_torch.kernels import moe_dispatch
    from repro_torch.kernels.ref import moe_gather_ref
    x, ids, keep = _gather_inputs(torch, T, d, S, getattr(torch, dtype))
    before = moe_dispatch.LAUNCHES.count
    out = moe_dispatch.moe_gather(x, ids, keep)
    torch.cuda.synchronize()
    assert moe_dispatch.LAUNCHES.count == before + 1
    _same_bits(torch, out, moe_gather_ref(x, ids, keep))


def test_moe_gather_kernel_reads_strided_rows_and_clamps_ids(torch):
    """x as a column slice of a wider matrix (row stride != d), and kept
    ids out of range, which the kernel clamps as the plain version does."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_gather_ref
    wide, ids, keep = _gather_inputs(torch, 50, 200, 300, torch.bfloat16)
    for x in (wide[:, 8:136], wide[:, 3:40]):
        assert not x.is_contiguous()
        bad = ids.clone()
        bad[:4] = torch.tensor([-7, 50, 1000, -1], dtype=torch.int32)
        k = keep.clone()
        k[:4] = True
        _same_bits(torch, ops.moe_gather(x, bad, k),
                   moe_gather_ref(x, bad, k))


def test_moe_gather_kernel_refuses_what_it_does_not_take(torch):
    from repro_torch.kernels import moe_dispatch
    x, ids, keep = _gather_inputs(torch, 8, 16, 12, torch.bfloat16)
    with pytest.raises(TypeError):
        moe_dispatch.moe_gather(x.half(), ids, keep)
    with pytest.raises(TypeError):
        moe_dispatch.moe_gather(x, ids.long(), keep)
    with pytest.raises(TypeError):
        moe_dispatch.moe_gather(x, ids, keep.int())
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch.moe_gather(x.t().contiguous().t(), ids, keep)
    with pytest.raises(ValueError, match="CUDA"):
        moe_dispatch.moe_gather(x.cpu(), ids.cpu(), keep.cpu())


@pytest.mark.parametrize("T,d,S,kept", [
    (4, 2048, 480, 16 / 480),   # qwen2-moe decode at batch 4
    (4096, 2048, 20_640, 0.8),  # qwen2-moe prefill
    (100, 48, 333, 0.75),       # ragged: S against the blocks, 96/192 B rows
    (37, 1032, 1001, 0.5),      # rows of 2,064 / 4,128 bytes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_kernel_over_row_layouts(torch, T, d, S, kept, dtype):
    """Bit-equal to the plain version with kept ids out of range (clamped),
    on x itself and on x as a column slice of a wider matrix: at a 16-byte
    aligned base (copied in 16-byte words) and at a base one element past
    it (copied element by element)."""
    from repro_torch.kernels import moe_dispatch
    from repro_torch.kernels.ref import moe_gather_ref
    dt = getattr(torch, dtype)
    wide, ids, keep = _gather_inputs(torch, T, 2 * d + 8, S, dt, kept=kept)
    ids[:3] = torch.tensor([-7, T, 10 * T], dtype=torch.int32)
    keep[:3] = True
    for x in (wide[:, :d].contiguous(), wide[:, 8:8 + d],
              wide[:, 1:1 + d]):
        before = moe_dispatch.LAUNCHES.count
        out = moe_dispatch.moe_gather(x, ids, keep)
        torch.cuda.synchronize()
        assert moe_dispatch.LAUNCHES.count == before + 1
        assert out.is_contiguous()
        _same_bits(torch, out, moe_gather_ref(x, ids, keep))


def _scan_inputs(torch, Bt, L, di, N, seed=0):
    """tests/test_kernels.py's distribution: dt = 0.1 softplus(normal),
    A = -exp(0.3 normal), B, C, x standard normal; float32 on the card."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda")
    dt = torch.nn.functional.softplus(mk(Bt, L, di)) * 0.1
    A = -torch.exp(mk(di, N) * 0.3)
    return dt, A, mk(Bt, L, N), mk(Bt, L, N), mk(Bt, L, di)


@pytest.mark.parametrize("Bt,L,di,N", [
    (2, 33, 64, 8), (1, 64, 128, 16), (3, 16, 32, 4),  # tests/test_kernels.py
    (1, 100, 256, 16),  # L not a multiple of the 16-step chunk
    (1, 7, 200, 16),    # di not a multiple of a block's channels
    (4, 50, 130, 5),    # Bt > 1, N padded to the register width
    (1, 1, 1, 1),
    (1, 4096, 16384, 16),  # jamba-1.5-large prefill: B=1, S=4096
])
def test_ssm_scan_kernel_matches_plain(torch, Bt, L, di, N):
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import ssm_scan_ref
    dt, A, B, C, x = _scan_inputs(torch, Bt, L, di, N)
    before = ss.LAUNCHES.count
    out = ss.ssm_scan(dt, A, B, C, x)
    torch.cuda.synchronize()
    assert ss.LAUNCHES.count == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    want = ssm_scan_ref(dt, A, B, C, x)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


def test_ssm_scan_kernel_reads_column_slices_of_the_projection(torch):
    """B and C as mamba_apply passes them: column slices of the x_proj
    output (row stride R + 2N), and dt, x as strided views: read in place
    through their strides, no copy."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_ref
    Bt, L, di, N, R = 2, 70, 160, 16, 24
    dt, A, _, _, x = _scan_inputs(torch, Bt, L, di, N)
    proj = torch.randn(Bt, L, R + 2 * N, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(3))
    B, C = proj[..., R:R + N], proj[..., R + N:]
    assert not B.is_contiguous() and not C.is_contiguous()
    wide = torch.zeros(Bt, L, 2 * di, device="cuda")
    wide[..., :di] = x
    xs = wide[..., :di]
    out = ops.ssm_scan(dt, A, B, C, xs)
    want = ssm_scan_ref(dt, A, B.contiguous(), C.contiguous(), x)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


def test_ssm_scan_kernel_refuses_what_it_does_not_take(torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    dt, A, B, C, x = _scan_inputs(torch, 1, 8, 32, 4)
    _, A17, B17, C17, _ = _scan_inputs(torch, 1, 8, 32, 17)
    before = ss.LAUNCHES.count
    with pytest.raises(TypeError, match="float32"):
        ss.ssm_scan(dt.bfloat16(), A, B, C, x)
    with pytest.raises(TypeError, match="float32"):
        ops.ssm_scan(dt, A, B.double(), C, x)  # no upcast on the card
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(dt, A.t().contiguous().t(), B, C, x)
    with pytest.raises(ValueError, match="state size"):
        ss.ssm_scan(dt, A17, B17, C17, x)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssm_scan(dt, A[:16], B, C, x)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan(dt.cpu(), A.cpu(), B.cpu(), C.cpu(), x.cpu())
    assert ss.LAUNCHES.count == before


def _paged_inputs(torch, B, H, K, hd, page, max_pages, dtype, seed=0,
                  holes=True):
    """Pages drawn as a random permutation of a pool larger than the
    tables need; lengths not multiples of the page; with ``holes``, one
    hole inside row 0's length and a last row of holes only."""
    rng = np.random.default_rng(seed)
    P = B * max_pages + 3
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    q = mk(B, H, hd)
    k_pages, v_pages = mk(P, page, K, hd), mk(P, page, K, hd)
    tables = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    lengths = rng.integers(1, max_pages * page + 1, B)
    if holes:
        lengths[0] = max(lengths[0], 2 * page + 1)
        tables[0, 1] = -1
        if B > 1:
            tables[-1] = -1
    return (q, k_pages, v_pages,
            torch.from_numpy(tables.astype(np.int32)).to("cuda"),
            torch.from_numpy(lengths.astype(np.int32)).to("cuda"))


@pytest.mark.parametrize("B,H,K,hd,page,max_pages", [
    (3, 8, 8, 128, 16, 4),    # G=1 (qwen2-moe's MHA)
    (4, 10, 2, 128, 16, 5),   # G=5 (qwen2.5-32b's grouping)
    (2, 40, 8, 128, 64, 8),   # qwen2.5-32b's heads
    (3, 64, 8, 128, 32, 3),   # G=8 (jamba's heads)
    (2, 12, 1, 64, 8, 7),     # G=12: two chunks of heads
    (5, 6, 2, 32, 5, 9),      # odd page size
    (2, 32, 32, 96, 16, 5),   # hd 96, G=1 (phi3-mini's 32/32 heads)
    (2, 96, 8, 192, 16, 4),   # hd 192, G=12 (nemotron-4-340b's 96/8)
    (2, 16, 16, 256, 16, 3),  # hd 256, G=1 (gemma-7b's 16/16)
    (1, 4, 4, 64, 16, 2),     # one span: no combine pass
    (2, 48, 8, 128, 64, 8),   # G=6 (internvl2-26b's 48/8 heads)
    (3, 12, 2, 128, 16, 5),   # G=6, several spans
    (2, 12, 12, 64, 16, 4),   # whisper-small's 12/12 heads of 64
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain(torch, B, H, K, hd, page,
                                              max_pages, dtype):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref
    dt = getattr(torch, dtype)
    args = _paged_inputs(torch, B, H, K, hd, page, max_pages, dt)
    before = pa.LAUNCHES.count
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES.count == before + 1
    assert out.dtype == dt and out.shape == (B, H, hd)
    want = paged_attention_ref(*args)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("H,K,hd", [(10, 2, 64), (10, 2, 96), (10, 2, 128),
                                    (24, 2, 192), (4, 4, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_long_rows_over_many_spans(torch, H, K, hd,
                                                          dtype):
    """40 pages of 16 split into several spans, every row's length in the
    last page of its table (the last span partly filled), one hole: the
    combine pass merges the spans, at every head dim of the reference's
    configs (G=12 at hd 192, as nemotron-4-340b's heads)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref
    dt = getattr(torch, dtype)
    B, page, max_pages = 3, 16, 40
    args = _paged_inputs(torch, B, H, K, hd, page, max_pages, dt,
                         holes=False)
    tables, lengths = args[3], args[4]
    lengths.copy_(torch.tensor([max_pages * page, max_pages * page - 1,
                                (max_pages - 1) * page + 3],
                               dtype=torch.int32))
    tables[1, 7] = -1
    _, n_spans = pa.span_plan(B, K, max_pages, page)
    assert n_spans > 1
    before = pa.LAUNCHES.count
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES.count == before + 1
    want = paged_attention_ref(*args)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)
    # each (sequence, head) row against the float32 answer, relative to
    # the row's scale: bf16 output and P roundings stay under 1e-2 of it
    # (as chip_smoke.py's PAGED_ROW_TOL)
    want32 = paged_attention_ref(*(a.float() for a in args[:3]), *args[3:])
    row_err = ((out.float() - want32).abs().amax(-1)
               / want32.abs().amax(-1)).max().item()
    assert row_err <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("B,H,K,hd,page,max_pages", [
    (4, 10, 2, 64, 8, 96),    # several spans: the combine pass
    (1, 4, 4, 64, 16, 2),     # one span: the split kernel alone
    (4, 96, 8, 192, 64, 4),   # one of 16 shards of nemotron's 4,096-token rows
    (3, 12, 1, 128, 16, 5),   # G=12: two chunks of heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_partial_mode_matches_plain(torch, B, H, K, hd, page,
                                                    max_pages, dtype):
    """The partial mode (a rank's share of a pool split over the
    sequence) against ``ref.paged_attention_partial_ref``: each row's
    float32 output over its own sum and its (max, sum); a hole, a row of
    holes only and a length-0 row, both the empty partial (zeros, -1e30,
    0). One launch in ``LAUNCHES_PARTIAL``, none in ``LAUNCHES``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_partial_ref
    dt = getattr(torch, dtype)
    args = _paged_inputs(torch, B, H, K, hd, page, max_pages, dt)
    if B > 2:
        args[4][1] = 0
    before, whole = pa.LAUNCHES_PARTIAL.count, pa.LAUNCHES.count
    out, ml = ops.paged_attention_partial(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_PARTIAL.count == before + 1
    assert pa.LAUNCHES.count == whole
    assert out.dtype == ml.dtype == torch.float32
    assert out.shape == (B, H, hd) and ml.shape == (B, H, 2)
    want, want_ml = paged_attention_partial_ref(*args)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(ml.cpu().numpy(), want_ml.cpu().numpy(),
                               atol=tol, rtol=tol)
    empty = want_ml[..., 1] == 0
    if B > 1:
        assert bool(empty[-1].all())  # holes only
    assert bool((ml[..., 1][empty] == 0).all())
    assert bool((ml[..., 0][empty] == -1e30).all())
    assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_rows_with_no_valid_position(torch, dtype):
    """Length 0, holes only, and length 0 over real pages, with several
    spans per row: each row is the reference's uniform mean of V over its
    gathered positions, found by the combine pass."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref
    dt = getattr(torch, dtype)
    q, kp, vp, tables, lengths = _paged_inputs(torch, 4, 10, 2, 64, 8, 96,
                                               dt, holes=False)
    assert pa.span_plan(4, 2, 96, 8)[1] > 1
    tables[1] = -1
    lengths[2] = 0
    tables[3, 1] = -1
    lengths[3] = 0
    before = pa.LAUNCHES.count
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert pa.LAUNCHES.count == before + 1
    want = paged_attention_ref(q, kp, vp, tables, lengths)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)
    mean = vp[0].float().mean(0).repeat_interleave(5, 0)  # page 0, G=5
    np.testing.assert_allclose(out[1].float().cpu().numpy(),
                               mean.cpu().numpy(), atol=tol, rtol=tol)


def test_paged_attention_kernel_reads_the_model_pool_view(torch):
    """One layer's view of the (L, P, page, K, hd) pool and q as the model
    passes it, a (B, 1, H, hd) slice: read in place, no copy; several
    spans per row."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref
    q, kp, vp, tables, lengths = _paged_inputs(torch, 3, 10, 2, 128, 16, 48,
                                               torch.bfloat16)
    assert pa.span_plan(3, 2, 48, 16)[1] > 1
    pool_k = torch.stack([kp, kp.flip(0), kp])
    pool_v = torch.stack([vp, vp, vp.flip(0)])
    q4 = q[:, None]
    out = ops.paged_attention(q4[:, 0], pool_k[1], pool_v[1], tables,
                              lengths)
    want = paged_attention_ref(q, kp.flip(0), vp, tables, lengths)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


def test_paged_attention_kernel_reads_the_last_layer_of_a_deep_pool(torch):
    """gemma-7b's 16/16 heads of 256 read from the last layer's view of a
    28-layer pool, as its decode step reads layer 27 (the other layers
    hold other values)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import paged_attention_ref
    q, kp, vp, tables, lengths = _paged_inputs(torch, 2, 16, 16, 256, 16, 6,
                                               torch.bfloat16)
    pool_k = torch.full((28, *kp.shape), 3.0, dtype=kp.dtype, device="cuda")
    pool_v = torch.full_like(pool_k, -3.0)
    pool_k[-1], pool_v[-1] = kp, vp
    out = ops.paged_attention(q, pool_k[-1], pool_v[-1], tables, lengths)
    want = paged_attention_ref(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


def test_paged_attention_kernel_refuses_what_it_does_not_take(torch):
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, tables, lengths = _paged_inputs(torch, 2, 4, 2, 64, 8, 3,
                                               torch.bfloat16)
    before = pa.LAUNCHES.count
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp.half(), vp.half(), tables, lengths)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp.float(), vp, tables, lengths)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, kp.transpose(0, 1).contiguous().transpose(0, 1),
                           vp, tables, lengths)
    # bf16 rows of 40 bytes (hd 20) are not whole 16-byte words; hd 264
    # is past the largest head dim
    for hd in (20, 264):
        qx = torch.zeros(2, 4, hd, device="cuda", dtype=torch.bfloat16)
        kx = torch.zeros(5, 8, 2, hd, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            pa.paged_attention(qx, kx, kx, tables, lengths)
    with pytest.raises(ValueError, match="disagree"):
        pa.paged_attention(q[:, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q.cpu(), kp.cpu(), vp.cpu(), tables.cpu(),
                           lengths.cpu())
    assert pa.LAUNCHES.count == before


@pytest.mark.parametrize("L", [1, 65, 1001])
@pytest.mark.parametrize("N", [1, 4, 8, 16])
@pytest.mark.parametrize("lanes", [2, 4])
def test_ssm_scan_kernel_ragged_steps_channels_and_states(torch, L, N,
                                                          lanes):
    """L against the 32-step chunk, di = 100 against the block's 32
    channels, N below the 16 states held: against the plain version and
    the kernel's arithmetic in plain PyTorch, both at 1e-5."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import ssm_scan_ex2_ref, ssm_scan_ref
    dt, A, B, C, x = _scan_inputs(torch, 2, L, 100, N)
    copies = ss.COPIES.count
    out = ss._scan(dt, A, B, C, x, lanes)
    torch.cuda.synchronize()
    assert out.shape == x.shape
    assert ss.COPIES.count == copies + (2 if N % 4 else 0)  # B and C
    for want in (ssm_scan_ref(dt, A, B, C, x),
                 ssm_scan_ex2_ref(dt, A, B, C, x, lanes=lanes)):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_ssm_scan_kernel_copies_only_what_tma_cannot_read(torch):
    """B and C as column slices of a projection whose rows are not whole
    16-byte words (R = 23), dt and x of 99 channels: each is copied into a
    padded buffer first (four copies), y is a column view; at jamba's
    layout (R = 512, rows of 2,176 bytes) nothing is copied."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import ssm_scan_ref
    gen = torch.Generator("cuda").manual_seed(5)
    for R, di, copies in ((23, 99, 4), (512, 96, 0)):
        Bt, L, N = 2, 70, 16
        dt, A, _, _, x = _scan_inputs(torch, Bt, L, di, N)
        proj = torch.randn(Bt, L, R + 2 * N, device="cuda", generator=gen)
        B, C = proj[..., R:R + N], proj[..., R + N:]
        before = ss.COPIES.count
        out = ops.ssm_scan(dt, A, B, C, x)
        torch.cuda.synchronize()
        assert ss.COPIES.count == before + copies
        want = ssm_scan_ref(dt, A, B.contiguous(), C.contiguous(), x)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------- the relational kernels
# K1 (expr_core) and K2 (segment_reduce) hold numpy's bytes, no tolerance.
_EXPR_OPS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
             "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
             "+": np.add, "-": np.subtract, "*": np.multiply,
             "/": np.true_divide, "&&": np.logical_and,
             "||": np.logical_or}
_EXPR_DTYPES = ["?", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2",
                "f4", "f8"]


def _expr_values(rng, dt, n):
    """Random values of dt with its edge values; a NaN only meets NaNs of
    its own bits (numpy's choice between two NaNs depends on its path)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        edge = np.array([info.min, info.max, 0, 1], dt)
    else:
        with np.errstate(over="ignore"):
            v = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-5, 6, n)).astype(dt)
        edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0]).astype(dt)
    v[:len(edge)] = edge
    return v


@pytest.mark.parametrize("op", list(_EXPR_OPS))
def test_expr_core_kernel_gives_numpy_bytes(torch, op):
    """Every dtype pair numpy computes ``op`` for, at 8,192 rows (the
    executor's batch) and 1,000: the kernel, its plain version on the
    card and numpy, bit for bit."""
    import warnings

    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    from repro_torch.kernels.transfer import to_device
    rng = np.random.default_rng(sum(map(ord, op)))
    for n in (8192, 1000):
        for da in _EXPR_DTYPES:
            for db in _EXPR_DTYPES:
                a, b = _expr_values(rng, da, n), _expr_values(rng, db, n)
                try:
                    with np.errstate(all="ignore"), \
                            warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        want = _EXPR_OPS[op](a, b)
                except TypeError:  # numpy refuses it (bool - bool)
                    continue
                prog = ec.encode([(op, 2, (0, 1))], {
                    0: a.dtype, 1: b.dtype, 2: want.dtype}, [0, 1], [2])
                ins = to_device([a, b], torch.device("cuda"))
                got, = ops.expr_core(prog, ins, n)
                plain, = ec.expr_core_ref(prog, ins, n)
                got_np = got.cpu().numpy().view(want.dtype)
                assert got_np.tobytes() == want.tobytes(), (da, op, db)
                assert got_np.tobytes() == plain.cpu().numpy().view(
                    want.dtype).tobytes(), (da, op, db)


def test_expr_core_kernel_constants_and_refusals(torch):
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    a = torch.tensor([1.5, -2.0, float("nan"), 4.0], device="cuda",
                     dtype=torch.float64)
    k = torch.tensor([3], device="cuda")  # one value for every row
    dts = {0: np.dtype(np.float64), 1: np.dtype(np.int64),
           2: np.dtype(bool), 3: np.dtype(np.float64)}
    prog = ec.encode([("<", 2, (0, 1)), ("*", 3, (0, 1))], dts, [0, 1],
                     [2, 3])
    before = ec.LAUNCHES.count
    lt, prod = ops.expr_core(prog, [a, k], 4)
    assert ec.LAUNCHES.count == before + 1
    assert lt.tolist() == [True, True, False, False]
    assert prod.cpu().numpy().tobytes() == (a.cpu().numpy() * 3).tobytes()
    with pytest.raises(ValueError, match="want"):
        ops.expr_core(prog, [a, k.to(torch.int32)], 4)


def _numpy_scatter(inv, n, v, comb, acc):
    shape = (n,) + v.shape[1:]
    if comb == "sum":
        want = np.zeros(shape, acc)
        np.add.at(want, inv, v)
    else:
        want = np.full(shape, np.inf if comb == "min" else -np.inf)
        with np.errstate(invalid="ignore"):
            (np.minimum if comb == "min" else np.maximum).at(want, inv, v)
    return want


def _check_segment_kernel(torch, inv, n, vals):
    """One kernel call per combiner over vals: the kernel, its plain
    version and numpy's indexed loops, bit for bit; one launch each."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels.transfer import to_device
    kept = (inv >= 0) & (inv < n)
    for comb in ("sum", "min", "max"):
        flat = to_device([inv] + vals, torch.device("cuda"))
        cols = [t.reshape(v.shape) for t, v in zip(flat[1:], vals)]
        dts = [v.dtype for v in vals]
        before = sr.LAUNCHES.count
        got = ops.segment_reduce(flat[0], n, cols, dts, [comb] * len(vals))
        assert sr.LAUNCHES.count == before + 1
        plain = sr.segment_reduce_ref(flat[0], n, cols, dts,
                                      [comb] * len(vals))
        for g, p, v in zip(got, plain, vals):
            acc = sr.acc_dtype(v.dtype, comb)
            want = _numpy_scatter(inv[kept], n, v[kept], comb, acc)
            g_np = g.cpu().numpy().view(acc)
            assert g_np.tobytes() == want.tobytes(), (comb, v.dtype, v.shape)
            assert g_np.tobytes() == p.cpu().numpy().view(acc).tobytes()


def _nan_payloads(inv, v):
    """v's NaNs given a payload by group (7 kinds), so that NaNs of one
    group share their bits (numpy keeps either of two different NaNs by
    its code path)."""
    bits = v.view(np.uint64)
    nan = np.isnan(v)
    bits[nan] = np.uint64(0x7ff8000000000000) | (
        (inv[nan] % 7).astype(np.uint64) + np.uint64(1))
    return v


@pytest.mark.parametrize("groups", [3, 10_000, 2**20 + 1])
def test_segment_reduce_kernel_gives_numpy_bytes(torch, groups):
    """sum / min / max of float64 (NaN with payloads, +-0.0 ties), int32
    (wrapping sums), bool (int64 sums), a (rows, 3) float32 column and
    uint64, one call each, with rows outside [0, n) dropped: at 3 groups
    (long chains through the ring, min / max in pieces), 10,000 and
    2^20 + 1 (two radix passes); then a linalg-shaped call, (rows, 16,384)
    float64 blocks summed into at most 64 groups: the kernel, its plain
    version and numpy's indexed loops, bit for bit."""
    rng = np.random.default_rng(groups)
    rows = max(200_000, groups + groups // 2)
    inv = rng.integers(0, groups, rows).astype(np.int64)
    inv[:groups] = rng.permutation(groups)
    inv[rng.random(rows) < 0.001] = -1
    f64 = rng.standard_normal(rows) * 10.0 ** rng.integers(-3, 4, rows)
    f64[rng.random(rows) < 0.01] = np.nan
    f64[rng.random(rows) < 0.02] = 0.0
    f64[rng.random(rows) < 0.02] = -0.0
    _nan_payloads(inv, f64)
    _check_segment_kernel(torch, inv, groups, [
        f64, rng.integers(-2**31, 2**31 - 1, rows, dtype=np.int32),
        rng.random(rows) < 0.5,
        rng.standard_normal((rows, 3)).astype(np.float32),
        rng.integers(0, 2**64 - 1, rows, dtype=np.uint64)])
    wide_groups = min(groups, 64)
    wide_rows = 4 * wide_groups + 3
    wide_inv = rng.integers(0, wide_groups, wide_rows).astype(np.int64)
    wide = rng.standard_normal((wide_rows, 16_384))
    wide[rng.random(wide.shape) < 0.001] = np.nan
    wide[rng.random(wide.shape) < 0.01] = -0.0
    _nan_payloads(np.broadcast_to(wide_inv[:, None], wide.shape).copy(),
                  wide)
    _check_segment_kernel(torch, wide_inv, wide_groups, [wide])


def test_expr_core_kernel_reads_pinned_staging_and_refuses_pageable(torch):
    """K1 as the engine runs it: inputs packed into a pinned staging
    buffer and read through the card's mapping, outputs written into
    pinned host memory, one wait; numpy's bytes. A pageable host tensor
    is refused by the C entry (cudaErrorInvalidHostPointer, 16)."""
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    from repro_torch.kernels.transfer import Staging
    rng = np.random.default_rng(4)
    n = 8192
    a = rng.standard_normal(n)
    b = rng.integers(-5, 5, n).astype(np.int32)
    c = np.array([0.25])  # a constant, one value for every row
    dts = {0: a.dtype, 1: b.dtype, 2: c.dtype, 3: np.dtype(np.float64),
           4: np.dtype(np.float64), 5: np.dtype(bool)}
    prog = ec.encode([("*", 3, (0, 1)), ("-", 4, (3, 2)), (">", 5, (4, 0))],
                     dts, [0, 1, 2], [4, 5])
    ins_stage, outs_stage = Staging(), Staging()
    dev = torch.device("cuda", 0)
    for _ in range(3):  # the buffers are reused
        ins, _ = ins_stage.pack([[a], [b], [c]])
        assert all(x.is_pinned() for x in ins)
        outs = outs_stage.views([(n, np.float64), (n, np.dtype(bool))])
        before = ec.LAUNCHES.count
        ops.expr_core(prog, ins, n, outs=outs, device=dev)
        assert ec.LAUNCHES.count == before + 1
        torch.cuda.synchronize()
        want = a * b - c[0]
        assert outs[0].numpy().tobytes() == want.tobytes()
        assert outs[1].numpy().tobytes() == (want > a).tobytes()
    pageable = [torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)]
    with pytest.raises(RuntimeError, match="CUDA error 16"):
        ops.expr_core(prog, pageable, n, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error 16"):
        ops.expr_core(prog, ins, n, outs=[torch.empty(n, dtype=torch.float64),
                                          torch.empty(n, dtype=torch.bool)],
                      device=dev)


def test_q1_on_the_card_is_byte_identical_to_the_numpy_backend(torch):
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.data.synthetic import tpch_q1_lineitems
    from repro_torch.kernels import ops
    lines = tpch_q1_lineitems(100_000, seed=2)
    results = []
    ops.reset_launch_counts()
    for backend in ("numpy", "torch"):
        sess = Session(num_partitions=4, expr_backend=backend)
        ds = sess.load("lineitem", lines, LineitemQ1)
        results.append(q1_pricing_summary(sess.store, ds.set_name,
                                          session=sess).collect())
    counts = ops.launch_counts()
    assert counts["segment_reduce"] == 4 and counts["expr_core"] > 0
    for col in results[0]:
        assert results[0][col].tobytes() == results[1][col].tobytes(), col


# ----------------------------------------- four ranks sharing one card
def test_q1_over_four_thread_workers_on_the_card(torch):
    """Q1 over 4 thread workers sharing the card and over socket workers
    launched as threads: the local numpy backend's bytes; K1 once a batch
    that reaches its core and K2 once a rank with rows."""
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.data.synthetic import tpch_q1_lineitems
    from repro_torch.kernels import ops
    lines = tpch_q1_lineitems(200_000, seed=6)

    def q1(**kw):
        sess = Session(**kw)
        ds = sess.load("lineitem", lines, LineitemQ1)
        return q1_pricing_summary(sess.store, ds.set_name,
                                  session=sess).collect()

    want = q1(num_partitions=4, expr_backend="numpy")
    for kw in ({"worker_kind": "thread"},
               {"worker_kind": "socket", "socket_launch": "thread"}):
        ops.reset_launch_counts()
        got = q1(backend="workers", num_workers=4, **kw)
        counts = ops.launch_counts()
        for col in want:
            assert want[col].tobytes() == got[col].tobytes(), (kw, col)
        assert counts["segment_reduce"] == 4
        assert counts["expr_core"] >= 4 * -(-200_000 // 4 // 8192)


def test_k1_and_k2_from_four_threads_at_once(torch):
    """Four threads, each on its own stream, calling K1 (through the
    pinned staging as the engine does) and K2 over and over at once:
    every result bit-equal to the kernel's plain version, and the launch
    counts add up to every launch."""
    import threading

    from repro_torch.core.exprc import _run_core
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels.transfer import to_device, to_device_pinned
    dev = torch.device("cuda", 0)
    dts = {0: np.dtype(np.float64), 1: np.dtype(np.int64),
           2: np.dtype(np.float64), 3: np.dtype(bool)}
    prog = ec.encode([("*", 2, (0, 1)), (">", 3, (2, 0))], dts, [0, 1],
                     [2, 3])
    rounds, errors = 12, []
    ops.reset_launch_counts()
    barrier = threading.Barrier(4)

    def rank(k):
        try:
            rng = np.random.default_rng(k)
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                barrier.wait(timeout=60)
                for r in range(rounds):
                    n = 8192 - 97 * r
                    a = rng.standard_normal(n)
                    b = rng.integers(-9, 9, n)
                    got = _run_core(prog, [a, b], [False, False], n, dev)
                    plain = ec.expr_core_ref(
                        prog, to_device([a, b], torch.device("cpu")), n)
                    for g, p, dt in zip(got, plain, prog.out_dtypes):
                        assert g.tobytes() == p.numpy().view(dt).tobytes()
                    inv = rng.integers(0, 50, 100_000)
                    v = rng.standard_normal(100_000)
                    flat = to_device_pinned([[inv], [v]], dev, "agg")
                    acc, = ops.segment_reduce(flat[0], 50, [flat[1]],
                                              [v.dtype], ["sum"])
                    want, = sr.segment_reduce_ref(
                        torch.from_numpy(inv), 50, [torch.from_numpy(v)],
                        [v.dtype], ["sum"])
                    assert acc.cpu().numpy().tobytes() \
                        == want.numpy().tobytes()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append((k, e))

    threads = [threading.Thread(target=rank, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert ops.launch_counts()["expr_core"] == 4 * rounds
    assert ops.launch_counts()["segment_reduce"] == 4 * rounds


def test_launch_counter_totals_after_concurrent_launches(torch):
    """Eight threads launching K2 at once on their own streams: the count
    is every launch, none lost."""
    import threading

    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr
    dev = torch.device("cuda", 0)
    inv = torch.randint(0, 7, (4096,), device=dev)
    v = torch.randn(4096, device=dev, dtype=torch.float64)
    before = sr.LAUNCHES.count
    per, errors = 200, []

    def launch():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for _ in range(per):
                    ops.segment_reduce(inv, 7, [v], [np.dtype(np.float64)],
                                       ["max"])
                torch.cuda.current_stream(dev).synchronize()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    torch.cuda.synchronize()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert sr.LAUNCHES.count == before + 8 * per


def test_expr_core_from_new_threads_reading_cached_pinned_blocks(torch):
    """Threads that start after torch's host allocator has cached pinned
    blocks (the worker runtime's ranks, a new thread each query) get their
    staging from the cache, with no CUDA call of their own before K1's C
    entry checks the pinned pointers: each still launches, bit-equal to
    the plain version."""
    import threading

    from repro_torch.core.exprc import _run_core
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels.transfer import to_device
    dev = torch.device("cuda", 0)
    dts = {0: np.dtype(np.float64), 1: np.dtype(np.int64),
           2: np.dtype(np.float64)}
    prog = ec.encode([("*", 2, (0, 1))], dts, [0, 1], [2])
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal(8192), rng.integers(-9, 9, 8192)
    want = ec.expr_core_ref(prog, to_device([a, b], torch.device("cpu")),
                            8192)[0].numpy().view(np.float64)
    for _ in range(3):  # each round's threads end; their blocks are cached
        errors, outs = [], []

        def rank():
            try:
                outs.append(_run_core(prog, [a, b], [False, False], 8192,
                                      dev)[0])
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=rank) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(o.tobytes() == want.tobytes() for o in outs)


# ------------------------------------------------------ training kernels
@pytest.mark.parametrize("T,d,S,kept", [
    (4100, 2048, 60 * 344, 4 * 4100),  # qwen2-moe's training dispatch
    (64, 2048, 1001, 128),             # ragged S, most slots dropped
    (30, 7, 100, 60),                  # rows that are not 16-byte words
    (5, 16, 3, 0),                     # nothing kept: zeros
    (8, 7, 100, 80),                   # 10 slots a token: past the fan
    (4, 2048, 200, 150),               # ~38 slots: the ballot's 2nd word
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_bwd_kernel_matches_plain(torch, T, d, S, kept, dtype):
    from repro_torch.kernels import moe_dispatch as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_slots, moe_gather_bwd_ref
    rng = np.random.default_rng(T + S)
    ids = np.full(S, -1, np.int32)
    slots = rng.choice(S, kept, replace=False)
    ids[slots] = rng.permutation(np.resize(np.arange(T), kept))
    tids = torch.from_numpy(ids).cuda()
    keep = tids >= 0
    g = torch.from_numpy(rng.standard_normal((S, d), dtype=np.float32)).to(
        "cuda", getattr(torch, dtype))
    slots = gather_slots(tids, keep, T)
    assert slots.shape[1] == -(-kept // T)
    out = mg.moe_gather_bwd(g, slots)
    again = mg.moe_gather_bwd(g, slots)
    want = moe_gather_bwd_ref(g, slots)
    torch.cuda.synchronize()
    bits = torch.int16 if g.element_size() == 2 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits))
    assert torch.equal(out.view(bits), again.view(bits))
    # through the port's entry with autograd: forward and backward kernels,
    # given the map (as moe_apply gives it) or building it from the ids
    x = torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32)).to(
        "cuda", g.dtype).requires_grad_(True)
    for kw in ({"slots": slots}, {}):
        ops.reset_launch_counts()
        dx, = torch.autograd.grad(ops.moe_gather(x, tids, keep, **kw), x, g)
        counts = ops.launch_counts()
        assert counts["moe_gather"] == counts["moe_gather_bwd"] == 1
        assert torch.equal(dx.view(bits), want.view(bits))


@pytest.mark.parametrize("Bt,L,di,N", [
    (2, 33, 64, 8), (1, 100, 256, 16),
    (1, 7, 200, 16),    # L under one 16-step chunk, di not a warp multiple
    (4, 65, 128, 8),    # the reduced jamba's training shape
    (3, 1001, 40, 5),   # ragged L, N padded
])
def test_ssm_scan_bwd_kernel_matches_plain(torch, Bt, L, di, N):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ref import (ssm_scan_bwd_ref,
                                         ssm_scan_checkpointed_ref)
    dt, A, _, _, x = _scan_inputs(torch, Bt, L, di, N)
    rng = np.random.default_rng(1)
    proj = torch.from_numpy(rng.standard_normal(
        (Bt, L, 2 * N + 3), dtype=np.float32)).cuda()
    B, C = proj[..., 3:3 + N], proj[..., 3 + N:]  # strided, as the model's
    g = torch.from_numpy(rng.standard_normal((Bt, L, di),
                                             dtype=np.float32)).cuda()
    y, ck = ss.ssm_scan_checkpointed(dt, A, B, C, x)
    assert torch.equal(y, ss.ssm_scan(dt, A, B, C, x))
    ck_ref = ssm_scan_checkpointed_ref(dt, A, B, C, x)[1]
    assert float((ck - ck_ref).abs().max()) <= \
        1e-4 * max(1.0, float(ck_ref.abs().max()))
    want = ssm_scan_bwd_ref(dt, A, B, C, x, g)
    for channels in ss.BWD_CHANNELS:
        kw = dict(channels=channels)
        out = ss.ssm_scan_bwd(dt, A, B, C, x, g, ck=ck, **kw)
        again = ss.ssm_scan_bwd(dt, A, B, C, x, g, ck=ck, **kw)
        direct = ss.ssm_scan_bwd(dt, A, B, C, x, g, **kw)
        torch.cuda.synchronize()
        for name, got, w, a, b in zip(("ddt", "dA", "dB", "dC", "dx"), out,
                                      want, again, direct):
            assert got.shape == w.shape and torch.equal(got, a) \
                and torch.equal(got, b), (kw, name)
            err = float((got - w).abs().max() / w.abs().max())
            assert err <= 1e-4, (kw, name, err)
    out = ss.ssm_scan_bwd(dt, A, B, C, x, g)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (dt, A, proj, x)]
    lp = leaves[2]
    ops.reset_launch_counts()
    y = ops.ssm_scan(leaves[0], leaves[1], lp[..., 3:3 + N],
                     lp[..., 3 + N:], leaves[3])
    assert torch.equal(y.grad_fn.saved_tensors[5], ck)
    ddt, dA, dproj, dx = torch.autograd.grad(y, leaves, g)
    counts = ops.launch_counts()
    assert counts["ssm_scan"] == counts["ssm_scan_bwd"] == 1
    assert torch.equal(ddt, out[0]) and torch.equal(dA, out[1])
    assert torch.equal(dproj[..., 3:3 + N], out[2])
    assert torch.equal(dproj[..., 3 + N:], out[3]) and torch.equal(dx, out[4])


def test_training_on_the_card_follows_the_cpu(torch):
    """``train_loop`` at reduced_config (jamba: both training kernels) on
    the card and on the CPU from the same weights and batches: losses
    within 1e-3 relative, step for step."""
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    cfg = reduced_config(get_arch("jamba15_large"))
    w = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                     "float32").state_dict()
    kw = dict(reduced=False, steps=6, batch=4, seq=32, weights=w,
              log_every=100)
    card = train_loop(cfg, device="cuda", **kw)["losses"]
    host = train_loop(cfg, device="cpu", **kw)["losses"]
    np.testing.assert_allclose(card, host, rtol=1e-3)


def test_expert_parallel_forward_over_four_ranks_on_the_card(torch,
                                                             tmp_path):
    """The expert-parallel phase's smallest form: reduced qwen2-moe (4
    experts top-2, one shared) over a (data 1, model 4) mesh of four
    processes sharing the card (gloo on CUDA tensors), float32, each rank's attention through the
    flash kernel and its expert's dispatch through the gather kernel,
    against the single process's plain forward on the card (attention
    without the flash kernel, so the kernel is held too) within 2e-3 of
    log_softmax (tests/test_multidevice.py's bound), and its served tokens
    the single process's engine's."""
    import dataclasses

    from torch_mesh_ranks import run_ranks

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    cfg = reduced_config(get_arch("qwen2_moe"))
    model = build_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(0), torch.float32)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64),
                                               dtype=np.int32)
    serve = {"n_requests": 4, "max_new": 6, "batch_size": 2}
    with torch.no_grad():
        want, aux = model.forward({"tokens": torch.from_numpy(tokens).cuda()},
                                  Ctx())
        served = serve_model(model, **serve)["outputs"]
    ranks = run_ranks(tmp_path, {"checks": ["ep"], "ep": [{
        "name": "qwen", "cfg": dataclasses.asdict(cfg), "mesh": (1, 4),
        "shape": "prefill_32k", "use_flash": True, "tokens": tokens,
        "state": {k: v.cpu() for k, v in model.state_dict().items()},
        "serve": serve}]}, device="cuda")
    want = torch.log_softmax(want.cpu(), dim=-1)
    for r in ranks:
        res = r["ep"]["qwen"]
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert res["expert_shape"][1] == 1  # 4 experts over 4 ranks
        err = float((torch.log_softmax(res["logits"], dim=-1) - want)
                    .abs().max())
        assert err < 2e-3, err
        assert abs(res["aux"] - float(aux)) <= 1e-4 * abs(float(aux))
        assert res["launches"]["flash_attention"] == cfg.n_layers
        assert res["launches"]["moe_gather"] == cfg.n_layers
        assert res["served"] == served


def test_tensor_parallel_forward_over_four_ranks_on_the_card(torch,
                                                             tmp_path):
    """The tensor-parallel phase's smallest form: reduced nemotron-4-340b
    (4 heads of 16 over 2 kv heads, relu2, untied head) over a (data 1,
    model 4) mesh of four processes sharing the card (gloo on CUDA
    tensors), each holding a quarter of the heads, ff and vocab under
    ``param_specs``, float32, its attention through the flash kernel at
    one head, against the single process's plain forward on the card
    (attention without the flash kernel, so the kernel is held too)
    within 2e-3 of log_softmax (tests/test_multidevice.py's bound); its
    paged decode and paged serving the single process's."""
    import dataclasses

    from torch_mesh_ranks import _teacher_forced, run_ranks

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    cfg = reduced_config(get_arch("nemotron4_340b"))
    model = build_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(0), torch.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    dec = rng.integers(0, cfg.vocab_size, (2, 4), dtype=np.int32)
    serve = {"n_requests": 4, "max_new": 6, "batch_size": 2}
    with torch.no_grad():
        want = model.forward({"tokens": torch.from_numpy(tokens).cuda()},
                             Ctx())[0]
        steps = _teacher_forced(model, torch.from_numpy(dec).cuda(), None,
                                kv_layout="paged", page_size=4)
        served = serve_model(model, kv_layout="paged", page_size=4,
                             **serve)["outputs"]
    ranks = run_ranks(tmp_path, {"checks": ["tp"], "tp": [{
        "name": "nemotron", "cfg": dataclasses.asdict(cfg), "mesh": (1, 4),
        "shape": "prefill_32k", "use_flash": True, "tokens": tokens,
        "decode": dec, "serve": serve,
        "state": {k: v.cpu() for k, v in model.state_dict().items()}}]},
        device="cuda")
    want = torch.log_softmax(want.cpu(), dim=-1)
    for r in ranks:
        res = r["tp"]["nemotron"]
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert res["shapes"]["blocks.attn.wq"][-1] == 16  # one head of 4
        err = float((torch.log_softmax(res["logits"], dim=-1) - want)
                    .abs().max())
        assert err < 2e-3, err
        assert res["launches"]["flash_attention"] == cfg.n_layers
        for got, ref in zip(res["decode"]["paged"], steps):
            assert float((got - ref).abs().max()
                         / ref.abs().max()) < 1e-5
        assert res["served"]["paged"] == served


def test_mesh_training_over_four_ranks_on_the_card(torch, tmp_path):
    """Training over the mesh at its smallest: reduced qwen2-moe (4
    experts top-2, one shared) over a (data 1, model 4) mesh of four
    processes sharing the card (gloo on CUDA tensors), each holding its
    slices under ``param_specs``, 3 steps of ``make_train_step`` (each
    rank's expert through the gather kernel and its backward kernel),
    against the single process's steps on the card: losses within 1e-5
    relative, the first gradient gathered whole within 1e-5 of each leaf's
    largest |g| plus 1e-6, the whole leaves the same bits on every rank."""
    import dataclasses

    from torch_mesh_ranks import run_ranks

    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.engine import TrainConfig, make_grad_fn, make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.params import flatten
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    cfg = reduced_config(get_arch("qwen2_moe"))
    model = build_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(0), torch.float32)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
        batches.append({"tokens": tokens, "labels": tokens})
    lr = (1e-3, 1, 3)
    params = tr.tree_map(lambda p: p.detach().clone(), model.params())
    step = make_train_step(model, Ctx(), TrainConfig(), warmup_cosine(*lr))
    opt = init_opt_state(params, AdamWConfig())
    losses = []
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        if i == 0:
            _, _, g = make_grad_fn(model, Ctx())(params, tb)
            grads = {k: t.cpu() for k, t in flatten(g).items()}
        params, opt, _, met = step(params, opt, None, tb)
        losses.append(float(met["total_loss"]))
    ranks = run_ranks(tmp_path, {"checks": ["train"], "lr": lr, "train": [{
        "name": "qwen", "cfg": dataclasses.asdict(cfg), "mesh": (1, 4),
        "state": {k: v.cpu() for k, v in model.state_dict().items()},
        "batches": batches}]}, device="cuda")
    res = sorted((r["train"]["qwen"] for r in ranks),
                 key=lambda r: r["coords"]["model"])
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert r["launches"]["moe_gather"] == 3 * cfg.n_layers
        assert r["launches"]["moe_gather_bwd"] == 3 * cfg.n_layers
        assert r["launches"]["flash_attention"] == 0
    for key, want in grads.items():
        spec = res[0]["specs"][key]
        dim = next((i for i, e in enumerate(spec) if e is not None), None)
        blocks = [r["grads"][key] for r in res]
        got = blocks[0] if dim is None else torch.cat(blocks, dim)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max()) + 1e-6, key
        if dim is None:
            assert all(torch.equal(r["params"][key], res[0]["params"][key])
                       for r in res), key


def test_fsdp_training_over_four_ranks_on_the_card(torch, tmp_path):
    """FSDP at its smallest: reduced qwen2-moe at its published plan
    (``fsdp=True``, ``remat="full"``) over a (data 4, model 1) mesh of
    four processes sharing the card, each holding its blocks of the
    leaves over ``data`` (all-gathered where a layer takes them, inside
    its remat region; the gradients reduce-scattered), 3 steps of
    ``make_train_step`` against the single process's on the card: losses
    within 1e-5 relative, the gather kernel twice a layer a step (the
    forward and remat's recompute) and its backward once."""
    import dataclasses

    from torch_mesh_ranks import run_ranks

    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.engine import TrainConfig, make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    cfg = dataclasses.replace(reduced_config(get_arch("qwen2_moe")),
                              fsdp=True, remat="full")
    model = build_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(0), torch.float32)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
        batches.append({"tokens": tokens, "labels": tokens})
    lr = (1e-3, 1, 3)
    params = tr.tree_map(lambda p: p.detach().clone(), model.params())
    step = make_train_step(model, Ctx(), TrainConfig(), warmup_cosine(*lr))
    opt = init_opt_state(params, AdamWConfig())
    losses = []
    for b in batches:
        tb = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        params, opt, _, met = step(params, opt, None, tb)
        losses.append(float(met["total_loss"]))
    ranks = run_ranks(tmp_path, {"checks": ["train"], "lr": lr, "train": [{
        "name": "qwen", "cfg": dataclasses.asdict(cfg), "mesh": (4, 1),
        "state": {k: v.cpu() for k, v in model.state_dict().items()},
        "batches": batches}]}, device="cuda")
    for r in (r["train"]["qwen"] for r in ranks):
        assert r["fsdp"] == 4
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert r["launches"]["moe_gather"] == 2 * 3 * cfg.n_layers
        assert r["launches"]["moe_gather_bwd"] == 3 * cfg.n_layers
        assert r["launches"]["flash_attention"] == 0


def test_hybrid_split_over_four_ranks_on_the_card(torch, tmp_path):
    """The hybrid split at its smallest: reduced jamba (Mamba's ``inner``
    over the model axis, a quarter of the channels a rank) over a (data
    1, model 4) mesh of four processes sharing the card, float32: the
    prefill through flash and P4 on each rank's channels against the
    single process's plain forward on the card within 2e-3 of
    log_softmax, its paged decode within 1e-5 of the largest logit and
    its paged serving the single process's; ``inner_halves`` on CUDA
    tensors (gloo's all-to-all of uneven splits) exactly the rank's
    channels, and one Mamba layer's output and gradients (P4 and its
    backward on the rank's channels) within 1e-5 and 1e-4 of the single
    process's on the card."""
    import dataclasses

    from torch_mesh_ranks import Grid, _teacher_forced, run_ranks

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.distributed.elastic import local_index
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import Ctx, build_model
    from repro_torch.models.ssm import mamba_apply
    cfg = reduced_config(get_arch("jamba15_large"))
    model = build_model(cfg).init_params(
        torch.Generator("cuda").manual_seed(0), torch.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    dec = rng.integers(0, cfg.vocab_size, (2, 4), dtype=np.int32)
    serve = {"n_requests": 4, "max_new": 6, "batch_size": 2}
    di = cfg.ssm_expand * cfg.d_model
    layer = {k: v[0].detach().cpu().numpy().copy()
             for k, v in model.params()["groups"]["mamba"].items()}
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    xz = rng.standard_normal((2, 8, 2 * di)).astype(np.float32)
    with torch.no_grad():
        want = model.forward({"tokens": torch.from_numpy(tokens).cuda()},
                             Ctx())[0]
        steps = _teacher_forced(model, torch.from_numpy(dec).cuda(), None,
                                kv_layout="paged", page_size=4)
        served = serve_model(model, kv_layout="paged", page_size=4,
                             **serve)["outputs"]
    p = {k: torch.from_numpy(v).cuda().requires_grad_(True)
         for k, v in layer.items()}
    xt = torch.from_numpy(x).cuda().requires_grad_(True)
    y1 = mamba_apply(cfg, p, xt, Ctx())
    g1 = dict(zip(["x", *p], torch.autograd.grad(
        y1, [xt, *p.values()], torch.from_numpy(gy).cuda())))
    y1 = y1.detach().cpu()
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    ranks = run_ranks(tmp_path, {"checks": ["tp", "hybrid"], "tp": [{
        "name": "jamba", "cfg": dataclasses.asdict(cfg), "mesh": (1, 4),
        "shape": "prefill_32k", "use_flash": True, "tokens": tokens,
        "decode": dec, "serve": serve, "state": state}], "hybrid": [{
            "name": "jamba", "cfg": dataclasses.asdict(cfg), "mesh": (1, 4),
            "xz": xz, "g": xz, "layer": layer, "x": x, "gy": gy,
            "state": state, "decode": dec}]}, device="cuda")
    want = torch.log_softmax(want.cpu(), dim=-1)
    w = di // 4
    for r in ranks:
        res = r["tp"]["jamba"]
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert res["shapes"]["groups.mamba.D"][-1] == w
        err = float((torch.log_softmax(res["logits"], dim=-1) - want)
                    .abs().max())
        assert err < 2e-3, err
        assert res["launches"]["ssm_scan"] == cfg.n_layers // 2
        assert res["launches"]["flash_attention"] == cfg.n_layers // 2
        for got, ref in zip(res["decode"]["paged"], steps):
            assert float((got - ref).abs().max()
                         / ref.abs().max()) < 1e-5
        assert res["served"]["paged"] == served
        hy = r["hybrid"]["jamba"]
        m = hy["coords"]["model"]
        assert np.array_equal(hy["halves"].numpy(), np.concatenate(
            [xz[..., m * w:(m + 1) * w], xz[..., di + m * w:di + (m + 1) * w]],
            -1))
        assert float((hy["y"] - y1).abs().max()) <= \
            1e-5 * float(y1.abs().max())
        grid = Grid({"data": 1, "model": 4}, data=0, model=m)
        for key, got in hy["grads"].items():
            full = g1[key].cpu()
            mine = full if key == "x" else full[local_index(
                full.shape, hy["layer_specs"][key], grid)]
            assert float((got - mine).abs().max()) <= \
                1e-4 * float(full.abs().max()), key
