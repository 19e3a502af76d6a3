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
holds the Pallas kernel (online softmax against the plain full softmax)."""
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
