"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips (from inside the test, never
at collection) when ``torch.cuda.is_available()`` is false.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (the kernel rounds the softmax weights to bf16 before P@V, as
the model's plain path does)."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_inputs(torch, dtype):
    """q, k, v as views of the fused projection (B,S,(H+2K)*hd): no copies
    in the wrapper, the kernel walks the strides."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    B, S, H, K, hd = 2, 130, 8, 2, 64
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
