"""Flash attention at the head dims of the reference's other configs, on
the CPU: the port's entry against the reference's Pallas kernel, the plain
version of the CUDA kernel's tiled algorithm against the reference's
oracle, and the kernel's tile plan.

``repro.kernels.ops.flash_attention`` runs the Pallas kernel in interpret
mode, as tests/test_kernels.py runs it; ``repro.kernels.ref.attention_ref``
is its oracle. The same numpy-seeded inputs go through both sides.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (the tiled version rounds the unnormalised softmax weights to
bf16 before P@V, as the kernel does). The CUDA kernel itself is held
against the plain versions on the card by tests/test_torch_cuda.py."""
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


def _inputs(torch, B, S, T, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, dtype):
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# (B, S, T, H, K, hd, causal): phi3-mini's 96, nemotron-4-340b's 192 and
# gemma-7b's 256, GQA and MHA, S ragged against the 64-row blocks, T != S
CASES = [
    (1, 100, 100, 4, 4, 96, True),    # MHA, ragged
    (2, 64, 64, 8, 2, 96, False),     # GQA
    (1, 70, 130, 4, 2, 96, False),    # T != S
    (1, 100, 100, 6, 2, 192, True),   # GQA, ragged
    (1, 72, 72, 2, 2, 192, False),    # MHA
    (1, 40, 150, 4, 1, 192, False),   # MQA, T != S
    (1, 90, 90, 2, 2, 256, True),     # MHA, ragged
    (1, 64, 64, 4, 2, 256, False),    # GQA
    (1, 48, 160, 4, 2, 256, False),   # T != S
]


@pytest.mark.parametrize("B,S,T,H,K,hd,causal", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_at_wide_heads(
        torch, B, S, T, H, K, hd, causal, dtype):
    from repro_torch.kernels import ops
    (jq, jk, jv), (tq, tk, tv) = _inputs(torch, B, S, T, H, K, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got.float().numpy(), want, dtype)


# The tiled walk over several q and kv tiles: the kernel's own plan for
# each head dim, and small tiles (a kv tile shorter than a q tile, as the
# bf16 plan has at hd 192 and 256; S, T not multiples of either).
TILED = [
    (1, 300, 300, 4, 2, 64, True, None),
    (1, 260, 260, 2, 2, 96, True, None),
    (1, 300, 300, 2, 1, 128, True, None),
    (1, 200, 200, 3, 1, 192, True, None),
    (1, 200, 200, 2, 2, 256, True, None),
    (2, 100, 70, 4, 2, 96, False, (64, 32)),
    (1, 150, 150, 2, 2, 256, True, (128, 80)),
    (1, 90, 33, 4, 4, 192, False, (32, 16)),
    (1, 5, 300, 2, 1, 16, False, None),  # S shorter than one q tile
    (1, 300, 5, 2, 1, 32, False, None),  # T shorter than one kv tile
]


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,tiles", TILED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_version_matches_reference_oracle(torch, B, S, T, H, K, hd,
                                                causal, tiles, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_tiled_ref
    (jq, jk, jv), (tq, tk, tv) = _inputs(torch, B, S, T, H, K, hd, dtype,
                                         seed=1)
    q_tile, kv_tile = tiles or fa.plan(hd, getattr(torch, dtype))[:2]
    got = flash_attention_tiled_ref(tq, tk, tv, causal, q_tile, kv_tile)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    _close(got.float().numpy(), want, dtype)


def test_tiled_version_rounds_p_as_the_kernel_does(torch):
    """In bf16 the tiled version's P@V takes P rounded to bf16: it is not
    the float32 computation rounded once at the end."""
    from repro_torch.kernels.ref import attention_ref, \
        flash_attention_tiled_ref
    _, (q, k, v) = _inputs(torch, 1, 200, 200, 2, 1, 128, "bfloat16")
    tiled = flash_attention_tiled_ref(q, k, v, True, 128, 64)
    exact = attention_ref(q.float(), k.float(), v.float()).to(q.dtype)
    assert not torch.equal(tiled, exact)
    _close(tiled.float().numpy(), exact.float().numpy(), "bfloat16")


@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 192, 256])
def test_plan_fits_the_card(torch, hd):
    """Every instance's plan: shared memory within one block's 232,448
    bytes; bf16: a q tile of whole 64-row wgmma M, a kv tile a multiple of
    8 (the wgmma N) and 16 (the P@V K) up to 256, a ring of >= 2 stages
    and a swizzle span that divides the row's bytes; f32: the FMA
    kernel's 32 x 32 tiles, no swizzle."""
    from repro_torch.kernels import flash_attention as fa
    assert hd in fa.HEAD_DIMS
    p = fa.plan(hd, torch.bfloat16)
    assert p.smem_bytes <= fa.SMEM_LIMIT == 232_448
    assert p.q_tile % 64 == 0
    assert p.kv_tile % 16 == 0 and 8 <= p.kv_tile <= 256
    assert p.stages >= 2
    assert p.swizzle in (32, 64, 128) and (2 * hd) % p.swizzle == 0
    # the ring and Q fill what they claim
    assert p.smem_bytes >= p.q_tile * hd * 2 + p.stages * 4 * p.kv_tile * hd
    f = fa.plan(hd, torch.float32)
    assert f.smem_bytes <= fa.SMEM_LIMIT and f.swizzle == 0
    assert (f.q_tile, f.kv_tile) == (32, 32)


def test_plan_at_the_prefill_head_dims(torch):
    from repro_torch.kernels import flash_attention as fa
    assert fa.plan(128, torch.bfloat16) == (128, 128, 3, 128, 230_480)
    assert fa.plan(96, torch.bfloat16) == (128, 128, 4, 64, 222_312)
    assert fa.plan(192, torch.bfloat16) == (128, 64, 3, 128, 197_712)
    assert fa.plan(256, torch.bfloat16) == (128, 80, 2, 128, 230_456)


@pytest.mark.parametrize("hd", [8, 48, 100, 112, 160, 320])
def test_head_dims_without_an_instance_are_refused(torch, hd):
    from repro_torch.kernels import flash_attention as fa
    with pytest.raises(ValueError, match="head dim"):
        fa.plan(hd, torch.bfloat16)


def test_wrapper_refuses_before_any_build_or_launch(torch, monkeypatch):
    """A head dim outside the set, strides that are not whole 16-byte
    words, a dtype the kernel does not take: each raises before the
    library is built or a launch is counted."""
    from repro_torch.kernels import flash_attention as fa

    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(fa, "build", no_build)
    before = fa.LAUNCHES.count
    _, (q, k, v) = _inputs(torch, 1, 16, 16, 2, 1, 48, "bfloat16")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)
    # q as a view of a (B, S, H, hd + 4) buffer: row strides of 2*100 bytes
    buf = torch.zeros(1, 16, 2, 100, dtype=torch.bfloat16)
    q96 = buf[..., :96]
    _, (_, k96, v96) = _inputs(torch, 1, 16, 16, 2, 1, 96, "bfloat16")
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd(q96, k96, v96)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q96.half(), k96.half(), v96.half())
    assert fa.LAUNCHES.count == before
