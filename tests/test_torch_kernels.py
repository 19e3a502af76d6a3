"""The port's kernel entry against the reference's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` takes its plain version for CPU
tensors; ``repro.kernels.ops.flash_attention`` runs the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it. The same numpy-seeded
inputs go through both. Tolerances are those of tests/test_kernels.py:
2e-5 in float32, 2e-2 in bfloat16. The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py."""
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
    from repro_torch.kernels import ops
    _, (q, k, v) = _inputs(torch, 1, 8, 8, 2, 1, 16, "float32")
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts() == {"flash_attention": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)  # the kernel wrapper never runs CPU
    assert fa.LAUNCHES.count == 0


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
