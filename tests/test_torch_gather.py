"""The port's gather entry against the reference's oracle over the row
layouts the CUDA kernel tells apart, and the wrapper's refusals, on the
CPU.

The kernel (``csrc/moe_gather.cu``) copies a row in 16-byte words where
x's base, its row stride and the row bytes are whole 16-byte words, and
element by element otherwise. ``repro_torch.kernels.ops.moe_gather`` takes
the plain version for CPU tensors; here it meets
``repro.kernels.ref.moe_gather_ref`` bit for bit on rows of each kind,
on x itself and on x as a column slice of a wider matrix, at the model's
dispatch widths and at slot counts that do not fill the kernel's blocks.
The kernel itself is held bit for bit against the plain version at the
same layouts on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def torch():
    return pytest.importorskip("torch")


def _bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("T,d,S,width,offset,dtype", [
    (4, 2048, 480, 2048, 0, "bfloat16"),     # qwen2-moe decode at batch 4
    (64, 2048, 1001, 2048, 0, "bfloat16"),   # 4 KB rows, ragged S
    (64, 2048, 333, 2048, 0, "float32"),     # 8 KB rows
    (40, 5120, 96, 5120, 0, "bfloat16"),     # 10 KB rows
    (100, 48, 333, 48, 0, "float32"),        # 192-byte rows
    (30, 7, 100, 7, 0, "bfloat16"),          # rows of 14 bytes
    (30, 6, 100, 6, 0, "float32"),           # rows of 24 bytes
    (64, 2048, 480, 2 * 2048 + 8, 8, "bfloat16"),  # column slice, aligned
    (64, 2048, 480, 2051, 0, "bfloat16"),    # row stride of 4,102 bytes
    (64, 2048, 480, 2052, 4, "bfloat16"),    # base 8 bytes past 16
    (50, 1032, 3, 2 * 1032, 0, "float32"),   # three slots
    (9, 16, 1, 16, 0, "float32"),            # one slot
])
def test_ops_moe_gather_matches_oracle_over_row_layouts(torch, T, d, S,
                                                        width, offset,
                                                        dtype):
    """x is columns [offset, offset + d) of a (T, width) matrix; unkept
    slots hold -1 as the model's dispatch leaves them, and two kept ids are
    out of range (clamped)."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    rng = np.random.default_rng(S + d)
    wide = rng.standard_normal((T, width), dtype=np.float32)
    ids = rng.integers(0, T, S).astype(np.int32)
    keep = rng.random(S) < 0.75
    keep[:min(S, 2)] = True
    ids[~keep] = -1
    ids[:min(S, 2)] = [T + 5, -3][:min(S, 2)]
    x_np = wide[:, offset:offset + d]
    want = jref.moe_gather_ref(jnp.asarray(x_np).astype(jnp.dtype(dtype)),
                               jnp.asarray(ids), jnp.asarray(keep))
    x = torch.from_numpy(wide).to(getattr(torch, dtype))[:, offset:offset + d]
    assert x.stride() == (width, 1)
    got = ops.moe_gather(x, torch.from_numpy(ids), torch.from_numpy(keep))
    assert got.shape == (S, d) and got.dtype == x.dtype
    assert got.is_contiguous()
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        x.dtype)
    assert torch.equal(_bits(torch, got), _bits(torch, want_t))


@pytest.mark.parametrize("shapes", [
    ((4, 8), (6,), (6, 1)),    # keep not 1-d
    ((4, 8, 2), (6,), (6,)),   # x 3-d
    ((4, 8), (), ()),          # ids 0-d
])
def test_ops_moe_gather_refuses_mismatched_shapes(torch, shapes):
    from repro_torch.kernels import ops
    xs, ids, keep = shapes
    with pytest.raises(ValueError):
        ops.moe_gather(torch.zeros(xs), torch.zeros(ids, dtype=torch.int32),
                       torch.ones(keep, dtype=torch.bool))


def test_ops_moe_gather_never_sends_other_devices_to_the_plain_version(
        torch):
    """Only CPU tensors take the plain version; a tensor on any other
    device goes to the kernel's wrapper, which refuses what is not CUDA
    before it allocates, and counts no launch."""
    from repro_torch.kernels import moe_dispatch as mg
    from repro_torch.kernels import ops
    x = torch.zeros(4, 8, device="meta")
    ids = torch.zeros(6, dtype=torch.int32, device="meta")
    keep = torch.ones(6, dtype=torch.bool, device="meta")
    before = mg.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_gather(x, ids, keep)
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gather(torch.zeros(4, 8), ids.new_zeros(6, device="cpu"),
                      keep.new_ones(6, device="cpu"))
    assert mg.LAUNCHES.count == before


def test_ops_moe_gather_on_the_cpu_is_the_plain_version(torch):
    """Bit for bit the plain version, kept ids clamped, unkept rows 0."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_gather_ref
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 16), dtype=np.float32))
    ids = torch.tensor([0, 8, -1, 20, -3, 4], dtype=torch.int32)
    keep = torch.tensor([True, True, False, True, True, False])
    got = ops.moe_gather(x, ids, keep)
    assert torch.equal(got, moe_gather_ref(x, ids, keep))
    assert torch.equal(got[3], x[8]) and torch.equal(got[4], x[0])
    assert not got[2].any() and not got[5].any()
