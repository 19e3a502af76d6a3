"""The split-sequence algorithm of the port's paged-attention kernel,
``repro_torch.kernels.ref.paged_attention_split_ref`` (per-span partials
merged by the log-sum-exp rule in span order), against the reference's
oracle ``repro.kernels.ref.paged_attention_ref``, on the CPU; and the
wrapper's span plan, which depends on static shapes only.

Inputs are numpy-seeded: pages a random permutation of a larger pool; a
row whose length ends inside a span with a hole inside it, a short row
(later spans wholly past its length), a row of holes only, a length-0 row
over real pages (both of the last the reference's uniform mean of V), and
a full row. Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, those of
tests/test_kernels.py (online softmax against the full softmax)."""
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


def _inputs(G, hd, seed=3):
    """B=5, K=2, page 6, 7 table entries (42 positions per row)."""
    rng = np.random.default_rng(seed)
    B, K, ps, maxp = 5, 2, 6, 7
    P = 2 * B * maxp
    q = rng.standard_normal((B, K * G, hd), dtype=np.float32)
    kp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    vp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    tables = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.array([23, 5, 30, 0, maxp * ps], np.int32)
    tables[0, 1] = -1  # a hole inside row 0's length
    tables[2] = -1     # holes only
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("G,hd", [(5, 64), (5, 96), (5, 128), (5, 192),
                                  (5, 256), (1, 128), (8, 128), (12, 128)])
@pytest.mark.parametrize("pages_per_span", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_reference_oracle(torch, G, hd, pages_per_span,
                                            dtype):
    from repro_torch.kernels.ref import paged_attention_split_ref
    q, kp, vp, tables, lengths = _inputs(G, hd)
    want = jref.paged_attention_ref(
        *(jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(lengths))
    tdt = getattr(torch, dtype)
    # 3 pages of 6 do not divide the 7-page row: the last span is short
    got = paged_attention_split_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(lengths),
        tokens_per_span=pages_per_span * kp.shape[1])
    assert got.dtype == tdt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_split_ref_rows_without_a_valid_position_are_the_mean(torch):
    """Rows 2 (holes only: page 0 gathered everywhere) and 3 (length 0
    over real pages) give the uniform mean of V over their gathered
    positions, as the reference's softmax over -1e30 scores does."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    q, kp, vp, tables, lengths = _inputs(5, 64)
    got = paged_attention_split_ref(
        *map(torch.from_numpy, (q, kp, vp, tables, lengths)),
        tokens_per_span=12).numpy()
    page0 = vp[0].mean(axis=0).repeat(5, axis=0)  # (K*G, hd)
    np.testing.assert_allclose(got[2], page0, atol=2e-5, rtol=2e-5)
    rows = vp[tables[3]].reshape(-1, 2, 64).mean(axis=0).repeat(5, axis=0)
    np.testing.assert_allclose(got[3], rows, atol=2e-5, rtol=2e-5)


def test_split_ref_wants_whole_pages(torch):
    from repro_torch.kernels.ref import paged_attention_split_ref
    args = tuple(map(torch.from_numpy, _inputs(1, 64)))
    for bad in (0, 7):
        with pytest.raises(ValueError, match="multiple of the page"):
            paged_attention_split_ref(*args, tokens_per_span=bad)


@pytest.mark.parametrize("B,K,max_pages,page", [
    (32, 8, 64, 64),    # qwen2.5-32b decode
    (8, 8, 32, 128),    # jamba
    (4, 16, 8, 64),     # qwen2-moe
    (4, 8, 64, 64),     # qwen2.5-32b at long context, batch 4
    (2, 8, 9, 5),       # nemotron's kv heads, odd page
    (3, 2, 4, 16),      # few pages
    (1, 1, 1, 16),      # one page: one span
    (1, 1, 4096, 1),    # 4,096 one-token pages: at most MAX_SPANS
])
def test_span_plan_is_whole_pages_from_static_shapes(torch, B, K, max_pages,
                                                     page):
    from repro_torch.kernels import paged_attention as pa
    tokens, n = pa.span_plan(B, K, max_pages, page)
    assert tokens % page == 0 and tokens >= page
    assert (n - 1) * tokens < max_pages * page <= n * tokens
    blocks = B * K * n
    # near the target (whole pages round the span up), unless spans are
    # as short as allowed, or as long
    assert 2 * blocks > pa.TARGET_BLOCKS or n == max_pages or \
        tokens <= max(page, pa.MIN_SPAN_TOKENS) or \
        tokens >= pa.MAX_SPAN_TOKENS - page
    assert tokens <= max(page, pa.MAX_SPAN_TOKENS) or n == pa.MAX_SPANS
    assert n <= pa.MAX_SPANS
