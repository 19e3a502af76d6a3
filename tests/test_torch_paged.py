"""The port's paged KV path and int8 KV cache against the reference, on the
CPU.

``repro_torch.kernels.ops.paged_attention`` takes its plain version for
CPU tensors; it is held against the reference's oracle
``repro.kernels.ref.paged_attention_ref``. The reference's Pallas
``paged_attention`` is not called: its body uses ``pl.load``, which the
installed JAX's ``jax.experimental.pallas`` no longer has, so it fails
before it computes (tests/test_kernels.py::test_paged_attention_sweep). The
CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.

The reference decodes only against its dense cache, so the port's decode
over the paged pool is held against the reference's dense decode, and the
port's engine over the paged pool against the reference's engine, token
for token. Weights are the reference's ``init_params(PRNGKey(0), ...)``
carried over with ``from_jax_params``; inputs are numpy-seeded.

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 for the attention (those
of tests/test_kernels.py); the page pool's bytes exactly; 1e-4 for
whole-model float32 logits (tests/test_torch_models.py's decode
tolerance: the same sums in another order); int8 values and scales bit
for bit (``torch.round`` and ``jnp.round`` both round half to even)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.engine.serve_step import ServingEngine as JEngine
from repro.kernels import ref as jref
from repro.models import Ctx as JCtx
from repro.objectmodel import kvcache as jkv
from torch_parity import carry, port_cfg


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _lifted(arch):
    """The reduced config; a MoE one with the capacity lifted to n_experts,
    so that no slot is dropped on either side whatever the batch."""
    cfg = reduced_config(get_arch(arch))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


# ------------------------------------------------------------ the kernel
def _sweep_inputs(B, H, K, hd, ps, maxp, seed=1):
    """tests/test_kernels.py's paged sweep: pages handed out in order,
    P = B * maxp + 2, lengths in [1, maxp * ps)."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 2
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    kp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    vp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    lengths = rng.integers(1, maxp * ps, B).astype(np.int32)
    tables = np.full((B, maxp), -1, np.int32)
    nxt = 0
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            tables[b, j] = nxt
            nxt += 1
    return q, kp, vp, tables, lengths


def _grouped_inputs(seed=2):
    """G=5 (H=10, K=2): pages a random permutation of a larger pool, a
    hole inside row 0's length, row 3 all holes, row 2 of length 0."""
    rng = np.random.default_rng(seed)
    B, H, K, hd, ps, maxp = 5, 10, 2, 32, 8, 6
    P = 3 * B * maxp
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    kp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    vp = rng.standard_normal((P, ps, K, hd), dtype=np.float32)
    tables = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = rng.integers(1, maxp * ps + 1, B).astype(np.int32)
    lengths[0] = 3 * ps + 5
    tables[0, 1] = -1
    tables[3] = -1
    lengths[2] = 0
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("case", [
    (3, 8, 2, 32, 16, 4), (1, 4, 4, 64, 8, 6), (2, 2, 1, 128, 32, 2),
    (2, 4, 2, 96, 8, 3), (2, 2, 2, 256, 4, 3), "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_reference_oracle(torch, case, dtype):
    from repro_torch.kernels import ops
    arrs = (_grouped_inputs() if case == "grouped"
            else _sweep_inputs(*case))
    q, kp, vp, tables, lengths = arrs
    want = jref.paged_attention_ref(
        *(jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(lengths))
    tdt = getattr(torch, dtype)
    got = ops.paged_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert got.dtype == tdt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_paged_attention_row_of_holes_is_the_mean_of_page_zero(torch):
    """An idle serving slot's row: every table entry -1. The reference
    gathers page 0 for each entry and softmaxes over -1e30 scores only,
    which is uniform: the mean of page 0's V rows."""
    from repro_torch.kernels import ops
    q, kp, vp, tables, lengths = _grouped_inputs()
    got = ops.paged_attention(*map(torch.from_numpy,
                                   (q, kp, vp, tables, lengths)))
    mean = vp[0].mean(axis=0).repeat(5, axis=0)  # (K*G, hd), G=5
    np.testing.assert_allclose(got[3].numpy(), mean, atol=2e-5, rtol=2e-5)


def test_paged_attention_checks_shapes_and_counts_no_cpu_launch(torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, tables, lengths = map(torch.from_numpy,
                                     _sweep_inputs(3, 8, 2, 32, 16, 4))
    ops.reset_launch_counts()
    ops.paged_attention(q, kp, vp, tables, lengths)
    assert ops.launch_counts()["paged_attention"] == 0
    with pytest.raises(ValueError, match="disagree"):
        ops.paged_attention(q[:, :7], kp, vp, tables, lengths)  # H % K
    with pytest.raises(ValueError, match="disagree"):
        ops.paged_attention(q, kp, vp, tables[:2], lengths)
    with pytest.raises(ValueError, match="want"):
        ops.paged_attention(q, kp, vp[:, :, :1], tables, lengths)
    with pytest.raises(ValueError, match="want"):
        ops.paged_attention(q[:, None], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q, kp, vp, tables, lengths)  # never the CPU
    assert pa.LAUNCHES.count == 0


# ---------------------------------------------------- the device side
def _kv_cfgs(**kw):
    from repro_torch.objectmodel.kvcache import KVCacheConfig
    base = dict(n_layers=2, n_kv_heads=2, head_dim=4, max_seq_len=64,
                page_size=8, num_pages=16, dtype="float32")
    base.update(kw)
    return KVCacheConfig(**base), jkv.KVCacheConfig(**base)


def _same_bytes(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and str(got.dtype).endswith(
        str(want.dtype))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shards", [1, 2])
def test_init_paged_state_matches_reference(torch, shards):
    from repro_torch.objectmodel.kvcache import init_paged_state
    mine, ref = _kv_cfgs(num_shards=shards)
    got, want = init_paged_state(mine, 3), jkv.init_paged_state(ref, 3)
    for g, w in zip(got, want):
        _same_bytes(g, w)


@pytest.mark.parametrize("shards", [1, 2])
def test_paged_append_and_gather_match_reference(torch, shards):
    """tests/test_kvcache.py's round trip, on both packages: the same
    pages placed by the page manager, the same tokens appended; the pool,
    the lengths and each sequence's gathered K/V agree byte for byte, and
    the kernel's global tables address the same rows."""
    from repro_torch.objectmodel import kvcache as tkv
    mine, ref = _kv_cfgs(num_shards=shards)
    mgr = tkv.KVPageManager(mine)
    state, jstate = tkv.init_paged_state(mine, 2), jkv.init_paged_state(ref, 2)
    for b in range(2):
        mgr.allocate(b, 20)
    tables = mgr.build_tables([0, 1])
    state.block_tables.copy_(torch.from_numpy(tables))
    jstate = jstate._replace(block_tables=jnp.asarray(tables))
    rng = np.random.default_rng(0)
    for _ in range(20):
        k = rng.standard_normal((2, 2, 2, 4), dtype=np.float32)
        phys = np.asarray([mgr.tail_physical_page(b) for b in range(2)],
                          np.int32)
        state = tkv.paged_append(state, torch.from_numpy(k),
                                 torch.from_numpy(k + 1),
                                 torch.from_numpy(phys))
        jstate = jkv.paged_append(jstate, jnp.asarray(k), jnp.asarray(k + 1),
                                  jnp.asarray(phys))
        for b in range(2):
            mgr.advance(b)
    _same_bytes(state.k_pages, jstate.k_pages)
    _same_bytes(state.v_pages, jstate.v_pages)
    _same_bytes(state.length, jstate.length)
    glob = tkv.global_page_tables(state.block_tables, mine.pages_per_shard)
    for seq in range(2):
        got = tkv.gather_paged_kv(state, mine, seq)
        want = jkv.gather_paged_kv(jstate, ref, seq)
        for g, w in zip(got, want):
            _same_bytes(g, w)
        ids = glob[seq][glob[seq] >= 0].long()
        rows = state.k_pages[:, ids].flatten(1, 2)[:, :20]
        _same_bytes(rows, want[0])


def test_reference_paged_state_loads_into_the_port(torch):
    """A reference PagedKVState, as numpy, is the port's: its gather gives
    the same bytes (holes included, read as zeros)."""
    from repro_torch.objectmodel import kvcache as tkv
    mine, ref = _kv_cfgs(num_shards=2, dtype="bfloat16")
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((2, 16, 8, 2, 4), dtype=np.float32)
    tables = np.asarray([[[3, -1, 1, -1], [0, 2, -1, -1]],
                         [[7, 5, -1, -1], [-1, 6, -1, -1]]], np.int32)
    jstate = jkv.PagedKVState(jnp.asarray(pool, jnp.bfloat16),
                              jnp.asarray(-pool, jnp.bfloat16),
                              jnp.asarray(tables),
                              jnp.asarray([29, 21], jnp.int32))
    arrays = [np.array(a) for a in jstate]
    state = tkv.PagedKVState(
        torch.from_numpy(arrays[0].view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(arrays[1].view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(arrays[2]), torch.from_numpy(arrays[3]))
    for seq in range(2):
        got = tkv.gather_paged_kv(state, mine, seq)
        want = jkv.gather_paged_kv(jstate, ref, seq)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), np.asarray(w).view(np.int16))


def test_dense_append_matches_reference(torch):
    from repro_torch.objectmodel import kvcache as tkv
    mine, ref = _kv_cfgs()
    cache, jcache = tkv.init_dense_cache(mine, 3), jkv.init_dense_cache(ref, 3)
    rng = np.random.default_rng(4)
    for _ in range(3):
        k = rng.standard_normal((2, 3, 2, 4), dtype=np.float32)
        cache = tkv.dense_append(cache, torch.from_numpy(k),
                                 torch.from_numpy(2 * k))
        jcache = jkv.dense_append(jcache, jnp.asarray(k), jnp.asarray(2 * k))
    for g, w in zip(cache, jcache):
        _same_bytes(g, w)


def test_paged_writes_with_nowhere_to_go_are_dropped(torch):
    """A row whose page id is -1 writes nothing, also when it would clamp
    onto a place a kept row writes in the same scatter; with no kept row
    the pool is untouched."""
    from repro_torch.objectmodel.kvcache import (plan_paged_write,
                                                 write_paged)
    pages = torch.zeros(3, 4, 1, 2)
    new = torch.tensor([[[1.0, 1.0]], [[2.0, 2.0]], [[3.0, 3.0]]])
    length = torch.tensor([5, 1, 9], dtype=torch.int32)  # slots 1, 1, 1
    write_paged(pages, new, plan_paged_write(
        torch.tensor([-1, 0, -1], dtype=torch.int32), length, 4))
    want = torch.zeros(3, 4, 1, 2)
    want[0, 1] = 2.0
    assert torch.equal(pages, want)
    write_paged(pages, 7 * new, plan_paged_write(
        torch.tensor([-1, -1, -1], dtype=torch.int32), length, 4))
    assert torch.equal(pages, want)


def test_tail_pages_follow_the_page_manager(torch):
    from repro_torch.objectmodel import kvcache as tkv
    mine, _ = _kv_cfgs(max_seq_len=24, num_pages=12)
    mgr = tkv.KVPageManager(mine)
    mgr.allocate(0, 3)
    mgr.allocate(1, 17)
    glob = tkv.global_page_tables(
        torch.from_numpy(mgr.build_tables([0, 1, 9])), mine.pages_per_shard)
    for written in (0, 7, 8, 16):
        mgr.written[1] = written
        got = tkv.tail_pages(glob, torch.tensor([2, written, 0]), 8)
        assert got.tolist() == [mgr.tail_physical_page(0),
                                mgr.tail_physical_page(1), -1]
    # past the table's end: dropped, where the manager clamps
    assert tkv.tail_pages(glob, torch.tensor([24, 30, 5]), 8).tolist() == \
        [-1, -1, -1]


# ------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", ["qwen25_32b", "qwen2_moe",
                                  "jamba15_large"])
def test_paged_decode_matches_reference_dense_decode(torch, arch):
    """Teacher-forced over 12 tokens at page 4: each sequence spans 3
    pages of a pool twice that size, placed as a random permutation, so
    a sequence's pages are neither in order nor adjacent."""
    cfg = _lifted(arch)
    jm, jp, model = carry(cfg, "float32")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jstate = jm.init_decode_state(2, 16, "float32")
    state = model.init_decode_state(2, 16, "float32", kv_layout="paged",
                                    page_size=4, num_pages=16)
    n_attn = cfg.n_layers // (cfg.attn_period if cfg.family == "hybrid"
                              else 1)
    assert state.kv.k_pages.shape == (n_attn, 16, 4, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
    perm = np.random.default_rng(7).permutation(16)[:8].reshape(2, 4)
    state.kv.block_tables[0] = torch.from_numpy(perm.astype(np.int32))
    state.tail.copy_(state.kv.block_tables[0, :, 0])
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    assert state.length.tolist() == [12, 12]
    assert state.tail.tolist() == perm[:, 3].tolist()  # 12 // 4 = page 3
    k_seq = np.asarray(jstate.k_cache)  # (L, B, Smax, K, hd)
    pool = state.kv.k_pages.numpy()
    for b in range(2):
        got_k = pool[:, perm[b, :3]].reshape(n_attn, 12, *pool.shape[3:])
        np.testing.assert_allclose(got_k, k_seq[:, b, :12], atol=1e-5,
                                   rtol=1e-5)


def test_decode_state_layouts_and_their_errors(torch):
    from repro_torch.models import build_model
    from repro_torch.models.transformer import DecodeState, PagedDecodeState
    cfg = port_cfg(reduced_config(get_arch("qwen25_32b")))
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         "float32")
    paged = model.init_decode_state(3, 10, kv_layout="paged", page_size=4)
    assert isinstance(paged, PagedDecodeState)
    assert paged.kv.block_tables.tolist() == [[[0, 1, 2], [3, 4, 5],
                                               [6, 7, 8]]]
    assert paged.tail.tolist() == [0, 3, 6]
    assert isinstance(model.init_decode_state(3, 10), DecodeState)
    with pytest.raises(ValueError, match="int8"):
        model.init_decode_state(2, 8, kv_dtype="int8", kv_layout="paged")
    with pytest.raises(ValueError, match="kv_layout"):
        model.init_decode_state(2, 8, kv_layout="ragged")
    with pytest.raises(ValueError, match="cannot hold"):
        model.init_decode_state(3, 10, kv_layout="paged", page_size=4,
                                num_pages=8)
    # a narrower float cache is built, as the reference builds it; a wider
    # one is refused (the reference's decode fails on it)
    assert model.init_decode_state(2, 8, "float32",
                                   kv_dtype="float16").k_cache.dtype \
        == torch.float16
    with pytest.raises(ValueError, match="ROADMAP"):
        model.init_decode_state(2, 8, "bfloat16", kv_dtype="float32")


# ----------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ["qwen25_32b", "qwen2_moe",
                                  "jamba15_large"])
def test_paged_serving_matches_reference_token_for_token(torch, arch):
    """Six prompts through four slots, max_seq 48, page 8: slots go idle
    (their table rows all holes), sequences outgrow the pages allocated
    on admission and run to max_seq, and reused slots get recycled pages
    holding the previous request's K/V. The reference engine decodes
    against its dense cache. A decode batch of 4 tokens never fills a
    MoE expert's capacity of 8, and an idle slot's hidden state (which
    differs between the layouts) reaches no active slot's routing."""
    from repro_torch.engine.serve_step import ServingEngine
    cfg = reduced_config(get_arch(arch))
    jm, jp, model = carry(cfg, "float32")
    jeng = JEngine(jm, jp, batch_size=4, max_seq=48, eos_id=-1)
    eng = ServingEngine(model, batch_size=4, max_seq=48, eos_id=-1,
                        kv_layout="paged", page_size=8)
    assert eng.state.kv.k_pages.shape[:3] == (
        eng.kv_cfg.n_layers, 4 * 6 * 2, 8)
    rng = np.random.default_rng(0)
    for _ in range(6):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(2, 8)).tolist()
        jeng.submit(prompt)
        eng.submit(prompt)
    key = jax.random.PRNGKey(0)
    held = []
    for e, step in ((jeng, lambda: jeng.step(key)), (eng, eng.step)):
        for _ in range(1000):
            if not (e.queue or any(s is not None for s in e.slots)):
                break
            step()
            held.append(eng.pages.pages_in_use())
        else:
            raise AssertionError("serving did not drain")
    assert max(held) == 4 * 6  # 4 slots at their 6th page, none clamped
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 6
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()


def test_paged_serve_batch_drains_on_the_cpu(torch):
    from repro_torch.launch.serve import serve_batch
    kw = dict(n_requests=3, max_new=8, batch_size=2, reduced=True,
              device="cpu", dtype="float32")
    dense = serve_batch("qwen25_32b", **kw)
    paged = serve_batch("qwen25_32b", kv_layout="paged", page_size=4, **kw)
    assert paged["finished"] == 3 and paged["pages_in_use"] == 0
    assert paged["outputs"] == dense["outputs"]


def test_paged_serve_batch_without_a_card_raises(torch, monkeypatch):
    """No silent CPU: with no card and no device named, serving raises."""
    from repro_torch.launch.serve import serve_batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch("qwen25_32b", kv_layout="paged", page_size=4)


# -------------------------------------------------------------- int8
def test_quantize_kv_matches_reference_bit_for_bit(torch):
    """The same float32 inputs, with halves at the rounding points: the
    same int8 values and the same scales, bit for bit."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 2, 16), dtype=np.float32)
    x[0, 0, :] = np.arange(-8, 8, dtype=np.float32) + 0.5
    x[0, 0, 0] = 127.0  # scale 1: every other entry lies on a half
    x[1, 1, :] = 0.0  # the 1e-8 floor
    want_q, want_s = jtf._quantize_kv(jnp.asarray(x))
    got_q, got_s = tf._quantize_kv(torch.from_numpy(x))
    _same_bytes(got_q, want_q)
    _same_bytes(got_s, want_s)
    assert got_q[0, 0, 1:3].tolist() == [-6, -6]  # -6.5, -5.5: to even


def test_int8_decode_matches_reference_int8_decode(torch):
    """Teacher-forced int8 decode on the same weights: the int8 values
    equal bit for bit and the logits within 1e-4. The scales agree to
    1e-6 of their size: each is max|k| / 127 of a k that the two packages'
    float32 projections round differently (``_quantize_kv`` itself is
    bit-equal, test above)."""
    cfg = reduced_config(get_arch("qwen25_32b"))
    jm, jp, model = carry(cfg, "float32")
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jstate = jm.init_decode_state(2, 16, "float32", kv_dtype="int8")
    state = model.init_decode_state(2, 16, "float32", kv_dtype="int8")
    assert state.k_cache.dtype == torch.int8
    assert state.k_scale.data_ptr() != state.v_scale.data_ptr()
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
        for name in ("k_cache", "v_cache"):
            _same_bytes(getattr(state, name), getattr(jstate, name))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=1e-6, atol=0)


def test_int8_decode_meets_the_reference_bounds(torch):
    """tests/test_coverage_extra.py's bounds, on the port: teacher-forced
    int8 decode against the forward, log-softmax error mean < 0.01 and
    max < 0.15; the int8 cache and its scales take < 0.75 of the
    full-precision cache's bytes."""
    from repro_torch.models import Ctx
    cfg = reduced_config(get_arch("qwen25_32b"))
    _, _, model = carry(cfg, "float32")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    fwd, _ = model.forward({"tokens": toks}, Ctx())
    state = model.init_decode_state(B, S + 4, "float32", kv_dtype="int8")
    outs = []
    for t in range(S):
        lg, state = model.decode_step(toks[:, t:t + 1], state)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    a = torch.log_softmax(fwd[..., :cfg.vocab_size], -1)
    b = torch.log_softmax(dec[..., :cfg.vocab_size], -1)
    err = (a - b).abs()
    assert float(err.mean()) < 0.01, float(err.mean())
    assert float(err.max()) < 0.15, float(err.max())
    full = model.init_decode_state(B, S + 4, "float32")
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert nbytes(state.k_cache) + nbytes(state.k_scale) \
        < 0.75 * nbytes(full.k_cache)


def test_hybrid_int8_builds_what_the_reference_builds(torch):
    """A hybrid config ignores kv_dtype (the reference's
    init_decode_state builds its caches in the parameter dtype)."""
    cfg = reduced_config(get_arch("jamba15_large"))
    jm, _, model = carry(cfg, "float32")
    jstate = jm.init_decode_state(2, 8, "float32", kv_dtype="int8")
    state = model.init_decode_state(2, 8, "float32", kv_dtype="int8")
    for name in ("k_cache", "v_cache", "length"):
        _same_bytes(getattr(state, name), getattr(jstate, name))
    assert state.k_scale is None and jstate.k_scale is None
