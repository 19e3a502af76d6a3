"""The port's continuous-batching server against the reference's, on the
CPU: the same weights (carried over from the reference) serve the same
numpy-seeded prompts greedily, and the outputs must agree token for token.

Six prompts through four slots with max_seq=48 leave slots idle while
others run, and an idle slot's cache length keeps counting past max_seq:
the reference drops those out-of-range cache writes, so the port must
too (it masks them) for the outputs to agree. The MoE model's engine is
held against the reference's the same way."""
import jax
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.engine.serve_step import ServingEngine as JEngine
from repro.objectmodel.kvcache import KVCacheConfig as JKVConfig
from repro.objectmodel.kvcache import KVPageManager as JPages
from torch_parity import carry


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _drain(eng, step):
    lengths = []
    while eng.queue or any(s is not None for s in eng.slots):
        step()
        lengths.append(np.asarray(eng.state.length).max())
        assert len(lengths) < 1000, "serving did not drain"
    return max(lengths)


def _engines(arch, max_seq):
    """The reference's engine and the port's, on the same weights (the
    reference's float32 ``init_params(PRNGKey(0))`` carried over)."""
    from repro_torch.engine.serve_step import ServingEngine
    cfg = reduced_config(get_arch(arch))
    jm, jp, model = carry(cfg, "float32")
    return (cfg, JEngine(jm, jp, batch_size=4, max_seq=max_seq, eos_id=-1),
            ServingEngine(model, batch_size=4, max_seq=max_seq, eos_id=-1))


def test_greedy_serving_matches_reference_token_for_token(torch):
    max_seq = 48
    cfg, jeng, eng = _engines("qwen25_32b", max_seq)
    rng = np.random.default_rng(0)
    for _ in range(6):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(2, 8)).tolist()
        jeng.submit(prompt)
        eng.submit(prompt)
    key = jax.random.PRNGKey(0)
    _drain(jeng, lambda: jeng.step(key))
    longest = _drain(eng, eng.step)
    assert longest > max_seq  # an idle slot ran past the cache's end
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 6
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()


def test_moe_greedy_serving_matches_reference_token_for_token(torch):
    """qwen2_moe as ``serve_batch`` serves it (8 seeded prompts, batch 4,
    max_seq 48). A decode batch of 4 tokens never fills an expert's
    capacity of 8, so both engines route every slot."""
    max_seq = 48
    cfg, jeng, eng = _engines("qwen2_moe", max_seq)
    rng = np.random.default_rng(0)
    for _ in range(8):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(2, 8)).tolist()
        jeng.submit(prompt)
        eng.submit(prompt)
    key = jax.random.PRNGKey(0)
    _drain(jeng, lambda: jeng.step(key))
    _drain(eng, eng.step)
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()


def test_moe_serve_batch_drains_on_the_cpu(torch):
    from repro_torch.launch.serve import serve_batch
    out = serve_batch("qwen2_moe", n_requests=3, max_new=8, batch_size=2,
                      reduced=True, device="cpu", dtype="float32")
    assert out["finished"] == 3 and out["pages_in_use"] == 0
    assert out["tokens"] > 0


def test_sample_token_greedy_and_seeded(torch):
    from repro_torch.engine.serve_step import sample_token
    logits = torch.tensor([[[0.0, 3.0, 3.0, -1.0]], [[5.0, 0.0, 0.0, 0.0]]])
    assert sample_token(logits).tolist() == [[1], [0]]  # first index on ties
    big = torch.randn(3, 1, 50, generator=torch.Generator().manual_seed(1))
    draw = lambda: sample_token(  # noqa: E731
        big, torch.Generator().manual_seed(7), temperature=1.0)
    a, b = draw(), draw()
    assert a.dtype == torch.int32 and a.shape == (3, 1)
    assert a.tolist() == b.tolist()


def test_page_manager_matches_reference():
    from repro_torch.objectmodel.kvcache import KVCacheConfig, KVPageManager
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, max_seq_len=100,
              page_size=8, num_pages=24, num_shards=2)
    mine, ref = KVPageManager(KVCacheConfig(**kw)), JPages(JKVConfig(**kw))
    ops = [("allocate", 1, 20), ("allocate", 2, 9), ("advance", 1, 5),
           ("allocate", 1, 30), ("release", 2), ("allocate", 3, 17),
           ("advance", 3, 17), ("allocate", 3, 8)]
    for op, *args in ops:
        assert getattr(mine, op)(*args) == getattr(ref, op)(*args), op
        assert mine.free == ref.free and mine.owned == ref.owned
    np.testing.assert_array_equal(mine.build_tables([1, 3, 2]),
                                  ref.build_tables([1, 3, 2]))
    assert mine.tail_physical_page(3) == ref.tail_physical_page(3)
    with pytest.raises(MemoryError):
        mine.allocate(9, 1000)
