"""The reference's other dense configs in the port, against the reference
on the CPU: gemma-7b (GeGLU, 16 heads of 256 against d_model 3072, tied
embeddings), phi3-mini-3.8b (SwiGLU, 32/32 heads) and nemotron-4-340b
(squared ReLU, 96/8 heads), each at ``reduced_config`` size.

Weights are the reference's ``init_params(PRNGKey(0), ...)`` carried over
with ``from_jax_params``; inputs are numpy-seeded. Tolerances, as max
|diff| over the largest |logit|: 1e-5 in float32 (the same products
summed in another order); 2e-2 with bf16 parameters, as
tests/test_torch_models.py holds them (bf16 rounds at other places in the
two frameworks). The reference decodes only over its dense cache, so the
port's paged decode is held against the reference's dense decode."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from torch_parity import carry, decode_both, port_cfg, rel_err, serve_both

ARCHS = ["gemma_7b", "phi3_mini", "nemotron4_340b"]
FULL_PARAMS = {"gemma_7b": 8_537_680_896, "phi3_mini": 3_822_259_200,
               "nemotron4_340b": 341_025_638_400}


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _carried(arch, dtype="float32"):
    return carry(reduced_config(get_arch(arch)), dtype)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_config_is_the_reference_config(arch):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(arch))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(
        reduced_config(get_arch(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_full_width_count_match_reference(arch):
    from repro.models import params as jparams
    from repro_torch.models import build_model, params
    from repro_torch.models.transformer import model_defs
    cfg = reduced_config(get_arch(arch))
    mine = params.tree_paths(model_defs(port_cfg(cfg)))
    ref = jparams.tree_paths(jbuild(cfg).defs)
    assert {k.replace("/", "."): (d.shape, d.init, d.scale)
            for k, d in ref.items()} == {
        k: (d.shape, d.init, d.scale) for k, d in mine.items()}
    model = build_model(arch)  # meta parameters: nothing allocated
    assert model.embed.tokens.is_meta
    assert model.param_count() == jbuild(get_arch(arch)).param_count() \
        == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(torch, arch, use_flash):
    from repro_torch.models import Ctx
    jm, jp, model = _carried(arch)
    tokens = _tokens(model.cfg, (2, 24))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)},
                         JCtx(use_flash=use_flash))
    got, aux = model.forward({"tokens": torch.from_numpy(tokens)},
                             Ctx(use_flash=use_flash))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert rel_err(got, want) <= 1e-5
    last, _ = model.forward({"tokens": torch.from_numpy(tokens)},
                            Ctx(use_flash=use_flash), last_only=True)
    assert rel_err(last, np.asarray(want)[:, -1:]) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(torch, arch):
    from repro_torch.models import Ctx
    jm, jp, model = _carried(arch, "bfloat16")
    assert model.dtype == torch.bfloat16
    tokens = _tokens(model.cfg, (2, 24), seed=7)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    assert rel_err(got, want) <= 2e-2


def _paged_state(torch, model, B, max_seq, seed=7):
    """The port's paged pool, page 4, each sequence's pages a random
    permutation of a pool twice the size it needs."""
    n = -(-max_seq // 4)
    state = model.init_decode_state(B, max_seq, "float32",
                                    kv_layout="paged", page_size=4,
                                    num_pages=2 * B * n)
    perm = np.random.default_rng(seed).permutation(2 * B * n)[:B * n]
    state.kv.block_tables[0] = torch.from_numpy(
        perm.reshape(B, n).astype(np.int32))
    state.tail.copy_(state.kv.block_tables[0, :, 0])
    return state


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
def test_decode_matches_reference_teacher_forced(torch, arch, layout):
    """12 tokens teacher-forced: the port's dense cache, int8 cache (its
    int8 values bit for bit) or paged pool against the reference's dense
    or int8 cache."""
    jm, jp, model = _carried(arch)
    tokens = _tokens(model.cfg, (2, 12), seed=6)
    kv = "int8" if layout == "int8" else None
    jstate = jm.init_decode_state(2, 16, "float32", kv_dtype=kv)
    state = (_paged_state(torch, model, 2, 16) if layout == "paged"
             else model.init_decode_state(2, 16, "float32", kv_dtype=kv))
    worst, _, jstate, state = decode_both(jm, jp, model, tokens, jstate,
                                          state)
    assert worst <= 1e-5, worst
    assert state.length.tolist() == [12, 12]
    if layout == "int8":
        np.testing.assert_array_equal(state.k_cache.numpy(),
                                      np.asarray(jstate.k_cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_reference_token_for_token(torch, arch):
    """8 prompts through 4 slots, max_seq 48, as ``serve_batch`` serves
    them: every request's tokens equal the reference engine's."""
    jm, jp, model = _carried(arch)
    jeng, eng = serve_both(model.cfg, jm, jp, model)
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()


def test_gemma_ties_the_head_and_widens_q(torch):
    """Tied embeddings: no ``embed.head`` leaf, the logits read
    ``embed.tokens``; heads wider than d_model / n_heads: q_dim 128
    against d_model 64 (the full config's 4096 against 3072), forward and
    decode held against the reference."""
    cfg = dataclasses.replace(reduced_config(get_arch("gemma_7b")),
                              head_dim=32)
    assert cfg.tie_embeddings and cfg.n_heads * 32 == 2 * cfg.d_model
    jm, jp, model = carry(cfg, "float32")
    assert "embed.head" not in model.state_dict() and "head" not in jp["embed"]
    assert tuple(model.blocks.attn.wq.shape) == (cfg.n_layers, 64, 128)
    assert tuple(model.blocks.attn.wo.shape) == (cfg.n_layers, 128, 64)
    from repro_torch.models import Ctx, build_model
    full = build_model("gemma_7b")
    assert tuple(full.blocks.attn.wq.shape) == (28, 3072, 4096)
    assert not hasattr(full.embed, "head")
    tokens = _tokens(cfg, (2, 12), seed=3)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    assert rel_err(got, want) <= 1e-5
    # the head is the embedding: the last hidden state times tokens.T
    with torch.no_grad():
        model.embed.tokens.mul_(2.0)
    doubled, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    assert not torch.allclose(doubled, got)
    with torch.no_grad():
        model.embed.tokens.mul_(0.5)
    worst, _, _, _ = decode_both(jm, jp, model, tokens,
                                 jm.init_decode_state(2, 16, "float32"),
                                 model.init_decode_state(2, 16, "float32"))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float16"])
def test_float_kv_dtype_is_cast_as_the_reference_casts_it(torch, kv_dtype):
    """float32 parameters over a narrower float cache: the reference
    builds the cache in it, and its attention output comes out in it,
    which JAX promotes for the output projection; the port casts there.
    Cache dtype, logits dtype and logits agree (2e-2: the cache and the
    attention weights round to 16 bits on both sides, in other orders)."""
    jm, jp, model = _carried("gemma_7b")
    tokens = _tokens(model.cfg, (2, 10), seed=5)
    jstate = jm.init_decode_state(2, 16, "float32", kv_dtype=kv_dtype)
    state = model.init_decode_state(2, 16, "float32", kv_dtype=kv_dtype)
    assert str(state.k_cache.dtype) == f"torch.{jstate.k_cache.dtype}"
    assert state.k_scale is None
    worst, (got_dt, want_dt), _, _ = decode_both(jm, jp, model, tokens,
                                                 jstate, state)
    assert got_dt == torch.float32 and str(want_dt) == "float32"
    assert worst <= 2e-2, worst


@pytest.mark.parametrize("kv_dtype", ["float32", "float16"])
def test_wider_float_kv_dtype_fails_in_the_reference_and_is_refused(
        torch, kv_dtype):
    """bf16 parameters over a float32 (or float16: promoted to float32)
    cache: JAX promotes the attention output and then the residual stream
    to float32, and the reference's layer scan refuses a carry that
    changes type (TypeError at the first decode step). The port refuses
    the state (ValueError naming ROADMAP.md)."""
    jm, jp, model = _carried("gemma_7b", "bfloat16")
    jstate = jm.init_decode_state(2, 8, "bfloat16", kv_dtype=kv_dtype)
    with pytest.raises(TypeError, match="carry"):
        jm.decode_step(jp, jnp.zeros((2, 1), jnp.int32), jstate, JCtx())
    with pytest.raises(ValueError, match="ROADMAP"):
        model.init_decode_state(2, 8, "bfloat16", kv_dtype=kv_dtype)
