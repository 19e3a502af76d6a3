"""The port's model stack against the reference, on the CPU.

Weights come from the reference (``init_params(PRNGKey(0), ...)`` on the
reduced qwen2.5-32b config) and are carried over with ``from_jax_params``;
inputs are numpy-seeded. Tolerances: 1e-5 for single layers in float32,
1e-4 for whole-model logits in float32 (two layers of float32 matmuls
summed in another order). With bf16 parameters the logits agree to 2e-2 of
their largest magnitude: bf16 rounds at other places in the two frameworks
(XLA's CPU bf16 ``logistic`` is not correctly rounded, so silu differs by
an ulp in ~30% of elements, and XLA may keep excess precision across fused
ops), and one bf16 ulp of a logit near 4 is already 1.6e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from torch_parity import carry, port_cfg


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(get_arch("qwen25_32b"))


@pytest.fixture(scope="module")
def carried(cfg):
    return carry(cfg, "float32")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def test_port_config_is_the_reference_config(cfg):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget("qwen2.5-32b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        get_arch("qwen25_32b"))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(cfg)


def test_full_width_param_count_matches_reference():
    from repro_torch.models import build_model
    model = build_model("qwen25_32b")  # meta parameters: nothing allocated
    assert model.embed.tokens.is_meta
    assert model.param_count() == jbuild(
        get_arch("qwen25_32b")).param_count() == 32_763_876_352


def test_param_tree_paths_match_reference(cfg):
    from repro.models import params as jparams
    from repro_torch.models import params
    from repro_torch.models.transformer import model_defs
    mine = params.tree_paths(model_defs(port_cfg(cfg)))
    ref = jparams.tree_paths(jbuild(cfg).defs)
    assert {k.replace("/", "."): (d.shape, d.init, d.scale)
            for k, d in ref.items()} == {
        k: (d.shape, d.init, d.scale) for k, d in mine.items()}


def test_rmsnorm_matches_reference(torch):
    from repro_torch.models import layers
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_rope_matches_reference(torch, cfg):
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    pos = rng.integers(0, 50, (2, 7), dtype=np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                      cfg.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu2", "gelu"])
def test_ffn_apply_matches_reference(torch, cfg, activation):
    from repro_torch.models import layers
    c = dataclasses.replace(cfg, activation=activation)
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(d.shape, dtype=np.float32) * 0.1
         for k, d in jlayers.ffn_defs(c).items()}
    x = rng.standard_normal((2, 5, c.d_model), dtype=np.float32)
    want = jlayers.ffn_apply(c, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = layers.ffn_apply(port_cfg(c),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_logits_match_reference(torch, cfg, carried, use_flash):
    from repro_torch.models import Ctx
    jm, jp, model = carried
    tokens = _tokens(cfg, (2, 24))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)},
                         JCtx(use_flash=use_flash))
    got, aux = model.forward({"tokens": torch.from_numpy(tokens)},
                             Ctx(use_flash=use_flash))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    last, _ = model.forward({"tokens": torch.from_numpy(tokens)},
                            Ctx(use_flash=use_flash), last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4, rtol=1e-4)


def test_chunked_attention_matches_reference(torch, cfg):
    """The S >= CHUNKED_THRESHOLD path, called directly on a ragged T."""
    from repro.models import attention as jattn
    from repro_torch.models import attention
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 40, 4, 16), dtype=np.float32)
    k = rng.standard_normal((1, 40, 2, 16), dtype=np.float32)
    v = rng.standard_normal((1, 40, 2, 16), dtype=np.float32)
    for causal in (True, False):
        want = jattn.chunked_attention(cfg, *map(jnp.asarray, (q, k, v)),
                                       causal, chunk=16)
        got = attention.chunked_attention(
            port_cfg(cfg), *map(torch.from_numpy, (q, k, v)), causal,
            chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_decode_logits_match_reference_teacher_forced(torch, cfg, carried):
    jm, jp, model = carried
    tokens = _tokens(cfg, (2, 12), seed=6)
    jstate = jm.init_decode_state(2, 16, "float32")
    state = model.init_decode_state(2, 16, "float32")
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    assert state.length.tolist() == [12, 12]


def test_decode_drops_cache_writes_past_the_end(torch, cfg, carried):
    """JAX drops an out-of-range scatter; the port masks the write."""
    _, _, model = carried
    state = model.init_decode_state(2, 4, "float32")
    state = state._replace(length=torch.tensor([4, 1], dtype=torch.int32))
    _, state = model.decode_step(torch.tensor([[3], [5]]), state)
    assert state.length.tolist() == [5, 2]
    assert not state.k_cache[:, 0].any()  # slot 0 was full: nothing written
    assert state.k_cache[:, 1, 1].abs().sum() > 0
    assert not state.k_cache[:, 1, [0, 2, 3]].any()


def test_bf16_forward_matches_reference(torch, cfg):
    from repro_torch.models import Ctx
    jm, jp, model = carry(cfg, "bfloat16")
    assert model.dtype == torch.bfloat16
    tokens = _tokens(cfg, (2, 24), seed=7)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_init_params_follows_reference_std_rules(torch, cfg):
    """Same rules, other random numbers: zeros/ones leaves are equal, drawn
    leaves agree in standard deviation within 10%."""
    from repro_torch.models import build_model
    model = build_model(port_cfg(cfg)).init_params(
        torch.Generator().manual_seed(0), "float32")
    ref = jax.tree.map(np.asarray,
                       jbuild(cfg).init_params(jax.random.PRNGKey(0),
                                               "float32"))
    from repro_torch.models.params import flatten
    flat = flatten(ref)
    for name, t in model.state_dict().items():
        want = flat[name]
        assert t.dtype == torch.float32 and tuple(t.shape) == want.shape
        if want.std() == 0:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
        else:
            assert abs(t.std().item() / want.std() - 1) < 0.1, name


def test_from_jax_params_rejects_tree_mismatches(torch, cfg, carried):
    from repro_torch.models.convert import from_jax_params
    jm, jp, model = carried
    tree = jax.tree.map(np.asarray, jp)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="missing"):
        from_jax_params(missing, model)
    extra = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        from_jax_params(extra, model)
    reshaped = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(reshaped, model)


def test_unported_families_raise(torch, cfg, carried):
    """Every family of the reference builds; what the reference does not
    run raises: the paged layout for audio and ssm (the reference decodes
    them over the dense layout only) and an int8 paged pool."""
    from repro_torch.models import build_model
    for arch in ("xlstm_125m", "whisper_small"):
        model = build_model(port_cfg(reduced_config(get_arch(arch))))
        model.init_params(torch.Generator().manual_seed(0), "float32")
        model.init_decode_state(2, 8)  # the dense layout builds
        with pytest.raises(ValueError, match="ROADMAP"):
            model.init_decode_state(2, 8, kv_layout="paged")
    _, _, model = carried
    with pytest.raises(ValueError, match="int8"):  # no int8 paged pool
        model.init_decode_state(2, 8, kv_dtype="int8", kv_layout="paged")
