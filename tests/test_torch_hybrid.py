"""The port's hybrid (jamba) family against the reference, on the CPU.

Weights come from the reference (``init_params(PRNGKey(0), ...)`` on the
reduced jamba config: 4 layers in 2 groups of ``attn_period`` 2, each a
Mamba layer with a dense FFN and an attention layer with a 4-expert top-2
MoE; d_state 8) and are carried over with ``from_jax_params``; inputs are
numpy-seeded. On the CPU the Mamba recurrence runs the plain sequential
version of ``ssm_scan``, the reference a chunked associative scan: the
two round in another order.

Tolerances: 1e-4 for one Mamba layer and for whole-model logits in
float32 (the scans' order, and the MoE and attention sums of
tests/test_torch_moe.py), 2e-2 of the largest logit with bf16 parameters
(XLA's bf16 silu is one ulp off torch's, ROADMAP.md queue 3). Decode is
held against the reference with the capacity lifted to ``n_experts``, so
that no slot is dropped on either side whatever the batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.engine.serve_step import ServingEngine as JEngine
from repro.models import Ctx as JCtx
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from torch_parity import carry, port_cfg

ARCH = "jamba15_large"


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jamba():
    return reduced_config(get_arch(ARCH))


@pytest.fixture(scope="module")
def carried(jamba):
    return carry(jamba, "float32")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def test_port_jamba_config_is_the_reference_config(jamba):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget("jamba-1.5-large-398b")
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(ARCH))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(jamba)
    assert (jamba.n_layers, jamba.attn_period, jamba.n_experts,
            jamba.d_state) == (4, 2, 4, 8)


@pytest.mark.parametrize("reduced", [True, False])
def test_hybrid_param_tree_paths_match_reference(reduced):
    from repro.models import params as jparams
    from repro_torch.models import params
    from repro_torch.models.transformer import model_defs
    cfg = get_arch(ARCH)
    if reduced:
        cfg = reduced_config(cfg)
    mine = params.tree_paths(model_defs(port_cfg(cfg)))
    ref = jparams.tree_paths(jbuild(cfg).defs)
    assert {k.replace("/", "."): (d.shape, d.init, d.scale)
            for k, d in ref.items()} == {
        k: (d.shape, d.init, d.scale) for k, d in mine.items()}
    assert "groups.mamba.A_log" in mine and "blocks.attn.wq" not in mine


def test_jamba_full_width_param_count_matches_reference():
    from repro_torch.models import build_model
    model = build_model("jamba15_large")  # meta parameters: nothing allocated
    assert model.groups.mamba.in_proj.is_meta
    assert model.param_count() == jbuild(
        get_arch(ARCH)).param_count() == 398_555_111_424
    # the config's closed form (it omits the dt_rank projection and the
    # padded vocab) agrees in both packages
    assert model.cfg.param_count() == get_arch(
        ARCH).param_count() == 397_479_411_712
    # the cut the card runs: one group of 8 layers, 12 of 16 experts
    cut = dataclasses.replace(get_arch(ARCH), n_layers=8, n_experts=12)
    assert build_model(port_cfg(cut)).param_count() == jbuild(
        cut).param_count() == 35_574_538_240


@pytest.mark.parametrize("layers", [1, 7, 12])
def test_hybrid_depth_must_be_whole_groups(layers):
    from repro_torch.models import build_model
    with pytest.raises(ValueError, match="attn_period"):
        build_model("jamba15_large", layers=layers)
    assert build_model("jamba15_large", layers=16).cfg.n_layers == 16


def _mamba_params(cfg, seed=4):
    """One Mamba layer's leaves, numpy-seeded: 1/sqrt(fan-in) for the
    projections, 0.3 for A_log, 0.1 for the vectors (biases included, so
    that every term is exercised)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in jssm.mamba_defs(cfg).items():
        a = rng.standard_normal(d.shape, dtype=np.float32)
        if name == "A_log":
            a *= 0.3
        elif len(d.shape) == 1:
            a = a * 0.1 + (1.0 if d.init == "ones" else 0.0)
        else:
            a /= np.sqrt(d.shape[-2])
        out[name] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("L", [37, 300])  # 300: past one 256-step chunk
def test_mamba_apply_matches_reference(torch, jamba, L):
    from repro_torch.models import Ctx
    from repro_torch.models import ssm
    p = _mamba_params(jamba)
    x = np.random.default_rng(5).standard_normal(
        (2, L, jamba.d_model), dtype=np.float32)
    want = jssm.mamba_apply(jamba, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), JCtx())
    got = ssm.mamba_apply(port_cfg(jamba),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), Ctx())
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_mamba_decode_step_matches_reference(torch, jamba):
    from repro_torch.models import ssm
    p = _mamba_params(jamba)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xs = np.random.default_rng(6).standard_normal(
        (2, 9, jamba.d_model), dtype=np.float32)
    jstate = jssm.mamba_init_state(jamba, 2, "float32")
    stacked = ssm.mamba_init_state(port_cfg(jamba), 2, torch.float32, "cpu",
                                   layers=1)
    state = ssm.MambaState(h=stacked.h[0], conv=stacked.conv[0])
    for t in range(xs.shape[1]):
        want, jstate = jssm.mamba_decode_step(jamba, jp,
                                              jnp.asarray(xs[:, t:t + 1]),
                                              jstate)
        got, state = ssm.mamba_decode_step(port_cfg(jamba), tp,
                                           torch.from_numpy(xs[:, t:t + 1]),
                                           state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(state.conv.numpy(),
                                   np.asarray(jstate.conv), atol=1e-6)


@pytest.mark.parametrize("use_flash", [False, True])
def test_hybrid_forward_logits_and_aux_match_reference(torch, jamba, carried,
                                                       use_flash):
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    jm, jp, model = carried
    tokens = _tokens(jamba, (2, 24))
    want, want_aux = jm.forward(jp, {"tokens": jnp.asarray(tokens)},
                                JCtx(use_flash=use_flash))
    ops.reset_launch_counts()
    got, aux = model.forward({"tokens": torch.from_numpy(tokens)},
                             Ctx(use_flash=use_flash))
    assert ops.launch_counts() == {  # CPU: plain versions
        "flash_attention": 0, "paged_attention": 0,
        "paged_attention_partial": 0, "moe_gather": 0, "moe_gather_bwd": 0,
        "ssm_scan": 0, "ssm_scan_bwd": 0,
        "expr_core": 0, "segment_reduce": 0}
    assert got.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    last, _ = model.forward({"tokens": torch.from_numpy(tokens)},
                            Ctx(use_flash=use_flash), last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4, rtol=1e-4)


def test_hybrid_bf16_forward_matches_reference(torch, jamba):
    """Whole model in bf16. As in tests/test_torch_moe.py, one bf16 ulp of
    difference in a layer's input (XLA's silu) flips a token's top-2
    choice where the random router (std 0.02) leaves two of the 4 experts
    within rounding of each other, and a flip changes that token's output
    wholesale: over 60 seeds of (2, 24) tokens every one flips somewhere
    in the two MoE layers. These 24 tokens (seed 10, shape (2, 12))
    route with margins above bf16 rounding in both; without a flip the
    two packages differ by ~1.7e-2 of the largest logit."""
    from repro_torch.models import Ctx
    jm, jp, model = carry(jamba, "bfloat16")
    assert model.dtype == torch.bfloat16
    tokens = _tokens(jamba, (2, 12), seed=10)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, JCtx())
    got, _ = model.forward({"tokens": torch.from_numpy(tokens)}, Ctx())
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_hybrid_decode_matches_reference_teacher_forced(torch, jamba):
    lifted = dataclasses.replace(jamba, capacity_factor=float(jamba.n_experts))
    jm, jp, model = carry(lifted, "float32")
    tokens = _tokens(lifted, (2, 12), seed=6)
    jstate = jm.init_decode_state(2, 16, "float32")
    state = model.init_decode_state(2, 16, "float32")
    assert state.k_cache.shape[0] == 2 and state.mamba.h.shape[0] == 2
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    np.testing.assert_allclose(state.mamba.h.numpy(),
                               np.asarray(jstate.mamba.h), atol=1e-4,
                               rtol=1e-4)
    assert state.length.tolist() == [12, 12]


def test_hybrid_decode_agrees_with_prefill(torch, jamba):
    """Within the port: the one-step recurrence against the plain scan."""
    from repro_torch.models import Ctx
    lifted = dataclasses.replace(jamba, capacity_factor=float(jamba.n_experts))
    _, _, model = carry(lifted, "float32")
    tokens = torch.from_numpy(_tokens(lifted, (2, 10), seed=8))
    ref, _ = model.forward({"tokens": tokens}, Ctx())
    state = model.init_decode_state(2, 16, "float32")
    for t in range(tokens.shape[1]):
        got, state = model.decode_step(tokens[:, t:t + 1], state)
        np.testing.assert_allclose(got.numpy(), ref[:, t:t + 1].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")


def test_decode_applies_rope_only_with_rope_positions(torch, jamba,
                                                      monkeypatch):
    """A dense config still rotates q and k in decode (one call each per
    layer); jamba, with no positions, never does."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    calls = []
    real = tf.rope
    monkeypatch.setattr(tf, "rope", lambda *a: calls.append(1) or real(*a))
    dense = port_cfg(reduced_config(get_arch("qwen25_32b")))
    for cfg, want in ((dense, 2 * dense.n_layers), (port_cfg(jamba), 0)):
        model = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                             "float32")
        state = model.init_decode_state(1, 4, "float32")
        calls.clear()
        model.decode_step(torch.tensor([[3]]), state)
        assert len(calls) == want, cfg.name


def test_hybrid_serving_matches_reference_token_for_token(torch, jamba):
    """8 prompts through 4 slots, as ``serve_batch`` serves them: slots
    are reused, and a reused slot keeps the Mamba state its last request
    left (the reference resets only ``length`` on admit), so the outputs
    agree only if the port keeps it too. A decode batch of 4 tokens never
    fills an expert's capacity of 8, so both engines route every slot."""
    from repro_torch.engine.serve_step import ServingEngine
    max_seq = 48
    jm, jp, model = carry(jamba, "float32")
    jeng = JEngine(jm, jp, batch_size=4, max_seq=max_seq, eos_id=-1)
    eng = ServingEngine(model, batch_size=4, max_seq=max_seq, eos_id=-1)
    rng = np.random.default_rng(0)
    for _ in range(8):
        prompt = rng.integers(1, jamba.vocab_size, rng.integers(2, 8)).tolist()
        jeng.submit(prompt)
        eng.submit(prompt)
    key = jax.random.PRNGKey(0)
    for e, step in ((jeng, lambda: jeng.step(key)), (eng, eng.step)):
        for _ in range(1000):
            if not (e.queue or any(s is not None for s in e.slots)):
                break
            step()
        else:
            raise AssertionError("serving did not drain")
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()
    assert eng.state.mamba.h.abs().sum() > 0  # never reset
    np.testing.assert_allclose(eng.state.mamba.h.numpy(),
                               np.asarray(jeng.state.mamba.h), atol=1e-4,
                               rtol=1e-4)


def test_hybrid_serve_batch_takes_a_config_and_drains_on_the_cpu(torch):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.launch.serve import serve_batch
    out = serve_batch(treduced(tget(ARCH)), n_requests=3, max_new=8,
                      batch_size=2, reduced=False, device="cpu",
                      dtype="float32")
    assert out["finished"] == 3 and out["pages_in_use"] == 0
    assert out["tokens"] > 0
