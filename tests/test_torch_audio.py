"""The audio family (whisper-small: a pre-LayerNorm encoder-decoder with
learned positions, QKV biases and GELU FFNs; the conv front end a stub of
precomputed frame embeddings) in the port, against the reference on the
CPU, at ``reduced_config`` size (2 + 2 layers, 16 frames).

Weights are the reference's ``init_params(PRNGKey(0), ...)`` carried over
with ``from_jax_params``; tokens and frames are numpy-seeded. Tolerances:
1e-5 in float32 for one layer at a time (relative to the largest |value|)
and for whole-model logits (relative to the largest |logit|); 2e-2 with
bf16 parameters, as tests/test_torch_models.py holds them. Decode is held
against the reference's over the dense cache with ``enc_out`` from the
encoder on both sides; the reference has no paged decode and its int8
decode fails, and the port refuses both."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.models import Ctx as JCtx
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from torch_parity import carry, decode_both, port_cfg, rel_err, serve_both

ARCH = "whisper_small"


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def audio():
    return reduced_config(get_arch(ARCH))


@functools.lru_cache(maxsize=None)
def _carried(dtype="float32"):
    return carry(reduced_config(get_arch(ARCH)), dtype)


def _batch(cfg, B=2, S=20, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "frames": rng.standard_normal((B, cfg.encoder_len, cfg.d_model),
                                          dtype=np.float32)}


def test_port_audio_config_is_the_reference_config(audio):
    from repro_torch.configs import get_arch as tget
    from repro_torch.configs import reduced_config as treduced
    full = tget("whisper-small")
    assert dataclasses.asdict(full) == dataclasses.asdict(get_arch(ARCH))
    assert dataclasses.asdict(treduced(full)) == dataclasses.asdict(audio)
    assert (audio.norm, audio.pos_embedding, audio.encoder_layers) == (
        "layernorm", "learned", 2)


@pytest.mark.parametrize("reduced", [True, False])
def test_audio_param_tree_paths_match_reference(reduced):
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
    assert mine["embed.positions"].shape == (32_768, cfg.d_model)
    assert mine["decoder.lnx.bias"].shape == (cfg.n_layers, cfg.d_model)


def test_audio_full_width_param_count_matches_reference():
    from repro_torch.models import build_model
    model = build_model(ARCH)  # meta parameters: nothing allocated
    assert model.encoder.attn.wq.is_meta
    assert model.param_count() == jbuild(get_arch(ARCH)).param_count() \
        == 304_499_712


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(torch, dtype):
    """Statistics in float32, cast to x's type before scale and bias."""
    from repro_torch.models import layers
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s, dtype=np.float32) + 0.5
               for s in ((2, 5, 64), (64,), (64,)))
    want = jlayers.layernorm(*(jnp.asarray(a, dtype) for a in (x, w, b)))
    got = layers.layernorm(*(torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in (x, w, b)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(got, np.asarray(want, np.float32)) <= tol


def _attn_params(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(
        np.float32) for k, d in jattn.attn_defs(cfg).items()}


def test_cross_attention_block_matches_reference(torch, audio):
    """Queries from 7 decoder positions onto 16 encoder positions: not
    causal, no positions, biases on q, k and v."""
    from repro_torch.models import attention
    p = _attn_params(audio)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, audio.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, 16, audio.d_model), dtype=np.float32)
    want = jattn.cross_attention_block(
        audio, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(enc))
    got = attention.cross_attention_block(
        port_cfg(audio), {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), torch.from_numpy(enc))
    assert got.shape == (2, 7, audio.d_model)
    assert rel_err(got, want) <= 1e-5


def test_encode_whisper_matches_reference(torch, audio):
    from repro_torch.models import Ctx
    jm, jp, model = _carried()
    frames = _batch(audio)["frames"]
    want = jm.encode(jp, jnp.asarray(frames), JCtx(use_flash=True))
    got = model.encode(torch.from_numpy(frames), Ctx(use_flash=True))
    assert got.shape == frames.shape
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("use_flash", [False, True])
def test_audio_forward_matches_reference(torch, audio, use_flash):
    from repro_torch.kernels import ops
    from repro_torch.models import Ctx
    jm, jp, model = _carried()
    batch = _batch(audio)
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         JCtx(use_flash=use_flash))
    ops.reset_launch_counts()
    got, aux = model.forward(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        Ctx(use_flash=use_flash))
    assert ops.launch_counts()["flash_attention"] == 0  # CPU: plain
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert rel_err(got, want) <= 1e-5
    last, _ = model.forward({k: torch.from_numpy(v)
                             for k, v in batch.items()},
                            Ctx(use_flash=use_flash), last_only=True)
    assert rel_err(last, np.asarray(want)[:, -1:]) <= 1e-5


def test_audio_bf16_forward_matches_reference(torch, audio):
    from repro_torch.models import Ctx
    jm, jp, model = _carried("bfloat16")
    batch = _batch(audio, seed=7)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(batch["tokens"]),
                              "frames": jnp.asarray(batch["frames"],
                                                    jnp.bfloat16)}, JCtx())
    got, _ = model.forward(
        {"tokens": torch.from_numpy(batch["tokens"]),
         "frames": torch.from_numpy(batch["frames"]).to(torch.bfloat16)},
        Ctx())
    assert rel_err(got, want) <= 2e-2


def test_audio_decode_matches_reference_teacher_forced(torch, audio):
    """12 tokens teacher-forced with the encoder's output as ``enc_out``
    on both sides; the learned positions read at each slot's length."""
    from repro_torch.models import Ctx
    jm, jp, model = _carried()
    batch = _batch(audio, S=12, seed=6)
    jenc = jm.encode(jp, jnp.asarray(batch["frames"]), JCtx())
    enc = model.encode(torch.from_numpy(batch["frames"]), Ctx())
    jstate = jm.init_decode_state(2, 16, "float32")._replace(enc_out=jenc)
    state = model.init_decode_state(2, 16, "float32")
    assert state.enc_out.shape == (2, audio.encoder_len, audio.d_model)
    assert not state.enc_out.any()  # zeros until the caller sets it
    state = state._replace(enc_out=enc)
    worst, _, _, state = decode_both(jm, jp, model, batch["tokens"], jstate,
                                     state)
    assert worst <= 1e-5, worst
    assert state.length.tolist() == [12, 12]


def test_audio_decode_agrees_with_its_forward(torch, audio):
    """Within the port: decode from the encoder's output against the
    forward over the same frames, position by position."""
    from repro_torch.models import Ctx
    _, _, model = _carried()
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(audio, S=10, seed=8).items()}
    ref, _ = model.forward(batch, Ctx())
    state = model.init_decode_state(2, 16, "float32")._replace(
        enc_out=model.encode(batch["frames"], Ctx()))
    for t in range(10):
        got, state = model.decode_step(batch["tokens"][:, t:t + 1], state)
        assert rel_err(got, ref[:, t:t + 1].numpy()) <= 1e-5, t


def test_reference_audio_int8_decode_fails_and_the_port_refuses_it(torch):
    """The reference builds int8 caches and scales for audio, but its
    audio decode step passes no scales to ``_attn_decode``, which then
    writes into ``None``; the port refuses the state up front."""
    jm, jp, model = _carried()
    jstate = jm.init_decode_state(2, 8, "float32", kv_dtype="int8")
    assert jstate.k_cache.dtype == jnp.int8 and jstate.k_scale is not None
    with pytest.raises(AttributeError, match="at"):
        jm.decode_step(jp, jnp.zeros((2, 1), jnp.int32), jstate, JCtx())
    with pytest.raises(ValueError, match="ROADMAP"):
        model.init_decode_state(2, 8, "float32", kv_dtype="int8")


def test_audio_has_no_paged_pool(torch):
    from repro_torch.engine.serve_step import ServingEngine
    _, _, model = _carried()
    with pytest.raises(ValueError, match="ROADMAP"):
        model.init_decode_state(2, 8, kv_layout="paged")
    with pytest.raises(ValueError, match="ROADMAP"):
        ServingEngine(model, batch_size=2, max_seq=16, kv_layout="paged")


def test_audio_serving_matches_reference_token_for_token(torch, audio):
    """8 prompts through 4 slots, max_seq 48, ``enc_out`` zeros on both
    sides (the reference's serving never runs the encoder): every
    request's tokens equal the reference engine's."""
    jm, jp, model = _carried()
    jeng, eng = serve_both(audio, jm, jp, model)
    assert [s.sid for s in eng.finished] == [s.sid for s in jeng.finished]
    assert len(eng.finished) == 8
    for got, want in zip(eng.finished, jeng.finished):
        assert got.out == want.out, got.sid
    assert eng.pages.pages_in_use() == 0 == jeng.pages.pages_in_use()


def test_position_lookup_fills_past_the_table_as_jnp_take(torch):
    """An index past the learned table is NaN on both sides (jnp.take's
    fill mode), never an error; the lengths an idle slot reaches in
    serving stay far below the table's 32,768 rows."""
    from repro_torch.models import layers
    table = np.arange(10, dtype=np.float32).reshape(5, 2)
    idx = np.asarray([1, 4, 5, 9], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = layers.position_lookup(torch.from_numpy(table),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[2:]).all()


def test_reference_decode_state_carries_zeros_for_the_encoder(torch, audio):
    """``init_decode_state`` for audio: the reference's caches, lengths and
    ``enc_out`` (zeros in the parameters' dtype) byte for byte."""
    jstate = jtf.init_decode_state(audio, 3, 8, "float32")
    _, _, model = _carried()
    state = model.init_decode_state(3, 8, "float32")
    for name in ("k_cache", "v_cache", "length", "enc_out"):
        got, want = getattr(state, name), np.asarray(getattr(jstate, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want)
    assert jax.tree.leaves(jstate.k_scale) == [] and state.k_scale is None
