"""The port's training stack against the reference's, on the CPU.

Weights are the reference's (``init_params(PRNGKey(0), "float32")`` on a
``reduced_config``) carried over with ``from_jax_params``, the optimizer
state with ``from_jax_opt_state``; batches are numpy-seeded. Held here:

* ``make_loss_fn``: the loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's, for the dense (qwen2.5-32b),
  MoE (qwen2-moe), hybrid (jamba), ssm (xlstm-125m), audio (whisper-small)
  and vlm (internvl2-26b) families, float32. Per leaf max |err| <= 1e-4
  of the leaf's largest |g| + 1e-6: the two frameworks sum the products
  and reductions in other orders (the forwards agree to ~1e-6 relative),
  and a backward compounds that over the layers.
* one ``adamw_update``: params, both moments, the gradient norm and the
  step count, rtol 2e-6 (float32; the norm's sum is taken in another
  order, which moves the clip scale and so every update by ~1e-7).
* 3 steps of ``make_train_step`` against the reference's (jitted, as its
  train loop runs it) with 1 and 2 microbatches and with compression
  none, int8 and topk, on phi3-mini (dense, no biases): the losses at
  rtol 1e-5 and the parameters at 1e-4 of each leaf's largest |value|
  (three AdamW steps normalise the gradients' rounding differences into
  the updates); with compression, a gradient entry within rounding of a
  quantisation boundary may go either way, so up to 0.1% of a leaf's
  entries may differ by up to three AdamW steps (``_close``). Not on qwen2.5-32b: the gradient of its key bias is zero
  in exact arithmetic (a softmax ignores a constant added to a row), so
  AdamW turns each framework's rounding noise there into steps of the
  learning rate's size, which no tolerance on the values can hold.
* ``warmup_cosine`` and ``constant``, rtol 1e-6 (float32 cos).
* the mirror of tests/test_system.py's
  ``test_training_deterministic_and_converging`` through the port's
  ``train_loop``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced_config
from repro.engine import TrainConfig as JTrainConfig
from repro.engine import make_loss_fn as jmake_loss_fn
from repro.engine import make_train_step as jmake_train_step
from repro.engine.compression import CompressionConfig as JCompression
from repro.models import Ctx as JCtx
from repro.optim import AdamWConfig as JAdamW
from repro.optim import OptState as JOptState
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import warmup_cosine as jwarmup_cosine
from torch_parity import carry

FAMILIES = ["qwen25_32b", "qwen2_moe", "jamba15_large", "xlstm_125m",
            "whisper_small", "internvl2_26b"]


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _batch(cfg, B=2, S=16, seed=1):
    """tokens (B, S); labels the tokens with a few positions -1 (masked);
    whisper's frames and the vlm's patches drawn at random."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    labels = tokens.copy()
    labels[:, -3:] = -1
    labels[0, 4] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree):
    from repro_torch.models.params import flatten
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
            for k, v in flatten(tree).items()}


def _port_tree(torch, model):
    """The model's parameters as fresh float32 leaves (not the module's)."""
    from repro_torch import tree as tr
    return tr.tree_map(lambda p: p.detach().clone(), model.params())


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(torch, arch):
    from repro_torch import tree as tr
    from repro_torch.engine import TrainConfig, make_loss_fn
    from repro_torch.models import Ctx
    cfg = reduced_config(get_arch(arch))
    jm, jp, model = carry(cfg, "float32")
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jm, JCtx(), JTrainConfig()), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tr.tree_map(lambda p: p.detach().requires_grad_(True),
                         model.params())
    loss, met = make_loss_fn(model, Ctx(), TrainConfig())(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tr.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for key in ("loss", "aux_loss", "z_loss", "tokens"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-9, err_msg=key)
    want = _flat(jgrads)
    got = {k: g.numpy() for k, g in
           zip(_flat(params).keys(), grads)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        tol = 1e-4 * np.abs(w).max() + 1e-6
        err = np.abs(got[k] - w).max()
        assert err <= tol, f"{arch} {k}: max|err| {err:.3g} > {tol:.3g}"


SHAPES = {"w": (6, 5), "b": (5,), "blocks": {"a": (3, 4), "c": (7,)}}


def _draw(rng, shapes, scale=1.0):
    return {k: (_draw(rng, s, scale) if isinstance(s, dict)
                else (rng.standard_normal(s) * scale).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_update_matches_reference(torch, clip):
    from repro_torch import tree as tr
    from repro_torch.optim import AdamWConfig, OptState, adamw_update
    rng = np.random.default_rng(int(clip))
    params, grads = _draw(rng, SHAPES), _draw(rng, SHAPES, 3.0)
    m, v = _draw(rng, SHAPES, 0.1), tr.tree_map(np.abs,
                                                 _draw(rng, SHAPES, 0.01))
    step, lr = 4, np.float32(3e-3)
    jcfg = JAdamW(grad_clip=clip)
    jparams, jstate, jmet = jadamw_update(
        jax.tree.map(jnp.asarray, grads),
        JOptState(jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, v),
                  jnp.asarray(step, jnp.int32)),
        jax.tree.map(jnp.asarray, params), jnp.asarray(lr), jcfg)
    t = lambda tree: tr.tree_map(  # noqa: E731
        lambda a: torch.tensor(a), tree)
    got_p, state, met = adamw_update(
        t(grads), OptState(t(m), t(v), torch.tensor(step, dtype=torch.int32)),
        t(params), torch.tensor(lr), AdamWConfig(grad_clip=clip))
    assert int(state.step) == int(jstate.step) == step + 1
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]))
    for got, want in ((got_p, jparams), (state.m, jstate.m),
                      (state.v, jstate.v)):
        g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-6, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_reference(torch, scheme, micro):
    from repro_torch.engine import (CompressionConfig, TrainConfig,
                                    init_error_state, make_train_step)
    from repro_torch.models import Ctx
    from repro_torch.models.convert import from_jax_opt_state
    from repro_torch.optim import AdamWConfig, warmup_cosine
    cfg = reduced_config(get_arch("phi3_mini"))
    jm, jp, model = carry(cfg, "float32")
    jtcfg = JTrainConfig(microbatches=micro, opt=JAdamW(),
                         compression=JCompression(scheme, topk_frac=0.05))
    jstep = jax.jit(jmake_train_step(jm, JCtx(), jtcfg,
                                     jwarmup_cosine(1e-3, 1, 3)))
    jopt = jinit_opt_state(jp, jtcfg.opt)
    jerr = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
            if scheme != "none" else None)
    tcfg = TrainConfig(microbatches=micro, opt=AdamWConfig(),
                       compression=CompressionConfig(scheme, topk_frac=0.05))
    step = make_train_step(model, Ctx(), tcfg, warmup_cosine(1e-3, 1, 3))
    params = _port_tree(torch, model)
    opt = from_jax_opt_state(jax.tree.map(np.asarray, jopt), model)
    err = init_error_state(params) if scheme != "none" else None
    for i in range(3):
        batch = _batch(cfg, B=4, S=12, seed=10 + i)
        jp, jopt, jerr, jmet = jstep(
            jp, jopt, jerr, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, err, met = step(
            params, opt, err, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        np.testing.assert_allclose(float(met["total_loss"]),
                                   float(jmet["total_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert int(opt.step) == 3
    got, want = _flat(params), _flat(jax.tree.map(np.asarray, jp))
    for k, w in want.items():
        _close(got[k], w, 1e-4 * np.abs(w).max(), scheme, k)
    # the residuals (gf - its int8 or top-k round trip) are differences of
    # near-equal numbers, held on equal inputs by
    # test_compression_round_trips_match_reference; here they reach the
    # parameters through steps 2 and 3


def _close(got, want, atol, scheme, name):
    """Within ``atol``; with compression, up to 0.1% of the entries (at
    least one) may instead differ by up to three AdamW steps (3 x 2 x the
    peak learning rate): a gradient entry that lies within rounding of a
    quantisation boundary (int8: a half quantum; top-k: the threshold)
    goes either way in the two frameworks, and that entry's update then
    differs by up to the learning rate in each step."""
    if scheme == "none":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
        return
    bad = np.abs(got - want) > atol
    assert bad.sum() <= max(1, bad.size // 1000), (name, bad.sum())
    assert np.abs(got - want).max() <= max(atol, 3 * 2 * 1e-3), name


def test_compression_round_trips_match_reference(torch):
    """One int8 and one top-k round trip on the same gradients and
    residuals: the decompressed gradients and new residuals, float32; top-k
    keeps every entry tied at the threshold, as the reference does."""
    from repro.engine.compression import compress_grads as jcompress
    from repro_torch import tree as tr
    from repro_torch.engine import CompressionConfig, compress_grads
    rng = np.random.default_rng(7)
    g, e = _draw(rng, SHAPES), _draw(rng, SHAPES, 0.01)
    g["w"][0, :3] = g["w"][1, 1]  # ties at a large magnitude
    for scheme, frac in (("int8", 0.01), ("topk", 0.2), ("topk", 0.0)):
        jg, je = jcompress(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, e),
                           JCompression(scheme, frac))
        t = lambda tree: tr.tree_map(  # noqa: E731
            lambda a: torch.tensor(a), tree)
        tg, te = compress_grads(t(g), t(e), CompressionConfig(scheme, frac))
        for got, want in ((tg, jg), (te, je)):
            a, b = _flat(got), _flat(jax.tree.map(np.asarray, want))
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                           atol=1e-7, err_msg=(scheme, k))


def test_schedules_match_reference(torch):
    from repro.optim import constant as jconstant
    from repro_torch.optim import constant, warmup_cosine
    for peak, warm, total in ((3e-4, 5, 100), (1e-3, 1, 3), (6e-4, 0, 10)):
        jf, f = jwarmup_cosine(peak, warm, total), warmup_cosine(peak, warm,
                                                                 total)
        for s in range(total + 3):
            got = f(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(jf(s)), rtol=1e-6,
                                       err_msg=(peak, warm, total, s))
    assert float(constant(2e-4)(torch.tensor(7))) == float(
        jconstant(2e-4)(7))


def test_training_deterministic_and_converging(torch):
    """tests/test_system.py's test through the port's train_loop on the
    CPU: xlstm-125m reduced, 30 steps of batch 4 x 32 tokens at lr 1e-3;
    two runs give the same losses (same arithmetic, one thread), and the
    mean of the last 5 is 0.3 under the first post-warmup loss."""
    from repro_torch.launch.train import train_loop
    steps, lr = 30, 1e-3
    warmup = max(1, steps // 20)
    a = train_loop("xlstm_125m", steps=steps, batch=4, seq=32, lr=lr,
                   log_every=100, device="cpu")
    b = train_loop("xlstm_125m", steps=steps, batch=4, seq=32, lr=lr,
                   log_every=100, device="cpu")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    post_warmup = a["losses"][warmup]
    assert np.mean(a["losses"][-5:]) < post_warmup - 0.3, a["losses"]
    assert [h["loss"] for h in a["history"]] == a["losses"]
