"""Shared set-up of the port-against-reference suites (tests/test_torch_*.py
that import JAX): the reference's config as the port's, and a model whose
weights are carried from the reference into the port. torch is imported
inside the functions, as the suites import it inside fixtures."""
import dataclasses

import jax
import numpy as np

from repro.models import build_model as jbuild


def port_cfg(cfg):
    """The reference's ArchConfig as the port's (same fields)."""
    from repro_torch.configs import ArchConfig
    return ArchConfig(**dataclasses.asdict(cfg))


def carry(cfg, dtype):
    """(reference model, its params from ``PRNGKey(0)`` in ``dtype``) and
    the port's model with the same weights, through ``from_jax_params``."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import from_jax_params
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype)
    model = build_model(port_cfg(cfg))
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, jp), model), assign=True)
    return jm, jp, model


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|: ``got`` a torch tensor,
    ``want`` a numpy or JAX array, both compared in float32."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def decode_both(jm, jp, model, tokens, jstate, state):
    """Teacher-forced decode of ``tokens`` (B, T) numpy through the
    reference's jitted ``decode_step`` from ``jstate`` and the port's from
    ``state``: returns the worst ``rel_err`` over the steps, the logits'
    dtypes (port, reference) and both final states."""
    import jax.numpy as jnp
    import torch
    from repro.models import Ctx as JCtx
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, JCtx()))
    worst = 0.0
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, state = model.decode_step(torch.from_numpy(tok), state)
        worst = max(worst, rel_err(got, np.asarray(want)))
    return worst, (got.dtype, want.dtype), jstate, state


def serve_both(cfg, jm, jp, model, n_requests=8, max_seq=48, **engine_kw):
    """``n_requests`` prompts of 2-7 tokens drawn as ``serve_model`` draws
    them (seed 0), through the reference's engine and the port's (batch
    4, greedy, ``engine_kw`` for the port's), each run until it drains.
    Returns both engines."""
    from repro.engine.serve_step import ServingEngine as JEngine
    from repro_torch.engine.serve_step import ServingEngine
    jeng = JEngine(jm, jp, batch_size=4, max_seq=max_seq, eos_id=-1)
    eng = ServingEngine(model, batch_size=4, max_seq=max_seq, eos_id=-1,
                        **engine_kw)
    rng = np.random.default_rng(0)
    for _ in range(n_requests):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(2, 8)).tolist()
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
    return jeng, eng
