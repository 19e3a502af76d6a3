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
