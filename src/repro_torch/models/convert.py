"""Carry the reference's parameters into the port."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import flatten
from repro_torch.optim.adamw import OptState

__all__ = ["from_jax_params", "from_jax_opt_state"]


def from_jax_params(tree: Mapping, model: Model) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree, as numpy arrays, -> a state_dict for
    ``model`` under the same paths (joined by ``.``) and shapes.

    bf16 arrays (``ml_dtypes.bfloat16``) go through float32, which is
    exact. Raises on a missing, extra or reshaped leaf. Load the result
    with ``model.load_state_dict(sd, assign=True)``."""
    flat = flatten(tree)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing, extra = sorted(want.keys() - flat), sorted(flat.keys() - want)
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    out = {}
    for key, leaf in flat.items():
        arr = np.asarray(leaf)
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, the port wants "
                             f"{want[key]}")
        if arr.dtype.name == "bfloat16":
            out[key] = torch.from_numpy(
                arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def _nested(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a.b.c": t}`` -> the nested dict ``{"a": {"b": {"c": t}}}``."""
    out: Dict = {}
    for key, t in flat.items():
        *outer, leaf = key.split(".")
        node = out
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def from_jax_opt_state(state, model: Model, device=None) -> OptState:
    """The reference's ``OptState(m, v, step)``, its leaves numpy arrays
    (or anything ``np.asarray`` takes), -> the port's, on ``device``
    (default the CPU): m and v nested dicts of ``model.params()``'s paths
    and shapes in the moments' dtype, step a 0-d int32 tensor. Raises as
    ``from_jax_params`` on a missing, extra or reshaped leaf."""
    m, v = (_nested(from_jax_params(t, model)) for t in (state.m, state.v))
    to = lambda t: t.to(device or "cpu")  # noqa: E731
    return OptState(m=tr.tree_map(to, m), v=tr.tree_map(to, v),
                    step=to(torch.tensor(int(np.asarray(state.step)),
                                         dtype=torch.int32)))
