"""Carry the reference's parameters into the port."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.params import flatten

__all__ = ["from_jax_params"]


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
