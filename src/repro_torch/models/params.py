"""Parameter definition trees (port of ``repro.models.params``).

Every parameter is declared once as a :class:`ParamDef` carrying its shape
and logical axes. From one definition tree we derive:

* ``abstract(defs, dtype)`` — tensors on the meta device (no storage:
  the reference's ShapeDtypeStructs),
* ``initialize(defs, generator, dtype, device)`` — real tensors,
* ``specs(defs, plan)``  — the partition spec (``core.planner.P``) tree,
* ``local_shape(shape, spec, axis_sizes)`` — what one rank holds of a
  leaf under its spec,
* ``count(defs)``  — exact parameter count,
* ``tree_paths(defs)`` — flat ``{"a.b.c": ParamDef}`` view.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

__all__ = ["ParamDef", "abstract", "initialize", "init_leaf", "specs",
           "map_defs", "count", "tree_paths", "flatten", "torch_dtype",
           "local_shape"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _iter_defs(defs: Dict[str, Any], prefix: str = ""
              ) -> Iterator[Tuple[str, ParamDef]]:
    """Yields ``(dotted path, ParamDef)`` in sorted key order (JAX's pytree
    order for dicts)."""
    for key in sorted(defs):
        sub = defs[key]
        path = f"{prefix}{key}"
        if isinstance(sub, ParamDef):
            yield path, sub
        else:
            yield from _iter_defs(sub, path + ".")


def tree_paths(defs) -> Dict[str, ParamDef]:
    return dict(_iter_defs(defs))


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"a.b.c": leaf}`` (state_dict keys)."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            out.update(flatten(sub, path + "."))
        else:
            out[path] = sub
    return out


def map_defs(fn, defs) -> Dict[str, Any]:
    """``fn`` of every ParamDef, into a nested dict of ``defs``' paths."""
    return {k: fn(v) if isinstance(v, ParamDef) else map_defs(fn, v)
            for k, v in sorted(defs.items())}


def abstract(defs, dtype) -> Dict[str, Any]:
    dt = torch_dtype(dtype)
    return map_defs(
        lambda d: torch.empty(d.shape, dtype=dt, device="meta"), defs)


def specs(defs, plan) -> Dict[str, Any]:
    return map_defs(lambda d: plan.spec(*d.axes), defs)


def local_shape(shape: Tuple[int, ...], spec,
                axis_sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec`` (a ``core.planner.P``) on a mesh of ``axis_sizes``: a dim
    whose entry names an axis, or a tuple of axes, is split into that many
    equal blocks (their product); ``None``, or a dim past the spec's end,
    stays whole. Raises ValueError where a dim does not split evenly."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} for a leaf of {len(shape)} dims")
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(axis_sizes[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks over {axes}")
        out[dim] = shape[dim] // n
    return tuple(out)


def count(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _iter_defs(defs))


def _std(d: ParamDef) -> float:
    if d.init == "embed":
        return d.scale
    if d.init == "small":
        return 0.02 * d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(1, d.shape[-1])
    return d.scale / math.sqrt(fan_in)


def init_leaf(d: ParamDef, generator: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    """One leaf, drawn on ``device`` directly in ``dtype`` (the full-width
    model is tens of GB: no float32 staging copy, no host draws)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    out = torch.empty(d.shape, dtype=dtype, device=device)
    return out.normal_(0.0, _std(d), generator=generator)


def initialize(defs, generator: torch.Generator, dtype: torch.dtype,
               device) -> Dict[str, Any]:
    """Nested dict of tensors mirroring ``defs``. The std rules are the
    reference's; the numbers differ (torch.Generator, not jax.random)."""
    return {k: (init_leaf(v, generator, dtype, device)
                if isinstance(v, ParamDef)
                else initialize(v, generator, dtype, device))
            for k, v in sorted(defs.items())}


def torch_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype!r}")
    return out
