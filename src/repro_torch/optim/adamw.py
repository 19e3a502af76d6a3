"""AdamW (port of ``repro.optim.adamw``, single device).

A plain function over the parameter tree with the reference's arithmetic,
not ``torch.optim.AdamW`` (which decays as ``p *= 1 - lr * wd`` before the
step, another rounding): the global gradient norm summed over the leaves
in the reference's leaf order (sorted dict keys), the clip scale, then per
leaf in float32 ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
``p = p - lr (m / c1 / (sqrt(v / c2) + eps) + wd p)``, moments stored in
``moment_dtype``.

The update writes the new values into the leaves of ``params`` and of the
moments, in place, and returns them: the reference's train loop donates
both to its jitted step, and at full width (tens of GB of parameters and
moments) a second copy does not fit beside the first. The moments mirror
the parameters' sharding (``opt_state_specs``); ``abstract_opt_state``
gives them as meta tensors. Over a mesh each rank updates its own blocks
(over the model axis, the data axis under FSDP, or both) and their
moments in place; the global norm counts each leaf once over the whole
mesh, so every rank gets the same bits for the norm and the clip scale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.core.planner import P
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.elastic import split_over
from repro_torch.models.params import torch_dtype

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "abstract_opt_state", "opt_state_specs", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # 0-d int32, on the parameters' device


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    first = tr.leaves(params)[0]
    return OptState(m=tr.tree_map(zeros, params),
                    v=tr.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=first.device))


def abstract_opt_state(abstract_params, cfg: AdamWConfig) -> OptState:
    dt = torch_dtype(cfg.moment_dtype)
    meta = lambda p: torch.empty(p.shape, dtype=dt,  # noqa: E731
                                 device="meta")
    return OptState(m=tr.tree_map(meta, abstract_params),
                    v=tr.tree_map(meta, abstract_params),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def opt_state_specs(param_specs) -> OptState:
    return OptState(m=param_specs, v=param_specs, step=P())


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over the leaves, in leaf order, of each leaf's sum
    of squares in float32. Over a mesh (each leaf of ``tree`` this rank's
    block of one under ``specs``, the leaves' ``param_specs``): a rank
    adds a leaf's sum only where its index is 0 on every axis that does
    not split the leaf, so each block counts once, and one all-reduce
    over every rank of the mesh gives the same bits on each."""
    sums = [torch.sum(torch.square(leaf.float())) for leaf in tr.leaves(tree)]
    if mesh is not None:
        sq = torch.stack(sums)
        skip = [any(mesh.index(a) for a in mesh.shape
                    if a not in split_over(spec, mesh))
                for spec in tr.leaves(specs)]
        sq = sq.masked_fill(torch.tensor(skip, device=sq.device), 0.0)
        sums = coll.all_reduce(sq, None).unbind()
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def _update_leaf(p, g, m, v, scale, lr, c1, c2, cfg: AdamWConfig) -> None:
    """One leaf's step, in place; each operation rounds as the
    reference's expression does."""
    g = g.float() * scale
    mf = (m.float() * cfg.b1).add_(g * (1 - cfg.b1))
    vf = (v.float() * cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
    del g
    m.copy_(mf)
    v.copy_(vf)
    update = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
    del mf, vf
    pf = p.float()
    update.add_(pf * cfg.weight_decay).mul_(lr)
    if pf is p:
        p.sub_(update)
    else:
        p.copy_(pf.sub_(update))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr: torch.Tensor,
                 cfg: AdamWConfig, specs=None, mesh=None
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: params and the moments updated in place and
    returned, the step count advanced; metrics hold the gradient's global
    norm (before clipping; over a mesh ``specs`` and ``mesh`` as
    :func:`global_norm` takes them) and the learning rate."""
    step = state.step + 1
    gnorm = global_norm(grads, specs, mesh)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for p, g, m, v in zip(tr.leaves(params), tr.leaves(grads),
                          tr.leaves(state.m), tr.leaves(state.v)):
        _update_leaf(p, g, m, v, scale, lr, c1, c2, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, step), metrics
