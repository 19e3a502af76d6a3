"""The training step (port of ``repro.engine.train_step``).

The reference's two-stage gradient aggregation on one device: stage 1
splits the batch into ``microbatches`` and adds their float32 gradients in
microbatch order (the reference's ``lax.scan`` over one combiner buffer),
then divides by their count; optional compression with error feedback sits
between the stages; stage 2 is the AdamW update. ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the parameter leaves.

The step reads the parameters through aliases that require grad (the same
storage, detached from any graph), so it takes any tree of tensors, and
AdamW then writes the new values into that storage: the step updates
``params`` and ``opt_state`` in place and returns them, as the reference's
train loop donates them to its jitted step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.engine.compression import CompressionConfig, compress_grads
from repro_torch.models import transformer as tf
from repro_torch.models.context import Ctx
from repro_torch.models.model_zoo import Model
from repro_torch.optim import AdamWConfig, OptState, adamw_update, constant

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step",
           "make_eval_step", "AUX_LOSS_COEF"]

AUX_LOSS_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    opt: AdamWConfig = AdamWConfig()
    compression: CompressionConfig = CompressionConfig()
    z_loss: float = 1e-4


def make_loss_fn(model: Model, ctx: Ctx, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (total, metrics): shifted cross-entropy
    (token t+1 predicted from the prefix up to t; labels < 0 masked), plus
    the z-loss on log Z, plus ``AUX_LOSS_COEF`` times the MoE load-balance
    loss, as the reference's."""
    cfg = model.cfg

    def loss_fn(params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, aux = tf.forward(cfg, params, batch, ctx)  # (B,S,V) f32
        labels = batch["labels"]
        lg = logits[:, :-1]
        tg = labels[:, 1:]
        mask = (tg >= 0).to(torch.float32)
        tg = torch.clamp(tg, min=0).long()
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, tg[..., None])[..., 0]
        nll = (logz - ll) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = nll.sum() / denom
        zl = tcfg.z_loss * ((logz * mask) ** 2).sum() / denom
        total = ce + zl + AUX_LOSS_COEF * aux
        metrics = {"loss": ce, "aux_loss": aux, "z_loss": zl,
                   "tokens": denom}
        return total, metrics

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads): grads a tree of params' structure."""
    work = tr.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        total, metrics = loss_fn(work, batch)
        grads = torch.autograd.grad(total, tr.leaves(work))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tr.unflatten(params, list(grads))


def make_train_step(model: Model, ctx: Ctx,
                    tcfg: TrainConfig = TrainConfig(),
                    lr_fn: Optional[Callable] = None):
    """Returns train_step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics). One device: a context with a
    mesh raises, as no step reduces its gradients over one."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "a train step over a mesh (data-parallel or FSDP, gradients "
            "through grad_reduce_two_stage, sharded AdamW state, the EP "
            "backward) waits for training over the mesh (ROADMAP.md, "
            "queue 1, item 11)")
    loss_fn = make_loss_fn(model, ctx, tcfg)
    if lr_fn is None:
        lr_fn = constant(3e-4)

    def train_step(params, opt_state: OptState, err_state, batch: Dict):
        k = tcfg.microbatches
        if k <= 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
        else:
            # -------- stage 1: microbatch pre-aggregation (combiner pages)
            micro = [{key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                      for key, x in batch.items()} for i in range(k)]
            grads, loss_sum = None, None
            for mb in micro:
                (l, _), g = _value_and_grad(loss_fn, params, mb)
                if grads is None:  # the reference's zeros + g
                    grads = tr.tree_map(lambda b: 0.0 + b.float(), g)
                    loss_sum = 0.0 + l
                else:
                    grads = tr.tree_map(lambda a, b: a.add_(b.float()),
                                        grads, g)
                    loss_sum = loss_sum + l
                del g
            grads = tr.tree_map(lambda g: g.div_(k), grads)
            loss = loss_sum / k
            metrics = {"loss": loss}

        # -------- optional compression with error feedback (cross-pod)
        grads, err_state = compress_grads(grads, err_state,
                                          tcfg.compression)
        # -------- stage 2: the optimizer update (final aggregation)
        lr = lr_fn(opt_state.step)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr, tcfg.opt)
        metrics = {**metrics, **opt_metrics, "total_loss": loss}
        return params, opt_state, err_state, metrics

    return train_step


def make_eval_step(model: Model, ctx: Ctx, tcfg: TrainConfig = TrainConfig()):
    loss_fn = make_loss_fn(model, ctx, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
