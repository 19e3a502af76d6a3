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

Over a mesh (``Ctx(plan=, mesh=)``) each rank holds its slices of every
leaf under ``Model.param_specs`` and its data shard of the batch
(:func:`shard_batch`: its rows of each global microbatch), and the step
computes what the single device computes on the global batch, as GSPMD
gives the reference: the loss's denominators and the MoE aux over the
global batch, the loss over the split vocab from all-reduced maxima, sums
of exponentials and label logits (no all-gather of the logits), stage 1
on the shard, then stage 2's shuffle: one all-reduce a leaf of its
float32 gradient over the data axes. Leaves held whole on the model axis
get the same complete gradient on every rank (``layers.to_model`` /
``model_sum``), so nothing is reduced over it; compression and AdamW run
on the rank's blocks with the whole leaf's semantics (``param_specs``
says which axes split each leaf).

Under FSDP a leaf split over the data axis is all-gathered where the
model reads it (``collectives.gather_data``), and the gather's backward
reduce-scatters its float32 gradient over the data axis: each
microbatch's gradient arrives as the rank's block, summed over the data
shards, and the blocks are added in microbatch order. Stage 2 then sums
such a leaf over the other data axes only (``pod``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.elastic import split_over
from repro_torch.engine.compression import CompressionConfig, compress_grads
from repro_torch.models import transformer as tf
from repro_torch.models.context import Ctx
from repro_torch.models.layers import data_sum, model_sum
from repro_torch.models.model_zoo import Model
from repro_torch.optim import AdamWConfig, OptState, adamw_update, constant

__all__ = ["TrainConfig", "make_loss_fn", "make_grad_fn", "make_train_step",
           "make_eval_step", "shard_batch", "AUX_LOSS_COEF"]

AUX_LOSS_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    opt: AdamWConfig = AdamWConfig()
    compression: CompressionConfig = CompressionConfig()
    z_loss: float = 1e-4


def shard_batch(batch: Dict, ctx: Ctx, microbatches: int = 1) -> Dict:
    """This rank's data shard of a global batch: for each of the
    ``microbatches`` global microbatches (rows [i B/k, (i+1) B/k), the
    reference's split), this shard's block of its rows, in microbatch
    order; the whole batch without data shards."""
    dp, r, k = ctx.dp, ctx.dp_index, max(1, microbatches)
    if dp == 1:
        return batch

    def rows(x):
        B = x.shape[0]
        if B % (k * dp):
            raise ValueError(f"a batch of {B} rows does not split into {k} "
                             f"microbatches of {dp} data shards")
        return x.reshape(k, dp, B // (k * dp), *x.shape[1:])[:, r].reshape(
            B // dp, *x.shape[1:])
    return {key: rows(x) for key, x in batch.items()}


def _specs(model: Model, ctx: Ctx):
    """The parameters' ``param_specs`` over a mesh (each leaf's blocks, by
    axis), None without one."""
    return None if ctx.mesh is None else model.param_specs(ctx.plan)


def _split_vocab(lg: torch.Tensor, tg: torch.Tensor, ctx: Ctx
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log Z, the label's logit) from this rank's vocab columns ``lg``
    (..., V/tp): the maximum, the sum of exponentials and the label's
    logit (from the rank that holds its column) summed over the model
    axis."""
    V = lg.shape[-1]
    m = coll.all_reduce_max(lg.detach().amax(dim=-1), ctx.tp_group)
    logz = m + torch.log(model_sum(torch.exp(lg - m[..., None]).sum(-1),
                                   ctx))
    local = tg - ctx.tp_index * V
    mine = (local >= 0) & (local < V)
    ll = torch.gather(lg, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    return logz, model_sum(torch.where(mine, ll, 0.0), ctx)


def make_loss_fn(model: Model, ctx: Ctx, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (objective, metrics): shifted
    cross-entropy (token t+1 predicted from the prefix up to t; labels < 0
    masked), plus the z-loss on log Z, plus ``AUX_LOSS_COEF`` times the
    MoE load-balance loss, as the reference's; ``metrics["total"]`` is
    that sum.

    Over a mesh ``batch`` is the rank's shard, the metrics are the global
    batch's and the objective is the rank's: its tokens' cross-entropy
    and z-loss over the global token count, plus the aux, whose gradients
    summed over the data shards are the global loss's. Without one the
    objective is the total."""
    cfg = model.cfg
    if ctx.mesh is not None:
        ctx = dataclasses.replace(ctx, global_aux=True)

    def loss_fn(params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, aux = tf.forward(cfg, params, batch, ctx,
                                 gather_logits=False)
        labels = batch["labels"]
        lg = logits[:, :-1]
        tg = labels[:, 1:]
        mask = (tg >= 0).to(torch.float32)
        tg = torch.clamp(tg, min=0).long()
        if lg.shape[-1] == cfg.padded_vocab:
            logz = torch.logsumexp(lg, dim=-1)
            ll = torch.gather(lg, -1, tg[..., None])[..., 0]
        else:
            logz, ll = _split_vocab(lg, tg, ctx)
        nll = (logz - ll) * mask
        zsq = ((logz * mask) ** 2).sum()
        # the global batch's token count, nll and z sums: one all-reduce
        sums = data_sum(torch.stack([mask.sum(), nll.sum(), zsq]).detach(),
                        ctx)
        denom = torch.clamp(sums[0], min=1.0)
        objective = (nll.sum() / denom + tcfg.z_loss * zsq / denom
                     + AUX_LOSS_COEF * aux)
        ce, zl = sums[1] / denom, tcfg.z_loss * sums[2] / denom
        metrics = {"loss": ce, "aux_loss": aux, "z_loss": zl,
                   "tokens": denom, "total": ce + zl + AUX_LOSS_COEF * aux}
        return objective, metrics

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads): the gradient of the objective, a tree of
    params' structure, and the total from the metrics."""
    work = tr.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        objective, metrics = loss_fn(work, batch)
        grads = torch.autograd.grad(objective, tr.leaves(work))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (metrics.pop("total"), metrics), tr.unflatten(params, list(grads))


def make_grad_fn(model: Model, ctx: Ctx, tcfg: TrainConfig = TrainConfig()):
    """grad_fn(params, batch) -> (loss, metrics, grads): stage 1, the
    microbatches' float32 gradients added in order and divided by their
    count, then over a mesh stage 2's shuffle, each leaf's gradient summed
    over the data axes by one all-reduce (the loss the global batch's
    total; under FSDP a leaf split over the data axis is summed over the
    other data axes alone: its gather's backward reduce-scattered it)."""
    loss_fn = make_loss_fn(model, ctx, tcfg)
    specs = _specs(model, ctx)

    def grad_fn(params, batch: Dict):
        k = tcfg.microbatches
        if k <= 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params,
                                                     batch)
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
        # -------- stage 2: the shuffle, the data shards' gradients summed
        axes = ([a for a in ctx.plan.dp_axes if ctx.plan.mesh_axes[a] > 1]
                if ctx.dp > 1 else [])
        for axis in axes:
            group = ctx.mesh.group(axis)
            scattered = axis == "data" and ctx.fsdp > 1  # by the gathers
            grads = tr.tree_map(lambda g, spec: g.float() if scattered and (
                "data" in split_over(spec, ctx.mesh)) else coll.all_reduce(
                g.float(), group), grads, specs)
        return loss, metrics, grads

    return grad_fn


def make_train_step(model: Model, ctx: Ctx,
                    tcfg: TrainConfig = TrainConfig(),
                    lr_fn: Optional[Callable] = None):
    """Returns train_step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics). Over a mesh ``params``,
    ``opt_state`` and ``err_state`` hold the rank's blocks under
    ``param_specs`` (FSDP's over the data axis too) and ``batch`` its
    shard (:func:`shard_batch`)."""
    if ctx.mesh is not None:
        tf.check_split(model.cfg, ctx)
    grad_fn = make_grad_fn(model, ctx, tcfg)
    specs = _specs(model, ctx)
    if lr_fn is None:
        lr_fn = constant(3e-4)

    def train_step(params, opt_state: OptState, err_state, batch: Dict):
        loss, metrics, grads = grad_fn(params, batch)
        # -------- optional compression with error feedback (cross-pod)
        grads, err_state = compress_grads(grads, err_state,
                                          tcfg.compression, specs, ctx.mesh)
        # -------- stage 2: the optimizer update (final aggregation)
        lr = lr_fn(opt_state.step)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr, tcfg.opt, specs, ctx.mesh)
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
