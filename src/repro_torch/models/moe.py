"""Mixture-of-Experts layer (port of ``repro.models.moe``).

Dispatch is the reference's hash-partition build: the router gives each
token its top-k experts, the token-slots are sorted by expert (stable, so
within an expert by token), each slot is ranked within its expert, and the
first C of every expert are kept; the rest are dropped and the residual
carries them. The (E*C, d) buffer of kept rows is built by
``kernels.ops.moe_gather``: the hand-written CUDA kernel for tensors on a
card, its plain version on the CPU. The experts run as batched products
over all E experts, as in the reference, and the combine adds each token's
k weighted outputs back.

Routing runs on the device with tensor ops only: no boolean-mask indexing
and no ``.item()``, so the host never waits on the card. Dropped slots go
to a trash index E*C, which is where duplicate scatter writes land.

``Ctx(plan=, mesh=, ep_shard_map=True)`` with an "ep" plan takes the
explicit expert-parallel path (the reference's
``_moe_apply_ep_shard_map``, :func:`_moe_apply_ep`): each rank of the
model axis routes its tokens, keeps the slots of its own E/tp experts,
builds their buffer through the same ``moe_gather``, runs them, adds the
partial of the shared experts whose ff columns it holds, and one
all-reduce over the model axis sums the ranks' partial outputs. It
trains too: x enters the gather (P3 forward, ``moe_gather_bwd``
backward) and the routing weights enter the combine through
``layers.to_model``, so the router's and x's gradients are complete on
every rank.

On a batch split over data shards (``Ctx.dp`` > 1) the capacity is that
of the global token count, and :func:`moe_apply` ranks each expert's
slots over the global batch: a shard's ranks start after the earlier
shards' counts (one all-gather of E counts over the data axes a layer;
``engine.shard_batch`` puts their rows first in every microbatch), so
the kept slots are the single device's. Under ``Ctx.global_aux`` the
load-balance loss is the global batch's: the expert counts and the sums
of the probs summed over the shards (``layers.data_sum``, autograd
through the probs), as the single device computes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (_act, data_sum, ffn_apply, ffn_defs,
                                       ffn_partial, held_split, model_sum,
                                       to_model)
from repro_torch.models.params import ParamDef

__all__ = ["moe_defs", "moe_apply", "expert_capacity"]


def expert_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / max(1, cfg.n_experts)
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _shared_cfg(cfg: ArchConfig) -> ArchConfig:
    """The shared experts fuse into one always-on FFN of width
    n_shared * d_ff."""
    return dataclasses.replace(cfg, d_ff=cfg.n_shared_experts * cfg.d_ff)


def moe_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    out = {
        "router": ParamDef((*lead, d, E), (*la, "embed", None), init="small"),
        "w_down": ParamDef((*lead, E, ff, d), (*la, "experts", "ff", "embed")),
        "w_up": ParamDef((*lead, E, d, ff), (*la, "experts", "embed", "ff")),
    }
    if cfg.activation in ("swiglu", "geglu"):
        out["w_gate"] = ParamDef((*lead, E, d, ff),
                                 (*la, "experts", "embed", "ff"))
    if cfg.n_shared_experts:
        out["shared"] = ffn_defs(_shared_cfg(cfg), stacked)
    return out


def _aux_loss(cfg: ArchConfig, counts: torch.Tensor, probs: torch.Tensor,
              ctx: Ctx) -> torch.Tensor:
    """The Switch load-balance loss E * sum_e f_e * P_e from the expert
    counts of the T * k slots and the (T, E) probs: this shard's, or under
    ``ctx.global_aux`` the global batch's (counts and prob sums summed
    over the data shards)."""
    E = cfg.n_experts
    T, k = probs.shape[0], cfg.top_k
    if not (ctx.global_aux and ctx.dp > 1):
        return E * torch.sum(counts / (T * k) * probs.mean(dim=0))
    n = T * ctx.dp
    counts = data_sum(counts, ctx)
    return E * torch.sum(counts / (n * k) * (data_sum(probs.sum(0), ctx) / n))


def _earlier_counts(counts: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Each expert's slots on the data shards before this one: every
    shard's (E,) counts all-gathered over the data axes, innermost first,
    so the rows fall in ``ctx.dp_index`` order."""
    every = counts[None]
    for group in reversed(ctx.dp_groups):
        every = coll.all_gather(every, group)
    return every[:ctx.dp_index].sum(0)


def _expert_ffn(cfg: ArchConfig, p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), batched over experts."""
    if cfg.activation in ("swiglu", "geglu"):
        h = _act(cfg, torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = _act(cfg, torch.bmm(buf, p["w_up"]))
    return torch.bmm(h, p["w_down"])


def moe_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor, ctx: Ctx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    if (ctx.ep_shard_map and ctx.mesh is not None and ctx.plan is not None
            and ctx.plan.moe_strategy == "ep"):
        return _moe_apply_ep(cfg, p, x, ctx)
    if p["w_up"].shape[-3] != cfg.n_experts:
        raise ValueError(
            f"{p['w_up'].shape[-3]} of {cfg.n_experts} experts held: a "
            f"rank's experts run under Ctx(plan=, mesh=, ep_shard_map=True) "
            f"with an \"ep\" plan")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, T * ctx.dp)
    xt = x.reshape(T, d)
    dev = x.device

    # --- routing (float32)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = torch.topk(probs, k, dim=-1, sorted=True)  # (T, k)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    # Each token's k experts in increasing order: the global stable sort
    # below then gives the reference's slot order, and the combine adds a
    # token's outputs in the order of the reference's sorted scatter.
    ids, perm = ids.sort(dim=-1)
    weights = weights.gather(-1, perm)

    # --- hash-partition: sort token-slots by expert key
    se, order = torch.sort(ids.reshape(-1), stable=True)  # (T*k,)
    st = torch.div(order, k, rounding_mode="floor")  # slot -> token
    bounds = torch.searchsorted(se, torch.arange(E + 1, device=dev))
    starts = bounds[:-1]  # first slot per expert
    rank = torch.arange(T * k, device=dev) - starts[se]
    if ctx.dp > 1:  # ranked over the global batch, as the single device
        rank = rank + _earlier_counts(bounds[1:] - starts, ctx)[se]
    pos = torch.where(rank < C, se * C + rank, E * C)  # E*C = overflow bin

    # --- load-balance aux loss (Switch): E * sum_e f_e * P_e
    aux = _aux_loss(cfg, (bounds[1:] - starts).float(), probs, ctx)

    # --- build per-expert buffers (the repartitioned pages). pos_tok: each
    # token's k slots in increasing order (its experts are sorted), dropped
    # ones at E*C, past the buffer: the map the gather's backward reads.
    token_ids = torch.full((E * C + 1,), -1, dtype=torch.int32, device=dev)
    token_ids.scatter_(0, pos, st.to(torch.int32))
    token_ids = token_ids[:E * C]
    pos_tok = torch.empty_like(pos).scatter_(0, order, pos).reshape(T, k)
    buf = kops.moe_gather(xt, token_ids, token_ids >= 0,
                          slots=pos_tok).reshape(E, C, d)
    if ctx.quantize_dispatch:
        # int8 with a per-row absmax scale, dequantized expert-side (the
        # reference's all-to-all payload under expert parallelism)
        scale = (buf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-8)
        q = torch.clamp(torch.round(buf / scale), -127, 127).to(torch.int8)
        buf = (q.to(x.dtype) * scale).to(x.dtype)

    y_e = _expert_ffn(cfg, p, buf).reshape(E * C, d)

    # --- probe/combine: each token's k outputs, weighted, added in
    # increasing expert order in x's dtype. A dropped slot reads some row
    # with weight 0, as the reference reads its zero row. Each token adds
    # its own k rows: no atomics, the same sum on every run.
    w_tok = (weights * (pos_tok < E * C)).to(y_e.dtype)
    contrib = (y_e[pos_tok.clamp(max=E * C - 1)] * w_tok[..., None]
               ).to(x.dtype)  # (T, k, d)
    y = contrib[:, 0]
    for i in range(1, k):
        y = y + contrib[:, i]

    if cfg.n_shared_experts:
        y = y + ffn_apply(_shared_cfg(cfg), p["shared"], xt, ctx)
    return y.reshape(B, S, d), aux


def _moe_apply_ep(cfg: ArchConfig, p: Dict, x: torch.Tensor, ctx: Ctx
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism: x (B, S, d) is this rank's data shard
    of the batch, whole on every rank of the model axis, and ``p``'s
    expert leaves hold this rank's E/tp experts (``Model.param_specs``)
    with the router whole and the shared experts' ff split over the model
    axis where it divides; each rank gathers only its own experts' tokens
    (a shard-local hash-partition build: no dispatch collective), runs
    them, adds its partial of the shared experts, and the combine is one
    all-reduce of the partial outputs over the model axis a layer (shared
    experts held whole are added after it).

    As in the reference: the capacity C is ``expert_capacity`` of the
    global token count (B * S times the data shards), while each shard
    routes only its own tokens, so under a tight capacity the drops are
    not the single-device path's; the aux loss is this shard's own (the
    reference returns data shard 0's, its shard_map's replicated output)
    unless ``ctx.global_aux`` asks for the global batch's;
    ``quantize_dispatch`` is ignored; the shared experts' partial rides
    the same all-reduce.

    For the gradient, x enters the gather and the split shared experts,
    and the routing weights enter the combine, through ``to_model``: each
    rank's slots and shared columns give a partial gradient, which the
    backward sums over the model axis, so x's and the router's gradients
    (combine and aux) are complete on every rank and the aux counts
    once."""
    plan, mesh = ctx.plan, ctx.mesh
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_local = E // plan.tp_size
    my = mesh.index(plan.tp_axis)
    C = expert_capacity(cfg, B * ctx.dp * S)
    T = B * S
    xt = x.reshape(T, d)
    xm = to_model(xt, ctx)
    dev = x.device

    # --- routing (float32), this shard's tokens
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1, sorted=True)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    ids, perm = ids.sort(dim=-1)  # the reference's slot order (moe_apply)
    weights = weights.gather(-1, perm)
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, ids.reshape(-1), torch.ones(T * k, device=dev))
    aux = _aux_loss(cfg, counts, probs, ctx)

    # --- shard-local build: keep only the slots routed to MY experts
    flat_e = ids.reshape(-1)
    mine = torch.div(flat_e, E_local, rounding_mode="floor") == my
    local_e = torch.where(mine, flat_e - my * E_local, E_local)
    se, order = torch.sort(local_e, stable=True)
    st = torch.div(order, k, rounding_mode="floor")
    bounds = torch.searchsorted(se, torch.arange(E_local + 1, device=dev))
    rank = torch.arange(T * k, device=dev) - bounds[se]
    keep = (rank < C) & (se < E_local)
    pos = torch.where(keep, se * C + rank, E_local * C)
    token_ids = torch.full((E_local * C + 1,), -1, dtype=torch.int32,
                           device=dev)
    token_ids.scatter_(0, pos, st.to(torch.int32))
    token_ids = token_ids[:E_local * C]
    # each token's k slots here in increasing order, the others at
    # E_local * C, past the buffer: the map the gather's backward reads
    pos_tok = torch.empty_like(pos).scatter_(0, order, pos).reshape(T, k)
    buf = kops.moe_gather(xm, token_ids, token_ids >= 0,
                          slots=pos_tok).reshape(E_local, C, d)
    y_e = _expert_ffn(cfg, p, buf).reshape(E_local * C, d)

    # --- combine: each token's kept slots here, weighted, in increasing
    # expert order; then the ranks' partial sums, one all-reduce
    w_tok = (to_model(weights, ctx) * (pos_tok < E_local * C)).to(y_e.dtype)
    contrib = (y_e[pos_tok.clamp(max=E_local * C - 1)] * w_tok[..., None]
               ).to(x.dtype)
    y = contrib[:, 0]
    for i in range(1, k):
        y = y + contrib[:, i]
    if not cfg.n_shared_experts:
        return model_sum(y, ctx).reshape(B, S, d), aux
    scfg = _shared_cfg(cfg)
    if held_split(p["shared"]["w_down"].shape[-2], scfg.d_ff, ctx):
        y = model_sum(y + ffn_partial(scfg, p["shared"], xm), ctx)
    else:  # whole on every rank: added after the sum, x's own gradient
        y = model_sum(y, ctx) + ffn_partial(scfg, p["shared"], xt)
    return y.reshape(B, S, d), aux
