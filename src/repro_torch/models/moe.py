"""Mixture-of-Experts layer (port of ``repro.models.moe``), the path
without expert parallelism.

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

``Ctx(ep_shard_map=True)`` (the reference's ``_moe_apply_ep_shard_map``)
raises until the parallelism layer is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.context import Ctx
from repro_torch.models.layers import _act, ffn_apply, ffn_defs
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
    if ctx.ep_shard_map:
        raise NotImplementedError(
            "Ctx(ep_shard_map=True), explicit expert parallelism, waits for "
            "the parallelism layer (ROADMAP.md, 'Modules to port', item 9)")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, T)
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
    pos = torch.where(rank < C, se * C + rank, E * C)  # E*C = overflow bin

    # --- load-balance aux loss (Switch): E * sum_e f_e * P_e
    counts = (bounds[1:] - starts).float()
    aux = E * torch.sum(counts / (T * k) * probs.mean(dim=0))

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
        y = y + ffn_apply(_shared_cfg(cfg), p["shared"], xt)
    return y.reshape(B, S, d), aux
