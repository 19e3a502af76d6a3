"""Model assembly for the dense and MoE decoder-only families (port of
``repro.models.transformer``).

The stack loops over layer-stacked parameters ``(L, ...)``, slicing one
layer's views per step where the reference scans. A MoE config with
``moe_period == 1`` puts ``blocks["moe"]`` in every layer where a dense
one has ``blocks["mlp"]``. Other families (vlm, hybrid, ssm, audio) and
the int8 KV cache raise NotImplementedError: they are queued in
ROADMAP.md ("Modules to port").
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import (attn_defs, attn_project_qkv,
                                          attention_block, decode_attention)
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (apply_norm, embed_defs, embed_lookup,
                                       ffn_apply, ffn_defs, logits, norm_def,
                                       rope)
from repro_torch.models.moe import moe_apply, moe_defs

__all__ = ["model_defs", "forward", "decode_step", "init_decode_state",
           "DecodeState"]


class DecodeState(NamedTuple):
    """Per-layer decode state, stacked along the layer dim.

    ``decode_step`` updates the caches in place (JAX donates them instead)
    and returns a state holding the same cache tensors."""
    k_cache: torch.Tensor  # (L, B, Smax, K, hd)
    v_cache: torch.Tensor
    length: torch.Tensor  # (B,) int32


def _check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    dense = cfg.family == "dense" and not cfg.is_moe
    moe = cfg.family == "moe" and cfg.is_moe and cfg.moe_period == 1
    if not (dense or moe):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"'Modules to port': other model families)")
    if cfg.norm != "rmsnorm" or cfg.pos_embedding != "rope":
        raise NotImplementedError(
            f"norm {cfg.norm!r} / positions {cfg.pos_embedding!r} are not "
            f"ported yet (ROADMAP.md, 'Modules to port')")


def model_defs(cfg: ArchConfig) -> Dict:
    _check_supported(cfg)
    n = cfg.n_layers
    blocks = {"ln1": norm_def(cfg, n), "attn": attn_defs(cfg, n),
              "ln2": norm_def(cfg, n)}
    if cfg.is_moe:
        blocks["moe"] = moe_defs(cfg, n)
    else:
        blocks["mlp"] = ffn_defs(cfg, n)
    return {"embed": embed_defs(cfg), "final_norm": norm_def(cfg),
            "blocks": blocks}


def _take(tree: Dict[str, Any], idx: int) -> Dict[str, Any]:
    return {k: (_take(v, idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


def _mixer(cfg: ArchConfig, layer_p: Dict, z: torch.Tensor, ctx: Ctx
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward part: (output, aux loss or None)."""
    if "moe" in layer_p:
        return moe_apply(cfg, layer_p["moe"], z, ctx)
    return ffn_apply(cfg, layer_p["mlp"], z), None


# ================================================================== forward
def forward(cfg: ArchConfig, params: Dict, batch: Dict, ctx: Ctx,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits_f32, aux_loss).

    last_only=True (prefill): the LM head is applied to the final position
    only, so no (B, S, V) logits buffer ever materializes."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = ctx.constrain(embed_lookup(params["embed"], tokens),
                      "batch", None, None)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, aux = _uniform_stack(cfg, params["blocks"], x, positions, ctx)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(cfg, params["final_norm"], x)
    return logits(cfg, params["embed"], x), aux


def _uniform_stack(cfg, blocks, x, positions, ctx):
    """Returns (x, aux): aux is the MoE layers' load-balance loss summed
    over layers (zero for a dense stack)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        layer_p = _take(blocks, i)
        h = ctx.constrain(x, "batch", None, None)
        a = attention_block(cfg, layer_p["attn"],
                            apply_norm(cfg, layer_p["ln1"], h), positions,
                            causal=True, use_flash=ctx.use_flash)
        h = h + a
        m, layer_aux = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h),
                              ctx)
        if layer_aux is not None:
            aux = aux + layer_aux
        x = h + m
    return x, aux


# =============================================================== decode step
def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype: torch.dtype, device,
                      kv_dtype: Optional[str] = None) -> DecodeState:
    _check_supported(cfg)
    if kv_dtype is not None:
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r} (the int8 KV cache) is not ported yet "
            f"(ROADMAP.md, 'Modules to port')")
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _write_token(cache: torch.Tensor, new: torch.Tensor,
                 length: torch.Tensor) -> None:
    """cache[b, length[b]] = new[b] in place, for every b with
    length[b] < Smax. Rows at or past the end are dropped, as JAX drops an
    out-of-range scatter: an idle serving slot keeps counting past Smax.
    cache: (B,Smax,K,hd); new: (B,K,hd)."""
    B, Smax = cache.shape[:2]
    b_idx = torch.arange(B, device=cache.device)
    pos = length.long().clamp(max=Smax - 1)
    keep = (length < Smax)[:, None, None]
    cache[b_idx, pos] = torch.where(keep, new.to(cache.dtype),
                                    cache[b_idx, pos])


def _attn_decode(cfg, p, z, k_l, v_l, length):
    """One-token attention for one layer, writing its k/v into the cache
    views k_l, v_l (B,Smax,K,hd) in place."""
    B = z.shape[0]
    q, k, v = attn_project_qkv(cfg, p, z)
    pos = length[:, None]  # each slot's own position
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    _write_token(k_l, k[:, 0], length)
    _write_token(v_l, v[:, 0], length)
    out = decode_attention(cfg, q, k_l, v_l, length + 1)
    return out.reshape(B, 1, -1) @ p["wo"]


def decode_step(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                state: DecodeState, ctx: Ctx
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decoding step. token: (B, 1) -> (logits (B,1,V), new state).

    Every slot's ``length`` advances, idle ones included (as in the
    reference); the caches are updated in place."""
    x = ctx.constrain(embed_lookup(params["embed"], token),
                      "batch", None, None)
    for i in range(cfg.n_layers):
        layer_p = _take(params["blocks"], i)
        z = apply_norm(cfg, layer_p["ln1"], x)
        h = x + _attn_decode(cfg, layer_p["attn"], z, state.k_cache[i],
                             state.v_cache[i], state.length)
        m, _ = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h), ctx)
        x = h + m
    state = state._replace(length=state.length + 1)
    x = apply_norm(cfg, params["final_norm"], x)
    return logits(cfg, params["embed"], x), state
