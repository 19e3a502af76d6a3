"""Model assembly for the dense and MoE decoder-only families and the
jamba hybrid (port of ``repro.models.transformer``).

The stack loops over layer-stacked parameters ``(L, ...)``, slicing one
layer's views per step where the reference scans. A MoE config with
``moe_period == 1`` puts ``blocks["moe"]`` in every layer where a dense
one has ``blocks["mlp"]``. The hybrid family keeps the reference's
``groups`` tree: each subtree is stacked over all groups, and layer j of
group gi reads leaf ``gi * k + j`` (k layers of that kind per group) where
the reference reshapes to ``(groups, k, ...)`` and scans. Other families
(vlm, ssm, audio) and the int8 KV cache raise NotImplementedError: they
are queued in ROADMAP.md ("Modules to port").
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import (attn_defs, attn_project_qkv,
                                          attention_block, decode_attention)
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (apply_norm, embed_defs, embed_lookup,
                                       ffn_apply, ffn_defs, logits, norm_def,
                                       rope)
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.ssm import (MambaState, mamba_apply,
                                    mamba_decode_step, mamba_defs,
                                    mamba_init_state)

__all__ = ["model_defs", "forward", "decode_step", "init_decode_state",
           "DecodeState"]


class DecodeState(NamedTuple):
    """Per-layer decode state, stacked along the layer dim.

    ``decode_step`` updates the caches and the Mamba states in place (JAX
    donates them instead) and returns a state holding the same tensors."""
    k_cache: torch.Tensor  # (L_attn, B, Smax, K, hd)
    v_cache: torch.Tensor
    length: torch.Tensor  # (B,) int32
    mamba: Optional[MambaState] = None  # hybrid: stacked (L_mamba, ...)


def _check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    dense = cfg.family == "dense" and not cfg.is_moe
    moe = cfg.family == "moe" and cfg.is_moe and cfg.moe_period == 1
    hybrid = cfg.family == "hybrid" and cfg.attn_period > 0
    if not (dense or moe or hybrid):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"'Modules to port': other model families)")
    if hybrid and cfg.n_layers % cfg.attn_period:
        raise ValueError(
            f"a hybrid stack runs whole groups of attn_period="
            f"{cfg.attn_period} layers; n_layers={cfg.n_layers} is not a "
            f"multiple")
    if cfg.norm != "rmsnorm" or cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"norm {cfg.norm!r} / positions {cfg.pos_embedding!r} are not "
            f"ported yet (ROADMAP.md, 'Modules to port')")


def model_defs(cfg: ArchConfig) -> Dict:
    _check_supported(cfg)
    defs: Dict[str, Any] = {"embed": embed_defs(cfg),
                            "final_norm": norm_def(cfg)}
    if cfg.family == "hybrid":
        g = cfg.attn_period  # layers per group (e.g. 8: 7 mamba + 1 attn)
        ng = cfg.n_layers // g
        n_moe = g // cfg.moe_period
        n_dense = g - n_moe
        defs["groups"] = {
            "mamba_ln": norm_def(cfg, ng * (g - 1)),
            "mamba": mamba_defs(cfg, ng * (g - 1)),
            "attn_ln": norm_def(cfg, ng),
            "attn": attn_defs(cfg, ng),
            "moe_ln": norm_def(cfg, ng * n_moe),
            "moe": moe_defs(cfg, ng * n_moe),
            "mlp_ln": norm_def(cfg, ng * n_dense),
            "mlp": ffn_defs(cfg, ng * n_dense),
        }
        return defs
    n = cfg.n_layers
    blocks = {"ln1": norm_def(cfg, n), "attn": attn_defs(cfg, n),
              "ln2": norm_def(cfg, n)}
    if cfg.is_moe:
        blocks["moe"] = moe_defs(cfg, n)
    else:
        blocks["mlp"] = ffn_defs(cfg, n)
    defs["blocks"] = blocks
    return defs


def _take(tree: Dict[str, Any], idx: int) -> Dict[str, Any]:
    return {k: (_take(v, idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


def _mixer(cfg: ArchConfig, layer_p: Dict, z: torch.Tensor, ctx: Ctx
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward part: (output, aux loss or None)."""
    if "moe" in layer_p:
        return moe_apply(cfg, layer_p["moe"], z, ctx)
    return ffn_apply(cfg, layer_p["mlp"], z), None


class _HybridLayer(NamedTuple):
    """One layer of the hybrid stack: its token mixer ("attn" or "mamba")
    and channel mixer ("moe" or "mlp"), each with the index of its leaf in
    the ``groups`` subtree. The attention index is also the layer's KV
    cache index, the mamba index its decode state's."""
    mixer: str
    mixer_idx: int
    channel: str
    channel_idx: int


def _hybrid_layers(cfg: ArchConfig) -> List[_HybridLayer]:
    """The reference's group body, unrolled over the groups: in each group
    of attn_period layers the last is attention and the rest Mamba; every
    moe_period-th layer's channel mixer is MoE, the others a dense FFN."""
    g, mp = cfg.attn_period, cfg.moe_period
    n_moe = g // mp
    out = []
    for gi in range(cfg.n_layers // g):
        for i in range(g):
            mixer = ("attn", gi) if i == g - 1 else ("mamba",
                                                    gi * (g - 1) + i)
            if i % mp == mp - 1:
                channel = ("moe", gi * n_moe + i // mp)
            else:
                channel = ("mlp", gi * (g - n_moe) + i - i // mp)
            out.append(_HybridLayer(*mixer, *channel))
    return out


def _channel(cfg: ArchConfig, groups: Dict, layer: _HybridLayer,
             h: torch.Tensor, ctx: Ctx
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A hybrid layer's channel mixer on the residual h: (output, aux loss
    or None)."""
    i = layer.channel_idx
    z = apply_norm(cfg, _take(groups[layer.channel + "_ln"], i), h)
    return _mixer(cfg, {layer.channel: _take(groups[layer.channel], i)}, z,
                  ctx)


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
    if cfg.family == "hybrid":
        x, aux = _jamba_stack(cfg, params["groups"], x, positions, ctx)
    else:
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


def _jamba_stack(cfg, groups, x, positions, ctx):
    """Returns (x, aux): aux is the MoE layers' load-balance loss summed
    over layers."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _hybrid_layers(cfg):
        h = ctx.constrain(x, "batch", None, None)
        i = layer.mixer_idx
        if layer.mixer == "attn":
            z = apply_norm(cfg, _take(groups["attn_ln"], i), h)
            h = h + attention_block(cfg, _take(groups["attn"], i), z,
                                    positions, causal=True,
                                    use_flash=ctx.use_flash)
        else:
            z = apply_norm(cfg, _take(groups["mamba_ln"], i), h)
            h = h + mamba_apply(cfg, _take(groups["mamba"], i), z, ctx)
        m, layer_aux = _channel(cfg, groups, layer, h, ctx)
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
    n_attn, mamba = cfg.n_layers, None
    if cfg.family == "hybrid":
        g = cfg.attn_period
        n_attn = cfg.n_layers // g
        mamba = mamba_init_state(cfg, batch, dtype, device,
                                 n_attn * (g - 1))
    shape = (n_attn, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        mamba=mamba)


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
    if cfg.pos_embedding == "rope":
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
    reference); the caches and Mamba states are updated in place."""
    x = ctx.constrain(embed_lookup(params["embed"], token),
                      "batch", None, None)
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params["groups"], x, state, ctx)
    else:
        for i in range(cfg.n_layers):
            layer_p = _take(params["blocks"], i)
            z = apply_norm(cfg, layer_p["ln1"], x)
            h = x + _attn_decode(cfg, layer_p["attn"], z, state.k_cache[i],
                                 state.v_cache[i], state.length)
            m, _ = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h),
                          ctx)
            x = h + m
    state = state._replace(length=state.length + 1)
    x = apply_norm(cfg, params["final_norm"], x)
    return logits(cfg, params["embed"], x), state


def _hybrid_decode(cfg: ArchConfig, groups: Dict, x: torch.Tensor,
                   state: DecodeState, ctx: Ctx) -> torch.Tensor:
    """The hybrid stack for one token; writes each attention layer's k/v
    and each Mamba layer's new (h, conv window) into ``state`` in place."""
    for layer in _hybrid_layers(cfg):
        i = layer.mixer_idx
        if layer.mixer == "attn":
            z = apply_norm(cfg, _take(groups["attn_ln"], i), x)
            h = x + _attn_decode(cfg, _take(groups["attn"], i), z,
                                 state.k_cache[i], state.v_cache[i],
                                 state.length)
        else:
            z = apply_norm(cfg, _take(groups["mamba_ln"], i), x)
            mine = MambaState(h=state.mamba.h[i], conv=state.mamba.conv[i])
            y, new = mamba_decode_step(cfg, _take(groups["mamba"], i), z,
                                       mine)
            mine.h.copy_(new.h)
            mine.conv.copy_(new.conv)
            h = x + y
        m, _ = _channel(cfg, groups, layer, h, ctx)
        x = h + m
    return x
