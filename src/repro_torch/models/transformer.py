"""Model assembly for the dense and MoE decoder-only families and the
jamba hybrid (port of ``repro.models.transformer``).

The stack loops over layer-stacked parameters ``(L, ...)``, slicing one
layer's views per step where the reference scans. A MoE config with
``moe_period == 1`` puts ``blocks["moe"]`` in every layer where a dense
one has ``blocks["mlp"]``. The hybrid family keeps the reference's
``groups`` tree: each subtree is stacked over all groups, and layer j of
group gi reads leaf ``gi * k + j`` (k layers of that kind per group) where
the reference reshapes to ``(groups, k, ...)`` and scans. Other families
(vlm, ssm, audio) raise NotImplementedError: they are queued in ROADMAP.md
("Modules to port").

Decode runs against the state the caller builds with
``init_decode_state``: a dense cache (``DecodeState``; with
``kv_dtype="int8"`` int8 values and per-(token, head) scales, as in the
reference), or a paged pool (``PagedDecodeState``, ``kv_layout="paged"``)
whose every attention layer reads through the paged-attention kernel.
``decode_step`` dispatches on the state's type.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import (attn_defs, attn_project_qkv,
                                          attention_block, decode_attention,
                                          paged_decode_attention)
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (apply_norm, embed_defs, embed_lookup,
                                       ffn_apply, ffn_defs, logits, norm_def,
                                       rope)
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.params import torch_dtype
from repro_torch.models.ssm import (MambaState, mamba_apply,
                                    mamba_decode_step, mamba_defs,
                                    mamba_init_state)
from repro_torch.objectmodel.kvcache import (KVCacheConfig, PagedKVState,
                                             PagedWrite, global_page_tables,
                                             init_paged_state,
                                             plan_paged_write, tail_pages,
                                             write_paged, write_token)

__all__ = ["model_defs", "forward", "decode_step", "init_decode_state",
           "DecodeState", "PagedDecodeState"]


class DecodeState(NamedTuple):
    """Per-layer decode state over the dense cache, stacked along the layer
    dim.

    With the int8 KV cache (``kv_dtype="int8"``) the caches are int8 and
    ``k_scale``/``v_scale`` hold per-(token, kv head) absmax scales.
    ``decode_step`` updates the caches and the Mamba states in place (JAX
    donates them instead) and returns a state holding the same tensors."""
    k_cache: torch.Tensor  # (L_attn, B, Smax, K, hd)
    v_cache: torch.Tensor
    length: torch.Tensor  # (B,) int32
    k_scale: Optional[torch.Tensor] = None  # (L_attn, B, Smax, K) f32, int8
    v_scale: Optional[torch.Tensor] = None
    mamba: Optional[MambaState] = None  # hybrid: stacked (L_mamba, ...)


class PagedDecodeState(NamedTuple):
    """Decode state over the paged KV pool: ``kv`` holds the pool
    ``(L_attn, P, page, K, hd)``, one shard's block tables ``(1, B,
    slots)`` and the lengths; layer i's views ``kv.k_pages[i]`` reach the
    kernel without a copy. ``tail`` (B,) int32 is the global id of the
    page that takes each sequence's next token, -1 where it is dropped.
    ``decode_step`` writes there, then points ``tail`` at the page of the
    token after as far as the tables show; a caller that changes the tables
    (the serving engine, allocating pages as sequences grow) sets ``tail``
    with them."""
    kv: PagedKVState
    tail: torch.Tensor
    mamba: Optional[MambaState] = None  # hybrid: stacked (L_mamba, ...)

    @property
    def length(self) -> torch.Tensor:
        return self.kv.length


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
                      kv_dtype: Optional[str] = None,
                      kv_layout: str = "dense", page_size: int = 64,
                      num_pages: Optional[int] = None):
    """The decode state for ``batch`` sequences of up to ``max_seq`` tokens.

    ``kv_layout="dense"`` gives a ``DecodeState``; ``kv_dtype="int8"``
    makes its caches int8 with float32 scales starting at ones (a hybrid
    config ignores ``kv_dtype`` and caches in ``dtype``, as the reference
    does). ``kv_layout="paged"`` gives a ``PagedDecodeState`` over a pool
    of ``num_pages`` pages of ``page_size`` tokens (default: just enough),
    in which sequence b holds pages ``b * n`` to ``b * n + n - 1``,
    n = ceil(max_seq / page_size), so that it decodes from position 0
    with no page manager. The paged pool has no int8 form."""
    _check_supported(cfg)
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout {kv_layout!r}: 'dense' or 'paged'")
    if kv_layout == "paged" and kv_dtype is not None:
        raise ValueError(f"kv_dtype={kv_dtype!r} with the paged layout: the "
                         f"pool holds {dtype} (the reference has no int8 "
                         f"paged pool)")
    hybrid = cfg.family == "hybrid"
    kv_dt = torch_dtype(kv_dtype) if kv_dtype and not hybrid else dtype
    if kv_dt not in (dtype, torch.int8):
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: only 'int8' is ported (ROADMAP.md, "
            f"'Modules to port')")
    n_attn, mamba = cfg.n_layers, None
    if hybrid:
        g = cfg.attn_period
        n_attn = cfg.n_layers // g
        mamba = mamba_init_state(cfg, batch, dtype, device,
                                 n_attn * (g - 1))
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_layout == "paged":
        per_seq = -(-max_seq // page_size)
        kv_cfg = KVCacheConfig(
            n_layers=n_attn, n_kv_heads=K, head_dim=hd, max_seq_len=max_seq,
            page_size=page_size, num_pages=num_pages or batch * per_seq,
            dtype=str(dtype).split(".")[-1])
        if kv_cfg.num_pages < batch * per_seq:
            raise ValueError(f"{kv_cfg.num_pages} pages cannot hold {batch} "
                             f"sequences of {per_seq} pages")
        kv = init_paged_state(kv_cfg, batch, device)
        kv.block_tables[0] = torch.arange(
            batch * per_seq, dtype=torch.int32,
            device=device).view(batch, per_seq)
        return PagedDecodeState(kv, kv.block_tables[0, :, 0].clone(), mamba)
    shape = (n_attn, batch, max_seq, K, hd)

    def scales():
        return torch.ones(shape[:-1], dtype=torch.float32, device=device)

    int8 = kv_dt == torch.int8
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=kv_dt, device=device),
        v_cache=torch.zeros(shape, dtype=kv_dt, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=scales() if int8 else None,
        v_scale=scales() if int8 else None,
        mamba=mamba)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, K, hd) -> (int8 values, (B, K) f32 scales). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


class _PagedStep(NamedTuple):
    """What every attention layer of one paged decode step shares, made
    once per step: the kernel's global tables, the write plan and the
    lengths after the step."""
    tables: torch.Tensor  # (B, max_pages) int32
    write: PagedWrite
    lengths: torch.Tensor  # (B,) int32


def _paged_step(state: PagedDecodeState) -> _PagedStep:
    kv = state.kv
    tables = global_page_tables(
        kv.block_tables, kv.k_pages.shape[1] // kv.block_tables.shape[0])
    return _PagedStep(tables, plan_paged_write(state.tail, kv.length,
                                               kv.k_pages.shape[2]),
                      kv.length + 1)


def _attn_decode(cfg, p, z, state, i: int,
                 paged: Optional[_PagedStep] = None):
    """One-token attention for attention layer i, writing its k/v into the
    state's layer-i views in place: the paged pool (read through the paged
    kernel), the int8 cache (quantized on write; the whole cache is
    dequantized for the attention, as in the reference) or the dense
    cache."""
    B = z.shape[0]
    length = state.length
    q, k, v = attn_project_qkv(cfg, p, z)
    if cfg.pos_embedding == "rope":
        pos = length[:, None]  # each slot's own position
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if paged is not None:
        k_pages, v_pages = state.kv.k_pages[i], state.kv.v_pages[i]
        write_paged(k_pages, k[:, 0], paged.write)
        write_paged(v_pages, v[:, 0], paged.write)
        out = paged_decode_attention(q, k_pages, v_pages, paged.tables,
                                     paged.lengths)
    elif state.k_scale is not None:
        k_l, v_l = state.k_cache[i], state.v_cache[i]
        ks_l, vs_l = state.k_scale[i], state.v_scale[i]
        for cache, scales, new in ((k_l, ks_l, k), (v_l, vs_l, v)):
            values, scale = _quantize_kv(new[:, 0])
            write_token(cache, values, length)
            write_token(scales, scale, length)
        k_deq = (k_l.float() * ks_l[..., None]).to(z.dtype)
        v_deq = (v_l.float() * vs_l[..., None]).to(z.dtype)
        out = decode_attention(cfg, q, k_deq, v_deq, length + 1)
    else:
        k_l, v_l = state.k_cache[i], state.v_cache[i]
        write_token(k_l, k[:, 0], length)
        write_token(v_l, v[:, 0], length)
        out = decode_attention(cfg, q, k_l, v_l, length + 1)
    return out.reshape(B, 1, -1) @ p["wo"]


def decode_step(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                state, ctx: Ctx):
    """One decoding step. token: (B, 1) -> (logits (B,1,V), new state).

    ``state`` is a ``DecodeState`` or a ``PagedDecodeState``. Every slot's
    ``length`` advances, idle ones included (as in the reference); the
    caches, pool and Mamba states are updated in place."""
    paged = (_paged_step(state) if isinstance(state, PagedDecodeState)
             else None)
    x = ctx.constrain(embed_lookup(params["embed"], token),
                      "batch", None, None)
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params["groups"], x, state, ctx, paged)
    else:
        for i in range(cfg.n_layers):
            layer_p = _take(params["blocks"], i)
            z = apply_norm(cfg, layer_p["ln1"], x)
            h = x + _attn_decode(cfg, layer_p["attn"], z, state, i, paged)
            m, _ = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h),
                          ctx)
            x = h + m
    if paged is None:
        state = state._replace(length=state.length + 1)
    else:
        state = state._replace(
            kv=state.kv._replace(length=paged.lengths),
            tail=tail_pages(paged.tables, paged.lengths,
                            state.kv.k_pages.shape[2]))
    x = apply_norm(cfg, params["final_norm"], x)
    return logits(cfg, params["embed"], x), state


def _hybrid_decode(cfg: ArchConfig, groups: Dict, x: torch.Tensor, state,
                   ctx: Ctx, paged: Optional[_PagedStep]) -> torch.Tensor:
    """The hybrid stack for one token; writes each attention layer's k/v
    and each Mamba layer's new (h, conv window) into ``state`` in place."""
    for layer in _hybrid_layers(cfg):
        i = layer.mixer_idx
        if layer.mixer == "attn":
            z = apply_norm(cfg, _take(groups["attn_ln"], i), x)
            h = x + _attn_decode(cfg, _take(groups["attn"], i), z, state,
                                 i, paged)
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
