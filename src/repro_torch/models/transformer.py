"""Model assembly for every family of the reference (port of
``repro.models.transformer``): the decoder-only stacks (dense, MoE and
vlm), the jamba hybrid, the xLSTM stack (ssm) and the whisper
encoder-decoder (audio).

The stacks loop over layer-stacked parameters ``(L, ...)``, slicing one
layer's views per step where the reference scans. A MoE config with
``moe_period == 1`` puts ``blocks["moe"]`` in every layer where a dense
one has ``blocks["mlp"]``; a vlm config replaces the first ``n_patches``
positions with the batch's patch embeddings. The heterogeneous stacks
(hybrid, ssm) keep the reference's ``groups`` tree: each subtree is
stacked over all groups, and layer j of group gi reads leaf ``gi * k +
j`` (k layers of that kind per group) where the reference reshapes to
``(groups, k, ...)`` and scans. Whisper keeps ``encoder`` and
``decoder`` stacks; its encoder runs the plain attention path, as the
reference's does, and its decoder's self-attention goes through flash
under ``Ctx(use_flash=True)``.

Decode runs against the state the caller builds with
``init_decode_state``: a dense cache (``DecodeState``; with
``kv_dtype="int8"`` int8 values and per-(token, head) scales, with another
float ``kv_dtype`` a cache of that type, as in the reference), the
xLSTM stack's recurrent states (``DecodeState.mlstm`` / ``slstm``), or a
paged pool (``PagedDecodeState``, ``kv_layout="paged"``; the dense, MoE,
vlm and hybrid families) whose every attention layer reads through the
paged-attention kernel. ``decode_step`` dispatches on the state's type.

Over a mesh (``Ctx(plan=, mesh=)`` with a model axis of tp > 1) a rank
runs the uniform stacks (dense, MoE, vlm) and the hybrid stack on the
slices of every leaf that ``Model.param_specs`` places: the embedding's
vocab rows, its heads, its ff columns and rows, its experts under expert
parallelism, Mamba's ``inner`` channels (``models.ssm``), the head's
vocab columns; norms, positions and the router whole. The residual stream
is whole on every rank: each split product ends in one all-reduce over the
model axis (the embedding, each layer's attention, Mamba block and
feed-forward), and the logits in one all-gather along the vocab, so every
rank holds the same logits. A rank's decode state is laid out as
``Model.decode_state_specs`` places it: under the "heads" kv strategy its
K/tp kv heads over every position; under "sequence" (``Ctx.kv_seq``) its
span of the positions for every kv head, or its shard of the paged pool
(its sub-pool, its table row and the sequence page each entry holds),
decoded by ``_attn_decode_seq``; and its channels of each Mamba layer's
``h``, the conv windows whole. The ssm and audio families and the
MoE "tp" strategy raise NotImplementedError on such a mesh
(``check_split``); on a mesh of data shards alone (tp 1) every family runs
on its shard of the batch.

Under FSDP (``Ctx.fsdp`` > 1: the plan places a dim of the larger leaves
on the data axis too) a rank holds only its block of that dim. Each leaf is
all-gathered over the data axis where the model reads it
(``collectives.gather_data``): a layer's leaves where the layer takes
them (``_take``), the embedding's, the head's, the positions' and the
final norm's where ``forward``, the encoder and ``decode_step`` read
them (a table tied to the head once a forward, for both reads). The
gathered leaf is the one the model axis alone splits, so the
layers run as above; the gather's backward reduce-scatters the leaf's
gradient.

Training rematerializes each layer as the reference's ``_maybe_remat``
does (``cfg.remat``, :func:`_remat`): under "full" a layer body keeps
only its inputs for the backward and runs again there, its gathers too,
so that nothing gathered outlives its layer; "dots" keeps the outputs of
the products without batch dims as well. Without grad (serving) the
layers run as they are.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import (attn_defs, attn_output,
                                          attn_project_qkv,
                                          attention_block, combine_spans,
                                          cross_attention_block,
                                          decode_attention, decode_partial,
                                          head_block,
                                          paged_decode_attention)
from repro_torch.models.context import Ctx
from repro_torch.models.layers import (apply_norm, embed_defs, embed_lookup,
                                       ffn_apply, ffn_defs, logits,
                                       norm_def, position_lookup, rope)
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.params import torch_dtype
from repro_torch.models.ssm import (MambaState, mamba_apply,
                                    mamba_decode_step, mamba_defs,
                                    mamba_init_state)
from repro_torch.objectmodel.kvcache import (KVCacheConfig, PagedKVState,
                                             PagedWrite, global_page_tables,
                                             init_paged_state,
                                             plan_paged_write, shard_lengths,
                                             shard_tail, tail_pages,
                                             write_paged, write_token)

__all__ = ["model_defs", "forward", "decode_step", "init_decode_state",
           "encode_whisper", "check_split", "DecodeState", "PagedDecodeState"]

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


class DecodeState(NamedTuple):
    """Per-layer decode state over the dense cache, stacked along the layer
    (or group) dim; the fields a family does not use are None.

    With the int8 KV cache (``kv_dtype="int8"``) the caches are int8 and
    ``k_scale``/``v_scale`` hold per-(token, kv head) absmax scales.
    ``decode_step`` updates the caches and the recurrent states in place
    (JAX donates them instead) and returns a state holding the same
    tensors.

    Split over the sequence (a rank's span of Smax' = Smax rounded up to a
    multiple of the spans), the caches are (L_attn, B, Smax' / spans, K,
    hd) and ``seq_limit`` holds Smax: positions at or past it are never
    written nor read."""
    k_cache: Optional[torch.Tensor] = None  # (L_attn, B, Smax, K, hd)
    v_cache: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None  # (B,) int32
    k_scale: Optional[torch.Tensor] = None  # (L_attn, B, Smax, K) f32, int8
    v_scale: Optional[torch.Tensor] = None
    mamba: Optional[MambaState] = None  # hybrid: stacked (L_mamba, ...)
    mlstm: Optional[xl.MLSTMState] = None  # ssm: stacked (L_mlstm, ...)
    slstm: Optional[xl.SLSTMState] = None  # ssm: stacked (L_slstm, ...)
    enc_out: Optional[torch.Tensor] = None  # audio: (B, encoder_len, d)
    seq_limit: Optional[torch.Tensor] = None  # () int32, split over the seq


class PagedDecodeState(NamedTuple):
    """Decode state over the paged KV pool: ``kv`` holds the pool
    ``(L_attn, P, page, K, hd)``, one shard's block tables ``(1, B,
    slots)`` and the lengths; layer i's views ``kv.k_pages[i]`` reach the
    kernel without a copy. ``tail`` (B,) int32 is the global id of the
    page that takes each sequence's next token, -1 where it is dropped.
    ``decode_step`` writes there, then points ``tail`` at the page of the
    token after as far as the tables show; a caller that changes the tables
    (the serving engine, allocating pages as sequences grow) sets ``tail``
    with them.

    A rank's shard of a pool split over the sequence holds its sub-pool
    ``(L_attn, P / shards, page, K, hd)``, its own table row ``(1, B,
    slots)`` and ``seq_pages`` (B, slots) int32, the sequence page each
    entry holds (-1 none). It writes a token where ``tail``'s global id
    names its shard (``id // (P / shards)``), and after a step points
    ``tail`` at its own page of the next token, or -1."""
    kv: PagedKVState
    tail: torch.Tensor
    mamba: Optional[MambaState] = None  # hybrid: stacked (L_mamba, ...)
    seq_pages: Optional[torch.Tensor] = None  # (B, slots), split over seq

    @property
    def length(self) -> torch.Tensor:
        return self.kv.length


def _check_supported(cfg: ArchConfig) -> None:
    """Raise for a config whose stack cannot be assembled."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r}: one of {FAMILIES}")
    if cfg.family == "hybrid" and (cfg.attn_period <= 0
                                   or cfg.n_layers % cfg.attn_period):
        raise ValueError(
            f"a hybrid stack runs whole groups of attn_period="
            f"{cfg.attn_period} layers; n_layers={cfg.n_layers} is not a "
            f"multiple")
    if cfg.family == "ssm" and cfg.n_layers % _xlstm_period(cfg):
        raise ValueError(
            f"an xLSTM stack runs whole groups of slstm_period="
            f"{cfg.slstm_period} blocks; n_layers={cfg.n_layers} is not a "
            f"multiple")


# Where the split over the model axis is not ported, the ROADMAP item
# (queue 1) that takes it up
_SPLIT_ITEMS = {"ssm": 15, "audio": 16}


def check_split(cfg: ArchConfig, ctx: Ctx) -> None:
    """Raise NotImplementedError for what a rank of a mesh cannot run: on
    a model axis of tp > 1 the ssm and audio families and the MoE "tp"
    strategy (experts that do not divide the model axis). The hybrid
    family runs there: Mamba's ``inner`` over the model axis
    (``models.ssm``), its attention and MoE layers as the uniform
    stack's."""
    if ctx.tp == 1:
        return
    if cfg.family in _SPLIT_ITEMS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family split over the model axis "
            f"(tp {ctx.tp}) is not ported (ROADMAP.md, queue 1, item "
            f"{_SPLIT_ITEMS[cfg.family]})")
    if cfg.is_moe and ctx.plan.moe_strategy == "tp":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_experts} experts do not divide the model "
            f"axis ({ctx.tp}); tensor parallelism within the experts (the "
            f"\"tp\" MoE strategy) is not ported (ROADMAP.md, queue 1, item "
            f"17)")


def _xlstm_period(cfg: ArchConfig) -> int:
    """Blocks per xLSTM group: slstm_period - 1 mLSTM, then one sLSTM."""
    return cfg.slstm_period or cfg.n_layers


def model_defs(cfg: ArchConfig) -> Dict:
    _check_supported(cfg)
    defs: Dict[str, Any] = {"embed": embed_defs(cfg),
                            "final_norm": norm_def(cfg)}
    fam = cfg.family
    if fam == "hybrid":
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
    elif fam == "ssm":  # xlstm
        g = _xlstm_period(cfg)
        ng = cfg.n_layers // g
        defs["groups"] = {
            "mlstm_ln": norm_def(cfg, ng * (g - 1)),
            "mlstm": xl.mlstm_defs(cfg, ng * (g - 1)),
            "slstm_ln": norm_def(cfg, ng),
            "slstm": xl.slstm_defs(cfg, ng),
        }
    elif fam == "audio":  # whisper encoder-decoder
        ne, nd = cfg.encoder_layers, cfg.n_layers
        defs["encoder"] = {"ln1": norm_def(cfg, ne), "attn": attn_defs(cfg, ne),
                           "ln2": norm_def(cfg, ne), "mlp": ffn_defs(cfg, ne)}
        defs["enc_final_norm"] = norm_def(cfg)
        defs["decoder"] = {"ln1": norm_def(cfg, nd), "attn": attn_defs(cfg, nd),
                           "lnx": norm_def(cfg, nd),
                           "xattn": attn_defs(cfg, nd),
                           "ln2": norm_def(cfg, nd), "mlp": ffn_defs(cfg, nd)}
    else:  # dense, moe, vlm: one uniform stack
        n = cfg.n_layers
        blocks = {"ln1": norm_def(cfg, n), "attn": attn_defs(cfg, n),
                  "ln2": norm_def(cfg, n)}
        if cfg.is_moe and cfg.moe_period == 1:
            blocks["moe"] = moe_defs(cfg, n)
        else:
            blocks["mlp"] = ffn_defs(cfg, n)
        defs["blocks"] = blocks
    return defs


def _dims(ctx: Optional[Ctx], *path: str) -> Optional[Dict]:
    """The data-split dims (``Ctx.data_dims``) of the parameters' subtree
    at ``path`` under FSDP; None without FSDP."""
    if ctx is None or ctx.fsdp == 1:
        return None
    dims = ctx.data_dims
    for key in path:
        dims = dims[key]
    return dims


def _take(tree: Dict[str, Any], idx: Optional[int],
          dims: Optional[Dict] = None, ctx: Optional[Ctx] = None
          ) -> Dict[str, Any]:
    """Layer ``idx``'s views of a layer-stacked subtree (``idx`` None: a
    subtree not stacked, as it is). With ``dims`` (:func:`_dims`) each
    leaf split over the data axis is all-gathered along its dim (FSDP)."""
    out = {}
    for k, v in tree.items():
        d = None if dims is None else dims[k]
        if isinstance(v, dict):
            out[k] = _take(v, idx, d, ctx)
            continue
        if idx is not None:
            v, d = v[idx], None if d is None else d - 1
        out[k] = v if d is None else coll.gather_data(
            v, d, ctx.data_group, summed=ctx.dp > 1)
    return out


def _part(params: Dict, ctx: Ctx, key: str, *names: str) -> Dict:
    """The leaves ``names`` of the parameters' (unstacked) subtree
    ``key``, each gathered whole over the data axis under FSDP: the
    embedding's where a function reads them, never all at once."""
    dims = _dims(ctx, key)
    return _take({n: params[key][n] for n in names}, None,
                 None if dims is None else {n: dims[n] for n in names}, ctx)


def _tied(cfg: ArchConfig, table: Dict) -> Optional[Dict]:
    """The table as the lookup read it (under FSDP gathered once a
    forward) where the head is tied to it; else None, so that a gathered
    table is freed after the lookup."""
    return table if cfg.tie_embeddings else None


def _head(params: Dict, ctx: Ctx, tied: Optional[Dict]) -> Dict:
    """What ``layers.logits`` reads of the embedding: the tied table, or
    the head."""
    return tied if tied is not None else _part(params, ctx, "embed", "head")


# the products without batch dims, whose outputs "dots" keeps (the
# reference's checkpoint_dots_with_no_batch_dims)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(cfg: ArchConfig, fn):
    """``fn``, a layer body, under ``cfg.remat`` where autograd records
    (the reference's ``_maybe_remat``): "full" keeps only its inputs for
    the backward and runs it again there; "dots" also keeps the outputs
    of ``aten.mm`` / ``aten.addmm``; anything else, or no grad, runs it as
    it is. The model draws no random numbers, so no RNG state is kept."""
    if cfg.remat not in ("full", "dots") or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _mixer(cfg: ArchConfig, layer_p: Dict, z: torch.Tensor, ctx: Ctx
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward part: (output, aux loss or None)."""
    if "moe" in layer_p:
        return moe_apply(cfg, layer_p["moe"], z, ctx)
    return ffn_apply(cfg, layer_p["mlp"], z, ctx), None


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
    i, kind = layer.channel_idx, layer.channel
    dims = _dims(ctx, "groups") or {}
    z = apply_norm(cfg, _take(groups[kind + "_ln"], i,
                              dims.get(kind + "_ln"), ctx), h)
    return _mixer(cfg, {kind: _take(groups[kind], i, dims.get(kind), ctx)},
                  z, ctx)


# ================================================================== forward
def forward(cfg: ArchConfig, params: Dict, batch: Dict, ctx: Ctx,
            last_only: bool = False, gather_logits: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits_f32, aux_loss).

    ``batch`` holds ``tokens`` (B, S); a vlm config may add ``patches``
    (B, n_patches, d), which replace the first n_patches positions; an
    audio config needs ``frames`` (B, encoder_len, d).
    last_only=True (prefill): the LM head is applied to the final position
    only, so no (B, S, V) logits buffer ever materializes. With the vocab
    split over the model axis, ``gather_logits=False`` returns the rank's
    columns (a loss over the split vocab) instead of all of them."""
    check_split(cfg, ctx)
    if cfg.family == "audio":
        return _whisper_forward(cfg, params, batch, ctx, last_only)
    tokens = batch["tokens"]
    B, S = tokens.shape
    table = _part(params, ctx, "embed", "tokens")
    x = embed_lookup(cfg, table, tokens, ctx)
    table = _tied(cfg, table)
    if cfg.family == "vlm" and "patches" in batch:
        P = cfg.n_patches
        patches = batch["patches"] + _part(params, ctx, "embed",
                                           "patch_pos")["patch_pos"]
        x = torch.cat([patches.to(x.dtype), x[:, P:]], dim=1)
    if cfg.pos_embedding == "learned":
        x = x + _part(params, ctx, "embed", "positions")["positions"][:S]
    x = ctx.constrain(x, "batch", None, None)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.family == "hybrid":
        x, aux = _jamba_stack(cfg, params["groups"], x, positions, ctx)
    elif cfg.family == "ssm":
        x, aux = _xlstm_stack(cfg, params["groups"], x, ctx)
    else:
        x, aux = _uniform_stack(cfg, params["blocks"], x, positions, ctx)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(cfg, _take(params["final_norm"], None,
                              _dims(ctx, "final_norm"), ctx), x)
    return logits(cfg, _head(params, ctx, table), x, ctx, gather_logits), aux


def _uniform_stack(cfg, blocks, x, positions, ctx):
    """Returns (x, aux): aux is the MoE layers' load-balance loss summed
    over layers (zero for a dense stack)."""
    dims = _dims(ctx, "blocks")

    def layer(i, x):
        layer_p = _take(blocks, i, dims, ctx)
        h = ctx.constrain(x, "batch", None, None)
        a = attention_block(cfg, layer_p["attn"],
                            apply_norm(cfg, layer_p["ln1"], h), positions,
                            causal=True, use_flash=ctx.use_flash, ctx=ctx)
        h = h + a
        m, layer_aux = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h),
                              ctx)
        return h + m, layer_aux

    body = _remat(cfg, layer)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, layer_aux = body(i, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def _jamba_stack(cfg, groups, x, positions, ctx):
    """Returns (x, aux): aux is the MoE layers' load-balance loss summed
    over layers."""
    dims = _dims(ctx, "groups") or {}

    def body(layer, x):
        h = ctx.constrain(x, "batch", None, None)
        i, kind = layer.mixer_idx, layer.mixer
        z = apply_norm(cfg, _take(groups[kind + "_ln"], i,
                                  dims.get(kind + "_ln"), ctx), h)
        p = _take(groups[kind], i, dims.get(kind), ctx)
        if kind == "attn":
            h = h + attention_block(cfg, p, z, positions, causal=True,
                                    use_flash=ctx.use_flash, ctx=ctx)
        else:
            h = h + mamba_apply(cfg, p, z, ctx)
        m, layer_aux = _channel(cfg, groups, layer, h, ctx)
        return h + m, layer_aux

    body = _remat(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _hybrid_layers(cfg):
        x, layer_aux = body(layer, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def _xlstm_layers(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """The reference's group body, unrolled over the groups: in each group
    of slstm_period blocks, slstm_period - 1 mLSTM blocks then one sLSTM;
    each as (kind, index of its leaf in the ``groups`` subtree), which is
    also the index of its decode state."""
    g = _xlstm_period(cfg)
    out = []
    for gi in range(cfg.n_layers // g):
        out += [("mlstm", gi * (g - 1) + i) for i in range(g - 1)]
        out.append(("slstm", gi))
    return out


def _xlstm_stack(cfg, groups, x, ctx):
    """Returns (x, aux): no block has an aux loss (zero)."""
    dims = _dims(ctx, "groups") or {}

    def body(kind, i, x):
        z = apply_norm(cfg, _take(groups[kind + "_ln"], i,
                                  dims.get(kind + "_ln"), ctx), x)
        block = xl.mlstm_apply if kind == "mlstm" else xl.slstm_apply
        return x + block(cfg, _take(groups[kind], i, dims.get(kind), ctx), z,
                         ctx)

    body = _remat(cfg, body)
    for kind, i in _xlstm_layers(cfg):
        x = body(kind, i, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ whisper
def encode_whisper(cfg: ArchConfig, params: Dict, frames: torch.Tensor,
                   ctx: Ctx) -> torch.Tensor:
    """frames: (B, encoder_len, d) stub embeddings -> the encoder output.
    Self-attention through the plain path (not causal), as the
    reference's encoder runs it whatever ``ctx.use_flash`` says."""
    x = frames + _part(params, ctx, "embed", "enc_positions")[
        "enc_positions"][:frames.shape[1]]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    dims = _dims(ctx, "encoder")

    def layer(i, x):
        layer_p = _take(params["encoder"], i, dims, ctx)
        x = x + attention_block(cfg, layer_p["attn"],
                                apply_norm(cfg, layer_p["ln1"], x), positions,
                                causal=False, use_flash=False)
        return x + ffn_apply(cfg, layer_p["mlp"],
                             apply_norm(cfg, layer_p["ln2"], x))

    body = _remat(cfg, layer)
    for i in range(cfg.encoder_layers):
        x = body(i, x)
    return apply_norm(cfg, _take(params["enc_final_norm"], None,
                                 _dims(ctx, "enc_final_norm"), ctx), x)


def _whisper_forward(cfg, params, batch, ctx, last_only: bool = False):
    enc = encode_whisper(cfg, params, batch["frames"], ctx)
    tokens = batch["tokens"]
    B, S = tokens.shape
    table = _part(params, ctx, "embed", "tokens")
    x = (embed_lookup(cfg, table, tokens)
         + _part(params, ctx, "embed", "positions")["positions"][:S])
    table = _tied(cfg, table)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    dims = _dims(ctx, "decoder")

    def layer(i, x, enc):
        layer_p = _take(params["decoder"], i, dims, ctx)
        x = x + attention_block(cfg, layer_p["attn"],
                                apply_norm(cfg, layer_p["ln1"], x), positions,
                                causal=True, use_flash=ctx.use_flash)
        x = x + cross_attention_block(cfg, layer_p["xattn"],
                                      apply_norm(cfg, layer_p["lnx"], x), enc)
        return x + ffn_apply(cfg, layer_p["mlp"],
                             apply_norm(cfg, layer_p["ln2"], x))

    body = _remat(cfg, layer)
    for i in range(cfg.n_layers):
        x = body(i, x, enc)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(cfg, _take(params["final_norm"], None,
                              _dims(ctx, "final_norm"), ctx), x)
    return (logits(cfg, _head(params, ctx, table), x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# =============================================================== decode step
def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype: torch.dtype, device,
                      kv_dtype: Optional[str] = None,
                      kv_layout: str = "dense", page_size: int = 64,
                      num_pages: Optional[int] = None,
                      kv_heads: Optional[int] = None,
                      inner: Optional[int] = None,
                      seq_span: Optional[Tuple[int, int]] = None):
    """The decode state for ``batch`` sequences of up to ``max_seq`` tokens,
    its caches holding ``kv_heads`` kv heads (default the config's; a
    rank of a mesh under the "heads" strategy, its K/tp) and a hybrid
    config's Mamba ``h`` states ``inner`` channels (default all; a rank,
    its own), the conv windows whole. ``seq_span`` (index, count) gives a
    rank's share of a cache split over the sequence (``Ctx.seq_span``):
    its span of the positions (``DecodeState.seq_limit``), or its shard of
    the pool (``PagedDecodeState.seq_pages``), laid out as the round-robin
    placement of the pages that the single process's pool holds.

    ``kv_layout="dense"`` gives a ``DecodeState``. Its caches are in
    ``kv_dtype`` where given, else ``dtype``: ``"int8"`` with float32
    scales starting at ones, or a float type no wider than ``dtype`` (a
    bf16 cache under float32 parameters). As in the reference, a hybrid
    config ignores ``kv_dtype``; an ssm config has no cache, only the
    xLSTM states (zeros); an audio config carries ``enc_out``, zeros, for
    the caller to set from ``encode_whisper``. Two ``kv_dtype`` that the
    reference accepts here and then fails to decode raise ValueError: a
    float type wider than ``dtype`` (JAX promotes the residual stream to
    it, and the reference's layer scan refuses a carry that changes type)
    and ``"int8"`` on audio (its decode step passes no scales).

    ``kv_layout="paged"`` gives a ``PagedDecodeState`` over a pool of
    ``num_pages`` pages of ``page_size`` tokens (default: just enough), in
    which sequence b holds pages ``b * n`` to ``b * n + n - 1``, n =
    ceil(max_seq / page_size), so that it decodes from position 0 with no
    page manager; split over the sequence, shard s holds page j * count +
    s of each sequence at its entry j. The paged pool holds ``dtype`` (no
    other ``kv_dtype``), and the audio and ssm families have none
    (ValueError)."""
    _check_supported(cfg)
    fam = cfg.family
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout {kv_layout!r}: 'dense' or 'paged'")
    if kv_layout == "paged" and fam in ("audio", "ssm"):
        raise ValueError(
            f"kv_layout='paged' for the {fam} family: the reference decodes "
            f"it over the dense layout only (ROADMAP.md, queue 3)")
    if kv_layout == "paged" and kv_dtype is not None:
        raise ValueError(f"kv_dtype={kv_dtype!r} with the paged layout: the "
                         f"pool holds {dtype} (the reference has no int8 "
                         f"paged pool)")
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if fam == "ssm":
        g = _xlstm_period(cfg)
        ng = cfg.n_layers // g
        return DecodeState(
            length=length,
            mlstm=xl.mlstm_init_state(cfg, batch, dtype, device,
                                      ng * (g - 1)),
            slstm=xl.slstm_init_state(cfg, batch, device, ng))
    hybrid = fam == "hybrid"
    kv_dt = torch_dtype(kv_dtype) if kv_dtype and not hybrid else dtype
    if kv_dt != torch.int8 and (not kv_dt.is_floating_point
                                or torch.promote_types(kv_dt, dtype) != dtype):
        raise ValueError(
            f"kv_dtype={kv_dtype!r} under {dtype} parameters: 'int8' or a "
            f"float type no wider (the reference's decode fails on a wider "
            f"cache: its layer scan refuses the promoted residual stream; "
            f"ROADMAP.md, queue 3)")
    if fam == "audio" and kv_dt == torch.int8:
        raise ValueError(
            "kv_dtype='int8' for the audio family: the reference's audio "
            "decode step passes no scales to its int8 cache and fails "
            "(ROADMAP.md, queue 3)")
    n_attn, mamba = cfg.n_layers, None
    if hybrid:
        g = cfg.attn_period
        n_attn = cfg.n_layers // g
        mamba = mamba_init_state(cfg, batch, dtype, device,
                                 n_attn * (g - 1), inner)
    K, hd = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    index, count = seq_span or (0, 1)
    if kv_layout == "paged":
        per_seq = -(-max_seq // page_size)
        slots = -(-per_seq // count)  # a shard's entries a sequence
        kv_cfg = KVCacheConfig(
            n_layers=n_attn, n_kv_heads=K, head_dim=hd, max_seq_len=max_seq,
            page_size=page_size,
            num_pages=num_pages or batch * slots * count,
            num_shards=count, dtype=str(dtype).split(".")[-1])
        if kv_cfg.pages_per_shard < batch * slots:
            raise ValueError(f"{kv_cfg.num_pages} pages over {count} shards "
                             f"cannot hold {batch} sequences of {per_seq} "
                             f"pages")
        kv = init_paged_state(dataclasses.replace(
            kv_cfg, num_pages=kv_cfg.pages_per_shard, num_shards=1),
            batch, device)
        j = torch.arange(slots, dtype=torch.int32, device=device)
        page = (j * count + index).expand(batch, slots)
        held = page < per_seq
        local = torch.arange(batch * slots, dtype=torch.int32,
                             device=device).view(1, batch, slots)
        kv = kv._replace(block_tables=torch.where(held, local, -1))
        tail = local[0, :, 0].clone()  # page 0 is shard 0's
        return PagedDecodeState(
            kv, tail, mamba,
            torch.where(held, page, -1) if seq_span else None)
    shape = (n_attn, batch, -(-max_seq // count), K, hd)

    def scales():
        return torch.ones(shape[:-1], dtype=torch.float32, device=device)

    int8 = kv_dt == torch.int8
    enc = (torch.zeros((batch, cfg.encoder_len, cfg.d_model), dtype=dtype,
                       device=device) if fam == "audio" else None)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=kv_dt, device=device),
        v_cache=torch.zeros(shape, dtype=kv_dt, device=device),
        length=length,
        k_scale=scales() if int8 else None,
        v_scale=scales() if int8 else None,
        mamba=mamba, enc_out=enc,
        seq_limit=(torch.tensor(max_seq, dtype=torch.int32, device=device)
                   if seq_span else None))


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, K, hd) -> (int8 values, (B, K) f32 scales). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


class _PagedStep(NamedTuple):
    """What every attention layer of one paged decode step shares, made
    once per step: the kernel's tables (global ids; a shard's, local
    ones), the write plan, the lengths after the step and the valid
    positions of each row of the tables (the lengths, or a shard's
    ``shard_lengths``)."""
    tables: torch.Tensor  # (B, max_pages) int32
    write: PagedWrite
    lengths: torch.Tensor  # (B,) int32
    held: torch.Tensor  # (B,) int32


def _check_layout(state, ctx: Optional[Ctx]) -> None:
    """A state split over the sequence under a context that splits it,
    and the other way round (ValueError otherwise)."""
    split = getattr(state, "seq_limit", None) is not None or \
        getattr(state, "seq_pages", None) is not None
    if split != bool(ctx is not None and ctx.kv_seq):
        raise ValueError(
            "the decode state's layout does not match the context: under "
            "the plan's \"sequence\" kv strategy on a model axis build it "
            "with Model.init_decode_state(..., ctx=ctx), and only there")


def _paged_step(state: PagedDecodeState, ctx: Optional[Ctx]) -> _PagedStep:
    kv = state.kv
    page = kv.k_pages.shape[2]
    lengths = kv.length + 1
    if state.seq_pages is None:
        tables = global_page_tables(
            kv.block_tables, kv.k_pages.shape[1] // kv.block_tables.shape[0])
        return _PagedStep(tables, plan_paged_write(state.tail, kv.length,
                                                   page), lengths, lengths)
    # a shard: its own table row, its pages' valid positions; it writes
    # where the tail page is its own (the global id names the shard)
    tables, first = kv.block_tables[0], ctx.seq_span[0] * kv.k_pages.shape[1]
    mine = (state.tail >= first) & (state.tail < first + kv.k_pages.shape[1])
    local = torch.where(mine, state.tail - first, -1)
    return _PagedStep(tables, plan_paged_write(local, kv.length, page),
                      lengths, shard_lengths(tables, state.seq_pages,
                                             lengths, page))


def _attn_decode(cfg, p, z, state, i: int,
                 paged: Optional[_PagedStep] = None,
                 ctx: Optional[Ctx] = None):
    """One-token attention for attention layer i, writing its k/v into the
    state's layer-i views in place: the paged pool (read through the paged
    kernel), the int8 cache (quantized on write; the whole cache is
    dequantized for the attention, as in the reference) or the dense
    cache; over the heads that ``p`` gives this rank. Under the "sequence"
    kv strategy on a model axis, ``_attn_decode_seq``."""
    if ctx is not None and ctx.kv_seq:
        return _attn_decode_seq(cfg, p, z, state, i, paged, ctx)
    if p["wq"].shape[-1] % cfg.resolved_head_dim:
        raise ValueError(
            f"{cfg.name}: a q_dim block of {p['wq'].shape[-1]} splits a head; "
            f"it decodes over the sequence-sharded cache only (the plan's "
            f"\"sequence\" kv strategy: Ctx.kv_seq)")
    B = z.shape[0]
    length = state.length
    q, k, v = attn_project_qkv(cfg, p, z, ctx=ctx)
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
    # a cache narrower than the parameters (bf16 under float32) gives an
    # output in its type, which JAX promotes for the product
    return attn_output(cfg, p, out.reshape(B, 1, -1).to(p["wo"].dtype), ctx)


def _attn_decode_seq(cfg, p, z, state, i: int,
                     paged: Optional[_PagedStep], ctx: Ctx):
    """``_attn_decode`` on a rank of a cache split over the sequence: q of
    the rank's block of q_dim columns (``wq`` split, perhaps inside a
    head), k and v of all K heads (``wk`` and ``wv`` whole), written by
    the rank whose span (or shard) holds the position; the q columns
    all-gathered over the model axis (every head, then rotated), every
    head's partial over the rank's span (the paged kernel's partial mode
    on its pages, or ``decode_partial`` on its dense or dequantized int8
    span), the partials of the heads the rank's block overlaps merged over
    the spans (``combine_spans``), its columns of them times its rows of
    ``wo`` (``attn_output``)."""
    B = z.shape[0]
    hd = cfg.resolved_head_dim
    W = p["wq"].shape[-1]
    blocks = [head_block(cfg, W, r) for r in range(ctx.tp)]
    q, k, v = z @ p["wq"], z @ p["wk"], z @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = coll.all_gather(q[:, 0], ctx.tp_group, dim=1)  # every column
    q = q.reshape(B, 1, -1, hd)
    k, v = k.reshape(B, 1, -1, hd), v.reshape(B, 1, -1, hd)
    length = state.length
    if cfg.pos_embedding == "rope":
        pos = length[:, None]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    q = q[:, 0]
    if paged is not None:
        k_pages, v_pages = state.kv.k_pages[i], state.kv.v_pages[i]
        write_paged(k_pages, k[:, 0], paged.write)
        write_paged(v_pages, v[:, 0], paged.write)
        out, ml = kops.paged_attention_partial(q, k_pages, v_pages,
                                               paged.tables, paged.held)
    else:
        k_l, v_l = state.k_cache[i], state.v_cache[i]
        span = k_l.shape[1]
        first = ctx.seq_span[0] * span
        local = length - first
        own = length < state.seq_limit
        if state.k_scale is not None:
            ks_l, vs_l = state.k_scale[i], state.v_scale[i]
            for cache, scales, new in ((k_l, ks_l, k), (v_l, vs_l, v)):
                values, scale = _quantize_kv(new[:, 0])
                write_token(cache, values, local, own)
                write_token(scales, scale, local, own)
            k_l = (k_l.float() * ks_l[..., None]).to(z.dtype)
            v_l = (v_l.float() * vs_l[..., None]).to(z.dtype)
        else:
            write_token(k_l, k[:, 0], local, own)
            write_token(v_l, v[:, 0], local, own)
        n = torch.minimum(length + 1, state.seq_limit) - first
        valid = torch.arange(span, device=z.device)[None] < n[:, None]
        out, ml = decode_partial(q, k_l, v_l, valid)
    out = combine_spans(out, ml, ctx, blocks)
    return attn_output(cfg, p, out.reshape(B, 1, -1).to(p["wo"].dtype), ctx)


def decode_step(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                state, ctx: Ctx):
    """One decoding step. token: (B, 1) -> (logits (B,1,V), new state).

    ``state`` is a ``DecodeState`` or a ``PagedDecodeState``. Every slot's
    ``length`` advances, idle ones included (as in the reference); the
    caches, pool and recurrent states are updated in place. Learned
    positions are read at each slot's ``length`` (NaN past the table's
    end, as ``jnp.take`` fills)."""
    check_split(cfg, ctx)
    _check_layout(state, ctx)
    paged = (_paged_step(state, ctx) if isinstance(state, PagedDecodeState)
             else None)
    table = _part(params, ctx, "embed", "tokens")
    x = embed_lookup(cfg, table, token, ctx)
    table = _tied(cfg, table)
    if cfg.pos_embedding == "learned":
        x = x + position_lookup(_part(params, ctx, "embed", "positions")[
            "positions"], state.length)[:, None]
    x = ctx.constrain(x, "batch", None, None)
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params["groups"], x, state, ctx, paged)
    elif cfg.family == "ssm":
        x = _xlstm_decode(cfg, params["groups"], x, state, ctx)
    elif cfg.family == "audio":
        x = _whisper_decode(cfg, params["decoder"], x, state, ctx)
    else:
        dims = _dims(ctx, "blocks")
        for i in range(cfg.n_layers):
            layer_p = _take(params["blocks"], i, dims, ctx)
            z = apply_norm(cfg, layer_p["ln1"], x)
            h = x + _attn_decode(cfg, layer_p["attn"], z, state, i, paged,
                                 ctx)
            m, _ = _mixer(cfg, layer_p, apply_norm(cfg, layer_p["ln2"], h),
                          ctx)
            x = h + m
    if paged is None:
        state = state._replace(length=state.length + 1)
    elif state.seq_pages is None:
        state = state._replace(
            kv=state.kv._replace(length=paged.lengths),
            tail=tail_pages(paged.tables, paged.lengths,
                            state.kv.k_pages.shape[2]))
    else:
        pool = state.kv.k_pages
        state = state._replace(
            kv=state.kv._replace(length=paged.lengths),
            tail=shard_tail(paged.tables, state.seq_pages, paged.lengths,
                            pool.shape[2], ctx.seq_span[0] * pool.shape[1]))
    x = apply_norm(cfg, _take(params["final_norm"], None,
                              _dims(ctx, "final_norm"), ctx), x)
    return logits(cfg, _head(params, ctx, table), x, ctx), state


def _whisper_decode(cfg: ArchConfig, decoder: Dict, x: torch.Tensor,
                    state: DecodeState, ctx: Ctx) -> torch.Tensor:
    """The decoder stack for one token: self-attention over the dense
    cache (written in place), cross-attention onto ``state.enc_out``."""
    dims = _dims(ctx, "decoder")
    for i in range(cfg.n_layers):
        layer_p = _take(decoder, i, dims, ctx)
        z = apply_norm(cfg, layer_p["ln1"], x)
        x = x + _attn_decode(cfg, layer_p["attn"], z, state, i)
        x = x + cross_attention_block(cfg, layer_p["xattn"],
                                      apply_norm(cfg, layer_p["lnx"], x),
                                      state.enc_out)
        x = x + ffn_apply(cfg, layer_p["mlp"],
                          apply_norm(cfg, layer_p["ln2"], x))
    return x


def _xlstm_decode(cfg: ArchConfig, groups: Dict, x: torch.Tensor,
                  state: DecodeState, ctx: Ctx) -> torch.Tensor:
    """The xLSTM stack for one token; writes each block's new state into
    ``state.mlstm`` / ``state.slstm`` in place."""
    dims = _dims(ctx, "groups") or {}
    for kind, i in _xlstm_layers(cfg):
        z = apply_norm(cfg, _take(groups[kind + "_ln"], i,
                                  dims.get(kind + "_ln"), ctx), x)
        p = _take(groups[kind], i, dims.get(kind), ctx)
        if kind == "mlstm":
            mine = xl.MLSTMState(*(t[i] for t in state.mlstm))
            y, new = xl.mlstm_decode_step(cfg, p, z, mine)
        else:
            mine = xl.SLSTMState(*(t[i] for t in state.slstm))
            y, new = xl.slstm_decode_step(cfg, p, z, mine)
        for old, t in zip(mine, new):
            old.copy_(t)
        x = x + y
    return x


def _hybrid_decode(cfg: ArchConfig, groups: Dict, x: torch.Tensor, state,
                   ctx: Ctx, paged: Optional[_PagedStep]) -> torch.Tensor:
    """The hybrid stack for one token; writes each attention layer's k/v
    and each Mamba layer's new (h, conv window) into ``state`` in place."""
    dims = _dims(ctx, "groups") or {}
    for layer in _hybrid_layers(cfg):
        i, kind = layer.mixer_idx, layer.mixer
        z = apply_norm(cfg, _take(groups[kind + "_ln"], i,
                                  dims.get(kind + "_ln"), ctx), x)
        p = _take(groups[kind], i, dims.get(kind), ctx)
        if kind == "attn":
            h = x + _attn_decode(cfg, p, z, state, i, paged, ctx)
        else:
            mine = MambaState(h=state.mamba.h[i], conv=state.mamba.conv[i])
            y, new = mamba_decode_step(cfg, p, z, mine, ctx)
            mine.h.copy_(new.h)
            mine.conv.copy_(new.conv)
            h = x + y
        m, _ = _channel(cfg, groups, layer, h, ctx)
        x = h + m
    return x
