"""Common layers: norms, rotary embeddings, dense FFN variants, embeddings
(port of ``repro.models.layers``).

Matmuls run in the param dtype with float32 norm statistics; logits are
float32. The casts sit exactly where the reference puts them, because in
bf16 their order changes the bits.

On a rank of a mesh (``Ctx.tp`` > 1) the layers compute with the slices
that ``Model.param_specs`` places, read from the leaves' shapes: the
embedding's vocab rows (a token outside them looks up zeros, and one
all-reduce over the model axis sums the ranks' rows: each sum has one
non-zero addend, so it is exact), the FFN's ff columns of ``w_up`` and
``w_gate`` and rows of ``w_down`` (one all-reduce sums the partial
products), and the head's vocab columns (the pad mask at the global
column, then one all-gather along the vocab, or the rank's columns as
they are for a loss over the split vocab).

Gradients flow through the split as tensor parallelism pairs them, every
rank computing the same loss: an input of a split product enters through
:func:`to_model` (the identity; its gradient summed over the model axis)
and the partials leave through :func:`model_sum` (the all-reduce; the
gradient as it is). Every leaf held whole then gets the same complete
gradient on every rank, and a split leaf its block's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models.context import Ctx
from repro_torch.models.params import ParamDef

__all__ = ["rmsnorm", "layernorm", "norm_def", "apply_norm", "rope",
           "ffn_defs", "ffn_apply", "ffn_partial", "embed_defs",
           "embed_lookup", "position_lookup", "logits", "held_split",
           "model_sum", "to_model", "data_sum"]


# ----------------------------------------------------------- model axis
def held_split(held: int, whole: int, ctx: Optional[Ctx]) -> bool:
    """Whether a leaf's dim of size ``whole`` is held as this rank's
    1/tp block (``held``) rather than whole; anything else raises."""
    if held == whole:
        return False
    if ctx is None or ctx.tp == 1 or held * ctx.tp != whole:
        raise ValueError(
            f"a leaf dim of {held} where the model has {whole}: a rank "
            f"holds it whole or as 1/tp of it, under a Ctx with the plan "
            f"and the mesh (tp {1 if ctx is None else ctx.tp})")
    return True


def model_sum(y: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The ranks' partial products summed over the model axis: one
    all-reduce; the gradient passes back as it is (the identity where the
    model axis is one rank)."""
    return y if ctx.tp == 1 else coll.sum_forward(y, ctx.tp_group)


def to_model(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``x`` as it is, entering a split product; its gradient summed over
    the model axis (each rank's covers only its slices)."""
    return x if ctx.tp == 1 else coll.sum_backward(x, ctx.tp_group)


def data_sum(t: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``t`` summed over the data shards; the gradient passes back as it
    is, so each shard's part of a statistic of the global batch gets its
    own share."""
    for group in ctx.dp_groups:
        t = coll.sum_forward(t, group)
    return t


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Normalise in f32, cast back to x's dtype, then scale by w."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance in f32, cast back to x's dtype, then scale and
    bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm_def(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    d = {"scale": ParamDef((*lead, cfg.d_model), (*la, None), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((*lead, cfg.d_model), (*la, None), init="zeros")
    return d


def apply_norm(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, hd); positions: (..., S).

    The first and second halves of hd rotate together (not interleaved
    pairs); the rotation runs in f32 and is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- ffn
def ffn_defs(cfg: ArchConfig, stacked: Optional[int] = None) -> Dict:
    """Dense FFN parameter defs (gated or plain, per cfg.activation)."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = (stacked,) if stacked else ()
    la = ("layers",) if stacked else ()
    gated = cfg.activation in ("swiglu", "geglu")
    out = {"w_down": ParamDef((*lead, ff, d), (*la, "ff", "embed"))}
    if gated:
        out["w_gate"] = ParamDef((*lead, d, ff), (*la, "embed", "ff"))
    out["w_up"] = ParamDef((*lead, d, ff), (*la, "embed", "ff"))
    return out


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return F.silu(x)
    if cfg.activation in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "relu2":
        return F.relu(x).square()
    raise ValueError(cfg.activation)


def ffn_partial(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The FFN on the ff columns (and ``w_down`` rows) that ``p`` holds:
    the whole FFN, or this rank's partial of it."""
    if cfg.activation in ("swiglu", "geglu"):
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"])
    return h @ p["w_down"]


def ffn_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor,
              ctx: Optional[Ctx] = None) -> torch.Tensor:
    """The FFN; with ff split over the model axis (column- then
    row-parallel), x entering through ``to_model`` and the ranks' partials
    summed by one all-reduce."""
    if held_split(p["w_down"].shape[-2], cfg.d_ff, ctx):
        return model_sum(ffn_partial(cfg, p, to_model(x, ctx)), ctx)
    return ffn_partial(cfg, p, x)


# -------------------------------------------------------------- embedding
def embed_defs(cfg: ArchConfig) -> Dict:
    d = {"tokens": ParamDef((cfg.padded_vocab, cfg.d_model),
                            ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab"))
    if cfg.pos_embedding == "learned":
        # sized to the largest assigned full-sequence shape (prefill_32k)
        d["positions"] = ParamDef((32_768, cfg.d_model), (None, "embed"),
                                  init="small")
    if cfg.encoder_len:
        d["enc_positions"] = ParamDef((cfg.encoder_len, cfg.d_model),
                                      (None, "embed"), init="small")
    if cfg.n_patches:
        d["patch_pos"] = ParamDef((cfg.n_patches, cfg.d_model),
                                  (None, "embed"), init="small")
    return d


def embed_lookup(cfg: ArchConfig, p: Dict, tokens: torch.Tensor,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
    """The tokens' rows of the embedding table; with its vocab rows split
    over the model axis, each rank's rows (zeros for tokens it does not
    hold) summed by one all-reduce."""
    table = p["tokens"]
    if not held_split(table.shape[0], cfg.padded_vocab, ctx):
        return F.embedding(tokens.long(), table)
    V = table.shape[0]
    local = tokens.long() - ctx.tp_index * V
    mine = (local >= 0) & (local < V)
    rows = F.embedding(local.clamp(0, V - 1), table)
    rows = torch.where(mine[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))
    return model_sum(rows, ctx)


def position_lookup(table: torch.Tensor, index: torch.Tensor
                    ) -> torch.Tensor:
    """``table[index]`` for (B,) indices as ``jnp.take`` gives it: a row
    past the table's end is NaN (its "fill" mode), never an error. An idle
    serving slot's length keeps counting past max_seq."""
    n = table.shape[0]
    rows = table[index.long().clamp(max=n - 1)]
    return torch.where((index < n)[:, None], rows, float("nan"))


def logits(cfg: ArchConfig, p: Dict, x: torch.Tensor,
           ctx: Optional[Ctx] = None, gather: bool = True) -> torch.Tensor:
    """Final projection to the padded vocab: the product in x's dtype, then
    f32, with the pad columns masked to -1e30. With the vocab split over
    the model axis, each rank's columns (masked at their global index,
    x entering through ``to_model``), then one all-gather along the vocab:
    every rank holds the same logits (no gradient flows back through the
    gather: the train step's loss takes ``gather=False``, the rank's
    columns alone)."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    split = held_split(w.shape[-1], cfg.padded_vocab, ctx)
    if split:
        x = to_model(x, ctx)
    out = (x @ w.to(x.dtype)).float()
    V = out.shape[-1]
    if cfg.padded_vocab != cfg.vocab_size:
        start = ctx.tp_index * V if split else 0
        mask = torch.zeros(V, dtype=torch.float32, device=out.device)
        mask[max(0, cfg.vocab_size - start):] = -1e30
        out = out + mask
    if split and gather:
        return coll.all_gather(out, ctx.tp_group, dim=-1)
    return out
