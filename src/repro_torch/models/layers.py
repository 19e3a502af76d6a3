"""Common layers: norms, rotary embeddings, dense FFN variants, embeddings
(port of ``repro.models.layers``).

Matmuls run in the param dtype with float32 norm statistics; logits are
float32. The casts sit exactly where the reference puts them, because in
bf16 their order changes the bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.params import ParamDef

__all__ = ["rmsnorm", "layernorm", "norm_def", "apply_norm", "rope",
           "ffn_defs", "ffn_apply", "embed_defs", "embed_lookup",
           "position_lookup", "logits"]


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


def ffn_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation in ("swiglu", "geglu"):
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"])
    return h @ p["w_down"]


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


def embed_lookup(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tokens"])


def position_lookup(table: torch.Tensor, index: torch.Tensor
                    ) -> torch.Tensor:
    """``table[index]`` for (B,) indices as ``jnp.take`` gives it: a row
    past the table's end is NaN (its "fill" mode), never an error. An idle
    serving slot's length keeps counting past max_seq."""
    n = table.shape[0]
    rows = table[index.long().clamp(max=n - 1)]
    return torch.where((index < n)[:, None], rows, float("nan"))


def logits(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final projection to the padded vocab: the product in x's dtype, then
    f32, with the pad columns masked to -1e30."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    out = (x @ w.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.zeros(cfg.padded_vocab, dtype=torch.float32,
                           device=out.device)
        mask[cfg.vocab_size:] = -1e30
        out = out + mask
    return out
