"""Gradient compression with error feedback (port of
``repro.engine.compression``).

Two schemes, each a round trip (compress, then decompress as the far side
of a cross-pod reduce would) whose residual is carried to the next step:

* **int8 quantization**: a per-tensor absmax scale, values rounded half to
  even and clipped to [-127, 127];
* **top-k sparsification**: per tensor, the entries whose magnitude is at
  least the k-th largest (k = max(1, int(size * topk_frac))) are kept, so
  ties at the threshold are all kept, as the reference keeps them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree as tr

__all__ = ["CompressionConfig", "init_error_state", "compress_grads"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_error_state(params) -> Any:
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _int8_roundtrip(g: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def _topk_roundtrip(g: torch.Tensor, err: torch.Tensor, frac: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + err
    flat = gf.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (gf.abs() >= thresh).float()
    kept = gf * mask
    return kept.to(g.dtype), gf - kept


@torch.no_grad()
def compress_grads(grads, err_state, cfg: CompressionConfig
                   ) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-reduce, new error state)."""
    if cfg.scheme == "none":
        return grads, err_state
    if cfg.scheme == "int8":
        out = tr.tree_map(_int8_roundtrip, grads, err_state)
    elif cfg.scheme == "topk":
        out = tr.tree_map(lambda g, e: _topk_roundtrip(g, e, cfg.topk_frac),
                          grads, err_state)
    else:
        raise ValueError(cfg.scheme)
    # out holds a (grad, residual) pair where grads holds a leaf
    new_g = tr.tree_map(lambda g, pair: pair[0], grads, out)
    new_e = tr.tree_map(lambda g, pair: pair[1], grads, out)
    return new_g, new_e
