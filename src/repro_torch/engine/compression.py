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
from repro_torch.distributed import collectives as coll

__all__ = ["CompressionConfig", "init_error_state", "compress_grads"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_error_state(params) -> Any:
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _int8_roundtrip(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group``: the model axis's, where ``g`` is this rank's block of a
    leaf split over it."""
    gf = g.float() + err
    amax = gf.abs().max()
    if group is not None:
        amax = coll.all_reduce_max(amax.reshape(1), group)[0]
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def _topk_roundtrip(g: torch.Tensor, err: torch.Tensor, frac: float,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group`` as for :func:`_int8_roundtrip`."""
    gf = g.float() + err
    flat = gf.reshape(-1)
    n = flat.shape[0]
    if group is None:
        k = max(1, int(n * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
    else:  # the whole leaf's k-th largest from each block's top k
        k = max(1, int(n * torch.distributed.get_world_size(group) * frac))
        top = torch.topk(flat.abs(), min(k, n)).values
        thresh = torch.topk(coll.all_gather(top, group), k).values[-1]
    mask = (gf.abs() >= thresh).float()
    kept = gf * mask
    return kept.to(g.dtype), gf - kept


@torch.no_grad()
def compress_grads(grads, err_state, cfg: CompressionConfig, split=None,
                   group=None) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-reduce, new error state).
    Over a mesh ``split`` is a tree of flags, True where a leaf is this
    rank's block of one split over ``group`` (the model axis's)."""
    if cfg.scheme == "none":
        return grads, err_state
    if split is None:
        split = tr.tree_map(lambda g: False, grads)
    if cfg.scheme == "int8":
        out = tr.tree_map(lambda g, e, f: _int8_roundtrip(
            g, e, group if f else None), grads, err_state, split)
    elif cfg.scheme == "topk":
        out = tr.tree_map(lambda g, e, f: _topk_roundtrip(
            g, e, cfg.topk_frac, group if f else None), grads, err_state,
            split)
    else:
        raise ValueError(cfg.scheme)
    # out holds a (grad, residual) pair where grads holds a leaf
    new_g = tr.tree_map(lambda g, pair: pair[0], grads, out)
    new_e = tr.tree_map(lambda g, pair: pair[1], grads, out)
    return new_g, new_e
