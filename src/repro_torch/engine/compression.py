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
from repro_torch.distributed.elastic import split_over

__all__ = ["CompressionConfig", "init_error_state", "compress_grads"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_error_state(params) -> Any:
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _int8_roundtrip(g: torch.Tensor, err: torch.Tensor, groups=()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``groups``: the process groups of the mesh axes that split the
    leaf of which ``g`` is this rank's block (none for a whole leaf)."""
    gf = g.float() + err
    amax = gf.abs().max()
    for group in groups:
        amax = coll.all_reduce_max(amax.reshape(1), group)[0]
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def _topk_roundtrip(g: torch.Tensor, err: torch.Tensor, frac: float,
                    groups=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """``groups`` as for :func:`_int8_roundtrip`."""
    gf = g.float() + err
    flat = gf.reshape(-1)
    n = flat.shape[0]
    for group in groups:
        n *= torch.distributed.get_world_size(group)
    k = max(1, int(n * frac))  # of the whole leaf
    top = torch.topk(flat.abs(), min(k, flat.shape[0])).values
    for group in groups:  # the k largest of the blocks' k largest, per axis
        top = coll.all_gather(top, group)
        top = torch.topk(top, min(k, top.shape[0])).values
    thresh = top[-1]
    mask = (gf.abs() >= thresh).float()
    kept = gf * mask
    return kept.to(g.dtype), gf - kept


@torch.no_grad()
def compress_grads(grads, err_state, cfg: CompressionConfig, specs=None,
                   mesh=None) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-reduce, new error state).
    Over a mesh each gradient is this rank's block of its leaf under
    ``specs`` (``param_specs``: over the model axis, the data axis under
    FSDP, or both), and int8's absmax and top-k's threshold are the whole
    leaf's."""
    if cfg.scheme == "none":
        return grads, err_state
    if specs is None:
        groups = tr.tree_map(lambda g: [], grads)
    else:
        groups = tr.tree_map(lambda g, spec: [
            mesh.group(a) for a in split_over(spec, mesh)], grads, specs)
    if cfg.scheme == "int8":
        out = tr.tree_map(_int8_roundtrip, grads, err_state, groups)
    elif cfg.scheme == "topk":
        out = tr.tree_map(lambda g, e, gs: _topk_roundtrip(
            g, e, cfg.topk_frac, gs), grads, err_state, groups)
    else:
        raise ValueError(cfg.scheme)
    # out holds a (grad, residual) pair where grads holds a leaf
    new_g = tr.tree_map(lambda g, pair: pair[0], grads, out)
    new_e = tr.tree_map(lambda g, pair: pair[1], grads, out)
    return new_g, new_e
