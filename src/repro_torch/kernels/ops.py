"""Public kernel entry points, the API model code uses (port of
``repro.kernels.ops``).

Dispatch is by the tensors' device: CPU tensors go to the plain version,
CUDA tensors to the hand-written kernel, which counts its launches. There
is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import ref

__all__ = ["flash_attention", "moe_gather", "launch_counts",
           "reset_launch_counts"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) in q's
    dtype."""
    _fa.check_shapes(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention_fwd(q, k, v, causal=causal)


def moe_gather(x: torch.Tensor, token_ids: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """x: (T,d); token_ids: (S,) int32; keep: (S,) bool -> (S,d) dispatch
    buffer in x's dtype (the caller reshapes to (E,C,d))."""
    _moe.check_shapes(x, token_ids, keep)
    if x.device.type == "cpu":
        return ref.moe_gather_ref(x, token_ids, keep)
    return _moe.moe_gather(x, token_ids, keep)


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {"flash_attention": _fa.LAUNCHES.count,
            "moe_gather": _moe.LAUNCHES.count}


def reset_launch_counts() -> None:
    _fa.LAUNCHES.count = 0
    _moe.LAUNCHES.count = 0
