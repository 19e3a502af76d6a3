"""Public kernel entry points, the API model code uses (port of
``repro.kernels.ops``).

Dispatch is by the tensors' device: CPU tensors go to the plain version,
CUDA tensors to the hand-written kernel, which counts its launches. There
is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

__all__ = ["flash_attention", "launch_counts", "reset_launch_counts"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) in q's
    dtype."""
    _fa.check_shapes(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention_fwd(q, k, v, causal=causal)


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {"flash_attention": _fa.LAUNCHES.count}


def reset_launch_counts() -> None:
    _fa.LAUNCHES.count = 0
