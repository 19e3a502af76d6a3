"""Public kernel entry points, the API model code uses (port of
``repro.kernels.ops``).

Dispatch is by the tensors' device: CPU tensors go to the plain version,
CUDA tensors to the hand-written kernel, which counts its launches. There
is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm

__all__ = ["flash_attention", "paged_attention", "moe_gather", "ssm_scan",
           "launch_counts", "reset_launch_counts"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) in q's
    dtype."""
    _fa.check_shapes(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention_fwd(q, k, v, causal=causal)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v_pages: (P,page,K,hd); tables: (B,max_pages) int32
    global page ids, -1 a hole; lengths: (B,) int32 -> (B,H,hd) in q's
    dtype."""
    if q.device.type == "cpu":
        _pa.check_shapes(q, k_pages, v_pages, tables, lengths)
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths)
    return _pa.paged_attention(q, k_pages, v_pages, tables, lengths)  # checks


def moe_gather(x: torch.Tensor, token_ids: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """x: (T,d); token_ids: (S,) int32; keep: (S,) bool -> (S,d) dispatch
    buffer in x's dtype (the caller reshapes to (E,C,d))."""
    _moe.check_shapes(x, token_ids, keep)
    if x.device.type == "cpu":
        return ref.moe_gather_ref(x, token_ids, keep)
    return _moe.moe_gather(x, token_ids, keep)


def ssm_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dt, x: (Bt,L,di); A: (di,N); B, C: (Bt,L,N) -> y (Bt,L,di) float32.
    The kernel takes float32 only; the plain version upcasts."""
    _ssm.check_shapes(dt, A, B, C, x)
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(dt, A, B, C, x)
    return _ssm.ssm_scan(dt, A, B, C, x)


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {"flash_attention": _fa.LAUNCHES.count,
            "paged_attention": _pa.LAUNCHES.count,
            "moe_gather": _moe.LAUNCHES.count,
            "ssm_scan": _ssm.LAUNCHES.count}


def reset_launch_counts() -> None:
    _fa.LAUNCHES.count = 0
    _pa.LAUNCHES.count = 0
    _moe.LAUNCHES.count = 0
    _ssm.LAUNCHES.count = 0
