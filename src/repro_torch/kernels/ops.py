"""Public kernel entry points, the API model code uses (port of
``repro.kernels.ops``).

Dispatch is by the tensors' device: CPU tensors go to the plain version,
CUDA tensors to the hand-written kernel, which counts its launches. There
is no fallback from one to the other."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import expr_core as _ec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _sr
from repro_torch.kernels import ssm_scan as _ssm

__all__ = ["flash_attention", "paged_attention", "moe_gather", "ssm_scan",
           "expr_core", "segment_reduce", "launch_counts",
           "reset_launch_counts"]


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
    if x.is_cpu:
        _moe.check_shapes(x, token_ids, keep)
        return ref.moe_gather_ref(x, token_ids, keep)
    return _moe.moe_gather(x, token_ids, keep)  # checks


def ssm_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dt, x: (Bt,L,di); A: (di,N); B, C: (Bt,L,N) -> y (Bt,L,di) float32.
    The kernel takes float32 only; the plain version upcasts."""
    if x.device.type == "cpu":
        _ssm.check_shapes(dt, A, B, C, x)
        return ref.ssm_scan_ref(dt, A, B, C, x)
    return _ssm.ssm_scan(dt, A, B, C, x)  # checks


def expr_core(program: _ec.ExprProgram, inputs: Sequence[torch.Tensor],
              n: int, outs: Optional[Sequence[torch.Tensor]] = None,
              device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """One fused run's numeric core (an ``expr_core.ExprProgram``) over n
    elements: inputs are flat tensors of n elements or one (a constant),
    holding numpy columns (``transfer.torch_dtype``) -> one (n,) tensor per
    program output, numpy's bytes. On a card (the inputs', or ``device``
    when given) the kernel runs; inputs and ``outs`` may then lie in
    pinned host memory, which it reads and writes through the card's
    mapping. Otherwise, for inputs on the CPU, the plain version."""
    if device is not None and torch.device(device).type == "cuda":
        return _ec.expr_core(program, inputs, n, outs, device)  # checks
    if inputs[0].device.type == "cpu":
        return _ec.expr_core_ref(program, inputs, n)
    return _ec.expr_core(program, inputs, n, outs)  # checks


def segment_reduce(inv: torch.Tensor, n: int, vals: Sequence[torch.Tensor],
                   dtypes: Sequence, combiners: Sequence[str]
                   ) -> List[torch.Tensor]:
    """inv: (rows,) int64 group ids in [0, n); vals: (rows, ...) tensors
    holding numpy columns of ``dtypes`` -> one (n, ...) accumulator per
    column, reduced by its combiner (sum / min / max) with the bytes of
    numpy's ``np.add.at`` / ``np.minimum.at`` / ``np.maximum.at``."""
    if inv.device.type == "cpu":
        return _sr.segment_reduce_ref(inv, n, vals, dtypes, combiners)
    return _sr.segment_reduce(inv, n, vals, dtypes, combiners)  # checks


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {"flash_attention": _fa.LAUNCHES.count,
            "paged_attention": _pa.LAUNCHES.count,
            "moe_gather": _moe.LAUNCHES.count,
            "ssm_scan": _ssm.LAUNCHES.count,
            "expr_core": _ec.LAUNCHES.count,
            "segment_reduce": _sr.LAUNCHES.count}


def reset_launch_counts() -> None:
    _fa.LAUNCHES.count = 0
    _pa.LAUNCHES.count = 0
    _moe.LAUNCHES.count = 0
    _ssm.LAUNCHES.count = 0
    _ec.LAUNCHES.count = 0
    _sr.LAUNCHES.count = 0
