"""Public kernel entry points, the API model code uses (port of
``repro.kernels.ops``).

Dispatch is by the tensors' device: CPU tensors go to the plain version,
CUDA tensors to the hand-written kernel, which counts its launches. There
is no fallback from one to the other.

Gradients: on the CPU the plain versions are torch ops, which autograd
differentiates. On a card, ``moe_gather`` and ``ssm_scan`` run through a
``torch.autograd.Function`` whose backward is a hand-written kernel too
(when grad mode is on and an input requires grad; otherwise the forward
kernel is called directly, the serving path's short host path).
``flash_attention`` and ``paged_attention`` have no backward kernel: they
raise ``NotImplementedError`` on either device when asked for a gradient,
as the reference trains with ``Ctx(use_flash=False)``."""
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

__all__ = ["flash_attention", "paged_attention", "paged_attention_partial",
           "moe_gather", "ssm_scan", "expr_core", "segment_reduce",
           "launch_counts", "reset_launch_counts"]

_NO_BACKWARD = ("{} has no backward kernel: training runs attention on the "
                "plain path (Ctx(use_flash=False), as the reference trains); "
                "a flash-attention backward waits in ROADMAP.md (queue 1, "
                "item 10)")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(_NO_BACKWARD.format(name))


class _MoeGather(torch.autograd.Function):
    """The gather on a card: forward and backward kernels. The backward
    reads each token's slots from the map the forward was given."""

    @staticmethod
    def forward(ctx, x, token_ids, keep, slots):
        ctx.save_for_backward(slots)
        return _moe.moe_gather(x, token_ids, keep)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        return _moe.moe_gather_bwd(g, slots), None, None, None


class _SsmScan(torch.autograd.Function):
    """The scan on a card: the checkpointing forward kernel, and the
    backward kernel reading its checkpoints."""

    @staticmethod
    def forward(ctx, dt, A, B, C, x):
        y, ck = _ssm.ssm_scan_checkpointed(dt, A, B, C, x)
        ctx.save_for_backward(dt, A, B, C, x, ck)
        return y

    @staticmethod
    def backward(ctx, g):
        *inputs, ck = ctx.saved_tensors
        return _ssm.ssm_scan_bwd(*inputs, g, ck=ck)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) in q's
    dtype."""
    _fa.check_shapes(q, k, v)
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention_fwd(q, k, v, causal=causal)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v_pages: (P,page,K,hd); tables: (B,max_pages) int32
    global page ids, -1 a hole; lengths: (B,) int32 -> (B,H,hd) in q's
    dtype."""
    _refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        _pa.check_shapes(q, k_pages, v_pages, tables, lengths)
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths)
    return _pa.paged_attention(q, k_pages, v_pages, tables, lengths)  # checks


def paged_attention_partial(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, tables: torch.Tensor,
                            lengths: torch.Tensor) -> tuple:
    """The paged kernel's partial mode over a rank's share of a pool split
    over the sequence: inputs as ``paged_attention``'s (its sub-pool, its
    local table, the valid positions of each local row) -> (out (B,H,hd),
    ml (B,H,2)) float32, each row's output over its own sum and its (max,
    sum); a row with no valid position gives zeros and (-1e30, 0)."""
    _refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        _pa.check_shapes(q, k_pages, v_pages, tables, lengths)
        return ref.paged_attention_partial_ref(q, k_pages, v_pages, tables,
                                               lengths)
    return _pa.paged_attention_partial(q, k_pages, v_pages, tables,
                                       lengths)  # checks


def moe_gather(x: torch.Tensor, token_ids: torch.Tensor,
               keep: torch.Tensor, slots: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x: (T,d); token_ids: (S,) int32; keep: (S,) bool -> (S,d) dispatch
    buffer in x's dtype (the caller reshapes to (E,C,d)). ``slots``: the
    inverse map the backward kernel reads, (T, k) int64, each token's slots
    in increasing order, dropped ones at S (``moe_apply``'s ``pos_tok``);
    used only when a gradient is wanted on a card, where without it
    ``ref.gather_slots`` builds one from the ids."""
    if x.is_cpu:
        _moe.check_shapes(x, token_ids, keep)
        if slots is not None:
            _moe.check_slots(slots, x.shape[0])
        return ref.moe_gather_ref(x, token_ids, keep)
    if _wants_grad(x):
        if slots is None:
            slots = ref.gather_slots(token_ids, keep, x.shape[0])
        else:
            _moe.check_slots(slots, x.shape[0])
        return _MoeGather.apply(x, token_ids, keep, slots)
    return _moe.moe_gather(x, token_ids, keep)  # checks


def ssm_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dt, x: (Bt,L,di); A: (di,N); B, C: (Bt,L,N) -> y (Bt,L,di) float32.
    The kernel takes float32 only; the plain version upcasts."""
    if x.device.type == "cpu":
        _ssm.check_shapes(dt, A, B, C, x)
        return ref.ssm_scan_ref(dt, A, B, C, x)
    if _wants_grad(dt, A, B, C, x):
        return _SsmScan.apply(dt, A, B, C, x)
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
            "paged_attention_partial": _pa.LAUNCHES_PARTIAL.count,
            "moe_gather": _moe.LAUNCHES.count,
            "moe_gather_bwd": _moe.LAUNCHES_BWD.count,
            "ssm_scan": _ssm.LAUNCHES.count,
            "ssm_scan_bwd": _ssm.LAUNCHES_BWD.count,
            "expr_core": _ec.LAUNCHES.count,
            "segment_reduce": _sr.LAUNCHES.count}


def reset_launch_counts() -> None:
    _fa.LAUNCHES.count = 0
    _pa.LAUNCHES.count = 0
    _pa.LAUNCHES_PARTIAL.count = 0
    _moe.LAUNCHES.count = 0
    _moe.LAUNCHES_BWD.count = 0
    _ssm.LAUNCHES.count = 0
    _ssm.LAUNCHES_BWD.count = 0
    _ec.LAUNCHES.count = 0
    _sr.LAUNCHES.count = 0
