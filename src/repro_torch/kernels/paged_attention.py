"""Paged decode attention: the wrapper of the hand-written CUDA kernels in
``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:65``
``paged_attention`` (body ``_kernel``): one query token per sequence
attends to a KV cache kept as pages of a pool ``(P, page, K, hd)``,
following the sequence's row of a block table of global page ids (-1 is a
hole), with a float32 softmax over the G query heads of each kv head.

What bounds it on an H100 (data sheet, nothing measured here): a decode
step reads each cached K and V row once and does ~4 G flops per pair of
elements read, so device-memory bytes bound it: ~270 MB of K/V at
qwen2.5-32b's decode shape (B=32, K=8, hd=128, bf16, lengths up to 4,096),
~0.08 ms at 3.35 TB/s. The design is split-sequence flash-decoding: each
row is cut into spans of a whole number of pages, chosen from the static
shapes alone (``span_plan``: never from the lengths on the device, so the
launch needs no host sync and stays fixed under a CUDA graph); one block
per (span, kv head, chunk of query heads, sequence) streams its span's K
and V rows into shared memory with ``cp.async`` and keeps an online
softmax (tensor cores in bf16, CUDA cores in float32); a second kernel
merges the spans of each row in span order (no atomics). With one span
the first kernel writes the output and the second is not launched.
``ref.paged_attention_split_ref`` is the same algorithm in plain PyTorch.

The partial mode (``paged_attention_partial``) runs the same kernels over
one rank's share of a pool split over the sequence (its sub-pool and its
local table) and returns each row's unfinished result: the float32
output normalised by its own sum and its (max, sum), which the ranks'
log-sum-exp combine merges (``models.attention.merge_partials``); its
plain version is ``ref.paged_attention_partial_ref``.

Head dims: any hd up to 256 whose row is a whole number of 16-byte words
(bf16: a multiple of 8; float32: of 4).

The source is compiled with nvcc for sm_90a at first use and bound
through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import nvcc

__all__ = ["paged_attention", "paged_attention_partial", "check_shapes",
           "span_plan", "build", "LAUNCHES", "LAUNCHES_PARTIAL", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
# The span plan, from chip runs of the smoke's shapes (PERF.md, Findings):
# about four (sequence, kv head) blocks per SM of an H100's 132 (three fit
# by shared memory at hd 128, so blocks of rows of uneven length even out),
# in spans of 256 to 1,024 positions: shorter, a block's fixed costs (q,
# the first chunk's latency, the merge of its warps) outweigh its
# streaming; longer, the longest rows' blocks set the kernel's time. At
# most MAX_SPANS a row: the combine kernel keeps one weight per span in
# shared memory.
TARGET_BLOCKS = 512
MIN_SPAN_TOKENS = 256
MAX_SPAN_TOKENS = 1024
MAX_SPANS = 256

LAUNCHES = nvcc.LaunchCounter()
LAUNCHES_PARTIAL = nvcc.LaunchCounter()


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernels (once per source content) and load them."""
    lib = nvcc.load(SOURCE)
    fn = lib.repro_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 10
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return lib


def span_plan(B: int, K: int, max_pages: int,
              page: int) -> Tuple[int, int]:
    """(tokens_per_span, n_spans) from the static shapes alone: spans of a
    whole number of pages, enough of them that B * K * spans reaches
    ``TARGET_BLOCKS``, each ``MIN_SPAN_TOKENS`` to ``MAX_SPAN_TOKENS``
    long where whole pages allow, at most ``MAX_SPANS`` of them, never
    longer than the table. (Where a kv head's query heads need more than
    one block, each block takes the same spans.)"""
    want = -(-TARGET_BLOCKS // (B * K))
    pages = max(-(-max_pages // want), -(-MIN_SPAN_TOKENS // page))
    pages = min(pages, max(1, MAX_SPAN_TOKENS // page))
    pages = min(max(pages, -(-max_pages // MAX_SPANS)), max_pages)
    return pages * page, -(-max_pages // pages)


def check_shapes(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, tables: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape \
            or tables.dim() != 2 or lengths.dim() != 1:
        raise ValueError(
            f"want q (B,H,hd), k/v pages (P,page,K,hd), tables "
            f"(B,max_pages), lengths (B,); got q {tuple(q.shape)}, k "
            f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}, tables "
            f"{tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    B, H, hd = q.shape
    P, page, K, khd = k_pages.shape
    if khd != hd or K == 0 or H % K or tables.shape[0] != B \
            or lengths.shape[0] != B:
        raise ValueError(
            f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}, tables "
            f"{tuple(tables.shape)} and lengths {tuple(lengths.shape)} "
            f"disagree (need H % K == 0 and one table row and length per "
            f"sequence)")
    if P == 0 or page == 0 or tables.shape[1] == 0:
        raise ValueError("the pool and the table need at least one page")


def _check_kernel_inputs(q, k_pages, v_pages, tables, lengths) -> None:
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError("q, pages, tables and lengths must be on one "
                             "device")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}:"
                        f" the kernel takes float32 or bfloat16, all one type")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"want int32 tables and lengths; got {tables.dtype}, "
                        f"{lengths.dtype}")
    if q.stride(-1) != 1 or not k_pages.is_contiguous() \
            or not v_pages.is_contiguous() or not tables.is_contiguous() \
            or not lengths.is_contiguous():
        raise ValueError("q's head dim, the pages, tables and lengths must be "
                         "contiguous (stride 1)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the page pools must be 16-byte aligned")
    hd = q.shape[2]
    if hd * q.element_size() % 16 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} in {q.dtype}: a row must be a whole "
                         f"number of 16-byte words and hd at most "
                         f"{MAX_HEAD_DIM}")
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} over the grid's 65,535")
    if tables.shape[1] * k_pages.shape[1] >= 2 ** 31:
        raise ValueError("a row of more than 2**31 positions")


def _on_device(device: torch.device):
    """A guard that makes ``device`` current, or nothing when it is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, hd: int, K: int, page: int,
          max_pages: int) -> Tuple[int, int, int, int]:
    """(tokens per span, spans, floats of the partials' accumulators,
    floats of their (max, sum) pairs) of one launch shape."""
    span_tokens, n_spans = span_plan(B, K, max_pages, page)
    rows = B * n_spans * H  # (B, K, spans, G) partial rows
    return span_tokens, n_spans, rows * hd, rows * 2


def _launch(q, k_pages, v_pages, tables, lengths, out,
            out_ml=None) -> None:
    """Check the inputs and launch the kernels into ``out`` (and, in the
    partial mode, ``out_ml``); raises if the launch fails."""
    check_shapes(q, k_pages, v_pages, tables, lengths)
    _check_kernel_inputs(q, k_pages, v_pages, tables, lengths)
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    max_pages = tables.shape[1]
    if B == 0:
        return
    span_tokens, n_spans, n_acc, n_ml = _plan(B, H, hd, K, page, max_pages)
    lib = build()
    with _on_device(q.device):
        acc_ptr = ml_ptr = None
        if n_spans > 1:  # the partials: (B,K,S,G,hd) then (B,K,S,G,2) f32
            scratch = torch.empty(n_acc + n_ml, dtype=torch.float32,
                                  device=q.device)
            acc_ptr = scratch.data_ptr()
            ml_ptr = acc_ptr + 4 * n_acc
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), acc_ptr,
            ml_ptr, B, H, K, hd, page, max_pages, q.stride(0), q.stride(1),
            span_tokens, n_spans, q.element_size(), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
            None if out_ml is None else out_ml.data_ptr(),
            int(out_ml is not None))
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernels. q: (B, H, hd), head dim contiguous;
    k_pages, v_pages: contiguous (P, page, K, hd) in q's dtype (float32 or
    bfloat16); tables: (B, max_pages) int32 global page ids, -1 a hole;
    lengths: (B,) int32. Returns a new contiguous (B, H, hd) tensor in q's
    dtype, written on the current stream with no host sync.

    One call is one launch in ``LAUNCHES``, whether it runs the split
    kernel alone (one span) or the split kernel and the combine pass, so
    that launches per attention layer and step stay one."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k_pages, v_pages, tables, lengths, out)
    LAUNCHES.add()
    return out


def paged_attention_partial(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, tables: torch.Tensor,
                            lengths: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial mode: inputs as ``paged_attention``'s, over one rank's
    sub-pool and local table (lengths: the valid positions of each local
    row). Returns (out, ml), float32 and contiguous: out (B, H, hd) each
    row's output normalised by its own sum, ml (B, H, 2) its max score
    (natural log units, scale included) and its sum of exp(score - max);
    a row with no valid position gives zeros and (-1e30, 0). One call is
    one launch in ``LAUNCHES_PARTIAL``."""
    check_shapes(q, k_pages, v_pages, tables, lengths)
    B, H, hd = q.shape
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=q.device)
    _launch(q, k_pages, v_pages, tables, lengths, out, ml)
    LAUNCHES_PARTIAL.add()
    return out, ml
