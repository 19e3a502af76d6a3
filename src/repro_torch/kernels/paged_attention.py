"""Paged decode attention: the wrapper of the hand-written CUDA kernel in
``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:65``
``paged_attention`` (body ``_kernel``): one query token per sequence
attends to a KV cache kept as pages of a pool ``(P, page, K, hd)``,
following the sequence's row of a block table of global page ids (-1 is a
hole), with an online softmax in float32 over the G query heads of each kv
head.

What bounds it on an H100 (data sheet, nothing measured here): a decode
step reads each cached K and V row once and does ~4 G flops per pair of
elements read, so device-memory bytes bound it. At qwen2.5-32b's decode
shape (B=32, K=8, hd=128, bf16, page 64, lengths up to 4,096, mean ~2,048)
that is ~270 MB of K/V, ~0.08 ms at 3.35 TB/s. The design follows: one
block of 4 warps per (sequence, kv head, chunk of at most 8 query heads)
walks the sequence's pages in order, reading each K and V row with 16-byte
loads; only the first ceil(length / page) table entries are visited and
holes are skipped. Splitting a long sequence over several blocks
(flash-decoding) and prefetching pages are left for later.

The source is compiled with nvcc for sm_90a at first use and bound
through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

__all__ = ["paged_attention", "check_shapes", "build", "LAUNCHES", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 48 * 1024  # bytes a block may take without opting in

LAUNCHES = nvcc.LaunchCounter()


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it."""
    lib = nvcc.load(SOURCE)
    fn = lib.repro_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 8
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.repro_paged_attention_smem
    smem.argtypes = [ctypes.c_int64] * 3
    smem.restype = ctypes.c_int64
    return lib


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
    lanes = q.shape[2] * q.element_size() // 16
    if q.shape[2] * q.element_size() % 16 or lanes & (lanes - 1) \
            or not 0 < lanes <= 32:
        raise ValueError(f"head dim {q.shape[2]} in {q.dtype}: a row must be "
                         f"1, 2, 4, ... or 32 words of 16 bytes")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B, H, hd), head dim contiguous;
    k_pages, v_pages: contiguous (P, page, K, hd) in q's dtype (float32 or
    bfloat16); tables: (B, max_pages) int32 global page ids, -1 a hole;
    lengths: (B,) int32. Returns a new contiguous (B, H, hd) tensor in q's
    dtype, written on the current stream."""
    check_shapes(q, k_pages, v_pages, tables, lengths)
    _check_kernel_inputs(q, k_pages, v_pages, tables, lengths)
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = build()
    smem = lib.repro_paged_attention_smem(H // K, page, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"page {page} x head dim {hd} needs {smem} bytes of "
                         f"shared memory per block, over {SMEM_LIMIT}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, K,
            hd, page, tables.shape[1], q.stride(0), q.stride(1),
            q.element_size(), hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.count += 1
    return out
