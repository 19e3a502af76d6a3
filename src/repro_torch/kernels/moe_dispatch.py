"""MoE dispatch gather: the wrapper of the hand-written CUDA kernel in
``csrc/moe_gather.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_dispatch.py:37``
``moe_gather`` (body ``_kernel``): the build of the per-expert dispatch
buffer, ``out[i] = x[token_ids[i]] if keep[i] else 0``.

What bounds it on an H100: it is a copy, with no arithmetic. At the
qwen2-moe prefill shape (T=4096 tokens, d=2048, S=60*344=20,640 slots,
bf16) it reads at most the 16.8 MB of x and writes 84.5 MB of buffer, about
0.03 ms at 3.35 TB/s. The design follows: one warp per slot row, 16-byte
loads and stores where the rows are 16-byte aligned, element copies
otherwise; an unkept slot is zero-filled without reading x.

The source is compiled with nvcc for sm_90a at first use and bound
through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

__all__ = ["moe_gather", "check_shapes", "build", "LAUNCHES", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gather.cu"
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = nvcc.LaunchCounter()


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it."""
    lib = nvcc.load(SOURCE)
    fn = lib.repro_moe_gather
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_shapes(x: torch.Tensor, token_ids: torch.Tensor,
                 keep: torch.Tensor) -> None:
    if x.dim() != 2 or token_ids.dim() != 1 or keep.shape != token_ids.shape:
        raise ValueError(f"want x (T,d), token_ids (S,), keep (S,); got "
                         f"{tuple(x.shape)}, {tuple(token_ids.shape)}, "
                         f"{tuple(keep.shape)}")
    if x.shape[0] == 0:
        raise ValueError("x has no rows to gather from")


def _check_kernel_inputs(x, token_ids, keep) -> None:
    for name, t in (("x", x), ("token_ids", token_ids), ("keep", keep)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != x.device:
            raise ValueError("x, token_ids, keep must be on one device")
    if x.dtype not in DTYPES:
        raise TypeError(f"x is {x.dtype}; the kernel takes float32 or "
                        f"bfloat16")
    if token_ids.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError(f"want int32 token_ids and bool keep; got "
                        f"{token_ids.dtype}, {keep.dtype}")
    if x.stride(1) != 1 or not token_ids.is_contiguous() \
            or not keep.is_contiguous():
        raise ValueError("x's rows, token_ids and keep must be contiguous")


def moe_gather(x: torch.Tensor, token_ids: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: (T, d) float32 or bfloat16, rows read in
    place through x's row stride; token_ids: (S,) int32; keep: (S,) bool.
    Returns a new contiguous (S, d) tensor in x's dtype, written on the
    current stream."""
    check_shapes(x, token_ids, keep)
    _check_kernel_inputs(x, token_ids, keep)
    (T, d), S = x.shape, token_ids.shape[0]
    out = torch.empty((S, d), dtype=x.dtype, device=x.device)
    if S == 0 or d == 0:
        return out
    fn = build().repro_moe_gather
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), token_ids.data_ptr(), keep.data_ptr(),
                 out.data_ptr(), S, T, d, x.stride(0), x.element_size(),
                 stream)
    if err:
        raise RuntimeError(f"moe_gather kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.count += 1
    return out
