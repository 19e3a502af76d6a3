"""MoE dispatch gather: the wrapper of the hand-written CUDA kernel in
``csrc/moe_gather.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_dispatch.py:37``
``moe_gather`` (body ``_kernel``): the build of the per-expert dispatch
buffer, ``out[i] = x[token_ids[i]] if keep[i] else 0``.

What bounds it on an H100: it is a copy, with no arithmetic. At the
qwen2-moe prefill shape (T=4096 tokens, d=2048, S=60*344=20,640 slots,
bf16) it reads at most the 16.8 MB of x and writes 84.5 MB of buffer, about
0.03 ms at 3.35 TB/s; at the decode shape (T=4, S=480) the bound is under
a microsecond and the host's launch path is the time. The design follows:

- the device: one warp per slot row, 16-byte loads and stores where the
  rows are 16-byte aligned (every model row), element copies otherwise; an
  unkept slot is zero-filled without reading x.
- the host: the inputs checked in one test, one ctypes call through
  ``nvcc.launch`` (no Python context manager; the C entry switches device
  only when it must).

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
def build() -> ctypes._CFuncPtr:
    """Compile the kernel (once per source content), load it and bind its
    C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_moe_gather")


def check_shapes(x: torch.Tensor, token_ids: torch.Tensor,
                 keep: torch.Tensor) -> None:
    if x.dim() != 2 or token_ids.dim() != 1 or keep.shape != token_ids.shape:
        raise ValueError(f"want x (T,d), token_ids (S,), keep (S,); got "
                         f"{tuple(x.shape)}, {tuple(token_ids.shape)}, "
                         f"{tuple(keep.shape)}")
    if x.shape[0] == 0:
        raise ValueError("x has no rows to gather from")


def _check_kernel_inputs(x, token_ids, keep) -> None:
    """One device (CUDA), float32 or bfloat16 x with contiguous rows, int32
    ids and bool flags, both contiguous."""
    if not (x.is_cuda and token_ids.is_cuda and keep.is_cuda):
        raise ValueError(f"x, token_ids, keep are on {x.device}, "
                         f"{token_ids.device}, {keep.device}; the kernel "
                         f"needs CUDA")
    if not x.get_device() == token_ids.get_device() == keep.get_device():
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


def _inputs_ok(x, token_ids, keep) -> bool:
    """All of ``check_shapes`` and ``_check_kernel_inputs`` in one test,
    the launch path's only check; those two run only to say why an input
    is refused."""
    return (x.dim() == 2 and token_ids.dim() == 1 and keep.dim() == 1
            and token_ids.shape[0] == keep.shape[0] and x.shape[0] > 0
            and token_ids.dtype is torch.int32 and keep.dtype is torch.bool
            and (x.dtype is torch.bfloat16 or x.dtype is torch.float32)
            and x.stride(1) == 1 and token_ids.is_contiguous()
            and keep.is_contiguous() and x.is_cuda
            and x.get_device() == token_ids.get_device()
            == keep.get_device())


def moe_gather(x: torch.Tensor, token_ids: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x: (T, d) float32 or bfloat16, rows read in
    place through x's row stride; token_ids: (S,) int32; keep: (S,) bool.
    Returns a new contiguous (S, d) tensor in x's dtype, written on the
    current stream of x's device."""
    if not _inputs_ok(x, token_ids, keep):
        check_shapes(x, token_ids, keep)
        _check_kernel_inputs(x, token_ids, keep)
        raise ValueError("moe_gather: inputs refused")  # not reached
    (T, d), S = x.shape, token_ids.shape[0]
    out = x.new_empty((S, d))
    if S == 0 or d == 0:
        return out
    nvcc.launch(build(), "moe_gather", x.get_device(), x.data_ptr(),
                token_ids.data_ptr(), keep.data_ptr(), out.data_ptr(), S, T,
                d, x.stride(0), x.element_size())
    LAUNCHES.add()
    return out
