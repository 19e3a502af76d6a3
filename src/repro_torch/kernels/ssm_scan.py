"""Selective-SSM scan: the wrapper of the hand-written CUDA kernel in
``csrc/ssm_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:43``
``ssm_scan`` (body ``_kernel``): the Mamba recurrence
``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``, ``y_t = h_t . C_t``
over time, in float32, with the (di, N) state kept on chip.

What bounds it on an H100 (data sheet, nothing measured here): at the
jamba prefill shape (Bt=1, L=4096, di=16384, N=16) it moves 805 MB (dt, x
read, y written; 0.240 ms at 3.35 TB/s) and takes 1.07 G exponentials
(~0.28 ms on the special-function units), so the exponentials bound it at
~0.28 ms. The design follows: 4 neighbouring lanes per channel, each
with 4 of its 16 states and the matching entries of A in registers (a
smaller N is zero-padded to 16), the decay by ``__expf``, y summed
with warp shuffles (at Bt=1 that gives ~16 warps per SM where one thread
per channel gave ~4); time walked in chunks staged in shared memory with
``cp.async`` (double-buffered), B_t and C_t read as shared-memory
broadcasts.

The kernel reads every input through its strides (innermost stride 1), so
``mamba_apply``'s B and C, column slices of the ``x_proj`` output, reach
it without a copy. The source is compiled with nvcc for sm_90a at first
use and bound through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

__all__ = ["ssm_scan", "check_shapes", "build", "LAUNCHES", "SOURCE",
           "MAX_STATE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 16  # N held in registers

LAUNCHES = nvcc.LaunchCounter()


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it."""
    lib = nvcc.load(SOURCE)
    fn = lib.repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 15 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_shapes(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, x: torch.Tensor) -> None:
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2 \
            or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"want dt, x (Bt,L,di), A (di,N), B, C (Bt,L,N); "
                         f"got dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, "
                         f"x {tuple(x.shape)}")
    Bt, L, di = x.shape
    if A.shape[0] != di or B.shape[:2] != (Bt, L) or B.shape[2] != A.shape[1]:
        raise ValueError(f"dt/x {tuple(x.shape)}, A {tuple(A.shape)} and "
                         f"B/C {tuple(B.shape)} disagree")


def _check_kernel_inputs(dt, A, B, C, x) -> None:
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("x", x)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != x.device:
            raise ValueError("dt, A, B, C, x must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous "
                             f"(stride 1), got strides {t.stride()}")
    if not 0 < A.shape[1] <= MAX_STATE:
        raise ValueError(f"state size N={A.shape[1]} not in 1..{MAX_STATE}")


def ssm_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. dt, x: (Bt, L, di); A: (di, N); B, C:
    (Bt, L, N); all float32, last dim contiguous, other strides free.
    Returns a new contiguous (Bt, L, di) float32 tensor, written on the
    current stream."""
    check_shapes(dt, A, B, C, x)
    _check_kernel_inputs(dt, A, B, C, x)
    Bt, L, di = x.shape
    y = torch.empty((Bt, L, di), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    fn = build().repro_ssm_scan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                 x.data_ptr(), y.data_ptr(), Bt, L, di, A.shape[1],
                 *dt.stride()[:2], *x.stride()[:2], A.stride(0),
                 *B.stride()[:2], *C.stride()[:2], *y.stride()[:2], stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    LAUNCHES.count += 1
    return y
