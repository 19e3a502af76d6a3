"""Selective-SSM scan: the wrapper of the hand-written CUDA kernel in
``csrc/ssm_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:43``
``ssm_scan`` (body ``_kernel``): the Mamba recurrence
``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``, ``y_t = h_t . C_t``
over time, in float32, with the (di, N) state kept on chip.

What bounds it on an H100 (data sheet): at the jamba prefill shape (Bt=1,
L=4096, di=16384, N=16) it takes 1.07 G exponentials, 0.256 ms at the
special-function units' 16 per clock per SM, and moves 805 MB (dt, x
read, y written), 0.240 ms at 3.35 TB/s. The design follows: one
``ex2.approx.ftz`` per (t, c, n) with A pre-scaled by log2 e, and few other
instructions around it: a block of 32 channels walks the sequence in
chunks of 32 steps that a producer warp loads by TMA through a ring of
mbarrier-guarded stages; 2 or 4 neighbouring lanes own a channel (the
plan's choice, from the grid), 16 / lanes states each; y is reduced once
per 16 steps and leaves by a TMA store. ``ref.ssm_scan_ex2_ref`` is the
kernel's arithmetic in plain PyTorch.

TMA reads dt, x, B and C in place through their strides, so
``mamba_apply``'s B and C, column slices of the ``x_proj`` output, reach it
without a copy. An input whose base or strides break TMA's 16-byte rules is
first copied, by itself, into a buffer whose rows are whole 16-byte words
(``COPIES`` counts such inputs); y of a di that is not a multiple of 4 is
a column view of such a buffer. The source is compiled with nvcc for
sm_90a at first use and bound through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import nvcc

__all__ = ["ssm_scan", "check_shapes", "plan", "ScanPlan", "tma_ready",
           "build", "LAUNCHES", "COPIES", "SOURCE", "MAX_STATE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 16  # N held in registers
# The kernel's sizes, as the source's constants: 32 channels a block, 32
# steps a chunk, 3 stages, 45 KB of shared memory (four blocks fit an SM).
# Lanes per channel from the grid (measured on an H100, PERF.md): 2 (8
# states a lane: half the shuffles and duplicated dt/x reads of 4, 96
# threads a block) where the grid gives each SM at least
# MANY_BLOCKS_PER_SM blocks, as jamba's 512 at Bt=1 do (0.35 ms against
# 0.44 at 4 lanes); 4 (160 threads, twice the warps to hide latency)
# where it gives fewer (188 blocks: 0.064 ms against 0.088 at 2).
CHANNELS, CHUNK, STAGES = 32, 32, 3
MANY_BLOCKS_PER_SM = 3

LAUNCHES = nvcc.LaunchCounter()


class CopyCounter:
    """Inputs the wrapper copied into a TMA-ready layout."""
    count = 0


COPIES = CopyCounter()


class ScanPlan(NamedTuple):
    """One kernel instance: lanes per channel, channels per block, steps
    per chunk, ring stages and dynamic shared-memory bytes."""
    lanes: int
    channels: int
    chunk: int
    stages: int
    smem_bytes: int


def plan(Bt: int, di: int, n_sm: int = 132,
         lanes: Optional[int] = None) -> ScanPlan:
    """The launch for Bt batch rows of di channels on a card of ``n_sm``
    SMs: the instance with ``lanes`` lanes per channel (2 or 4; by
    default chosen from the grid's blocks per SM), as the source's
    constants give it. Raises ValueError for another count."""
    if lanes is None:
        blocks = Bt * -(-di // CHANNELS)
        lanes = 2 if blocks >= MANY_BLOCKS_PER_SM * n_sm else 4
    if lanes not in (2, 4):
        raise ValueError(f"lanes per channel {lanes} not in (2, 4)")
    stage = 4 * (2 * CHUNK * CHANNELS + 2 * CHUNK * MAX_STATE)  # dt x B C
    # 128 bytes of alignment, the ring, two y tiles, two mbarriers a stage
    smem = 128 + STAGES * stage + 2 * 4 * CHUNK * CHANNELS + 16 * STAGES
    return ScanPlan(lanes, CHANNELS, CHUNK, STAGES, smem)


@functools.lru_cache(maxsize=None)
def build() -> ctypes._CFuncPtr:
    """Compile the kernel (once per source content), load it and bind its
    C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_ssm_scan")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read the (Bt, L, w) float32 tensor ``t`` in place: a
    16-byte aligned base and, for each outer dimension longer than 1, a
    stride of whole 16-byte words (the innermost stride is 1)."""
    return t.data_ptr() % 16 == 0 and all(
        s % 4 == 0 for s, n in zip(t.stride()[:2], t.shape[:2]) if n > 1)


def _padded(shape: Tuple[int, int, int], like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (Bt, L, w) float32 view of a buffer whose rows are
    padded to whole 16-byte words."""
    Bt, L, w = shape
    return torch.empty((Bt, L, -(-w // 4) * 4), dtype=torch.float32,
                       device=like.device)[..., :w]


def _tma_input(t: torch.Tensor) -> torch.Tensor:
    if tma_ready(t):
        return t
    COPIES.add()
    return _padded(t.shape, t).copy_(t)


def ssm_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. dt, x: (Bt, L, di); A: (di, N); B, C:
    (Bt, L, N); all float32, last dim contiguous, other strides free.
    Returns a new (Bt, L, di) float32 tensor (contiguous where di is a
    multiple of 4), written on the current stream of x's device."""
    return _scan(dt, A, B, C, x, None)


def _scan(dt, A, B, C, x, lanes: Optional[int]) -> torch.Tensor:
    """``ssm_scan`` at ``plan``'s instance for ``lanes`` (None: the plan's
    own choice); tests and ``launch/kernel_compare`` hold and time the 2-
    and 4-lane instances against each other through it."""
    check_shapes(dt, A, B, C, x)
    _check_kernel_inputs(dt, A, B, C, x)
    Bt, L, di = x.shape
    index = x.get_device()
    p = plan(Bt, di, _sm_count(index), lanes)
    y = _padded((Bt, L, di), x)
    if y.numel() == 0:
        return y
    dt, B, C, x = (_tma_input(t) for t in (dt, B, C, x))
    nvcc.launch(build(), "ssm_scan", index,
                dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                x.data_ptr(), y.data_ptr(), Bt, L, di, A.shape[1],
                *dt.stride()[:2], *x.stride()[:2], A.stride(0),
                *B.stride()[:2], *C.stride()[:2], *y.stride()[:2], *p)
    LAUNCHES.add()
    return y
