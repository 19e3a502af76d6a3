"""Flash attention forward: the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:82``
``flash_attention_fwd`` (body ``_kernel``): an online softmax over KV
tiles with float32 running max, denominator and accumulator, GQA through
the q-head -> kv-head map ``h // G`` (no repeated KV), top-left causal
mask with fully masked tiles skipped, ragged S/T masked in the kernel.

What bounds it on an H100: at the prefill shape (B=1, S=T=4096, H=40,
K=8, hd=128, causal) the work is 2*B*H*S^2*hd ~ 172 GFLOP (~0.17 ms at
989 TFLOP/s bf16) against Q+K+V+O ~ 101 MB (~0.03 ms at 3.35 TB/s): it
is bound by tensor-core operations, which on Hopper only ``wgmma``
reaches. The bf16 design follows: one block owns one (b, h, 128-row q
tile) and loops over kv tiles itself (the TPU's sequential kv grid axis
and its scratch carry become this loop); a producer warp loads Q once and
K/V tiles through a ring of stages with TMA, guarded by mbarriers; two
consumer warpgroups (64 q rows each) run both products on ``wgmma``, P
from registers, and keep the softmax state in float32 registers; the
softmax hides under the products (each warpgroup issues S(t) with
P V(t-1), and the two take turns issuing); the output leaves through
TMA. Device memory sees Q+K+V+O only. Later tiles
of a causal launch start first, so the long rows do not trail. f32 inputs
take a plain FMA kernel of the same algorithm (the f32 check path).

``plan(hd, dtype)`` is the tile plan of each head dim; the C entry refuses
a call whose plan is not its own. TMA needs 16-byte aligned bases and
strides, which the wrapper demands.

The source is compiled with nvcc for sm_90a at first use and bound
through ctypes (``kernels/nvcc.py``): a plain C entry point, no PyTorch
headers.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc

__all__ = ["flash_attention_fwd", "check_shapes", "plan", "Plan", "build",
           "LAUNCHES", "SOURCE", "HEAD_DIMS", "SMEM_LIMIT"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448  # shared memory one block may opt into on an H100

LAUNCHES = nvcc.LaunchCounter()


class Plan(NamedTuple):
    """Tiles of one kernel instance: q rows per block, kv rows per tile,
    ring stages, swizzle bytes (0: none) and dynamic shared memory."""
    q_tile: int
    kv_tile: int
    stages: int
    swizzle: int
    smem_bytes: int


def plan(hd: int, dtype: torch.dtype) -> Plan:
    """The plan of the kernel instance for ``hd`` and ``dtype``, as
    ``Plan<HD>`` (bf16) and the f32 kernel's constants in the source
    compute it. Raises ValueError for a head dim without an instance."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:  # 32 q rows x 32 kv rows, 4 threads a row
        return Plan(32, 32, 1, 0, 4 * (64 * (hd + 1) + 32 * hd + 32 * 33))
    if dtype != torch.bfloat16:
        raise TypeError(f"{dtype}: the kernel takes float32 or bfloat16")
    # Tiles are cut into chunks of one swizzle span of columns: 64 (128 B)
    # where 64 divides hd, else 32 (64 B) or 16 (32 B).
    cols = 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else 16
    q_tile = 128  # two consumer warpgroups of 64 rows (the wgmma M)
    # fewer kv rows where O's hd/2 floats a thread leave fewer registers
    # (64 at hd 192 keeps three stages; 80 at 256, two)
    kv_tile = 128 if hd <= 128 else 64 if hd == 192 else 80
    q_bytes, stage = q_tile * hd * 2, 2 * kv_tile * hd * 2  # K and V
    stages = min(4, (SMEM_LIMIT - q_bytes - 1024 - 128) // stage)
    # 1 KB to align the swizzled tiles, Q, the ring, 8-byte mbarriers
    smem = 1024 + q_bytes + stages * stage + 8 * (1 + 3 * stages)
    return Plan(q_tile, kv_tile, stages, 2 * cols, smem)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it."""
    lib = nvcc.load(SOURCE)
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 18
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,T,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"disagree (need same B and hd, H % K == 0)")
    if S == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def _check_kernel_inputs(q, k, v) -> None:
    """What the kernel takes: one dtype (float32 or bfloat16), a
    contiguous head dim, 16-byte aligned bases and strides (TMA), one CUDA
    device. The layout is checked before the device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            f"or bfloat16, the same for q, k, v")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        vec = 16 // t.element_size()  # TMA: 16-byte base and strides
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"that are multiples of {vec} elements")
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B,S,H,hd); k/v: (B,T,K,hd), H % K == 0,
    read in place through their strides. Returns a new (B,S,H,hd) tensor in
    q's dtype, written on the current stream."""
    check_shapes(q, k, v)
    tiles = plan(q.shape[3], q.dtype)  # refuses a head dim first
    _check_kernel_inputs(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    fn = build().repro_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, T, H, K, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 _DTYPE_CODE[q.dtype], int(causal), hd ** -0.5, *tiles,
                 stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES.add()
    return out
