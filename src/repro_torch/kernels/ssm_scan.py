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

The backward (``ssm_scan_bwd``, the C entry ``repro_ssm_scan_bwd`` of the
same source) gives (ddt, dA, dB, dC, dx) from g = dL/dy: the gradient the
reference takes by autodiff of its scan (``repro/models/ssm.py:84``), as a
reverse-time scan (``ref.ssm_scan_bwd_ref`` is its function in plain
PyTorch). When a gradient is wanted the forward runs as
``ssm_scan_checkpointed``, the same kernel storing h before every 8 steps
(the checkpoints, ``checkpoint_shape``); the backward reads them and
recomputes each 8-step chunk with the forward's ex2, keeping the chunk's
states and decays in registers (one exponential a state step), with 4
lanes a channel, ``bwd_plan``'s channels a block and TMA loads in reverse
chunk order, a few chunks ahead. It reduces dB, dC and dA in a fixed order through
per-block partials, without atomics. Without the checkpoints
``ssm_scan_bwd`` first runs the checkpointing forward itself, so a direct
call gives the bits of the autograd path. Its scratch is allocated here; B
and C may be strided views, their gradients come back contiguous; ddt and
dx come back contiguous where di is a multiple of 4, as y does.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import nvcc

__all__ = ["ssm_scan", "ssm_scan_checkpointed", "ssm_scan_bwd",
           "check_shapes", "plan", "ScanPlan", "bwd_plan", "BwdPlan",
           "tma_ready", "build", "build_bwd",
           "checkpoint_shape", "LAUNCHES", "LAUNCHES_BWD", "COPIES",
           "SOURCE", "MAX_STATE", "BWD_CHUNK"]

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
# Steps between the training forward's checkpoints, which is also the
# backward's chunk (kBT in the source, which refuses another); the
# backward's ring stages (kBStages), lanes a channel (4: a lane's chunk of
# states and decays fits in registers) and its instances' channels a
# block. Measured on an H100 (PERF.md): 128 channels a block (fewer
# partials of dB and dC) where the grid gives at least half the SMs a
# block, as jamba's 128 at Bt = 1 do; 32 (four times the blocks) where it
# gives fewer, as the reduced model's 4 do.
BWD_CHUNK, BWD_STAGES, BWD_LANES = 8, 3, 4
BWD_CHANNELS = (128, 32)

LAUNCHES = nvcc.LaunchCounter()
LAUNCHES_BWD = nvcc.LaunchCounter()
COPIES = nvcc.LaunchCounter()  # inputs copied into a TMA-ready layout


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


class BwdPlan(NamedTuple):
    """One backward instance: lanes per channel, channels per block, steps
    per chunk, ring stages and dynamic shared-memory bytes."""
    lanes: int
    channels: int
    chunk: int
    stages: int
    smem_bytes: int


def bwd_smem_bytes(channels: int) -> int:
    """The source's ``Bwd<channels>::kSmem``: 128 bytes of alignment, the
    ring (dt, x and g tiles of 8 x channels, the checkpoint of channels x
    16 states, the B and C rows), two ddt and two dx tiles, two buffers of
    the warps' dB/dC sums, an mbarrier a stage."""
    warps, chunk = channels * BWD_LANES // 32, BWD_CHUNK
    tile = 4 * chunk * channels
    stage = 3 * tile + 4 * MAX_STATE * channels + 2 * 4 * chunk * MAX_STATE
    red = warps * chunk * 2 * MAX_STATE * 4
    return 128 + BWD_STAGES * stage + 4 * tile + 2 * red + 8 * BWD_STAGES


@functools.lru_cache(maxsize=None)
def bwd_plan(Bt: int, di: int, n_sm: int = 132,
             channels: Optional[int] = None) -> BwdPlan:
    """The backward's launch for Bt batch rows of di channels on a card of
    ``n_sm`` SMs: the instance of ``channels`` channels per block, by
    default 128 where that gives at least half the SMs a block, else 32.
    Raises ValueError for a count that is not an instance's."""
    if channels is None:
        channels = 128 if 2 * Bt * -(-di // 128) >= n_sm else 32
    if channels not in BWD_CHANNELS:
        raise ValueError(f"no backward instance of {channels} channels a "
                         f"block; the instances: {BWD_CHANNELS}")
    return BwdPlan(BWD_LANES, channels, BWD_CHUNK, BWD_STAGES,
                   bwd_smem_bytes(channels))


@functools.lru_cache(maxsize=None)
def build() -> ctypes._CFuncPtr:
    """Compile the kernel (once per source content), load it and bind its
    C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_ssm_scan")


@functools.lru_cache(maxsize=None)
def build_bwd() -> ctypes._CFuncPtr:
    """The backward's C entry, from the same library as ``build``."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_ssm_scan_bwd")


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
    (sb, st, _), (nb, nt, _) = t.stride(), t.shape
    return t.data_ptr() % 16 == 0 and (sb % 4 == 0 or nb == 1) \
        and (st % 4 == 0 or nt == 1)


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


def ssm_scan_checkpointed(dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssm_scan`` that also keeps the backward's checkpoints: returns (y,
    ck), ck the (Bt, ceil(L / 8), di, N) float32 states before steps 0, 8,
    16, .. (a view of a buffer that holds all 16 states of a channel, zeros
    past N, in one 64-byte row), by the same kernel's instance that stores
    them; y has ``ssm_scan``'s bits."""
    return _launch(dt, A, B, C, x, None, checkpoints=True)


def checkpoint_shape(Bt: int, L: int, di: int, N: int) -> tuple:
    """The checkpoints' shape: the state before every ``BWD_CHUNK`` steps."""
    return Bt, -(-L // BWD_CHUNK), di, N


def _scan(dt, A, B, C, x, lanes: Optional[int]) -> torch.Tensor:
    """``ssm_scan`` at ``plan``'s instance for ``lanes`` (None: the plan's
    own choice); tests and ``launch/kernel_compare`` hold and time the 2-
    and 4-lane instances against each other through it."""
    return _launch(dt, A, B, C, x, lanes)[0]


def _launch(dt, A, B, C, x, lanes: Optional[int], checkpoints: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, ck) of ``plan``'s instance for ``lanes``, ck None unless
    ``checkpoints``."""
    check_shapes(dt, A, B, C, x)
    _check_kernel_inputs(dt, A, B, C, x)
    Bt, L, di = x.shape
    N = A.shape[1]
    index = x.get_device()
    p = plan(Bt, di, _sm_count(index), lanes)
    y = _padded((Bt, L, di), x)
    ck = None
    if checkpoints:
        ck = torch.empty((Bt, -(-L // BWD_CHUNK), di, MAX_STATE),
                         dtype=torch.float32, device=x.device)[..., :N]
    if y.numel() == 0:
        return y, ck
    dt, B, C, x = (_tma_input(t) for t in (dt, B, C, x))
    nvcc.launch(build(), "ssm_scan", index,
                dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                x.data_ptr(), y.data_ptr(), Bt, L, di, N,
                *dt.stride()[:2], *x.stride()[:2], A.stride(0),
                *B.stride()[:2], *C.stride()[:2], *y.stride()[:2], *p,
                0 if ck is None else ck.data_ptr())
    LAUNCHES.add()
    return y, ck


def _check_checkpoints(ck: torch.Tensor, x: torch.Tensor, N: int) -> None:
    """ck as ``ssm_scan_checkpointed`` makes it: on x's device, float32,
    ``checkpoint_shape``, a view of a contiguous 16-byte aligned buffer of
    16 states a channel."""
    Bt, L, di = x.shape
    want = checkpoint_shape(Bt, L, di, N)
    if tuple(ck.shape) != want or ck.dtype != torch.float32 \
            or ck.device != x.device:
        raise ValueError(f"checkpoints {tuple(ck.shape)} {ck.dtype} on "
                         f"{ck.device}; want {want} float32 on {x.device}")
    S = MAX_STATE
    if ck.stride() != (want[1] * di * S, di * S, S, 1) or ck.data_ptr() % 16:
        raise ValueError(f"checkpoints' strides {ck.stride()}: want a view "
                         f"of a contiguous (Bt, n, di, {S}) buffer")


def ssm_scan_bwd(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                 ck: Optional[torch.Tensor] = None,
                 channels: Optional[int] = None) -> tuple:
    """Launch the backward kernels: from the forward's inputs (as
    ``ssm_scan`` takes them), g = dL/dy (Bt, L, di) float32, last dim
    contiguous, and the forward's checkpoints ``ck`` (from
    ``ssm_scan_checkpointed``; None: that forward is run here first),
    return (ddt, dA, dB, dC, dx), new float32 tensors written on the
    current stream of x's device: dA, dB, dC contiguous, ddt and dx where
    di is a multiple of 4. ``channels`` picks ``bwd_plan``'s instance."""
    check_shapes(dt, A, B, C, x)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} is not y's shape "
                         f"{tuple(x.shape)}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_kernel_inputs(dt, A, B, C, x)
    if not g.is_cuda or g.device != x.device or g.dtype != torch.float32:
        raise ValueError(f"g is {g.dtype} on {g.device}; want float32 on "
                         f"{x.device}")
    Bt, L, di = x.shape
    N = A.shape[1]
    index = x.get_device()
    p = bwd_plan(Bt, di, _sm_count(index), channels)
    # ddt and dx in one buffer of padded rows; dB, dC, dA in another; the
    # scratch (per-block partials of dB and dC, dA's per-row parts) apart
    dpad = -(-di // 4) * 4
    both = torch.empty((2, Bt, L, dpad), dtype=torch.float32,
                       device=x.device)[..., :di]
    ddt, dx = both[0], both[1]
    nb = Bt * L * N
    small = torch.empty(2 * nb + di * N, dtype=torch.float32,
                        device=x.device)
    dB, dC = small[:2 * nb].view(2, Bt, L, N)
    dA = small[2 * nb:].view(di, N)
    if x.numel() == 0:
        return ddt, dA.zero_(), dB.zero_(), dC.zero_(), dx
    if ck is None:
        ck = _launch(dt, A, B, C, x, None, checkpoints=True)[1]
    _check_checkpoints(ck, x, N)
    n_part = Bt * -(-di // p.channels) * L * 2 * MAX_STATE
    scratch = torch.empty(n_part + Bt * di * N, dtype=torch.float32,
                          device=x.device)
    dt, B, C, x, g = (_tma_input(t) for t in (dt, B, C, x, g))
    nvcc.launch(build_bwd(), "ssm_scan_bwd", index,
                dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                x.data_ptr(), g.data_ptr(), ck.data_ptr(), ddt.data_ptr(),
                dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * n_part,
                Bt, L, di, N, *dt.stride()[:2], *x.stride()[:2],
                *g.stride()[:2], A.stride(0), *B.stride()[:2],
                *C.stride()[:2], *ddt.stride()[:2], *p)
    LAUNCHES_BWD.add()
    return ddt, dA, dB, dC, dx
