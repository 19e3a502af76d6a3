"""The least time an H100 SXM could take for the gather's and the scan's
work, forward and backward, the yardstick beside their measured times in
``chip_smoke.py`` and ``launch/kernel_compare.py``.

Each bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the memory rate, and
its operations over the peak rate of their unit.
"""
from __future__ import annotations

from repro_torch.kernels.ssm_scan import BWD_CHUNK

__all__ = ["PEAK_BYTES", "PEAK_F32", "PEAK_EXP", "gather_bound_ms",
           "scan_bound_ms", "gather_bwd_bound_ms", "scan_bwd_bound_ms",
           "checkpoint_bytes"]

# NVIDIA data sheet, dense, at the 700 W limit: 3.35 TB/s; 67 TFLOP/s
# float32 on the CUDA cores; 16 special-function lanes per SM x 132 SMs at
# the 1.98 GHz that float32 peak implies (132 SMs x 128 lanes x 2 flops).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_EXP = 16 * PEAK_F32 / (128 * 2)


def gather_bound_ms(n_rows_read, d, S, elem) -> tuple:
    """(ms, "bytes"): the least time to read each needed row of x, the ids
    (int32) and keep flags (bool) once and write the (S, d) buffer once.
    A copy does no arithmetic, so bytes bound it."""
    nbytes = n_rows_read * d * elem + S * (4 + 1) + S * d * elem
    return 1e3 * nbytes / PEAK_BYTES, "bytes"


def checkpoint_bytes(Bt, L, di, N) -> int:
    """The scan's checkpoints: the float32 state of each batch row before
    every ``BWD_CHUNK`` steps, a channel's 16 states (N of them,
    zeros past N) in one 64-byte row as the kernels keep them."""
    return 4 * Bt * -(-L // BWD_CHUNK) * di * 16


def scan_bound_ms(Bt, L, di, N, checkpoints: bool = False) -> tuple:
    """(ms, "operations" | "bytes"): dt and x (Bt,L,di) read once, B and C
    (Bt,L,N) and A (di,N) read once, y (Bt,L,di) written once, all f32,
    and with ``checkpoints`` the training forward's checkpoints
    (``checkpoint_bytes``) written once; against L*di*N exponentials per
    batch row on the special-function units and ~4 f32 operations per (t,
    c, n) (dt*A, the multiply-add into h, dt*x*B, h*C) at the f32 peak.
    The slower of the two operation counts is the operations bound."""
    nbytes = 4 * (3 * Bt * L * di + 2 * Bt * L * N + di * N)
    if checkpoints:
        nbytes += checkpoint_bytes(Bt, L, di, N)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(Bt * L * di * N / PEAK_EXP,
                4.0 * Bt * L * di * N / PEAK_F32)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gather_bwd_bound_ms(n_kept, T, d, k, elem) -> tuple:
    """(ms, "bytes"): the gather's backward reads the n_kept kept slots'
    rows of g and the (T, k) int64 map of each token's slots once and
    writes dx (T, d) once; its n_kept * d additions are far below the
    bytes' time."""
    nbytes = n_kept * d * elem + T * k * 8 + T * d * elem
    return 1e3 * nbytes / PEAK_BYTES, "bytes"


def scan_bwd_bound_ms(Bt, L, di, N, checkpoints: bool = True) -> tuple:
    """(ms, "operations" | "bytes"): the backward given the forward's
    checkpoints: dt, x and g (Bt,L,di), the checkpoints, B, C (Bt,L,N)
    and A (di,N) read once; ddt, dx (Bt,L,di), dB, dC (Bt,L,N) and dA
    (di,N) written once, all f32; against one exponential per (t, c, n)
    (the decay, recomputed from the checkpoints and kept for the reverse
    step) on the special-function units, and ~18 f32 operations per (t, c,
    n) (the recompute's 4; dh, the carried decay, w, the two n-sums, dA,
    the dB and dC terms and their sums over channels) at the f32 peak.
    Without ``checkpoints``, the function's own minimum: the same without
    the checkpoints' reads, which the design's spacing sets."""
    nbytes = 4 * (5 * Bt * L * di + 4 * Bt * L * N + 2 * di * N)
    if checkpoints:
        nbytes += checkpoint_bytes(Bt, L, di, N)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(Bt * L * di * N / PEAK_EXP,
                18.0 * Bt * L * di * N / PEAK_F32)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
