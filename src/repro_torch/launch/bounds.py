"""The least time an H100 SXM could take for the gather's and the scan's
work, the yardstick beside their measured times in ``chip_smoke.py`` and
``launch/kernel_compare.py``.

Each bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the memory rate, and
its operations over the peak rate of their unit.
"""
from __future__ import annotations

__all__ = ["PEAK_BYTES", "PEAK_F32", "PEAK_EXP", "gather_bound_ms",
           "scan_bound_ms"]

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


def scan_bound_ms(Bt, L, di, N) -> tuple:
    """(ms, "operations" | "bytes"): dt and x (Bt,L,di) read once, B and C
    (Bt,L,N) and A (di,N) read once, y (Bt,L,di) written once, all f32;
    against L*di*N exponentials per batch row on the special-function
    units and ~4 f32 operations per (t, c, n) (dt*A, the multiply-add into
    h, dt*x*B, h*C) at the f32 peak. The slower of the two operation counts
    is the operations bound."""
    nbytes = 4 * (3 * Bt * L * di + 2 * Bt * L * N + di * N)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(Bt * L * di * N / PEAK_EXP,
                4.0 * Bt * L * di * N / PEAK_F32)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
