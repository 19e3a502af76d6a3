"""The relational pre-aggregation (K2): the wrapper of the hand-written
CUDA kernels in ``csrc/segment_reduce.cu`` and its plain version.

Replaces the jitted segment reduction of the reference's JAX backend,
``repro/core/relops.py:562`` ``device_segment_reducer`` (``jax.jit`` of
``_core`` at :637): every accumulator column of one partition reduced into
its n group slots, byte-identical to numpy's ``np.add.at`` (sum: floats
into float64, bools into int64, integers in their own width, wrapping)
and ``np.minimum.at`` / ``np.maximum.at`` (into float64, from +-inf).

A float sum has numpy's bytes only when each group's rows are added in row
order from +0.0, so the kernel sorts the row ids by group (stable) and
walks each group in order, a warp per (column, group, element) whose
lanes load the rows and all add them in order; see the source for the
passes. What bounds it on an H100: the bytes (each value and group id
read once, each accumulator written once) are well under a millisecond
at TPC-H Q1's ~15 M-row partitions, but Q1 has 3 groups, so the in-order
walk is a few dozen warps each adding millions of dependent float64
values: the chain of adds is the time, far above the bound.

The plain version does the same in PyTorch on the host: a stable sort by
group, each group's float sums by ``torch.cumsum`` over its rows (the CPU
kernel adds them one after another, in order), min / max as the first NaN
or the last row at the extreme (numpy's tie rule), integer sums by
``index_add_`` (order-free), and returns on the inputs' device. The source
is compiled with nvcc for sm_90a at first use and bound through ctypes
(``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels import numpy_ops as npo
from repro_torch.kernels import nvcc
from repro_torch.kernels.transfer import torch_dtype

__all__ = ["segment_reduce", "segment_reduce_ref", "acc_dtype", "build",
           "LAUNCHES", "SOURCE", "COMBINERS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
COMBINERS = {"sum": 0, "min": 1, "max": 2}
MAX_COUNTS = 1 << 20  # (group, chunk) counts of the sort's scan

LAUNCHES = nvcc.LaunchCounter()


def acc_dtype(dt: np.dtype, combiner: str) -> np.dtype:
    """The accumulator dtype numpy's scatter gives (the reference's
    ``relops.sum_acc_dtype`` for a sum, float64 for min / max)."""
    dt = np.dtype(dt)
    if combiner != "sum" or dt.kind == "f":
        return np.dtype(np.float64)
    return np.dtype(np.int64) if dt.kind == "b" else dt


def _plan(rows: int, n: int):
    """(chunks, rows per chunk) of the counting sort: about 256 rows a warp
    where the (group, chunk) counts stay under MAX_COUNTS."""
    chunks = max(1, min(-(-rows // 256), MAX_COUNTS // n, 132 * 32))
    chunk = -(-rows // chunks)
    return -(-rows // chunk), chunk


@functools.lru_cache(maxsize=None)
def build() -> ctypes._CFuncPtr:
    """Compile the kernels (once per source content), load them and bind
    their C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_segment_reduce")


def _check(inv: torch.Tensor, n: int, vals: Sequence[torch.Tensor],
           dtypes: Sequence[np.dtype], combiners: Sequence[str]) -> None:
    if inv.dim() != 1 or inv.dtype != torch.int64:
        raise ValueError(f"inv: want (rows,) int64; got {tuple(inv.shape)} "
                         f"{inv.dtype}")
    if n < 1 or not (len(vals) == len(dtypes) == len(combiners) >= 1):
        raise ValueError("want n >= 1 and one dtype and combiner per value "
                         "column")
    for k, (v, dt, comb) in enumerate(zip(vals, dtypes, combiners)):
        if comb not in COMBINERS:
            raise ValueError(f"unknown combiner {comb!r}")
        if v.dtype != torch_dtype(dt) or v.dim() < 1 \
                or v.shape[0] != inv.shape[0]:
            raise ValueError(f"column {k}: want ({inv.shape[0]}, ...) of "
                             f"{torch_dtype(dt)} for {dt}; got "
                             f"{tuple(v.shape)} {v.dtype}")


def segment_reduce(inv: torch.Tensor, n: int, vals: Sequence[torch.Tensor],
                   dtypes: Sequence[np.dtype], combiners: Sequence[str]
                   ) -> List[torch.Tensor]:
    """Launch the CUDA kernels: ``inv`` (rows,) int64 group ids in [0, n)
    (a row outside is dropped), ``vals`` (rows, ...) tensors holding numpy
    columns of ``dtypes`` (``transfer.torch_dtype``), contiguous, on inv's
    CUDA device; returns one (n, ...) accumulator tensor per column, on
    the current stream."""
    _check(inv, n, vals, dtypes, combiners)
    dev = inv.device
    if dev.type != "cuda" or any(v.device != dev for v in vals):
        raise ValueError("segment_reduce's inputs must lie on one CUDA "
                         "device")
    if not inv.is_contiguous() or not all(v.is_contiguous() for v in vals):
        raise ValueError("segment_reduce's inputs must be contiguous")
    accs = [acc_dtype(dt, c) for dt, c in zip(dtypes, combiners)]
    outs = [torch.empty((n,) + tuple(v.shape[1:]), dtype=torch_dtype(a),
                        device=dev) for v, a in zip(vals, accs)]
    rows = inv.shape[0]
    if rows == 0 or any(o.numel() == 0 for o in outs):
        for o, a, c in zip(outs, accs, combiners):  # numpy's initial values
            o.fill_(0 if c == "sum" else (np.inf if c == "min" else -np.inf))
        return outs
    chunks, chunk = _plan(rows, n)
    counts = torch.empty(n * chunks, dtype=torch.int64, device=dev)
    order = torch.empty(rows, dtype=torch.int64, device=dev)
    cols = []
    for v, dt, a, c, o in zip(vals, dtypes, accs, combiners, outs):
        cols += [v.data_ptr(), o.data_ptr(), max(1, v[:1].numel()),
                 npo.DTYPE_CODES[np.dtype(dt)], npo.DTYPE_CODES[a],
                 COMBINERS[c]]
    nan64 = npo.host_nans()[0]
    nvcc.launch(build(), "segment_reduce", dev.index, inv.data_ptr(), rows,
                n, chunks, chunk, counts.data_ptr(), order.data_ptr(),
                nan64 - (1 << 64) if nan64 >> 63 else nan64, len(vals),
                *cols)
    LAUNCHES.count += 1
    return outs


def _extreme(seg: torch.Tensor, combiner: str) -> torch.Tensor:
    """numpy's ``maximum.at`` / ``minimum.at`` over one group's rows (a
    (rows, k) float64 tensor, row order): the first NaN if there is one,
    else the last row at the extreme (a tie replaces the accumulator)."""
    isnan = torch.isnan(seg)
    first_nan = isnan.to(torch.int8).argmax(0)
    clean = torch.where(isnan, -torch.inf if combiner == "max" else torch.inf,
                        seg)
    best = clean.amax(0) if combiner == "max" else clean.amin(0)
    at_best = (clean == best).flip(0).to(torch.int8).argmax(0)
    last = seg.shape[0] - 1 - at_best
    pick = torch.where(isnan.any(0), first_nan, last)
    return seg.gather(0, pick[None]).squeeze(0)


def segment_reduce_ref(inv: torch.Tensor, n: int,
                       vals: Sequence[torch.Tensor],
                       dtypes: Sequence[np.dtype], combiners: Sequence[str]
                       ) -> List[torch.Tensor]:
    """The plain version (on the host, see the module's note); returns on
    inv's device."""
    _check(inv, n, vals, dtypes, combiners)
    inv_c = inv.cpu()
    keep = (inv_c >= 0) & (inv_c < n)
    rows = torch.nonzero(keep).squeeze(1)
    order = rows[torch.argsort(inv_c[rows], stable=True)]
    ends = torch.bincount(inv_c[rows], minlength=n).cumsum(0).tolist()
    starts = [0] + ends[:-1]
    outs = []
    for v, dt, comb in zip(vals, dtypes, combiners):
        dt = np.dtype(dt)
        acc = acc_dtype(dt, comb)
        x = npo.carrier(v.cpu().reshape(v.shape[0], -1), dt)[order]
        k = x.shape[1]
        if comb == "sum" and acc.kind != "f":  # integers: order-free
            out = torch.zeros(n, k, dtype=torch.int64).index_add_(
                0, inv_c[order], x)
        else:
            x = npo.to_f64(x, dt)
            init = 0.0 if comb == "sum" else (
                torch.inf if comb == "min" else -torch.inf)
            out = torch.full((n, k), init, dtype=torch.float64)
            for g, (s, e) in enumerate(zip(starts, ends)):
                if e > s:
                    seg = x[s:e]
                    out[g] = (seg.cumsum(0)[-1] if comb == "sum"
                              else _extreme(seg, comb))
        out = npo.from_carrier(out, acc).reshape((n,) + tuple(v.shape[1:]))
        outs.append(out.to(inv.device))
    return outs
